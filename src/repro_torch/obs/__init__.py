"""Observability of the port: span tracing, a live terminal console and a
web dashboard over the telemetry stream (the port of ``repro/obs``).

  - ``obs.spans``: the span tracer, exporting Chrome trace-event JSON
    (Perfetto-loadable), its spans on the card ending with their device
    work;
  - ``obs.tail``: a JSONL tail reader robust to partial lines, truncation
    and rotation;
  - ``obs.metrics``: the one rollup the console, the dashboard and the
    headless snapshot read;
  - ``obs.console``, ``obs.web``: ``python -m repro_torch.obs console|web``.

This ``__init__`` stays light: the engines import ``obs.spans`` for the
shared ``NULL_TRACER``, so nothing here imports the console or torch.
"""
from repro_torch.obs.spans import (                # noqa: F401
    NULL_TRACER, NullTracer, SpanTracer, validate_chrome_trace,
)
from repro_torch.obs.tail import (                 # noqa: F401
    TailReader, read_complete_lines,
)
