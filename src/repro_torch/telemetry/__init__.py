"""Telemetry: structured per-arrival update-quality diagnostics.

Port of ``repro/telemetry``: the paper's Section-5 evidence layer (who sent
what, how stale it was, how well it aligned with the outer momentum, how
much the method corrected, what the per-language losses did) as a typed
JSONL stream the engine writes with no extra kernel launch per arrival
(the stats ride the fused packed sweeps as an extra output; see
``repro_torch.telemetry.stats``). The schema, recorder and analyses are
copies of the reference's, so its tools read the port's streams.

    from repro_torch.telemetry import TelemetryRecorder
    rec = TelemetryRecorder()
    eng = make_engine(run_cfg, telemetry=rec)
    eng.run(...)
    rec.write_jsonl("results/telemetry/run.jsonl")
"""
from repro_torch.telemetry.analysis import (          # noqa: F401
    language_spread, per_language_curves, per_language_final,
    staleness_alignment, summarize,
)
from repro_torch.telemetry.recorder import (          # noqa: F401
    DEFAULT_WINDOW, TelemetryRecorder, iter_jsonl,
)
from repro_torch.telemetry.schema import (            # noqa: F401
    SCHEMA_VERSION, ArrivalMetrics, EvalMetrics, FaultMetrics, FlushMetrics,
    RunMeta, RuntimeMetrics, StreamDecoder, TransportMetrics, from_json_line,
    to_json_line,
)
from repro_torch.telemetry.stats import (             # noqa: F401
    MOMENT_FIELDS, N_MOMENTS, UpdateStats, momentum_only_moments,
    reference_moments, stats_from_moments,
)
