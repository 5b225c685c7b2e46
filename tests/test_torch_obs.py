"""The port's observability stack (``repro_torch.obs``) on the CPU, against
the reference's ``repro.obs``.

  * the tail reader, the span tracer, the console, the web dashboard and
    the ``python -m repro_torch.obs`` command line: counterparts of the
    reference's unit tests in tests/test_obs.py, with the high-water mark
    of ``export_new`` under threads and ``ingest_remote``'s re-basing;
  * one stream, rendered by both packages: the console's text byte-equal
    and the dashboard's panels equal, over a stream the port's recorder
    wrote and over the committed chaos_partition stream; each package's
    validator accepts the other's trace;
  * engines: a traced ``paper_hetero_severe`` (and the batched
    ``hogwild_rampup``) with telemetry on keeps the golden's arrivals and
    the untraced run's bits, and records the multiset of (name, cat, args)
    the reference's live run records from the same bridged parameters;
    ``verify(obs=True)``; the launcher's ``--trace`` through the CLI's
    validator; the threaded runtime's transport spans;
  * cross-process collection without processes: ``_on_obs`` with a
    hand-built frame and malformed ones, the pool's obs branch; and in the
    ``proc`` lane ``socket_hetero`` over 4 processes with the whole stack.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import Counter

import pytest
import torch

from repro.async_engine.engine import make_engine as jax_make_engine
from repro.async_engine.engine import make_eval_fn as jax_make_eval_fn
from repro.obs import console as jconsole
from repro.obs import spans as jspans
from repro.obs import web as jweb
from repro.scenarios import registry as jregistry
from repro_torch import bridge
from repro_torch.async_engine.engine import make_eval_fn
from repro_torch.async_engine.proc import WorkerProcessPool
from repro_torch.launch import train
from repro_torch.obs import spans, web
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.obs.console import ConsoleState, render, sparkline
from repro_torch.obs.console import main as console_main
from repro_torch.obs.spans import NULL_TRACER, SpanTracer, validate_chrome_trace
from repro_torch.obs.tail import TailReader, read_complete_lines
from repro_torch.scenarios import registry, run, trace
from repro_torch.telemetry import StreamDecoder, TelemetryRecorder, schema
from test_torch_methods import one_intra_op_thread  # noqa: F401
from test_torch_server import _flat
from test_torch_wallclock import _twin

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
GOLDEN_STREAM = os.path.join(REPO, "results", "golden", "streams",
                             "chaos_partition.jsonl")
# every HTTP read of the dashboard tests gives up after this many seconds
HTTP_TIMEOUT = 10


# ---------------------------------------------------------------------------
# Tail / follow reader
# ---------------------------------------------------------------------------

def test_tail_holds_back_partial_trailing_line(tmp_path):
    p = tmp_path / "s.jsonl"
    p.write_text('{"a": 1}\n{"b": 2')          # second record still mid-write
    r = TailReader(str(p))
    assert r.read_available() == ['{"a": 1}']
    assert r.read_available() == []             # partial line stays buffered
    with open(p, "a") as f:
        f.write('}\n{"c": 3}\n')
    assert r.read_available() == ['{"b": 2}', '{"c": 3}']
    r.close()


def test_tail_restarts_on_truncation(tmp_path):
    p = tmp_path / "s.jsonl"
    p.write_text("one\ntwo\nthree\n")
    r = TailReader(str(p))
    assert r.read_available() == ["one", "two", "three"]
    p.write_text("fresh\n")                     # a rerun over the same path
    assert r.read_available() == ["fresh"]
    r.close()


def test_tail_follows_rotation_to_new_inode(tmp_path):
    p = tmp_path / "s.jsonl"
    p.write_text("old\n")
    r = TailReader(str(p))
    assert r.read_available() == ["old"]
    os.rename(p, tmp_path / "s.jsonl.1")        # rotate
    (tmp_path / "s.jsonl").write_text("new\n")
    # a filesystem may reuse the inode: poll twice
    got = r.read_available() or r.read_available()
    assert got == ["new"]
    r.close()


def test_tail_waits_for_missing_file(tmp_path):
    p = tmp_path / "later.jsonl"
    r = TailReader(str(p))
    assert r.read_available() == []             # not an error
    p.write_text("here\n")
    assert r.read_available() == ["here"]
    r.close()


def test_follow_drains_after_stop_and_survives_concurrent_writer(tmp_path):
    p = tmp_path / "s.jsonl"
    p.write_text("")
    stop = threading.Event()
    got = []

    def writer():
        with open(p, "a") as f:
            for i in range(20):
                f.write(f"line-{i}\n")
                f.flush()
                time.sleep(0.002)
        stop.set()

    t = threading.Thread(target=writer)
    t.start()
    r = TailReader(str(p), poll=0.005)
    for ln in r.follow(stop=stop.is_set):
        got.append(ln)
    t.join(timeout=10)
    assert not t.is_alive()
    r.close()
    # the drain after stop: nothing written before it is lost
    assert got == [f"line-{i}" for i in range(20)]


def test_read_complete_lines_drops_partial_tail(tmp_path):
    p = tmp_path / "s.jsonl"
    p.write_text("a\nb\ncut-off-no-newline")
    assert read_complete_lines(str(p)) == ["a", "b"]


# ---------------------------------------------------------------------------
# Span tracer and Chrome trace export
# ---------------------------------------------------------------------------

def test_span_tracer_exports_valid_chrome_trace_with_thread_names():
    tr = SpanTracer()
    with tr.span("outer", cat="engine", step=1):
        with tr.span("inner", cat="compute"):
            pass
    tr.instant("retry", cat="transport", wid=3)

    def worker():
        with tr.span("worker_round", cat="compute", wid=0):
            pass

    t = threading.Thread(target=worker, name="heloco-worker-0")
    t.start()
    t.join(timeout=10)
    assert len(tr) == 4
    doc = tr.to_chrome()
    assert validate_chrome_trace(doc) == []
    names = [e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "thread_name"]
    assert "heloco-worker-0" in names
    spans_ = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in spans_} == {"outer", "inner", "worker_round"}
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in spans_)
    # nesting: inner ends no later than outer
    by = {e["name"]: e for e in spans_}
    assert (by["inner"]["ts"] + by["inner"]["dur"]
            <= by["outer"]["ts"] + by["outer"]["dur"] + 1e-3)


def test_span_tracer_write_roundtrip(tmp_path):
    tr = SpanTracer()
    with tr.span("s"):
        pass
    path = tr.write(str(tmp_path / "t.trace.json"))
    with open(path) as f:
        assert validate_chrome_trace(json.load(f)) == []


def test_null_tracer_is_inert():
    with NULL_TRACER.span("anything", cat="compute", wid=1):
        pass
    NULL_TRACER.instant("x")
    assert len(NULL_TRACER) == 0
    with pytest.raises(RuntimeError):
        NULL_TRACER.write("/nonexistent/nope.json")


def test_validate_chrome_trace_rejects_malformed():
    assert validate_chrome_trace({}) != []
    assert validate_chrome_trace({"traceEvents": []}) != []
    no_dur = {"traceEvents": [{"name": "a", "ph": "X", "ts": 0,
                               "pid": 0, "tid": 0}]}
    assert any("dur" in p for p in validate_chrome_trace(no_dur))
    meta_only = {"traceEvents": [{"name": "process_name", "ph": "M",
                                  "pid": 0, "args": {"name": "p"}}]}
    assert any("no complete" in p for p in validate_chrome_trace(meta_only))


def test_device_spans_make_no_cuda_event_without_cuda(monkeypatch):
    """Where CUDA is not initialised a span of a device category records
    like any other and makes no CUDA event."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    tr = SpanTracer()
    for cat in sorted(spans.DEVICE_CATS) + ["transport"]:
        with tr.span("s", cat=cat):
            pass
    assert len(tr) == len(spans.DEVICE_CATS) + 1


def test_export_new_ships_each_span_once_under_threads():
    """Threads record while the shipper exports: the high-water mark puts
    every span in exactly one batch, in recording order."""
    tr = SpanTracer()
    n_threads, per_thread = 12, 300
    start = threading.Barrier(n_threads + 1)

    def record(i):
        start.wait()
        for j in range(per_thread):
            with tr.span("s", cat="transport", i=i, j=j):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=record, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        start.wait()
        batches = []
        while any(t.is_alive() for t in threads):
            batches.append(tr.export_new())
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        batches.append(tr.export_new())
    finally:
        sys.setswitchinterval(old)
    shipped = [tuple(e) for b in batches for e in b["events"]]
    assert len(shipped) == n_threads * per_thread
    assert shipped == [tuple(e) for e in tr._events]
    assert tr.export_new()["events"] == []


def test_ingest_remote_rebases_clamps_and_keys_by_pid():
    tr = SpanTracer()
    with tr.span("server_commit", cat="server"):
        pass
    ev = ["worker_round", "compute", "X", 0.5, 0.25, 7, {"wid": 1}]
    # a child whose epoch lies 1 s after the parent's
    tr.ingest_remote(pid=101, epoch_offset=tr._epoch + 1.0, events=[ev],
                     names={7: "MainThread"}, process_name="w1")
    # a respawned child (new pid) whose clock estimate lies before it
    tr.ingest_remote(pid=102, epoch_offset=tr._epoch - 10.0, events=[ev],
                     names={7: "MainThread"}, process_name="w1 again")
    tr.ingest_remote(pid=101, epoch_offset=tr._epoch + 2.0,
                     events=[ev[:3] + [0.0] + ev[4:]], names={})
    assert tr.pids == [0, 101, 102] and len(tr) == 4
    doc = tr.to_chrome()
    assert validate_chrome_trace(doc) == []
    rows = {e["args"]["name"] for e in doc["traceEvents"]
            if e["name"] == "process_name"}
    assert rows == {"heloco-runtime", "w1", "w1 again"}
    ts = sorted((e["pid"], e["ts"]) for e in doc["traceEvents"]
                if e["ph"] == "X" and e["pid"])
    # pid 101's last offset re-bases both of its batches; pid 102 clamps
    assert ts == [(101, 2.0e6), (101, 2.5e6), (102, 0.0)]


# ---------------------------------------------------------------------------
# Console, dashboard and CLI over the committed chaos_partition stream
# ---------------------------------------------------------------------------

def _console_over(lines):
    state = ConsoleState()
    for ln in lines:
        state.add_line(ln)
    return state, render(state, color=False)


def _meta_line(version: int) -> str:
    d = json.loads(schema.to_json_line(schema.RunMeta(
        method="heloco", engine="sim", n_workers=2, outer_steps=4, seed=0)))
    d["schema_version"] = version
    return json.dumps(d)


def test_console_once_renders_committed_chaos_partition_stream():
    lines = read_complete_lines(GOLDEN_STREAM)
    assert lines, f"missing committed stream {GOLDEN_STREAM}"
    state, out = _console_over(lines)
    assert state.meta is not None and state.meta.scenario == "chaos_partition"
    for needle in ("HeLoCo operator console", "chaos_partition",
                   "staleness histogram", "cos(D,m)", "per-language loss",
                   "workers", "runtime health", "delivery / chaos",
                   "transport (per worker process)",
                   "commit-buffer flushes"):
        assert needle in out, f"panel {needle!r} missing:\n{out}"
    # the partitioned worker (wid 3) shows dead
    assert state.workers[3]["state"] == "dead" and "dead" in out
    assert "liveness_deaths" in out and "redelivered_deduped" in out
    assert len(state.transport) >= 2
    assert any(wid == 3 for wid, _pid in state.transport)
    assert state.n_flushes >= 1 and "batch-full" in out
    assert "schema drift" not in out
    assert state.decoder.stream_version == schema.SCHEMA_VERSION


def test_console_surfaces_unknown_kind_instead_of_crashing():
    lines = [_meta_line(schema.SCHEMA_VERSION + 1),
             '{"kind": "quantum_flux", "q": 1}']
    _state, out = _console_over(lines)
    assert "schema drift" in out and "quantum_flux" in out


def test_console_cli_once_smoke(capsys):
    assert console_main([GOLDEN_STREAM, "--once"]) == 0
    out = capsys.readouterr().out
    assert "HeLoCo operator console" in out and "chaos_partition" in out


def test_trace_cli_validate(tmp_path, capsys):
    tr = SpanTracer()
    with tr.span("s"):
        pass
    p = tr.write(str(tmp_path / "t.json"))
    assert obs_main(["trace", p, "--validate"]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text('{"traceEvents": [{"ph": "X"}]}')
    capsys.readouterr()
    assert obs_main(["trace", str(bad), "--validate"]) == 1


@pytest.mark.parametrize("argv, code", [([], 0), (["--help"], 0),
                                        (["nope"], 2)])
def test_obs_cli_exit_codes(argv, code, capsys):
    assert obs_main(argv) == code
    out = capsys.readouterr()
    assert "console <stream.jsonl>" in out.out + out.err


def test_sparkline_shape():
    assert sparkline([]) == ""
    s = sparkline([0, 1, 2, 3], width=4)
    assert len(s) == 4 and s[0] == "▁" and s[-1] == "█"
    assert sparkline([5.0] * 3) == "▁▁▁"        # a constant series


def test_web_snapshot_contains_acceptance_panels():
    p = web.snapshot_panels(GOLDEN_STREAM)
    assert p["meta"]["scenario"] == "chaos_partition"
    assert p["meta"]["schema_version"] == schema.SCHEMA_VERSION
    assert p["arrivals"]["commits"] > 0
    assert p["arrivals"]["rate_per_sec"] > 0
    assert p["staleness"]
    assert sum(p["staleness"].values()) == p["arrivals"]["commits"]
    assert len(p["transport"]["workers"]) >= 2
    assert p["transport"]["totals"]["frames_sent"] > 0
    assert p["transport"]["totals"]["compute_s"] > 0
    assert p["flush"]["flushes"] >= 1
    assert "batch-full" in p["flush"]["reasons"]
    assert p["flush"]["fused"] + p["flush"]["sequential"] >= 2
    assert p["drift"] == []


def test_web_snapshot_cli(capsys):
    assert obs_main(["web", GOLDEN_STREAM, "--snapshot"]) == 0
    p = json.loads(capsys.readouterr().out)
    for panel in ("arrivals", "staleness", "transport", "flush"):
        assert p[panel], f"panel {panel!r} empty in --snapshot output"


def test_console_and_web_share_one_aggregation_code_path():
    state = ConsoleState()
    for ln in read_complete_lines(GOLDEN_STREAM):
        state.add_line(ln)
    assert state.panels() == web.snapshot_panels(GOLDEN_STREAM)


def test_web_server_routes_live(tmp_path):
    """The dashboard on an ephemeral port of 127.0.0.1: / serves the page,
    /snapshot.json follows a growing stream, /events pushes an SSE frame,
    an unknown path is a 404. Every read has a timeout of its own."""
    lines = read_complete_lines(GOLDEN_STREAM)
    stream = tmp_path / "live.jsonl"
    stream.write_text("\n".join(lines[:3]) + "\n")
    hub = web._Hub(str(stream), poll=0.02)
    hub.start()
    handler = type("H", (web._Handler,), {"hub": hub, "sse_interval": 0.05})
    httpd = web.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    httpd.daemon_threads = True
    t = threading.Thread(target=httpd.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        page = urllib.request.urlopen(base + "/",
                                      timeout=HTTP_TIMEOUT).read()
        assert b"HeLoCo dashboard" in page and b"EventSource" in page
        with open(stream, "a") as f:
            f.write("\n".join(lines[3:]) + "\n")
        snap = {}
        deadline = time.monotonic() + HTTP_TIMEOUT
        while time.monotonic() < deadline:
            snap = json.loads(urllib.request.urlopen(
                base + "/snapshot.json", timeout=HTTP_TIMEOUT).read())
            if snap.get("transport") and snap.get("flush"):
                break
            time.sleep(0.05)
        assert snap["arrivals"]["commits"] > 0
        assert snap["transport"] and snap["flush"]
        resp = urllib.request.urlopen(base + "/events", timeout=HTTP_TIMEOUT)
        payload = None
        for _ in range(100):
            ln = resp.readline()
            if ln.startswith(b"data: "):
                payload = json.loads(ln[6:])
                break
        resp.close()
        assert payload is not None and payload["arrivals"]["commits"] > 0
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "/nope", timeout=HTTP_TIMEOUT)
        assert exc.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        hub.stop()
        t.join(timeout=HTTP_TIMEOUT)
    assert not t.is_alive()


# ---------------------------------------------------------------------------
# Engines: traced runs against untraced ones and the reference's spans
# ---------------------------------------------------------------------------

LIVE = ("paper_hetero_severe", "hogwild_rampup")


def _state_bits(eng):
    st = eng.server.state
    return {f"{part}/{k}": v for part, tree in
            (("p", st.params), ("m", st.momentum), ("a", st.aux or {}))
            for k, v in tree.items()}


def _span_multiset(doc):
    return Counter((e["name"], e["cat"], json.dumps(e.get("args"),
                                                    sort_keys=True))
                   for e in doc["traceEvents"] if e["ph"] in ("X", "i"))


@pytest.fixture(scope="module", params=LIVE)
def live(request, tmp_path_factory):
    """The reference's live run with its tracer, then the port's from the
    same bridged parameters traced with a live telemetry sink, and
    untraced; each port run's trace written to a file."""
    name = request.param
    d = tmp_path_factory.mktemp(name)
    jscn = jregistry.get_scenario(name)
    jtr = jspans.SpanTracer()
    jeng = jax_make_engine(jscn, tracer=jtr)
    init = _flat(jeng.server.state.params)
    jeng.run(eval_every=jscn.eval_cadence,
             eval_fn=jax_make_eval_fn(jeng, batch=jscn.eval_batch))
    scn = registry.get_scenario(name)
    sink = str(d / "live.jsonl")
    rec, tr = TelemetryRecorder(sink=sink), SpanTracer()
    eng, hist = run.run(scn, "cpu", init_params=init, telemetry=rec,
                        tracer=tr)
    rec.close()
    off, off_hist = run.run(scn, "cpu", init_params=init)
    return {"name": name, "scn": scn, "jtr": jtr, "tr": tr, "eng": eng,
            "hist": hist, "off": off, "off_hist": off_hist, "sink": sink,
            "trace": tr.write(str(d / "port.trace.json")),
            "jtrace": jtr.write(str(d / "ref.trace.json"))}


def test_traced_run_is_golden_and_bit_equal_to_untraced(live):
    assert run.compare(live["scn"], live["hist"]) == []
    on, off = _state_bits(live["eng"]), _state_bits(live["off"])
    assert on.keys() == off.keys()
    for k, v in on.items():
        assert torch.equal(v, off[k]), k
    assert run.arrival_rows(live["hist"]) == \
        run.arrival_rows(live["off_hist"])
    assert live["hist"].evals == live["off_hist"].evals


def test_span_multiset_equals_the_references(live):
    got = _span_multiset(live["tr"].to_chrome())
    assert got == _span_multiset(live["jtr"].to_chrome())
    names = {n for n, _c, _a in got}
    assert {"worker_round", "compress_roundtrip", "eval"} <= names
    assert ("server_commit_batch" in names) == (live["name"] ==
                                                "hogwild_rampup")


def test_the_stream_renders_the_same_in_both_packages(live):
    """The port's stream: the console's text byte-equal and the panels
    equal in the two packages, and every panel the run feeds non-empty."""
    _check_same_render(live["sink"])
    p = web.snapshot_panels(live["sink"])
    for panel in ("meta", "arrivals", "staleness", "quality",
                  "per_language", "workers"):
        assert p[panel], panel
    if live["name"] == "hogwild_rampup":
        assert p["flush"]["flushes"] >= 1


def _check_same_render(stream):
    lines = read_complete_lines(stream)
    ours, theirs = ConsoleState(), jconsole.ConsoleState()
    for ln in lines:
        ours.add_line(ln)
        theirs.add_line(ln)
    text = render(ours, width=78, color=False)
    assert text == jconsole.render(theirs, width=78, color=False)
    assert web.snapshot_panels(stream) == jweb.snapshot_panels(stream)
    return text


def test_the_committed_stream_renders_the_same_in_both_packages():
    assert "transport (per worker process)" in _check_same_render(
        GOLDEN_STREAM)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_validator_accepts_the_others_trace(live, writer):
    path = live["trace"] if writer == "port" else live["jtrace"]
    with open(path) as f:
        doc = json.load(f)
    assert validate_chrome_trace(doc) == []
    assert jspans.validate_chrome_trace(doc) == []


@pytest.mark.parametrize("name", ["paper_hetero_severe", "fedbuff"])
def test_verify_obs_passes(name):
    res = trace.verify(registry.get_scenario(name), device="cpu", obs=True)
    assert res.ok, res.report()
    assert res.name.endswith("[obs]") and res.details["trace_events"] > 0


def test_launcher_trace_validates_with_the_cli(tmp_path, capsys):
    path, stream = tmp_path / "t.json", tmp_path / "t.jsonl"
    hist = train.main(["--scenario", "paper_hetero_severe", "--device",
                       "cpu", "--trace", str(path), "--telemetry",
                       str(stream)])
    assert "trace -> " in capsys.readouterr().out
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs", "trace",
                          str(path), "--validate"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "trace OK" in out.stdout and "worker_round" in out.stdout
    doc = json.loads(path.read_text())
    commits = [e for e in doc["traceEvents"] if e["name"] == "server_commit"]
    assert len(commits) == len(hist.arrivals) == 12


def test_threaded_runtime_traces_rounds_and_transport():
    """The deterministic threaded runtime with a tracer: the sim twin's
    bits, worker rounds and each result's send and ack wait on the worker
    threads' rows, commits on the server's."""
    scn = registry.get_scenario("wallclock_hetero")
    init = bridge.to_numpy(scn.build(device="cpu").server.state.params)
    tr = SpanTracer()
    eng, _hist = run.run(scn, "cpu", init_params=init, tracer=tr)
    twin = _twin(scn).build(device="cpu", init_params=init)
    twin.run()
    assert trace.param_digest(eng.server.state.params) == \
        trace.param_digest(twin.server.state.params)
    doc = tr.to_chrome()
    assert validate_chrome_trace(doc) == []
    threads = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
               if e["name"] == "thread_name"}
    rows = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            rows.setdefault(e["name"], set()).add(threads[e["tid"]])
    for name in ("worker_round", "transport.send", "transport.ack_wait"):
        assert rows[name] and all(t.startswith("heloco-worker-")
                                  for t in rows[name]), (name, rows[name])
    assert rows["server_commit"] == {"MainThread"}


# ---------------------------------------------------------------------------
# Cross-process collection, without processes
# ---------------------------------------------------------------------------

def _payload(**kw):
    p = {"wid": 2, "pid": 4242, "final": False, "offset": 0.01,
         "metrics": {"frames_sent": 3, "frames_recv": 4, "bytes_sent": 10,
                     "bytes_recv": 20, "ser_s": 0.5, "deser_s": 0.25,
                     "crc_rejects": 0, "credit_wait_s": 0.0, "retries": 1,
                     "rounds": 2, "compute_s": 1.5},
         "epoch_offset": 0.0,
         "spans": {"events": [["worker_round", "compute", "X", 0.1, 0.2, 9,
                               {"wid": 2, "s_i": 0, "h": 2}]],
                   "names": {9: "MainThread"}}}
    p.update(kw)
    return p


@pytest.fixture(scope="module")
def runtime_obs():
    """A threaded runtime, never run, with a tracer and a recorder."""
    rec, tr = TelemetryRecorder(), SpanTracer()
    eng = registry.get_scenario("wallclock_hetero").build(
        device="cpu", telemetry=rec, tracer=tr)
    yield eng, rec, tr
    eng.shutdown()


def test_on_obs_merges_a_child_frame(runtime_obs):
    eng, rec, tr = runtime_obs
    eng._on_obs(_payload(epoch_offset=tr._epoch))
    eng._on_obs(_payload(final=True, spans=None,
                         metrics=dict(_payload()["metrics"], rounds=5)))
    assert tr.pids == [0, 4242]
    row = tr._foreign[4242]
    assert row["name"] == "heloco-worker-2 (pid 4242)"
    assert [e[0] for e in row["events"]] == ["worker_round"]
    tps = [r for r in rec.records if isinstance(r, schema.TransportMetrics)]
    assert [(t.wid, t.pid, t.rounds, t.final) for t in tps] == \
        [(2, 4242, 2, False), (2, 4242, 5, True)]
    assert tps[0].frames_sent == 3 and tps[0].clock_offset_s == 0.01
    # latest cumulative snapshot per (wid, pid); off the socket transport
    # the report is empty
    assert eng._child_wire[(2, 4242)]["rounds"] == 5
    assert eng.child_obs_report() == {"reports": {}, "final": [], "wire": {}}
    eng.assert_child_reports()          # no pool: nothing to hold


@pytest.mark.parametrize("bad", [None, {}, {"pid": 3}, {"wid": 1},
                                 {"wid": "x", "pid": 3},
                                 {"wid": 1, "pid": None}])
def test_on_obs_drops_a_malformed_frame(runtime_obs, bad):
    eng, rec, tr = runtime_obs
    before = (len(rec.records), len(tr), dict(eng._child_wire))
    eng._on_obs(bad)
    assert (len(rec.records), len(tr), dict(eng._child_wire)) == before


def test_pool_counts_obs_frames_and_calls_its_hook():
    pool = WorkerProcessPool(registry.get_scenario("socket_hetero")
                             .materialize().run_cfg, device="cpu", obs=True,
                             obs_every=3)
    try:
        got = []
        pool.on_obs = got.append

        class Conn:
            wid, incarnation = 1, 1
        pool._on_control(Conn, "obs", {"wid": 1, "final": False})
        pool._on_control(Conn, "obs", {"final": True})   # wid of the conn
        pool._on_control(Conn, "obs", "not a dict")
        assert pool.obs_reports == {1: 2} and pool.obs_final == {1}
        assert len(got) == 2 and not pool.child_counters
        assert (pool.obs, pool.obs_every) == (True, 3)
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# The proc lane: worker processes with the whole observability stack
# ---------------------------------------------------------------------------

@pytest.mark.proc
def test_socket_hetero_with_the_full_obs_stack(tmp_path):
    """``socket_hetero`` over 4 processes with a live stream, runtime
    records and a tracer: the golden's arrivals and the sim twin's bits, a
    process row of child spans per worker with their sends and ack waits,
    re-based child times never negative, a final obs report from every
    worker and a transport record per child pid in the stream."""
    scn = registry.get_scenario("socket_hetero")
    init = bridge.to_numpy(scn.build(device="cpu").server.state.params)
    sink = str(tmp_path / "live.jsonl")
    rec, tr = TelemetryRecorder(sink=sink), SpanTracer()
    eng = scn.build(device="cpu", init_params=init, telemetry=rec,
                    tracer=tr, runtime_record_every=2)
    hist = eng.run(eval_every=scn.eval_cadence,
                   eval_fn=make_eval_fn(eng, batch=scn.eval_batch))
    eng.assert_child_reports()
    rec.close()
    assert run.compare(scn, hist) == []
    twin = _twin(scn).build(device="cpu", init_params=init)
    twin.run()
    assert trace.param_digest(eng.server.state.params) == \
        trace.param_digest(twin.server.state.params)
    doc = tr.to_chrome()
    assert validate_chrome_trace(doc) == []
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    rows = {e["args"]["name"] for e in doc["traceEvents"]
            if e["name"] == "process_name" and e["pid"]}
    assert rows == {f"heloco-worker-{w} (pid {p})"
                    for w, p in eng._child_wire}
    assert sorted(w for w, _p in eng._child_wire) == [0, 1, 2, 3]
    child = {e["name"] for e in xs if e["pid"]}
    assert {"worker_round", "transport.send", "transport.ack_wait"} <= child
    assert all(e["ts"] >= 0 for e in xs)
    assert any(e["name"] == "server_commit" for e in xs if not e["pid"])
    report = eng.stats_summary()["child_obs"]
    assert report["final"] == [0, 1, 2, 3]
    assert report["wire"]["rounds"] == eng.stats_summary()["rounds"]
    dec = StreamDecoder(strict=True)
    tps = [r for r in map(dec.decode, read_complete_lines(sink))
           if isinstance(r, schema.TransportMetrics)]
    assert {t.pid for t in tps} == {p for _w, p in eng._child_wire}
    assert sum(t.final for t in tps) == 4
