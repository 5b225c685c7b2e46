"""The port's wall-clock runtime (``async_engine/runtime.py``) at smoke width
on the CPU.

  * the deterministic wall-clock goldens (``wallclock_hetero`` and the three
    method twins), the two chaos twins, and the sim goldens of the barrier
    rounds, crash/rejoin, elastic membership and int8 + DyLU replayed on the
    runtime: arrivals, ``tokens``, ``comm_bytes`` and ``final_time`` equal
    to the golden's, and the final parameters' digest bit-equal to the
    port's own sim run of the same config from the same initial bits;
  * the chaos twins with ``wallclock_hetero``'s digest and non-zero fault
    counters, ``fault`` telemetry records of the rejects;
  * a leave and rejoin of one wid, and a checkpoint taken on the runtime
    and resumed on both engines;
  * one live reference ``wallclock_hetero`` run from bridged bits;
  * in the ``wallclock`` lane (threaded runs that sleep on the wall clock):
    the free-running goldens inside ``trace.FREE_BANDS``, quarantine in
    free mode, a healthy heartbeat channel, and liveness death and revival
    under a partition.
"""
import functools
import math

import numpy as np
import pytest

from repro_torch import bridge
from repro_torch.async_engine.engine import make_engine, make_eval_fn
from repro_torch.async_engine.faults import FaultSpec, PartitionSpec
from repro_torch.async_engine.runtime import ConcurrentRuntime
from repro_torch.checkpoint import ckpt
from repro_torch.core import methods
from repro_torch.scenarios import registry, run, trace
from repro_torch.scenarios.spec import ElasticSpec
from repro_torch.telemetry import TelemetryRecorder
from test_torch_methods import _live, check_live, one_intra_op_thread  # noqa: F401

WALL = {"engine": "wallclock"}

# (scenario, overrides): the runtime's run must reproduce the golden of
# ``scenario`` and the simulator's bits
EXACT = (("wallclock_hetero", {}), ("delayed_nesterov_wallclock", {}),
         ("fedbuff_wallclock", {}), ("dcasgd_wallclock", {}),
         ("chaos_lossy", {}), ("chaos_corrupt", {}),
         ("sync_baseline", WALL), ("crash_rejoin", WALL),
         ("elastic_membership", WALL), ("int8_dylu", WALL))


@functools.cache
def _init():
    """One set of initial parameters every run here starts from."""
    eng = registry.get_scenario("wallclock_hetero").build(device="cpu")
    return bridge.to_numpy(eng.server.state.params)


def _twin(scn):
    """The fault-free sim scenario with ``scn``'s run config."""
    return scn.overridden(engine="sim", mode="deterministic", faults=None,
                          transport="inproc")


@functools.cache
def _trace(scn):
    return trace.run_trace(scn, "cpu", init_params=_init())


def _scn(name, overrides):
    return registry.get_scenario(name).overridden(**overrides)


@pytest.mark.parametrize("name, overrides", EXACT,
                         ids=[n for n, _ in EXACT])
def test_runtime_reproduces_golden_and_sim_bits(name, overrides):
    scn = _scn(name, overrides)
    got = _trace(scn)
    fails = []
    trace._cmp_counts(fails, got, run.load_golden(name))
    assert fails == []
    assert got["param_digest"] == _trace(_twin(scn))["param_digest"]
    s = got["stats"]
    assert s["rounds"] >= len(got["arrivals"])
    if not methods.get(scn.method).sync:        # barrier rounds: no _commit
        assert s["arrivals"] == len(got["arrivals"]) and s["overlap_max"] >= 1
    assert all(math.isfinite(e["mean"]) for e in got["evals"])


@pytest.mark.parametrize("name, counters", [
    ("chaos_lossy", ("injected_drops", "injected_reorders", "retries")),
    ("chaos_corrupt", ("injected_corruptions", "checksum_rejects",
                       "retries"))])
def test_chaos_twin_commits_wallclock_heteros_bits(name, counters):
    got = _trace(registry.get_scenario(name))
    want = _trace(registry.get_scenario("wallclock_hetero"))
    assert got["param_digest"] == want["param_digest"]
    assert got["arrivals"] == want["arrivals"]
    d = got["stats"]["delivery"]
    assert all(d[k] > 0 for k in counters), d
    assert not any(want["stats"]["delivery"].values())


def test_chaos_rejects_reach_the_telemetry_stream():
    rec = TelemetryRecorder()
    eng = registry.get_scenario("chaos_corrupt").build(
        device="cpu", init_params=_init(), telemetry=rec)
    eng.run()
    events = [f.event for f in rec.faults()]
    d = eng.delivery_stats()
    assert events.count("checksum_reject") == d["checksum_rejects"] > 0
    # the summary is the counters when the run finalized; the rounds still
    # in flight then go on sending until the shutdown
    summary = rec.faults()[-1]
    assert summary.event == "summary" and set(summary.detail) == set(d)
    assert all(v <= d[k] for k, v in summary.detail.items())


def test_leave_then_rejoin_of_one_wid_drops_the_orphan_round():
    """A departed worker's round in flight never commits as the rejoined
    incarnation's: task ids are engine-unique."""
    scn = registry.get_scenario("wallclock_hetero").overridden(elastic=(
        ElasticSpec(time=2.0, action="leave", wid=2),
        ElasticSpec(time=8.0, action="join", wid=2, pace=1.0, lang=2)))
    got, want = _trace(scn), _trace(_twin(scn))
    assert got["arrivals"] == want["arrivals"]
    assert got["param_digest"] == want["param_digest"]
    assert any(a[1] == 2 and a[6] > 8.0 for a in got["arrivals"])


def test_checkpoint_on_the_runtime_resumes_on_both_engines(tmp_path):
    scn = registry.get_scenario("wallclock_hetero").overridden(
        outer_steps=6)
    rt = scn.build(device="cpu", init_params=_init())
    rt.run(ckpt_every=3, ckpt_dir=str(tmp_path))
    path = str(tmp_path / "step_6.npz")
    assert ckpt.latest(str(tmp_path)) == path
    longer = scn.overridden(outer_steps=9)
    docs = []
    for s in (longer, _twin(longer)):
        eng = s.build(device="cpu", init_params=_init())
        eng.restore(path)
        assert eng.server.t == 6 and eng.restored_arrivals == 6
        assert trace.param_digest(eng.server.state.params) == \
            trace.param_digest(rt.server.state.params)
        hist = eng.run()
        assert eng.server.t == 9
        docs.append((run.arrival_rows(hist),
                     trace.param_digest(eng.server.state.params)))
    assert docs[0] == docs[1]


def test_worker_error_and_unported_options_raise():
    rc = registry.get_scenario("wallclock_hetero").run_config()
    eng = make_engine(rc, "wallclock", device="cpu")

    def boom(task):
        raise ValueError("inner round failed")
    eng._execute = boom
    with pytest.raises(RuntimeError, match="inner round failed"):
        eng.run()
    assert not eng._threads                      # torn down anyway
    sock = ConcurrentRuntime(rc, device="cpu", transport="socket")
    try:
        assert sock.transport_kind == "socket" and not sock._pool._procs
    finally:
        sock.shutdown()
    with pytest.raises(ValueError, match="transport must be"):
        ConcurrentRuntime(rc, device="cpu", transport="tcp")
    with pytest.raises(ValueError, match="free"):
        ConcurrentRuntime(rc, device="cpu", faults=FaultSpec(
            partitions=(PartitionSpec(0.0, 1.0),)))
    with pytest.raises(TypeError):
        make_engine(rc, "sim", device="cpu", mode="free")


def test_launcher_chaos_flags_reproduce_the_golden(tmp_path):
    """``--engine wallclock --chaos`` on ad-hoc flags that rebuild
    ``wallclock_hetero``: its golden's arrivals, and the runtime's summary
    with injected faults in ``--stats-json``."""
    import json
    from repro_torch.launch import train
    stats = tmp_path / "s.json"
    hist = train.main(("--smoke --engine wallclock --chaos --workers 4 "
                       "--paces 1,2,6,15 --outer 10 --inner 2 --batch 2 "
                       f"--seq 16 --device cpu --stats-json {stats}").split())
    assert run.arrival_rows(hist) == \
        run.load_golden("wallclock_hetero")["arrivals"]
    summary = json.loads(stats.read_text())
    assert summary["mode"] == "deterministic" and summary["arrivals"] == 10
    assert sum(v for k, v in summary["delivery"].items()
               if k.startswith("injected_")) > 0


def test_live_reference_wallclock_hetero_from_the_same_bits():
    """The reference's threaded runtime and the port's, both in
    deterministic mode: the bands of tests/test_torch_methods.py."""
    check_live(*_live("wallclock_hetero"))


# ---------------------------------------------------------------------------
# Free-running runs: the wall clock decides the arrival order
# ---------------------------------------------------------------------------

def _tiny(**kw):
    base = dict(n_workers=3, outer_steps=8, inner_steps=1,
                worker_paces=(1.0, 1.0, 2.0), mode="free", pace_scale=0.02)
    base.update(kw)
    return registry.get_scenario("wallclock_free").overridden(**base)


@pytest.mark.wallclock
@pytest.mark.parametrize("name", ["wallclock_free", "chaos_partition"])
def test_free_running_golden_within_bands(name):
    res = trace.verify(registry.get_scenario(name), device="cpu")
    assert res.ok, res.report()
    s = res.details["stats"]
    assert s["arrivals"] == 10 and s["overlap_max"] >= 1
    if name == "chaos_partition":
        assert s["delivery"]["liveness_deaths"] >= 1
        assert s["delivery"]["partition_drops"] > 0


@pytest.mark.wallclock
def test_free_mode_quarantine_degrades_gracefully():
    # short resends: three corrupt frames land well inside the run
    scn = _tiny(faults=FaultSpec(corrupt_p=1.0, corrupt_wids=(1,),
                                 quarantine_after=3, seed=5,
                                 ack_timeout=0.01, max_backoff=0.02))
    eng = scn.build(device="cpu", init_params=_init())
    hist = eng.run()
    assert len(hist.arrivals) == 8
    assert all(a["worker_id"] != 1 for a in hist.arrivals)
    d = eng.delivery_stats()
    assert d["quarantines"] == 1 and d["checksum_rejects"] >= 3, d


@pytest.mark.wallclock
def test_healthy_heartbeats_kill_nobody():
    scn = _tiny(outer_steps=6, faults=FaultSpec(
        seed=1, heartbeat_interval=0.05, liveness_misses=50))
    eng = scn.build(device="cpu", init_params=_init())
    assert len(eng.run().arrivals) == 6
    assert eng.delivery_stats()["liveness_deaths"] == 0


@pytest.mark.wallclock
def test_partition_liveness_death_and_revival():
    scn = _tiny(outer_steps=14, worker_paces=(1.0, 1.0, 1.0), pace_scale=0.2,
                faults=FaultSpec(
                    seed=13, heartbeat_interval=0.05, liveness_misses=2,
                    ack_timeout=0.1, max_backoff=0.2,
                    partitions=(PartitionSpec(0.5, 4.0, wids=(2,)),)))
    eng = scn.build(device="cpu", init_params=_init())
    hist = eng.run(eval_every=7, eval_fn=make_eval_fn(eng, batch=2))
    assert len(hist.arrivals) == 14
    d = eng.delivery_stats()
    assert d["liveness_deaths"] >= 1 and d["heartbeat_misses"] >= 2, d
    assert d["liveness_revivals"] >= 1, d
    assert any(a["worker_id"] == 2 and a["sim_time"] > 4.0
               for a in hist.arrivals)
    assert all(np.isfinite(e["mean"]) for e in hist.evals)


@pytest.mark.wallclock
def test_free_running_crash_rejoin_and_elastic_join():
    from repro_torch.scenarios.spec import FailureSpec
    scn = _tiny(outer_steps=10,
                failures=(FailureSpec(time=0.5, wid=0, restart_delay=1.0),),
                elastic=(ElasticSpec(time=1.0, action="join", wid=5,
                                     pace=1.0, lang=1),))
    eng = scn.build(device="cpu", init_params=_init())
    hist = eng.run()
    assert len(hist.arrivals) == 10
    assert 5 in {a["worker_id"] for a in hist.arrivals}
