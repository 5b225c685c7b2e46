"""The port's scenario layer against the reference's registry and the
committed golden traces.

  * every registered scenario's ``to_dict()`` equals the reference
    registry's and its golden's ``scenario`` dict, and ``from_dict`` of
    that dict rebuilds it;
  * seven of the fifteen sim goldens the port runs (``PORTED``; the other
    eight, and the live runs of int8 compression, are
    tests/test_torch_goldens.py's, split so that each file takes about half
    the time; ``paper_hetero_severe`` is tests/test_torch_engine.py's) are
    reproduced exactly: arrivals, ``tokens``, ``comm_bytes``,
    ``final_time``;
  * every registered scenario runs on the port, the wall-clock ones
    (tests/test_torch_wallclock.py) and ``socket_hetero`` on worker
    processes (tests/test_torch_proc.py) too; the refusal of an axis the
    port lacks, held with a test-only axis, raises before anything runs,
    and ``socket_hetero`` builds into a socket runtime that starts no
    process before its first round;
  * ``fedbuff``, ``crash_rejoin``, ``poly_stale``, ``drop_stale`` and
    ``elastic_membership`` against a live reference
    run from the same bits, with the bands of tests/test_torch_methods.py
    (evals 1e-4 absolute, final parameters 5e-4 of each leaf's largest
    |value|); in the slow lane ``delayed_nesterov`` also at full width
    (evals 1e-3).
"""
import json

import pytest

from repro.async_engine.engine import make_engine as jax_make_engine
from repro.async_engine.engine import make_eval_fn as jax_make_eval_fn
from repro.scenarios import registry as jregistry
from repro_torch.async_engine import engine as engine_lib
from repro_torch.async_engine.engine import make_eval_fn
from repro_torch.launch import train
from repro_torch.scenarios import registry, run
from repro_torch.scenarios.spec import Scenario
from test_torch_methods import _live, check_live, one_intra_op_thread  # noqa: F401
from test_torch_server import _flat

PORTED = ("delayed_nesterov", "fedbuff", "dcasgd", "poly_stale",
          "sync_baseline", "drop_stale", "flexible_shards",
          "noniid_dirichlet", "crash_rejoin", "elastic_membership",
          "int8_dylu", "hogwild_rampup", "trace_paced", "gossip_ring",
          "gossip_random")
# the registered wall-clock scenarios the port runs (all of them)
WALLCLOCK = ("wallclock_hetero", "delayed_nesterov_wallclock",
             "fedbuff_wallclock", "dcasgd_wallclock", "wallclock_free",
             "chaos_lossy", "chaos_corrupt", "chaos_partition",
             "socket_hetero")
# an axis the port refuses, for the refusal machinery's test only: the
# scenario's n_workers set away from a "default" no scenario has
TEST_AXIS = ("n_workers", 0, "A99")


def test_registry_names_match_reference():
    assert registry.names() == jregistry.names()
    assert len(registry.names()) == 25


@pytest.mark.parametrize("name", jregistry.names())
def test_scenario_dict_equals_reference_and_golden(name):
    scn = registry.get_scenario(name)
    d = json.loads(json.dumps(scn.to_dict()))
    assert d == json.loads(json.dumps(jregistry.get_scenario(name).to_dict()))
    assert d == run.load_golden(name)["scenario"]
    assert Scenario.from_dict(d) == scn
    assert scn.eval_cadence == jregistry.get_scenario(name).eval_cadence
    assert (not scn.unported_axes()) == (name in PORTED + WALLCLOCK + (
        "paper_hetero_severe",))


# the other golden cases are tests/test_torch_goldens.py's
@pytest.mark.parametrize("name", PORTED[:7])
def test_port_reproduces_golden_exactly(name):
    scn = registry.get_scenario(name)
    _eng, hist = run.run(scn, "cpu")
    assert run.compare(scn, hist) == []
    golden = run.load_golden(name)
    assert (hist.tokens, hist.comm_bytes, hist.final_time) == \
        (golden["tokens"], golden["comm_bytes"], golden["final_time"])
    assert len(hist.evals) == len(golden["evals"])


def test_compare_reports_a_tampered_golden():
    scn = registry.get_scenario("sync_baseline")
    _eng, hist = run.run(scn, "cpu")
    golden = run.load_golden("sync_baseline")
    golden["arrivals"][2][6] += 1.0
    golden["tokens"] += 1
    bad = run.compare(scn, hist, golden)
    assert len(bad) == 2 and "arrival 2" in bad[0] and "tokens" in bad[1]
    # another batch: the tokens are no longer the golden's to hold
    wider = scn.overridden(batch_size=3)
    assert run.compare(wider, hist, run.load_golden("sync_baseline")) == []


def test_cli_verify_and_launcher_run_a_scenario(capsys):
    assert run.main(["verify", "poly_stale", "--device", "cpu"]) == 0
    assert "PASS poly_stale" in capsys.readouterr().out
    hist = train.main(["--scenario", "sync_baseline", "--device", "cpu"])
    assert run.arrival_rows(hist) == run.load_golden("sync_baseline")[
        "arrivals"]


# the launcher's ad-hoc flags that rebuild a registered scenario's run
FLAG_RUNS = {
    "int8_dylu": "--workers 3 --paces 1,2,6 --outer 8 --inner 4 --dylu "
                 "--compression int8",
    "noniid_dirichlet": "--workers 5 --paces 1,1,2,6,6 --outer 12 --inner 2 "
                        "--mixture-alpha 0.3 --seed 1",
}


@pytest.mark.parametrize("name", sorted(FLAG_RUNS))
def test_launcher_flags_reproduce_the_golden(name):
    hist = train.main(["--smoke", "--batch", "2", "--seq", "16", "--device",
                       "cpu", *FLAG_RUNS[name].split()])
    golden = run.load_golden(name)
    assert run.arrival_rows(hist) == golden["arrivals"]
    assert (hist.tokens, hist.comm_bytes) == (golden["tokens"],
                                              golden["comm_bytes"])


@pytest.mark.parametrize("name", ["socket_hetero"])
def test_unported_axis_raises_before_running(name, monkeypatch):
    """Every axis runs now, so the refusal is held with a test-only one:
    ``Scenario.build`` raises naming its ROADMAP item before any engine is
    built, and so does ``run verify`` of the scenario."""
    def never(*a, **k):
        raise AssertionError("an engine was built")
    monkeypatch.setattr(engine_lib, "make_engine", never)
    monkeypatch.setattr(engine_lib, "UNPORTED_AXES", (TEST_AXIS,))
    scn = registry.get_scenario(name)
    assert scn.unported_axes() == ("n_workers=4 (ROADMAP A99)",)
    with pytest.raises(NotImplementedError, match="ROADMAP A99"):
        scn.build(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A99"):
        run.main(["verify", name, "--device", "cpu"])


def test_engine_refuses_an_unported_run_config():
    """``socket_hetero`` (worker processes, ``async_engine/proc.py``) builds
    through every entry point, ``Scenario.build``, ``make_engine`` with a
    Scenario and ``make_engine`` with its run config and the runtime's
    options, into a ``ConcurrentRuntime`` on the socket transport that has
    started no process before its first round (the wall-clock engine this
    test held until A13 runs too, tests/test_torch_wallclock.py; the
    topology axis it held until A14, tests/test_torch_topology.py)."""
    from repro_torch.async_engine.runtime import ConcurrentRuntime
    scn = registry.get_scenario("socket_hetero")
    m = scn.materialize()
    engines = [scn.build(device="cpu"),
               engine_lib.make_engine(scn, device="cpu"),
               engine_lib.make_engine(m.run_cfg, "wallclock", device="cpu",
                                      **m.engine_kw)]
    try:
        for eng in engines:
            assert isinstance(eng, ConcurrentRuntime)
            assert eng.transport_kind == "socket"
            assert eng.transport is eng._pool.transport
            assert not eng._pool._procs and not eng._pool._conns
    finally:
        for eng in engines:
            eng.shutdown()
    assert all(eng._pool._closing for eng in engines)


# delayed_nesterov's, noniid_dirichlet's and flexible_shards' live runs
# are tests/test_torch_goldens.py's
@pytest.mark.parametrize("name", ["fedbuff", "crash_rejoin", "poly_stale",
                                  "drop_stale", "elastic_membership"])
def test_live_reference_run_from_the_same_bits(name):
    check_live(*_live(name))


@pytest.mark.slow
def test_full_width_delayed_nesterov_within_band_of_live_reference():
    """``delayed_nesterov`` at tinygpt-15m's full width (bf16 compute, batch
    4 x 128, as ``chip_smoke.py`` runs it) from the reference's initial
    parameters: arrivals equal and evals within 1e-3 of the live reference,
    the band of tests/test_torch_engine.py's full-width test (measured:
    1.1e-4; ~60 s on the CPU, so the slow lane)."""
    jeng = jax_make_engine(jregistry.get_scenario(
        "delayed_nesterov").overridden(**train.FULL_WIDTH))
    eng = registry.get_scenario("delayed_nesterov").overridden(
        **train.FULL_WIDTH).build(device="cpu",
                                  init_params=_flat(jeng.server.state.params))
    hist = eng.run(eval_every=3, eval_fn=make_eval_fn(eng, batch=8))
    jhist = jeng.run(eval_every=3, eval_fn=jax_make_eval_fn(jeng, batch=8))
    assert run.arrival_rows(hist) == run.arrival_rows(jhist)
    for got, want in zip(hist.evals, jhist.evals):
        assert abs(got["mean"] - want["mean"]) < 1e-3, (got, want)
