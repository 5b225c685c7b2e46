"""The port's scenario layer against the reference's registry and the
committed golden traces.

  * every registered scenario's ``to_dict()`` equals the reference
    registry's and its golden's ``scenario`` dict, and ``from_dict`` of
    that dict rebuilds it;
  * the seven sim goldens the port runs (the five method baselines,
    ``drop_stale`` and ``flexible_shards``; ``paper_hetero_severe`` is
    tests/test_torch_engine.py's) are reproduced exactly: arrivals,
    ``tokens``, ``comm_bytes``, ``final_time``;
  * a scenario with an axis the port lacks raises before it runs;
  * ``delayed_nesterov`` and ``fedbuff`` against a live reference run from
    the same bits, with the bands of tests/test_torch_methods.py (evals
    1e-4 absolute, final parameters 5e-4 of each leaf's largest |value|);
    in the slow lane ``delayed_nesterov`` also at full width (evals 1e-3).
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
from test_torch_methods import _live, check_live
from test_torch_server import _flat

PORTED = ("delayed_nesterov", "fedbuff", "dcasgd", "poly_stale",
          "sync_baseline", "drop_stale", "flexible_shards")
UNPORTED = ("noniid_dirichlet", "crash_rejoin", "elastic_membership",
            "int8_dylu", "wallclock_hetero", "chaos_lossy", "gossip_ring",
            "socket_hetero", "hogwild_rampup", "trace_paced",
            "chaos_partition")


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
    assert (not scn.unported_axes()) == (name in PORTED + (
        "paper_hetero_severe",))


@pytest.mark.parametrize("name", PORTED)
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


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_axis_raises_before_running(name, monkeypatch):
    def never(*a, **k):
        raise AssertionError("an engine was built")
    monkeypatch.setattr(engine_lib, "make_engine", never)
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        registry.get_scenario(name).build(device="cpu")


def test_engine_refuses_an_unported_run_config():
    cfg = registry.get_scenario("drop_stale").overridden(
        mixture_alpha=0.3).run_config()
    with pytest.raises(NotImplementedError, match="mixture_alpha"):
        engine_lib.make_engine(cfg, device="cpu")


@pytest.mark.parametrize("name", ["delayed_nesterov", "fedbuff"])
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
