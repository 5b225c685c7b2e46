"""The port's scenario layer against the reference's registry and the
committed golden traces.

  * every registered scenario's ``to_dict()`` equals the reference
    registry's and its golden's ``scenario`` dict, and ``from_dict`` of
    that dict rebuilds it;
  * the fifteen sim goldens the port runs (the five method baselines,
    ``drop_stale``, ``flexible_shards``, ``noniid_dirichlet``,
    ``crash_rejoin``, ``elastic_membership``, ``int8_dylu``, the batched
    ``hogwild_rampup`` and ``trace_paced``, and the ``gossip_ring`` and
    ``gossip_random`` topologies; ``paper_hetero_severe`` is
    tests/test_torch_engine.py's) are reproduced exactly: arrivals,
    ``tokens``, ``comm_bytes``, ``final_time``;
  * a scenario with an axis the port lacks raises before it runs;
  * ``delayed_nesterov``, ``fedbuff``, ``crash_rejoin``, ``poly_stale``,
    ``drop_stale``, ``noniid_dirichlet``, ``elastic_membership``,
    ``flexible_shards`` and ``sync_baseline`` with int8 compression against
    a live reference run from the same bits, with the bands of tests/test_torch_methods.py (evals
    1e-4 absolute, final parameters 5e-4 of each leaf's largest |value|),
    and ``int8_dylu`` likewise but for at most two parameters that may
    sit one int8 quantization step off (a .5 tie rounded the other way);
    in the slow lane ``delayed_nesterov`` also at full width (evals 1e-3).
"""
import json

import pytest
import torch

from repro.async_engine.engine import make_engine as jax_make_engine
from repro.async_engine.engine import make_eval_fn as jax_make_eval_fn
from repro.scenarios import registry as jregistry
from repro_torch.async_engine import engine as engine_lib
from repro_torch.async_engine.engine import make_eval_fn
from repro_torch.core import compression, packing
from repro_torch.launch import train
from repro_torch.scenarios import registry, run
from repro_torch.scenarios.spec import Scenario
from test_torch_methods import _live, check_live
from test_torch_server import _flat

PORTED = ("delayed_nesterov", "fedbuff", "dcasgd", "poly_stale",
          "sync_baseline", "drop_stale", "flexible_shards",
          "noniid_dirichlet", "crash_rejoin", "elastic_membership",
          "int8_dylu", "hogwild_rampup", "trace_paced", "gossip_ring",
          "gossip_random")
UNPORTED = ("wallclock_hetero", "chaos_lossy", "socket_hetero",
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


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_axis_raises_before_running(name, monkeypatch):
    def never(*a, **k):
        raise AssertionError("an engine was built")
    monkeypatch.setattr(engine_lib, "make_engine", never)
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        registry.get_scenario(name).build(device="cpu")


def test_engine_refuses_an_unported_run_config():
    """The wall-clock engine (ROADMAP A13) is refused through both entry
    points, ``Scenario.build`` and ``make_engine``, before any engine is
    built (the topology axis this test held until A14 runs now,
    tests/test_torch_topology.py)."""
    scn = registry.get_scenario("drop_stale").overridden(engine="wallclock")
    with pytest.raises(NotImplementedError, match="engine.*A13"):
        scn.build(device="cpu")
    with pytest.raises(NotImplementedError, match="engine.*A13"):
        engine_lib.make_engine(scn, device="cpu")


@pytest.mark.parametrize("name", ["delayed_nesterov", "fedbuff",
                                  "crash_rejoin", "poly_stale", "drop_stale",
                                  "noniid_dirichlet", "elastic_membership",
                                  "flexible_shards"])
def test_live_reference_run_from_the_same_bits(name):
    check_live(*_live(name))


def test_live_int8_dylu_from_the_same_bits(monkeypatch):
    """``int8_dylu`` against a live reference run from the same bits:
    arrivals equal, evals within 1e-4 (measured: 3.2e-6) and final
    parameters within 5e-4 of each leaf's largest |value|, but for at most
    two elements that may instead be off by one int8 quantization step of
    their block. The inner rounds of the two packages drift apart in the
    last bits, and an element within that drift of a .5 tie rounds the
    other way (measured on the CPU: 1 of 124,032 parameters,
    layer_00/norm1/bias[17], off by 1.8e-5, 0.44 of its block's step of
    4.17e-5, after its last round's target sat at 70.4997 steps in the
    reference and 70.5105 in the port). The compression's arithmetic is
    held bit for bit by tests/test_torch_compression.py."""
    scales = []

    def recording(buf, layout):
        scales.append(block_scales(buf, layout))
        return scales[-1]

    block_scales = compression.block_scales
    monkeypatch.setattr(compression, "block_scales", recording)
    jeng, jhist, eng, hist = _live("int8_dylu")
    layout = eng.server.layout
    assert len(scales) == len(hist.arrivals) == 8
    row_block = torch.from_numpy(layout.row_block).long()
    step = torch.stack(scales).amax(0)[row_block]
    steps = packing.unpack(layout, step[:, None].expand(-1, 128).contiguous())
    check_live(jeng, jhist, eng, hist,
               int8_steps={k: v.numpy() for k, v in steps.items()},
               max_flips=2)


def test_live_int8_sync_rounds_average_packed_deltas():
    """``sync_baseline`` with int8 compression: every barrier round averages
    the workers' packed (``Packed``) pseudo-gradients."""
    check_live(*_live("sync_baseline", compression="int8"))


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
