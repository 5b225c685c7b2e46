"""The port's sim engine on the ``paper_hetero_severe`` scenario (reduced
tinygpt, 4 workers at paces 1/2/6/15, H=2, 12 arrivals, HeLoCo), started
from the reference engine's initial parameters through the bridge.

The arrival sequence depends only on paces, H and the schedule: it must
equal the committed golden's and a live reference run's exactly. The
golden's evals and parameter digest are not a target (the reference's own
initial draw has drifted with the installed JAX; see ROADMAP queue C), so
evals and final parameters are held to the live run from the same bits:
every eval loss within 1e-4 absolute (measured: 3.6e-7) and the final
parameters within 5e-4 of each leaf's largest |value| (measured: 3.3e-5),
the drift of 24 AdamW steps and 12 outer steps in another summation order.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.async_engine.engine import make_engine as jax_make_engine
from repro.async_engine.engine import make_eval_fn as jax_make_eval_fn
from repro.scenarios import registry
from repro_torch.async_engine.engine import make_engine, make_eval_fn
from repro_torch.configs import get_config
from repro_torch.configs.base import (
    HeLoCoConfig, InnerOptConfig, OuterOptConfig, RunConfig,
)

ROOT = Path(__file__).resolve().parents[1]


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in leaves}


def _port_config(jcfg) -> RunConfig:
    """The reference RunConfig's fields the port reads."""
    o, i = jcfg.outer, jcfg.inner
    return RunConfig(
        model=get_config(jcfg.model.name),
        inner=InnerOptConfig(lr=i.lr, warmup_steps=i.warmup_steps,
                             total_steps=i.total_steps,
                             weight_decay=i.weight_decay, b1=i.b1, b2=i.b2,
                             eps=i.eps, grad_clip=i.grad_clip,
                             schedule=i.schedule),
        outer=OuterOptConfig(method=o.method, outer_lr=o.outer_lr,
                             momentum=o.momentum,
                             weight_factor=o.weight_factor,
                             lookahead_init=o.lookahead_init,
                             heloco=HeLoCoConfig(**o.heloco.__dict__),
                             drop_stale_after=o.drop_stale_after,
                             delay_weighting=o.delay_weighting),
        n_workers=jcfg.n_workers, inner_steps=jcfg.inner_steps,
        outer_steps=jcfg.outer_steps, batch_size=jcfg.batch_size,
        seq_len=jcfg.seq_len, seed=jcfg.seed,
        worker_paces=tuple(jcfg.worker_paces), non_iid=jcfg.non_iid,
        shard_assignment=jcfg.shard_assignment)


def _rows(hist):
    return [[a["outer_step"], a["worker_id"],
             a["outer_step"] - 1 - a["staleness"], a["staleness"], a["lang"],
             a["rho"], a["sim_time"], bool(a["dropped"])]
            for a in hist.arrivals]


@pytest.fixture(scope="module")
def runs():
    scn = registry.get_scenario("paper_hetero_severe")
    jeng = jax_make_engine(scn)
    init = _flat(jeng.server.state.params)
    eng = make_engine(_port_config(jeng.cfg), device="cpu", init_params=init)
    jhist = jeng.run(eval_every=scn.eval_cadence,
                     eval_fn=jax_make_eval_fn(jeng, batch=scn.eval_batch))
    hist = eng.run(eval_every=scn.eval_cadence,
                   eval_fn=make_eval_fn(eng, batch=scn.eval_batch))
    return jeng, jhist, eng, hist


def test_arrivals_equal_golden_and_live_reference(runs):
    jeng, jhist, eng, hist = runs
    golden = json.loads(
        (ROOT / "results/golden/paper_hetero_severe.json").read_text())
    rows = json.loads(json.dumps(_rows(hist)))
    assert len(rows) == 12
    assert rows == golden["arrivals"]
    assert rows == json.loads(json.dumps(_rows(jhist)))
    assert (hist.tokens, hist.comm_bytes, hist.final_time) == \
        (golden["tokens"], golden["comm_bytes"], golden["final_time"])


def test_evals_within_band_of_live_reference(runs):
    _jeng, jhist, _eng, hist = runs
    assert [e["step"] for e in hist.evals] == [e["step"] for e in jhist.evals]
    for got, want in zip(hist.evals, jhist.evals):
        assert got["time"] == want["time"]
        assert abs(got["mean"] - want["mean"]) < 1e-4, (got, want)
        for lang, loss in want["per_lang"].items():
            assert abs(got["per_lang"][lang] - loss) < 1e-4, (lang, got, want)


def test_final_params_within_band_of_live_reference(runs):
    jeng, _jhist, eng, _hist = runs
    want = _flat(jeng.server.state.params)
    got = eng.server.state.params
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0,
                                   atol=5e-4 * np.abs(v).max(), err_msg=k)


@pytest.mark.slow
def test_full_width_evals_within_band_of_live_reference():
    """The same schedule at tinygpt-15m's full width (bf16 compute, batch
    4 x 128, as ``chip_smoke.py`` runs it): evals within 1e-3 of the live
    reference (measured: 1.5e-4; ~100 s on 8 CPU cores, so the slow lane)."""
    scn = registry.get_scenario("paper_hetero_severe").overridden(
        smoke=False, batch_size=4, seq_len=128)
    jeng = jax_make_engine(scn)
    eng = make_engine(_port_config(jeng.cfg), device="cpu",
                      init_params=_flat(jeng.server.state.params))
    hist = eng.run(eval_every=3, eval_fn=make_eval_fn(eng, batch=8))
    jhist = jeng.run(eval_every=3, eval_fn=jax_make_eval_fn(jeng, batch=8))
    assert _rows(hist) == _rows(jhist)
    for got, want in zip(hist.evals, jhist.evals):
        assert abs(got["mean"] - want["mean"]) < 1e-3, (got, want)
