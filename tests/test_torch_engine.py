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
import torch

from repro.async_engine.engine import make_engine as jax_make_engine
from repro.async_engine.engine import make_eval_fn as jax_make_eval_fn
from repro.scenarios import registry
from repro_torch.async_engine.engine import make_engine, make_eval_fn
from repro_torch.configs import get_config
from repro_torch.configs.base import (
    HeLoCoConfig, InnerOptConfig, OuterOptConfig, RunConfig,
)
from test_torch_methods import one_intra_op_thread  # noqa: F401

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


# ---------------------------------------------------------------------------
# Crash/rejoin, elastic membership and DyLU: the event bookkeeping the
# reference's engine does (repro/async_engine/engine.py:_run_async,
# _handle_failure, _handle_elastic), on the reduced model on the CPU
# ---------------------------------------------------------------------------

def _port_scenario(name, **kw):
    from repro_torch.scenarios import registry as port_registry
    return port_registry.get_scenario(name).overridden(**kw)


def test_joining_worker_returns_from_the_previous_event_time():
    """A join due at t=3 is applied when the t=4 event pops, before the
    clock moves: the new worker is dispatched at the previous event's time
    (t=2), so its first return is at 2 + H * pace = 4, not 6. It starts
    from the current outer state with step count 0, and ``rho`` follows the
    new worker count from the next arrival on."""
    from repro_torch.scenarios.spec import ElasticSpec
    scn = _port_scenario("elastic_membership", outer_steps=5, elastic=(
        ElasticSpec(time=3.0, action="join", wid=9, pace=1.0, lang=1),))
    eng = scn.build(device="cpu")
    hist = eng.run()
    first = next(a for a in hist.arrivals if a["worker_id"] == 9)
    assert first["sim_time"] == 4.0 and first["outer_step"] - 1 - \
        first["staleness"] == 1
    assert [a["rho"] for a in hist.arrivals] == \
        [3 ** -0.5] + [0.5] * (len(hist.arrivals) - 1)
    assert eng.server.n_workers == 4
    assert eng.workers[9].inner_step_count == 2       # one round from 0


def test_dylu_pace_is_refreshed_on_membership_changes_only():
    """DyLU's reference pace is the fastest live pace at construction and
    after a join or leave; a crash leaves it as it was."""
    from repro_torch.async_engine.engine import ElasticEvent, FailureEvent
    eng = _port_scenario("int8_dylu").build(device="cpu")
    w1 = eng.workers[1]                               # pace 2, H = 4
    assert eng._min_pace == 1.0 and eng._h_steps(w1) == 2
    eng._handle_failure(FailureEvent(time=1.0, wid=0, restart_delay=5.0))
    assert not eng.workers[0].alive
    assert eng._min_pace == 1.0 and eng._h_steps(w1) == 2
    eng._handle_elastic(ElasticEvent(time=2.0, action="leave", wid=0))
    assert eng._min_pace == 2.0 and eng._h_steps(w1) == 4
    assert eng.server.n_workers == 2


def test_crash_loses_the_round_and_skips_its_stale_return():
    """``crash_rejoin``: worker 0 crashes at t=5 with a round in flight. The
    simulator drops the parked round at once, the round never runs, its
    return (t=6) commits nothing, and the restart at t=15 dispatches the
    worker again: every executed round is a committed arrival."""
    from repro_torch.async_engine.engine import FailureEvent
    eng = _port_scenario("crash_rejoin").build(device="cpu")
    for w in eng.workers.values():
        eng._dispatch(w)
    w0 = eng.workers[0]
    lost = w0.pending_task_id
    assert lost in eng._pending and len(eng._pending) == 3
    eng._crash_worker(w0)
    assert lost not in eng._pending and len(eng._pending) == 2
    assert (w0.alive, w0.generation, w0.in_flight, w0.ef) == \
        (False, 1, False, None)

    eng = _port_scenario("crash_rejoin").build(device="cpu")
    assert eng.failures == [FailureEvent(time=5.0, wid=0,
                                         restart_delay=10.0)]
    ran = []
    execute = eng._execute
    eng._execute = lambda task: ran.append(task.wid) or execute(task)
    hist = eng.run()
    assert len(ran) == len(hist.arrivals) == 12
    assert [a["worker_id"] for a in hist.arrivals] == ran
    times0 = [a["sim_time"] for a in hist.arrivals if a["worker_id"] == 0]
    # returns at 2 and 4; the round due at 6 is lost; rejoined at 15
    assert times0 == [2.0, 4.0, 17.0, 19.0, 21.0, 23.0]
    # what stays parked is the live workers' rounds in flight, nothing lost
    assert all(task.task_id == eng.workers[task.wid].pending_task_id
               for task in eng._pending.values())


def test_set_n_workers_changes_rho():
    from repro_torch.async_engine.server import Synchronizer
    from repro_torch.configs.base import OuterOptConfig
    params = {"w": torch.zeros(4, 3)}
    sync = Synchronizer(params, OuterOptConfig(), n_workers=4)
    delta = {"w": torch.full((4, 3), 0.1)}
    assert sync.on_arrival(delta, 0, 0).rho == 0.5
    sync.set_n_workers(9)
    assert sync.on_arrival(delta, 1, 1).rho == 9 ** 0.5 / 9


def test_join_of_a_member_keeps_the_old_slot_alive_as_the_reference():
    """An elastic join of a wid that is already a member (worker 1 again at
    t=5, pace 3): both engines replace ``workers[1]`` and leave the old
    worker's arena slot allocated and alive, so it counts in ``n_alive`` and
    in ``rho`` from then on. Arrivals (with each ``rho``), the live count
    and the fastest live pace equal the reference's."""
    from repro.scenarios.spec import ElasticSpec as JaxElasticSpec
    from repro_torch.scenarios.spec import ElasticSpec
    join = dict(time=5.0, action="join", wid=1, pace=3.0, lang=1)
    jscn = registry.get_scenario("elastic_membership")
    jscn = jscn.overridden(elastic=jscn.elastic + (JaxElasticSpec(**join),))
    scn = _port_scenario("elastic_membership")
    scn = scn.overridden(elastic=scn.elastic + (ElasticSpec(**join),))
    jeng = jax_make_engine(jscn)
    eng = scn.build(device="cpu", init_params=_flat(jeng.server.state.params))
    jhist, hist = jeng.run(), eng.run()
    assert _rows(hist) == _rows(jhist)
    assert (eng.arena.n_alive(), eng.arena.min_alive_pace(),
            eng.server.n_workers) == (jeng.arena.n_alive(),
                                      jeng.arena.min_alive_pace(),
                                      jeng.server.n_workers) == (5, 1.0, 5)
    nxt = next(a for a in hist.arrivals if a["sim_time"] > 5.0)
    assert nxt["rho"] == 5 ** 0.5 / 5
    assert eng.workers[1].pace == 3.0 and len(eng.workers) == 4
    # the parked rounds are the live workers' in flight; the old worker 1's
    # can never be obtained and was dropped at the join
    assert all(task.task_id == eng.workers[task.wid].pending_task_id
               for task in eng._pending.values())
