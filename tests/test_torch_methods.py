"""The port's outer-method layer against the reference's: the registry, the
host-side schedule scalars, the plain versions of the quadratic and
accumulator kernels against the reference's Pallas kernels (interpret mode
on the CPU), the packed Synchronizer of all 8 methods after every arrival,
and two method scenarios against a live reference run from the same bits.

Tolerances:
  * schedule scalars (MLA scale, DC-ASGD coefficient, delayed-Nesterov and
    FedBuff tables, dropped-arrival coefficients): bit for bit, the port
    repeating the reference's jitted fp32 operation by operation; within
    1 ulp the polynomial weight (1+tau)^-alpha, since numpy's powf and
    XLA's pow are two implementations, and the dropped-arrival
    coefficients, whose multiply-adds XLA's CPU backend contracts into
    fused multiply-adds (one rounding) where the port rounds each op;
  * the kernels' plain versions against the Pallas kernels: elementwise
    rtol/atol 1e-6 (a few ulp of O(1) operands; XLA may contract
    multiply-adds where PyTorch rounds each op); per-row moments within
    1e-5 of their own scale (another summation order);
  * Synchronizer state after every arrival: rtol 1e-5 / atol 1e-6, as in
    tests/test_torch_server.py (HeLoCo's branch scalars come from sums in
    another order, and the momentum carries that across arrivals);
  * live runs: every eval loss within 1e-4 absolute and final parameters
    within 5e-4 of each leaf's largest |value|, as in
    tests/test_torch_engine.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.async_engine.engine import make_engine as jax_make_engine
from repro.async_engine.engine import make_eval_fn as jax_make_eval_fn
from repro.async_engine.server import Synchronizer as JaxSynchronizer
from repro.configs.base import OuterOptConfig as JaxOuterOptConfig
from repro.core import methods as jmethods
from repro.kernels import packed as jpk
from repro.scenarios import registry as jregistry
from repro_torch import bridge
from repro_torch.async_engine.engine import make_eval_fn
from repro_torch.async_engine.server import Synchronizer
from repro_torch.configs.base import OuterOptConfig
from repro_torch.core import methods
from repro_torch.kernels import packed as pk
from repro_torch.scenarios import registry
from test_torch_packed_kernels import (
    SHAPES as KSHAPES, _bufs, _case, _close_elementwise, _close_sums,
)
from test_torch_server import _flat, _tree

METHODS = ("heloco", "mla", "nesterov", "sync_nesterov", "delayed_nesterov",
           "fedbuff", "poly_stale", "dcasgd")
# (s_i, worker) per arrival; with drop_stale_after=3 the arrivals at t = 4,
# 6, 7 and 10 are dropped. Buffer boundaries (phase 3 of 4) fall at t = 3
# and 11 (applied) and t = 7 (dropped).
SCHEDULE = [(0, 0), (0, 1), (1, 0), (1, 2), (0, 3), (4, 1), (2, 2), (3, 0),
            (7, 3), (8, 1), (6, 2), (9, 0)]
DROPPED = [False] * 4 + [True, False, True, True, False, False, True, False]
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for torch while a module runs (restored after
    it); the modules that run engines import this autouse fixture too. The
    suite runs files in parallel worker processes, and the default pool in
    each of them oversubscribes the cores with spinning threads: six
    concurrent processes running three smoke-width scenarios each took
    350 s with the default pool on an 8-core CPU, 5 s with one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_matches_reference():
    assert methods.cli_names() == jmethods.cli_names()
    assert methods.method_table() == jmethods.method_table()
    for name in jmethods.names():
        want, got = jmethods.get(name), methods.get(name)
        for f in ("sync", "outer_lr_cap", "tau_clip", "dc_lambda",
                  "stale_alpha", "buffer_period", "batchable", "aliases",
                  "uses_buffer", "custom_update"):
            assert getattr(got, f) == getattr(want, f), (name, f)


class _Layout:
    n_blocks = 1


def _ref_scalars(name):
    """The reference hook's scalars as a function of (tau, phase, rho),
    jitted over them as the reference server jits them."""
    m = jmethods.get(name)

    @jax.jit
    def fn(tau, phase, rho):
        ctx = jmethods.ArrivalCtx(outer_lr=m.outer_lr, mu=0.9, rho=rho,
                                  tau=tau, phase=phase, layout=_Layout())
        cu, cv, cq = m.packed_coeffs(m, ctx, None, None)
        sched = jnp.stack([jnp.asarray(c, jnp.float32)
                           for c in jmethods.schedule_coeffs(m, ctx)])
        decay = (jnp.zeros(2) if m.custom_update
                 else jnp.stack(jmethods.decay_coeffs(m, ctx)))
        return cu[0], cv[0], (cq[0] if cq is not None else jnp.nan), \
            sched, decay

    def scalars(tau, phase, rho):
        return [np.asarray(x, np.float32) for x in fn(
            jnp.asarray(tau, jnp.float32), jnp.asarray(phase, jnp.int32),
            jnp.asarray(rho))]
    return scalars


def _port_scalars(name, tau, phase, rho):
    m = methods.get(name)
    ctx = methods.ArrivalCtx(outer_lr=m.outer_lr, mu=0.9, rho=rho, tau=tau,
                             phase=phase, layout=_Layout())
    cu, cv, cq = m.packed_coeffs(m, ctx, torch.zeros(1), None)
    sched = np.array([np.float32(c) for c in methods.schedule_coeffs(m, ctx)])
    decay = (np.zeros(2, np.float32) if m.custom_update
             else np.array(methods.decay_coeffs(m, ctx), np.float32))
    return [np.float32(cu[0]), np.float32(cv[0]),
            np.float32(cq[0]) if cq is not None else np.float32(np.nan),
            sched, decay]


@pytest.mark.parametrize("name", [m for m in METHODS if m != "heloco"])
def test_schedule_scalars_match_reference_bits(name):
    ref = _ref_scalars(name)
    for tau in range(0, 21):
        for phase in range(4):
            rho = 0.5 / np.sqrt(1.0 + tau)
            want = ref(tau, phase, rho)
            got = _port_scalars(name, tau, phase, rho)
            for i, (g, w) in enumerate(zip(got, want)):
                if i == 4 or (name == "poly_stale" and i == 0):
                    np.testing.assert_array_max_ulp(g, w, maxulp=1)
                else:
                    np.testing.assert_array_equal(
                        np.asarray(g).view(np.uint32),
                        np.asarray(w).view(np.uint32),
                        err_msg=f"{name} tau={tau} phase={phase} slot {i}")


def _kernel_inputs(seed):
    layout, u, v = _case(seed)
    rng = np.random.default_rng(seed + 10)
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in KSHAPES.items()}
    b = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in KSHAPES.items()}
    db, mb, pb, bb = _bufs(layout, u, v, p, b)
    gen = np.random.default_rng(seed + 20)
    coef = [torch.from_numpy(gen.uniform(lo, hi, layout.n_blocks)
                             .astype(np.float32))
            for lo, hi in ((0.5, 1.5), (-0.5, 0.5), (-0.3, 0.0))]
    rb = np.asarray(layout.row_block)
    rows = [jnp.asarray(c.numpy()[rb][:, None]) for c in coef]
    return layout, (pb, mb, bb, db), coef, rows


def _j(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("with_stats", [False, True])
def test_quad_plain_version_matches_reference_kernel(with_stats):
    layout, (pb, mb, _bb, db), (cu, cv, cq), rows = _kernel_inputs(6)
    rb, _ = layout.device_tables("cpu")
    got = pk.packed_correct_outer_quad(pb, mb, db, cu, cv, cq, rb, 0.07, 0.9,
                                       0.5, with_stats=with_stats)
    want = jpk.packed_correct_outer_quad(
        _j(pb), _j(mb), _j(db), *rows, 0.07, 0.9, 0.5, interpret=True,
        with_stats=with_stats)
    assert len(got) == len(want) == (3 if with_stats else 2)
    _close_elementwise(got[0], want[0])
    _close_elementwise(got[1], want[1])
    if with_stats:
        _close_sums(got[2], want[2])


# (am, bm, ab, cg, cm, ca): a delayed-Nesterov boundary and a FedBuff
# non-boundary arrival (cg = 0: the parameters must not move)
ACC_TABLES = {"dn_boundary": (0.9, 0.025, 0.0, 1.0, 0.9, 0.0),
              "fedbuff_hold": (1.0, 0.0, 1.0, 0.0, 0.0, 0.0)}


@pytest.mark.parametrize("table", sorted(ACC_TABLES))
@pytest.mark.parametrize("with_stats", [False, True])
def test_acc_plain_version_matches_reference_kernel(table, with_stats):
    layout, (pb, mb, bb, db), (cu, cv, _cq), rows = _kernel_inputs(7)
    rb, _ = layout.device_tables("cpu")
    sched = ACC_TABLES[table]
    got = pk.packed_correct_outer_acc(pb, mb, bb, db, cu, cv, rb, 0.7, 0.5,
                                      *sched, with_stats=with_stats)
    want = jpk.packed_correct_outer_acc(
        _j(pb), _j(mb), _j(bb), _j(db), rows[0], rows[1], 0.7, 0.5, *sched,
        interpret=True, with_stats=with_stats)
    assert len(got) == len(want) == (4 if with_stats else 3)
    for g, w in zip(got[:3], want[:3]):
        _close_elementwise(g, w)
    if with_stats:
        _close_sums(got[3], want[3])
    if table == "fedbuff_hold":
        assert torch.equal(got[0], pb)


@pytest.mark.parametrize("kernel", ["quad", "acc"])
def test_stats_variant_and_in_place_keep_the_bits(kernel):
    layout, (pb, mb, bb, db), (cu, cv, cq), _rows = _kernel_inputs(8)
    rb, _ = layout.device_tables("cpu")
    if kernel == "quad":
        def call(*bufs, **kw):
            return pk.packed_correct_outer_quad(bufs[0], bufs[1], db, cu, cv,
                                                cq, rb, 0.07, 0.9, 0.5, **kw)
        state = (pb, mb)
    else:
        def call(*bufs, **kw):
            return pk.packed_correct_outer_acc(
                *bufs, db, cu, cv, rb, 0.7, 0.5,
                *ACC_TABLES["dn_boundary"], **kw)
        state = (pb, mb, bb)
    plain = call(*state)
    stats = call(*state, with_stats=True)
    assert stats[-1].shape == (layout.n_rows, pk.N_MOMENTS)
    assert all(torch.equal(a, b) for a, b in zip(plain, stats))
    copies = tuple(t.clone() for t in state)
    res = call(*copies, out=copies)
    assert all(r is c for r, c in zip(res, copies))
    assert all(torch.equal(a, b) for a, b in zip(plain, copies))


def _deltas(rng, n):
    """Each delta leans on the previous one (along it, against it, or
    neither), so HeLoCo's branches all occur."""
    prev, out = None, []
    for k in range(n):
        noise = _tree(rng, 0.01)
        d = noise if prev is None else jax.tree.map(
            lambda p, q, a=(1.0, -1.0, 0.1)[k % 3]: (a * p + q).astype(
                np.float32), prev, noise)
        out.append(d)
        prev = d
    return out


def _check_state(ours, ref):
    np.testing.assert_allclose(ours._pbuf.numpy(), np.asarray(ref._pbuf),
                               **TOL)
    np.testing.assert_allclose(ours._mbuf.numpy(), np.asarray(ref._mbuf),
                               **TOL)
    assert (ours._abuf is None) == (ref._abuf is None)
    if ours._abuf is not None:
        np.testing.assert_allclose(ours._abuf.numpy(), np.asarray(ref._abuf),
                                   **TOL)
    ref_init = _flat(ref.worker_init())
    for k, v in ours.worker_init().items():
        np.testing.assert_allclose(v.numpy(), ref_init[k], **TOL)


@pytest.mark.parametrize("name", METHODS)
def test_synchronizer_matches_reference_after_every_arrival(name):
    """Staleness up to 4, delay weighting, drops before, at and after a
    buffer boundary; sync_nesterov takes barrier rounds of three workers."""
    rng = np.random.default_rng(3)
    init = _tree(rng)
    preset = jmethods.get(name).defaults()
    cfg = dict(method=name, drop_stale_after=3, delay_weighting=True,
               **preset)
    ref = JaxSynchronizer(init, JaxOuterOptConfig(**cfg), n_workers=4)
    ours = Synchronizer(bridge.to_torch(_flat(init), "cpu"),
                        OuterOptConfig(**cfg), n_workers=4)
    deltas = _deltas(rng, len(SCHEDULE))
    to_port = [bridge.to_torch(_flat(d), "cpu") for d in deltas]
    if name == "sync_nesterov":
        for r in range(4):
            want = ref.on_sync_round(deltas[3 * r:3 * r + 3], sim_time=r)
            got = ours.on_sync_round(to_port[3 * r:3 * r + 3], sim_time=r)
            assert got.__dict__ == {k: want.__dict__[k] for k in got.__dict__}
            _check_state(ours, ref)
        assert ours.t == ref.t == 4
        return
    for (s_i, wid), d, dt in zip(SCHEDULE, deltas, to_port):
        want = ref.on_arrival(d, s_i, wid, sim_time=1.0, lang="de")
        got = ours.on_arrival(dt, s_i, wid, sim_time=1.0, lang="de")
        assert got.__dict__ == {k: want.__dict__[k] for k in got.__dict__}
        _check_state(ours, ref)
    assert [r.dropped for r in ours.records] == DROPPED
    state, ref_state = ours.state, ref.state
    assert (state.aux is None) == (ref_state.aux is None)
    if state.aux is not None:
        for k, v in _flat(ref_state.aux).items():
            np.testing.assert_allclose(state.aux[k].numpy(), v, **TOL)


def test_port_server_refuses_what_it_does_not_run():
    init = bridge.to_torch(_flat(_tree(np.random.default_rng(0))), "cpu")
    # compressed pseudo-gradients are taken since A9 (core/compression.py),
    # a commit buffer since A11 (tests/test_torch_batched.py)
    Synchronizer(init, OuterOptConfig(compression="int8"), n_workers=2)
    sync = Synchronizer(init, OuterOptConfig(), n_workers=2, commit_batch=4)
    assert (sync.commit_batch, sync.pending) == (4, 0)
    assert sync.flush() == [] and sync.flush_totals["flushes"] == 0
    # the per-leaf path and stacked layer axes since A16
    # (tests/test_torch_leaf.py)
    stacked = {"layers/w": 1, "layers/b": 1}
    leaf = Synchronizer(init, OuterOptConfig(), n_workers=2,
                        stacked_axes=stacked, use_kernel=True, packed=False)
    assert (leaf.packed, leaf.use_kernel, leaf.stacked_axes) == (
        False, True, stacked)
    assert leaf.layout is None and leaf.t == 0
    packed = Synchronizer(init, OuterOptConfig(), n_workers=2,
                          stacked_axes=stacked)
    assert packed.packed and packed.layout.n_blocks == len(init) + 4
    # the reference's telemetry switch since A10
    # (tests/test_torch_telemetry.py): stats on each record with it, None
    # without it
    delta = {k: 0.01 * torch.ones_like(v) for k, v in init.items()}
    for on in (True, False):
        srv = Synchronizer(init, OuterOptConfig(), n_workers=2, telemetry=on)
        rec = srv.on_arrival(delta, 0, 0)
        stats = (rec.cos_align, rec.corrected_frac, rec.delta_norm,
                 rec.momentum_norm)
        assert srv.telemetry is on
        if on:
            assert all(isinstance(x, float) for x in stats), stats
            assert rec.delta_norm > 0.0 and rec.momentum_norm == 0.0
        else:
            assert stats == (None,) * 4


def _live(name, recorders=(None, None), **overrides):
    """The reference and the port run scenario ``name`` (with ``overrides``)
    from the same initial parameters; returns (reference engine, its
    history, port engine, its history). ``recorders``: the reference's and
    the port's ``TelemetryRecorder`` (or None), each handed to its engine."""
    scn = jregistry.get_scenario(name).overridden(**overrides)
    jeng = jax_make_engine(scn, telemetry=recorders[0])
    eng = registry.get_scenario(name).overridden(**overrides).build(
        device="cpu", init_params=_flat(jeng.server.state.params),
        telemetry=recorders[1])
    jhist = jeng.run(eval_every=scn.eval_cadence,
                     eval_fn=jax_make_eval_fn(jeng, batch=scn.eval_batch))
    hist = eng.run(eval_every=scn.eval_cadence,
                   eval_fn=make_eval_fn(eng, batch=scn.eval_batch))
    return jeng, jhist, eng, hist


def check_live(jeng, jhist, eng, hist, int8_steps=None, max_flips=0):
    """Arrivals equal, evals within 1e-4, final parameters within 5e-4 of
    each leaf's largest |value|.

    With ``int8_steps`` (path -> per-element array: the largest int8
    quantization step of the element's block in the run), up to
    ``max_flips`` elements may lie outside that band by at most their step:
    the two packages' inner rounds differ in the last bits, and an element
    whose pseudo-gradient sits within that drift of a .5 quantization tie
    rounds to neighbouring int8 values on the two sides."""
    assert [dict(a) for a in hist.arrivals] == \
        [{k: a[k] for k in hist.arrivals[0]} for a in jhist.arrivals]
    assert [e["step"] for e in hist.evals] == [e["step"] for e in jhist.evals]
    for got, want in zip(hist.evals, jhist.evals):
        assert got["time"] == want["time"]
        assert abs(got["mean"] - want["mean"]) < 1e-4, (got, want)
        for lang, loss in want["per_lang"].items():
            assert abs(got["per_lang"][lang] - loss) < 1e-4, (lang, got, want)
    want = _flat(jeng.server.state.params)
    got = eng.server.state.params
    assert set(got) == set(want)
    flips = 0
    for k, v in want.items():
        if int8_steps is None:
            np.testing.assert_allclose(got[k].numpy(), v, rtol=0,
                                       atol=5e-4 * np.abs(v).max(),
                                       err_msg=k)
            continue
        diff = np.abs(got[k].numpy() - v)
        out = diff > 5e-4 * np.abs(v).max()
        assert (diff[out] <= int8_steps[k][out]).all(), (
            k, diff[out], int8_steps[k][out])
        flips += int(out.sum())
    assert flips <= max_flips, flips


@pytest.mark.parametrize("name", ["dcasgd", "sync_baseline"])
def test_live_reference_run_from_the_same_bits(name):
    check_live(*_live(name))
