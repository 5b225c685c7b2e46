"""The port's batched commit path (``commit_batch > 1``) against the
reference's: the four K-stacked kernels' plain versions, the K-flush
coefficients, ``apply_arrivals_packed``, the server's commit buffer, the
engine's arena, vectorised event queue and history ring, the hogwild batch
ramp-up, committed pace traces, and the two batched scenarios plus three
batched method baselines against live reference runs from the same bits.

Tolerances:
  * plain multi sweeps against the Pallas interpreter (the reference's own
    CPU path): elementwise rtol/atol 1e-6, as for the single-arrival sweeps
    in tests/test_torch_packed_kernels.py (XLA's CPU backend contracts
    multiply-adds into one rounding where PyTorch rounds each op, a few ulp
    of O(1) operands); per-row moments within 1e-5 of their own scale;
  * plain multi sweeps against K sequential calls of the port's
    single-arrival sweep: bit for bit (the kernels are held to the same on
    the card by tests/test_torch_cuda.py);
  * Gram matrices: each entry within 1e-5 of sqrt(G_aa * G_bb), which
    bounds it (Cauchy-Schwarz), for another summation order;
  * HeLoCo's K-flush branch scalars cu/cv against the reference's: within
    1e-4 absolute. Both are fp32-close, not bitwise, to the sequential
    statistics (the Gram entries are sums in another order), so a block
    whose statistics sit within that drift of a branch threshold could take
    another branch; none does on these inputs;
  * packed state after a flush: rtol 1e-5 / atol 5e-6, the reference's own
    band for batched against sequential (tests/test_scale.py);
  * live runs: check_live's bands (evals 1e-4, parameters 5e-4 of each
    leaf's largest |value|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.async_engine import engine as jengine
from repro.async_engine.server import Synchronizer as JaxSynchronizer
from repro.configs.base import HeLoCoConfig as JaxHeLoCoConfig
from repro.configs.base import OuterOptConfig as JaxOuterOptConfig
from repro.core import heloco as jheloco
from repro.core import methods as jmethods
from repro.core import packing as jpacking
from repro.kernels import packed as jpk
from repro.scenarios import registry as jregistry
from repro.scenarios.spec import load_pace_trace as jload_pace_trace
from repro_torch import bridge
from repro_torch.async_engine.engine import (
    HISTORY_WINDOW, EventQueue, History, WorkerArena,
)
from repro_torch.async_engine.server import Synchronizer
from repro_torch.configs.base import HeLoCoConfig, OuterOptConfig
from repro_torch.core import heloco, methods, packing
from repro_torch.kernels import packed as pk
from repro_torch.launch import train
from repro_torch.scenarios import registry, run
from repro_torch.scenarios.spec import load_pace_trace
from test_torch_methods import _live, check_live, one_intra_op_thread  # noqa: F401
from test_torch_packed_kernels import _close_elementwise, _close_sums

H = HeLoCoConfig()
JH = JaxHeLoCoConfig()
KS = (2, 3, 4)
# three blocks of uneven height: 3, 1 and 5 rows, the last one ragged
LEAVES = {"a": 3 * 128 - 5, "b": 100, "c": 5 * 128 - 77}
TOL = dict(rtol=1e-5, atol=5e-6)


def _j(t):
    return jnp.asarray(t.numpy())


def _layout():
    return packing.build_layout({k: np.zeros(n, np.float32)
                                 for k, n in LEAVES.items()})


def _multi_inputs(k, seed=0):
    """p, m, b (R, 128), a (K, R, 128) delta stack whose slices lean on the
    momentum in turn (along, against, across), (K, B) coefficient tables,
    and per-delta scalars."""
    layout = _layout()
    rng = np.random.default_rng(seed)
    r = layout.n_rows

    def buf():
        x = np.zeros((r, 128), np.float32)
        for s, e in layout.block_row_ranges:
            x[s:e] = rng.standard_normal((e - s, 128))
        return x

    p, m, b = buf(), buf(), buf()
    d = np.stack([(0.5, -0.8, 0.1, 1.0)[j % 4] * m + 0.3 * buf()
                  for j in range(k)]).astype(np.float32)
    # keep the padding of every buffer zero, as packing leaves it
    pad = np.ones((r, 128), bool)
    for leaf in layout.leaves:
        rows = leaf.rows_per_block
        view = pad[leaf.start_row:leaf.start_row + rows].reshape(-1)
        view[:leaf.block_elems] = False
    for x in (p, m, b, *d):
        x[pad] = 0.0
    nb = layout.n_blocks
    coef = [rng.uniform(lo, hi, (k, nb)).astype(np.float32)
            for lo, hi in ((0.5, 1.5), (-0.5, 0.5), (-0.3, 0.0))]
    rhos = [0.5 / np.sqrt(1.0 + j) for j in range(k)]
    bufs = [torch.from_numpy(x) for x in (p, m, b, d)]
    return layout, bufs, [torch.from_numpy(c) for c in coef], rhos


def _acc_table(k):
    """Per-delta (am, bm, ab, cg, cm, ca): delayed-Nesterov non-boundary
    rows with the second slot a boundary."""
    rows = [(1.0, 0.0, 1.0, 1.0, 0.9, 0.0)] * k
    rows[1] = (0.9, 0.025, 0.0, 1.0, 0.9, 0.0)
    return [np.array(col, np.float32) for col in zip(*rows)]


def _rows_of(c, layout):
    """(K, B) per-block table -> the reference's (K, R, 1) rows."""
    return jnp.asarray(c.numpy()[:, layout.row_block][:, :, None])


def _port_and_reference(kernel, k, with_stats):
    layout, (p, m, b, d), (cu, cv, cq), rhos = _multi_inputs(k, seed=k)
    rb, _ = layout.device_tables("cpu")
    jargs = [_rows_of(cu, layout), _rows_of(cv, layout)]
    if kernel == "plain":
        got = pk.packed_multi_correct_outer(p, m, d, cu, cv, rb, 0.7, 0.9,
                                            rhos, with_stats=with_stats)
        want = jpk.packed_multi_correct_outer(
            _j(p), _j(m), _j(d), *jargs, 0.7, 0.9, jnp.asarray(rhos),
            interpret=True, with_stats=with_stats)
    elif kernel == "quad":
        got = pk.packed_multi_correct_outer_quad(
            p, m, d, cu, cv, cq, rb, 0.07, 0.9, rhos, with_stats=with_stats)
        want = jpk.packed_multi_correct_outer_quad(
            _j(p), _j(m), _j(d), *jargs, _rows_of(cq, layout), 0.07, 0.9,
            jnp.asarray(rhos), interpret=True, with_stats=with_stats)
    else:
        table = _acc_table(k)
        got = pk.packed_multi_correct_outer_acc(
            p, m, b, d, cu, cv, rb, 0.7, rhos, *table,
            with_stats=with_stats)
        want = jpk.packed_multi_correct_outer_acc(
            _j(p), _j(m), _j(b), _j(d), *jargs, 0.7, jnp.asarray(rhos),
            *(jnp.asarray(c) for c in table), interpret=True,
            with_stats=with_stats)
    return got, want


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kernel", ["plain", "quad", "acc"])
def test_multi_plain_versions_match_pallas_interpreter(kernel, k, with_stats):
    got, want = _port_and_reference(kernel, k, with_stats)
    n_state = 3 if kernel == "acc" else 2
    assert len(got) == len(want) == n_state + with_stats
    for g, w in zip(got[:n_state], want[:n_state]):
        _close_elementwise(g, w)
    if with_stats:
        assert got[-1].shape == want[-1].shape == (k, g.shape[0],
                                                   pk.N_MOMENTS)
        for j in range(k):
            _close_sums(got[-1][j], want[-1][j])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kernel", ["plain", "quad", "acc"])
def test_multi_plain_versions_equal_k_sequential_port_calls(kernel, k):
    """Bit for bit: p', m' (b') and every slice of the moments, in place
    and not."""
    layout, (p, m, b, d), (cu, cv, cq), rhos = _multi_inputs(k, seed=10 + k)
    rb, _ = layout.device_tables("cpu")
    if kernel == "plain":
        state = (p, m)

        def multi(*s, **kw):
            return pk.packed_multi_correct_outer(*s, d, cu, cv, rb, 0.7, 0.9,
                                                 rhos, **kw)

        def single(j, *s):
            return pk.packed_correct_outer(*s, d[j], cu[j], cv[j], rb, 0.7,
                                           0.9, rhos[j], with_stats=True)
    elif kernel == "quad":
        state = (p, m)

        def multi(*s, **kw):
            return pk.packed_multi_correct_outer_quad(
                *s, d, cu, cv, cq, rb, 0.07, 0.9, rhos, **kw)

        def single(j, *s):
            return pk.packed_correct_outer_quad(
                *s, d[j], cu[j], cv[j], cq[j], rb, 0.07, 0.9, rhos[j],
                with_stats=True)
    else:
        state = (p, m, b)
        table = _acc_table(k)

        def multi(*s, **kw):
            return pk.packed_multi_correct_outer_acc(
                *s, d, cu, cv, rb, 0.7, rhos, *table, **kw)

        def single(j, *s):
            return pk.packed_correct_outer_acc(
                *s, d[j], cu[j], cv[j], rb, 0.7, rhos[j],
                *(c[j] for c in table), with_stats=True)
    seq, moments = state, []
    for j in range(k):
        out = single(j, *seq)
        seq, moments = out[:-1], moments + [out[-1]]
    got = multi(*state, with_stats=True)
    assert all(torch.equal(g, w) for g, w in zip(got[:-1], seq))
    assert torch.equal(got[-1], torch.stack(moments))
    assert all(torch.equal(g, w) for g, w in zip(multi(*state), seq))
    copies = tuple(t.clone() for t in state)
    res = multi(*copies, out=copies)
    assert all(r is c for r, c in zip(res, copies))
    assert all(torch.equal(c, w) for c, w in zip(copies, seq))


@pytest.mark.parametrize("k", (1, *KS))
def test_multi_gram_matches_reference(k):
    layout, (_p, m, _b, d), _coef, _rhos = _multi_inputs(k, seed=20 + k)
    parts = pk.packed_multi_gram(m, d)
    assert parts.shape == (layout.n_rows, (k + 1) * (k + 2) // 2)
    assert torch.equal(parts, pk.packed_multi_gram_ref(m, d))
    got = pk.multi_gram_blocks(m, d, layout).double().numpy()
    want = np.asarray(jpk.packed_multi_gram(
        _j(m), _j(d), layout.block_row_ranges, interpret=True), np.float64)
    assert got.shape == want.shape == (layout.n_blocks, k + 1, k + 1)
    np.testing.assert_array_equal(got, got.transpose(0, 2, 1))
    diag = np.sqrt(np.einsum("bii->bi", want))
    bound = 1e-5 * diag[:, :, None] * diag[:, None, :]
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def _method_inputs(k, seed):
    """Packed params/momentum/accumulator and K numpy-made deltas on the
    tinygpt-shaped mixed layout of tests/test_torch_packed_kernels.py."""
    from test_torch_packed_kernels import SHAPES, STACKED
    rng = np.random.default_rng(seed)
    tree = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}
    mom = {n: 0.1 * rng.standard_normal(s).astype(np.float32)
           for n, s in SHAPES.items()}
    deltas = []
    for j in range(k):
        a = (0.5, -0.8, 0.1, 1.0)[j % 4]
        deltas.append({n: (a * mom[n] + 0.05 * rng.standard_normal(s))
                       .astype(np.float32) for n, s in SHAPES.items()})
    layout = packing.build_layout(tree, STACKED)
    jlayout = jpacking.build_layout(
        {n: jnp.asarray(v) for n, v in tree.items()},
        {n: STACKED.get(n, 0) for n in tree})
    assert np.array_equal(np.asarray(jlayout.row_block), layout.row_block)
    return layout, jlayout, tree, mom, deltas


@pytest.mark.parametrize("name", sorted(jmethods.names()))
def test_apply_arrivals_packed_matches_reference(name):
    """K = 4 arrivals in one flush, the phases straddling a buffer boundary,
    against the reference's ``apply_arrivals_packed`` (Pallas interpreter)
    and against the port's own four sequential single-arrival steps (bit
    for bit where the coefficients do not read the momentum)."""
    k = 4
    layout, jlayout, tree, mom, deltas = _method_inputs(k, seed=5)
    m = methods.get(name)
    kw = dict(method=name, outer_lr=m.outer_lr, mu=0.9,
              rhos=[0.5 / np.sqrt(1.0 + j) for j in range(k)],
              taus=[float(j) for j in range(k)],
              phases=list(range(2, 2 + k)))
    pbuf = packing.pack(layout, bridge.to_torch(tree, "cpu"))
    mbuf = packing.pack(layout, bridge.to_torch(mom, "cpu"))
    abuf = packing.zeros(layout, "cpu") if m.uses_buffer else None
    tdeltas = [bridge.to_torch(dd, "cpu") for dd in deltas]
    got = heloco.apply_arrivals_packed(pbuf, mbuf, tdeltas, layout, h=H,
                                       abuf=abuf, **kw)
    want = jheloco.apply_arrivals_packed(
        _j(pbuf), _j(mbuf),
        [jpacking.Packed(_j(packing.pack(layout, dd))) for dd in tdeltas],
        jlayout, h=JH, interpret=True,
        abuf=jpacking.zeros(jlayout) if m.uses_buffer else None, **kw)
    assert len(got) == len(want) == (3 if m.uses_buffer else 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    seq = (pbuf, mbuf) + ((abuf,) if m.uses_buffer else ())
    for j in range(k):
        seq = heloco.apply_arrival_packed(
            *seq[:2], tdeltas[j], layout, method=name, outer_lr=m.outer_lr,
            mu=0.9, h=H, rho=kw["rhos"][j], tau=kw["taus"][j],
            abuf=seq[2] if m.uses_buffer else None, phase=kw["phases"][j])
    for g, w in zip(got, seq):
        if m.packed_multi_coeffs is None:
            assert torch.equal(g, w), name
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_heloco_flush_branch_scalars_within_band_of_reference():
    """HeLoCo's (K, B) cu/cv of a K = 4 flush, rebuilt from the Gram
    matrices, against the reference's: within 1e-4 absolute, and every
    block on the same Alg. 2 branch; and the deltas take more than one
    branch."""
    k = 4
    layout, jlayout, _tree, mom, deltas = _method_inputs(k, seed=6)
    rhos = [0.5 / np.sqrt(1.0 + j) for j in range(k)]
    ctxs = [methods.ArrivalCtx(outer_lr=0.7, mu=0.9, h=H, rho=r, tau=0.0,
                               layout=layout) for r in rhos]
    jctxs = [jmethods.ArrivalCtx(outer_lr=0.7, mu=0.9, h=JH, rho=r,
                                 tau=jnp.float32(0.0), layout=jlayout,
                                 interpret=True) for r in rhos]
    dstack = torch.stack([packing.pack(layout, bridge.to_torch(dd, "cpu"))
                          for dd in deltas])
    mbuf = packing.pack(layout, bridge.to_torch(mom, "cpu"))
    cu, cv, cq = methods.multi_packed_coeffs(methods.get("heloco"), ctxs,
                                             dstack, mbuf)
    jcu, jcv, jcq = jmethods.multi_packed_coeffs(
        jmethods.get("heloco"), jctxs, _j(dstack), _j(mbuf))
    assert cq is None and jcq is None
    assert cu.shape == cv.shape == (k, layout.n_blocks)
    np.testing.assert_allclose(cu.numpy(), np.asarray(jcu), rtol=0, atol=1e-4)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), rtol=0, atol=1e-4)
    keep = (cu == 1) & (cv == 0)
    assert np.array_equal(keep.numpy(), (np.asarray(jcu) == 1)
                          & (np.asarray(jcv) == 0))
    assert keep.any() and (~keep).any()


# ---------------------------------------------------------------------------
# The server's commit buffer
# ---------------------------------------------------------------------------

def _server_params(seed=0):
    rng = np.random.default_rng(seed)
    return {f"b{i}": rng.standard_normal(256).astype(np.float32)
            for i in range(4)}


def _server_deltas(n, seed=7):
    rng = np.random.default_rng(seed)
    return [{f"b{i}": (0.01 * rng.standard_normal(256)).astype(np.float32)
             for i in range(4)} for _ in range(n)]


def test_commit_batch_one_is_bit_identical():
    cfg = OuterOptConfig(method="heloco", delay_weighting=True)
    init = bridge.to_torch(_server_params(), "cpu")
    a = Synchronizer(init, cfg, n_workers=4)
    b = Synchronizer(init, cfg, n_workers=4, commit_batch=1)
    recs_a, recs_b = [], []
    for i, d in enumerate(_server_deltas(5)):
        d = bridge.to_torch(d, "cpu")
        recs_a.append(a.on_arrival(d, max(0, a.t - 2), i % 4))
        out = b.buffer_arrival(d, max(0, b.t - 2), i % 4)
        assert out is not None and len(out) == 1   # K = 1 flushes at once
        recs_b.extend(out)
    assert torch.equal(a._pbuf, b._pbuf) and torch.equal(a._mbuf, b._mbuf)
    assert [r.__dict__ for r in recs_a] == [r.__dict__ for r in recs_b]


@pytest.mark.parametrize("method", ["heloco", "delayed_nesterov", "dcasgd"])
def test_buffered_flush_matches_sequential_with_drops(method):
    """Seven arrivals, staleness 0..2 with drop_stale_after=1, buffered 3 at
    a time: the records equal the port's sequential server's and the
    reference's buffered server's; the state equals the port's sequential
    one bit for bit (within TOL for HeLoCo, whose flush statistics come from
    the Gram matrices) and the reference's within TOL."""
    cfg = dict(method=method, delay_weighting=True, drop_stale_after=1)
    init = _server_params()
    seq = Synchronizer(bridge.to_torch(init, "cpu"), OuterOptConfig(**cfg),
                       n_workers=4)
    ours = Synchronizer(bridge.to_torch(init, "cpu"), OuterOptConfig(**cfg),
                        n_workers=4, commit_batch=3)
    ref = JaxSynchronizer({k: jnp.asarray(v) for k, v in init.items()},
                          JaxOuterOptConfig(**cfg), n_workers=4,
                          commit_batch=3)
    recs, jrecs, seq_recs = [], [], []
    for i, d in enumerate(_server_deltas(7)):
        s_i = max(0, i - (i % 3))
        key = ("k", i)
        seq_recs.append(seq.on_arrival(bridge.to_torch(d, "cpu"), s_i, i % 4,
                                       commit_key=key))
        recs += ours.buffer_arrival(bridge.to_torch(d, "cpu"), s_i, i % 4,
                                    commit_key=key) or []
        jrecs += ref.buffer_arrival({k: jnp.asarray(v) for k, v in d.items()},
                                    s_i, i % 4, commit_key=key) or []
    recs += ours.flush("close")
    jrecs += ref.flush("close")
    assert ours.t == seq.t == ref.t == 7
    assert [r.__dict__ for r in recs] == [r.__dict__ for r in seq_recs]
    assert [r.__dict__ for r in recs] == \
        [{k: r.__dict__[k] for k in recs[0].__dict__} for r in jrecs]
    assert ours.flush_log == ref.flush_log
    assert ours.flush_totals == ref.flush_totals
    assert ours.flush_totals["fused"] > 0
    for name in ("_pbuf", "_mbuf", "_abuf"):
        got, want = getattr(ours, name), getattr(seq, name)
        if got is None:
            continue
        if method == "heloco":
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
        else:
            assert torch.equal(got, want), name
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(ref, name)), **TOL)


def test_idempotent_redelivery_while_buffered():
    s = Synchronizer(bridge.to_torch(_server_params(), "cpu"),
                     OuterOptConfig(method="heloco"), n_workers=4,
                     commit_batch=8)
    d = bridge.to_torch(_server_deltas(1)[0], "cpu")
    s.buffer_arrival(d, 0, 0, commit_key=("a", 0))
    s.buffer_arrival(d, 0, 0, commit_key=("a", 0))   # a duplicate, pending
    assert s.pending == 1
    assert len(s.flush()) == 1 and s.t == 1
    # a duplicate after the commit: the ledger refuses it, nothing buffers
    assert s.buffer_arrival(d, 0, 0, commit_key=("a", 0)) is None
    assert s.pending == 0 and s.flush() == [] and s.t == 1


# ---------------------------------------------------------------------------
# Event queue, worker arena, history ring
# ---------------------------------------------------------------------------

def test_pop_batch_preserves_global_event_order():
    for q in (EventQueue(), jengine.EventQueue()):
        q.push(1.0, "return", 0, 0)
        q.push(1.0, "return", 1, 0)
        q.push(1.0, "restart", 2, 1)     # same tick, between by push order
        q.push(1.0, "return", 3, 0)
        q.push(0.5, "return", 4, 0)
        assert [w for _, _, w, _ in q.pop_batch(8)] == [4]
        batch = q.pop_batch(8)           # stops before the restart
        assert [(w, k) for _, k, w, _ in batch] == [(0, "return"),
                                                    (1, "return")]
        assert [k for _, k, _, _ in q.pop_batch(8)] == ["restart"]
        assert [w for _, _, w, _ in q.pop_batch(1)] == [3]
        assert q.pop_batch(8) == [] and len(q) == 0


def test_queue_compacts_under_crash_rejoin_storm_n1000():
    """N = 1000: the returns a storm orphans are compacted away once they
    outnumber the live ones, never popped one by one; the port's queue pops
    what the reference's pops."""
    n = 1000
    queues = (EventQueue(), jengine.EventQueue())
    alive_gen = {w: 0 for w in range(n)}
    for q in queues:
        for w in range(n):
            q.push(1.0 + (w % 5), "return", w, 0)

    def live(kind, wid, gen):
        return kind == "restart" or alive_gen[wid] == gen

    for w in range(900):                 # 900 crash, each reported stale
        alive_gen[w] = 1
        for q in queues:
            q.note_stale()
            q.maybe_compact(live)
    for q in queues:
        assert q.compactions >= 1
        for w in range(900):             # ... and all rejoin
            q.push(7.0 + (w % 3), "restart", w, 1)
    popped = []
    for q in queues:
        dead, rows = 0, []
        while len(q):
            for row in q.pop_batch(64):
                rows.append(row)
                _t, kind, wid, gen = row
                if kind == "return" and alive_gen[wid] != gen:
                    dead += 1
                    q.note_skip()
        assert dead <= 64 and q.stale_skipped == dead
        popped.append(rows)
    assert popped[0] == popped[1]
    assert queues[0].compactions == queues[1].compactions


def test_worker_arena_grows_and_recycles_slots():
    arena = WorkerArena(2)
    slots = [arena.alloc(w) for w in range(5)]     # forces growth
    assert len(set(slots)) == 5 and arena.n_alive() == 5
    arena.cols["pace"][slots[3]] = 9.0
    arena.cols["pace"][slots[1]] = 0.5
    assert arena.min_alive_pace() == 0.5
    arena.cols["alive"][slots[1]] = False          # a crash
    assert arena.min_alive_pace() == 1.0 and arena.n_alive() == 4
    arena.cols["opt"][slots[0]] = object()
    arena.release(slots[0])
    assert arena.n_alive() == 3 and arena.cols["opt"][slots[0]] is None
    s = arena.alloc(17)                            # the recycled slot
    assert s == slots[0]
    assert arena.cols["wid"][s] == 17
    assert arena.cols["pace"][s] == 1.0 and arena.cols["alive"][s]
    assert arena.cols["pending_task"][s] == -1


def test_history_ring_bounds_memory_but_counts_everything():
    h = History(window=10)
    for i in range(25):
        h.append_arrival({"outer_step": i + 1})
    assert len(h.arrivals) == 10
    assert h.arrivals[0]["outer_step"] == 16       # the oldest kept
    assert h.total_arrivals == 25
    assert History().window == HISTORY_WINDOW == jengine.HISTORY_WINDOW


# ---------------------------------------------------------------------------
# Hogwild ramp-up and committed pace traces
# ---------------------------------------------------------------------------

def test_batch_rampup_token_accounting():
    """The ramp trains more tokens on the same arrivals, bounded by the
    target batch; each round's batch follows Python's round half to even,
    as the reference's, and equals the golden's token count."""
    scn = registry.get_scenario("hogwild_rampup")
    eng_r = scn.build(device="cpu")
    eng_b = scn.overridden(name="_flat", batch_rampup=None).build(device="cpu")
    batches = []
    execute = eng_r._execute
    eng_r._execute = lambda task: batches.append(task.batch_size) or \
        execute(task)
    # the golden's eval cadence caps the batches (and so the arrivals)
    eng_r.run(eval_every=scn.eval_cadence)
    eng_b.run(eval_every=scn.eval_cadence)
    hr, hb = eng_r.history, eng_b.history
    flat = hb.total_arrivals * scn.inner_steps * scn.batch_size * scn.seq_len
    assert hb.tokens == flat and hr.total_arrivals == hb.total_arrivals
    cap = hr.total_arrivals * scn.inner_steps * scn.batch_rampup * scn.seq_len
    assert flat < hr.tokens <= cap
    assert hr.tokens == run.load_golden("hogwild_rampup")["tokens"]
    assert set(batches) <= set(range(scn.batch_size, scn.batch_rampup + 1))
    assert len(set(batches)) > 1


def test_pace_trace_drives_paces_and_churn():
    scn = registry.get_scenario("trace_paced")
    tr = load_pace_trace(scn.pace_trace)
    assert tr == jload_pace_trace(scn.pace_trace)
    assert scn.paces == jregistry.get_scenario("trace_paced").paces == \
        tuple(tr["paces"][i % len(tr["paces"])] for i in range(scn.n_workers))
    assert scn.run_config().commit_batch == 4
    eng = scn.build(device="cpu")
    m = jregistry.get_scenario("trace_paced").materialize()
    assert [f.__dict__ for f in eng.failures] == \
        [f.__dict__ for f in m.failures]
    assert [e.__dict__ for e in eng.elastic] == [e.__dict__ for e in m.elastic]
    assert any(f.wid == 4 for f in eng.failures)   # from the trace file
    acts = {(e.action, e.wid) for e in eng.elastic}
    assert ("join", 11) in acts and ("leave", 6) in acts


def test_launcher_commit_batch_flag_overrides_the_scenario():
    args = train.parse_args(["--scenario", "fedbuff", "--commit-batch", "4"])
    assert args.commit_batch == 4
    cli = train.scenario_from_args(train.parse_args(
        ["--smoke", "--commit-batch", "3"]))
    assert cli.commit_batch == 3 and not cli.unported_axes()


# ---------------------------------------------------------------------------
# Whole runs: the batched scenarios and baselines against live reference
# runs from the same bits
# ---------------------------------------------------------------------------

LIVE = {"hogwild_rampup": {}, "trace_paced": {},
        "fedbuff": {"commit_batch": 4}, "delayed_nesterov":
        {"commit_batch": 4}, "dcasgd": {"commit_batch": 4}}


@pytest.mark.parametrize("name", sorted(LIVE))
def test_batched_run_matches_live_reference(name):
    """Arrivals, tokens, comm_bytes and final time equal; the flushes fuse
    the same arrivals; evals and final parameters inside check_live's
    bands."""
    jeng, jhist, eng, hist = _live(name, **LIVE[name])
    check_live(jeng, jhist, eng, hist)
    assert (hist.tokens, hist.comm_bytes, hist.final_time) == \
        (jhist.tokens, jhist.comm_bytes, jhist.final_time)
    assert eng.server.flush_totals == jeng.server.flush_totals
    assert eng.server.flush_totals["fused"] >= 2
    if not LIVE[name]:
        golden = run.load_golden(name)
        assert run.arrival_rows(hist) == golden["arrivals"]
        assert (hist.tokens, hist.comm_bytes, hist.final_time) == \
            (golden["tokens"], golden["comm_bytes"], golden["final_time"])
