"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one. The file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: p'/m'(/b') of the fused updates bit for bit (the source is
built with --fmad=false, so each product and sum rounds as in PyTorch), and
of the K-stacked multi sweeps bit for bit against their plain versions and
against K back-to-back launches of the single-arrival kernel; the
int8 sweeps bit for bit (a max is exact in any order; quantize is one IEEE
division and round half to even, dequantize one product);
per-row and per-block sums, which the kernel adds in a shuffle tree, each
within 1e-5 of its own scale: sqrt(uu*vv) for a dot product, the value
itself for a sum of squares. The per-leaf kernels (csrc/leaf.cu) are held
the same way: correct_apply and outer_update bit for bit, block_stats
within 1e-5 of its own scale. The per-tensor int8 kernels (csrc/quantize.cu)
bit for bit (a max is exact in any order; the IEEE quotient, or x times
the rounded 1/s where that rounds alike, and a round half to even; one
product back). flash_attention_fwd
(csrc/flash_attention.cu) within the reference's own bands of its plain
version: 2e-5 in fp32, 2e-2 in bf16 (tests/test_kernels.py:125-160); a
full-width prefill's logits within 2e-2 of their largest |value| of the
plain path's (tests/test_torch_serve.py's bf16 bound); each attention
family's smoke-width prefill within 1e-4 (logits) and 1e-5 (caches) of
their largest |value| of the CPU port's, fp32 on both sides. Checkpoints: a
state saved from the card restores to the card bit for bit, with the hash
of the same bits saved from the CPU; a full-width run checkpointed at 6
and resumed to 12 on the card has the arrivals of the same save and
resume on the CPU at smoke width. Worker processes on the card
(``transport="socket"``): the golden's arrivals and the final parameters
within ``trace._cmp_fingerprint``'s band (rtol 1e-5, atol 1e-6) of the
card's sim twin. Span tracing (``repro_torch.obs.spans``): a traced
full-width run ends in the untraced run's digest with the same launches; a
device span lasts at least the device work it queued (a host span only its
enqueue); the untraced path makes no CUDA event and no synchronise.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import HeLoCoConfig
from repro_torch import kernels
from repro_torch.core import compression, packing
from repro_torch.kernels import heloco_correct as hk
from repro_torch.kernels import outer_update as ok
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import packed as pk
from repro_torch.kernels import quantize as qk

H = HeLoCoConfig()


def block_branches(delta, momentum, h, stacked_axes=None, use_kernel=False):
    """Alg. 2's branch of every block, by path (an int8 (L,) tensor: 0
    keep, 1 anti, 2 weak, 3 degenerate): the cosine as the plain path computes it
    (``core.heloco``: normalized vectors, then their dot), or with
    ``use_kernel`` as the kernel path does (``block_stats``' sums, then
    ``branch_scalars``' cosine). It says whether the two paths took the
    same branch, which their outputs alone do not show."""
    stacked_axes = stacked_axes or {}
    out = {}
    for k, d in delta.items():
        blocks = int(np.prod(d.shape[:int(stacked_axes.get(k, 0))]))
        u = d.float().reshape(blocks, -1)
        v = momentum[k].float().reshape(blocks, -1)
        if use_kernel:
            dot, uu, vv = hk.block_stats(u.contiguous(),
                                         v.contiguous()).unbind(1)
            nu, nv = torch.sqrt(uu), torch.sqrt(vv)
            c = dot / torch.clamp_min(nu * nv, h.eps * h.eps)
        else:
            nu = torch.linalg.vector_norm(u, dim=1)
            nv = torch.linalg.vector_norm(v, dim=1)
            c = ((u / torch.clamp_min(nu, h.eps)[:, None])
                 * (v / torch.clamp_min(nv, h.eps)[:, None])).sum(1)
        code = torch.where(c >= h.c_ok, 0, torch.where(c < 0.0, 1, 2))
        code = torch.where((nu < h.eps) | (nv < h.eps), 3, code)
        out[k] = code.to(torch.int8)
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _layout(rows_per_leaf):
    return packing.build_layout(
        {f"leaf{i:02d}": torch.empty(r * 128 - 5) for i, r in
         enumerate(rows_per_leaf)})


def _buffers(layout, dev, n, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((layout.n_rows, 128), generator=gen, device=dev)
            for _ in range(n)]


def _close_sums(got, want):
    """Rows of (dot, uu, vv[, more sums of squares]), each entry within 1e-5
    of its own scale: sqrt(uu * vv) for the dot, itself for the others."""
    got, want = got.double().cpu(), want.double().cpu()
    scale = want.abs()
    scale[:, 0] = (want[:, 1] * want[:, 2]).sqrt()
    bad = ((got - want).abs() > 1e-5 * scale).nonzero()
    assert not len(bad), (f"{len(bad)} sums off, first at {bad[0].tolist()}: "
                          f"got {got[tuple(bad[0])]} want {want[tuple(bad[0])]}")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(1,), (3, 1, 33), (2048, 5, 2049)])
def test_row_stats_and_block_stats_match_plain(cuda, rows):
    layout = _layout(rows)
    d, m = _buffers(layout, cuda, 2)
    n0 = pk.packed_row_stats.launches
    got = pk.packed_row_stats(d, m)
    torch.cuda.synchronize()
    assert pk.packed_row_stats.launches == n0 + 1
    _close_sums(got, pk.packed_row_stats_ref(d, m))
    blocks = pk.packed_stats(d, m, layout)
    assert torch.equal(blocks, pk.packed_stats(d, m, layout))
    _close_sums(blocks.cpu(), pk.packed_stats(d.cpu(), m.cpu(), layout))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(1,), (3, 1, 33), (2048, 5, 2049)])
def test_correct_outer_bit_identical_to_plain(cuda, rows):
    layout = _layout(rows)
    p, m, d = _buffers(layout, cuda, 3, seed=1)
    cu, cv = pk.branch_scalars(pk.packed_stats(d, m, layout), H)
    rb, _ = layout.device_tables(cuda)
    want = pk.packed_correct_outer_ref(p, m, d, cu, cv, rb, 0.7, 0.9, 0.5,
                                       with_stats=True)
    n0 = pk.packed_correct_outer.launches
    p1, m1 = pk.packed_correct_outer(p, m, d, cu, cv, rb, 0.7, 0.9, 0.5)
    p2, m2, s = pk.packed_correct_outer(p, m, d, cu, cv, rb, 0.7, 0.9, 0.5,
                                        with_stats=True)
    torch.cuda.synchronize()
    assert pk.packed_correct_outer.launches == n0 + 2
    assert torch.equal(p1, want[0]) and torch.equal(m1, want[1])
    assert torch.equal(p2, p1) and torch.equal(m2, m1)
    _close_sums(s, want[2])
    pk.packed_correct_outer(p, m, d, cu, cv, rb, 0.7, 0.9, 0.5, out=(p, m))
    torch.cuda.synchronize()
    assert torch.equal(p, p1) and torch.equal(m, m1)


# (am, bm, ab, cg, cm, ca): a delayed-Nesterov boundary and a FedBuff
# non-boundary arrival (cg = 0: the parameters come back unchanged)
ACC_TABLES = {"dn_boundary": (0.9, 0.025, 0.0, 1.0, 0.9, 0.0),
              "fedbuff_hold": (1.0, 0.0, 1.0, 0.0, 0.0, 0.0)}


def _coeffs(layout, dev, seed=2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = layout.n_blocks
    return (torch.rand(n, generator=gen, device=dev) + 0.5,
            torch.rand(n, generator=gen, device=dev) - 0.5,
            -0.3 * torch.rand(n, generator=gen, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(1,), (3, 1, 33), (2048, 5, 2049)])
def test_correct_outer_quad_bit_identical_to_plain(cuda, rows):
    layout = _layout(rows)
    p, m, d = _buffers(layout, cuda, 3, seed=3)
    cu, cv, cq = _coeffs(layout, cuda)
    rb, _ = layout.device_tables(cuda)
    args = (cu, cv, cq, rb, 0.07, 0.9, 0.5)
    want = pk.packed_correct_outer_quad_ref(p, m, d, *args, with_stats=True)
    n0 = pk.packed_correct_outer_quad.launches
    p1, m1 = pk.packed_correct_outer_quad(p, m, d, *args)
    p2, m2, s = pk.packed_correct_outer_quad(p, m, d, *args, with_stats=True)
    torch.cuda.synchronize()
    assert pk.packed_correct_outer_quad.launches == n0 + 2
    assert torch.equal(p1, want[0]) and torch.equal(m1, want[1])
    assert torch.equal(p2, p1) and torch.equal(m2, m1)
    _close_sums(s, want[2])
    pk.packed_correct_outer_quad(p, m, d, *args, out=(p, m))
    torch.cuda.synchronize()
    assert torch.equal(p, p1) and torch.equal(m, m1)


@pytest.mark.cuda
@pytest.mark.parametrize("table", sorted(ACC_TABLES))
@pytest.mark.parametrize("rows", [(1,), (3, 1, 33), (2048, 5, 2049)])
def test_correct_outer_acc_bit_identical_to_plain(cuda, rows, table):
    layout = _layout(rows)
    p, m, b, d = _buffers(layout, cuda, 4, seed=4)
    cu, cv, _ = _coeffs(layout, cuda)
    rb, _ = layout.device_tables(cuda)
    args = (cu, cv, rb, 0.7, 0.5, *ACC_TABLES[table])
    want = pk.packed_correct_outer_acc_ref(p, m, b, d, *args, with_stats=True)
    n0 = pk.packed_correct_outer_acc.launches
    got = pk.packed_correct_outer_acc(p, m, b, d, *args)
    stats = pk.packed_correct_outer_acc(p, m, b, d, *args, with_stats=True)
    torch.cuda.synchronize()
    assert pk.packed_correct_outer_acc.launches == n0 + 2
    assert all(torch.equal(g, w) for g, w in zip(got, want[:3]))
    assert all(torch.equal(g, w) for g, w in zip(stats[:3], got))
    _close_sums(stats[3], want[3])
    if table == "fedbuff_hold":
        assert torch.equal(got[0], p)
    pk.packed_correct_outer_acc(p, m, b, d, *args, out=(p, m, b))
    torch.cuda.synchronize()
    assert all(torch.equal(x, g) for x, g in zip((p, m, b), got))


def _quant_inputs(layout, dev, seed=5):
    """N(0, 1) values, with block 0 on exact .5 ties at scale 0.5 and block
    1 all zero; per-block scales from the blocks' absmax, one of them cut
    so that x / s leaves [-127, 127] (the clip)."""
    (x,) = _buffers(layout, dev, 1, seed=seed)
    (s0, e0), (s1, e1) = layout.block_row_ranges[:2]
    ties = (torch.arange(-64, 64, device=dev, dtype=torch.float32) + 0.5) * 0.5
    x[s0:e0] = ties
    x[s0, 0] = 63.5
    x[s1:e1] = 0.0
    scale = compression.block_scales(x, layout)
    scale[-1] *= 0.25
    return x, scale, layout.device_tables(dev)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(1, 1, 1), (3, 1, 33), (2048, 5, 2049)])
def test_int8_kernels_bit_identical_to_plain(cuda, rows):
    layout = _layout(rows)
    x, scale, rb = _quant_inputs(layout, cuda)
    assert scale[0].item() == 0.5
    n0 = [f.launches for f in (pk.packed_rowabs, pk.packed_quant,
                               pk.packed_dequant)]
    absmax = pk.packed_rowabs(x)
    q = pk.packed_quant(x, scale, rb)
    dec = pk.packed_dequant(q, scale, rb)
    torch.cuda.synchronize()
    assert [f.launches for f in (pk.packed_rowabs, pk.packed_quant,
                                 pk.packed_dequant)] == [n + 1 for n in n0]
    assert torch.equal(absmax, pk.packed_rowabs_ref(x))
    assert torch.equal(q, pk.packed_quant_ref(x, scale, rb))
    assert torch.equal(dec, pk.packed_dequant_ref(q, scale, rb))
    # round half to even on the ties, and the clip of the cut block
    (s0, e0) = layout.block_row_ranges[0]
    assert torch.equal(q[s0, 1:9].cpu(), torch.tensor(
        [-62, -62, -60, -60, -58, -58, -56, -56], dtype=torch.int8))
    s_last, e_last = layout.block_row_ranges[-1]
    assert (q[s_last:e_last].abs() == 127).any()
    assert q.abs().max().item() == 127


@pytest.mark.cuda
def test_true_div_is_ieee_division_on_the_card(cuda):
    """``packing.true_div`` divides by a 0-d tensor on the device and
    gives the CPU's IEEE quotients bit for bit (PyTorch's CUDA division by
    a Python scalar multiplies by the reciprocal instead)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(1 << 20, generator=gen, device=cuda) * 3
    for c in (127.0, 3.0, 7.0):
        assert torch.equal(packing.true_div(x, c).cpu(), x.cpu() / c)


@pytest.mark.cuda
def test_rowabs_propagates_nan(cuda):
    layout = _layout((3, 2))
    (x,) = _buffers(layout, cuda, 1, seed=6)
    x[1, 17] = float("nan")
    absmax = pk.packed_rowabs(x)
    torch.cuda.synchronize()
    assert torch.isnan(absmax[1, 0]) and not torch.isnan(
        torch.cat([absmax[:1], absmax[2:]])).any()
    keep = torch.ones(layout.n_rows, dtype=torch.bool, device=cuda)
    keep[1] = False
    assert torch.equal(absmax[keep], pk.packed_rowabs_ref(x)[keep])


@pytest.mark.cuda
def test_kernels_refuse_mixed_devices(cuda):
    layout = _layout((2,))
    d, m = _buffers(layout, cuda, 2)
    with pytest.raises(ValueError):
        pk.packed_row_stats(d, m.cpu())
    cu = torch.ones(layout.n_blocks, device=cuda)
    rb = torch.from_numpy(layout.row_block)        # on the CPU
    with pytest.raises(ValueError):
        pk.packed_correct_outer(d, m, d, cu, cu, rb, 0.7, 0.9, 1.0)
    with pytest.raises(ValueError):
        pk.packed_correct_outer_quad(d, m, d, cu, cu, cu, rb, 0.07, 0.9, 1.0)
    with pytest.raises(ValueError):
        pk.packed_correct_outer_acc(d, m, d.cpu(), d, cu, cu,
                                    layout.device_tables(cuda)[0], 0.7, 1.0,
                                    *ACC_TABLES["dn_boundary"])


# (am, bm, ab, cg, cm, ca) per delta of a multi accumulator sweep:
# delayed-Nesterov non-boundary rows with a boundary in the second slot
DN_HOLD = (1.0, 0.0, 1.0, 1.0, 0.9, 0.0)


def _multi_table(k):
    rows = [DN_HOLD] * k
    rows[1] = ACC_TABLES["dn_boundary"]
    return [list(col) for col in zip(*rows)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("kernel", ["plain", "quad", "acc"])
@pytest.mark.parametrize("rows", [(1,), (3, 1, 33), (2048, 5, 2049)])
def test_multi_sweeps_bit_identical_to_plain_and_sequential(cuda, rows,
                                                            kernel, k):
    layout = _layout(rows)
    p, m, b = _buffers(layout, cuda, 3, seed=8)
    d = torch.stack(_buffers(layout, cuda, k, seed=9))
    cu, cv, cq = (torch.stack(c) for c in zip(*[_coeffs(layout, cuda, seed=s)
                                                for s in range(11, 11 + k)]))
    rb, _ = layout.device_tables(cuda)
    rhos = [0.5 / np.sqrt(1.0 + j) for j in range(k)]
    if kernel == "plain":
        state = (p, m)
        multi, ref = pk.packed_multi_correct_outer, \
            pk.packed_multi_correct_outer_ref
        args = (d, cu, cv, rb, 0.7, 0.9, rhos)

        def single(j, *s):
            return pk.packed_correct_outer(*s, d[j], cu[j], cv[j], rb, 0.7,
                                           0.9, rhos[j])
    elif kernel == "quad":
        state = (p, m)
        multi, ref = pk.packed_multi_correct_outer_quad, \
            pk.packed_multi_correct_outer_quad_ref
        args = (d, cu, cv, cq, rb, 0.07, 0.9, rhos)

        def single(j, *s):
            return pk.packed_correct_outer_quad(*s, d[j], cu[j], cv[j], cq[j],
                                                rb, 0.07, 0.9, rhos[j])
    else:
        state = (p, m, b)
        table = _multi_table(k)
        multi, ref = pk.packed_multi_correct_outer_acc, \
            pk.packed_multi_correct_outer_acc_ref
        args = (d, cu, cv, rb, 0.7, rhos, *table)

        def single(j, *s):
            return pk.packed_correct_outer_acc(*s, d[j], cu[j], cv[j], rb, 0.7,
                                               rhos[j], *(c[j] for c in table))
    want = ref(*state, *args, with_stats=True)
    n0 = multi.launches
    got = multi(*state, *args)
    stats = multi(*state, *args, with_stats=True)
    seq = state
    for j in range(k):
        seq = single(j, *seq)
    torch.cuda.synchronize()
    assert multi.launches == n0 + 2
    n = len(state)
    assert all(torch.equal(g, w) for g, w in zip(got, want[:n]))
    assert all(torch.equal(g, w) for g, w in zip(stats[:n], got))
    assert all(torch.equal(g, w) for g, w in zip(got, seq))
    assert stats[n].shape == (k, layout.n_rows, pk.N_MOMENTS)
    _close_sums(stats[n].reshape(-1, 4), want[n].reshape(-1, 4))
    copies = tuple(t.clone() for t in state)
    multi(*copies, *args, out=copies)
    torch.cuda.synchronize()
    assert all(torch.equal(c, g) for c, g in zip(copies, got))


def _close_gram(got, want, k):
    """(R or B, P) pair sums, each within 1e-5 of sqrt(G_aa * G_bb)."""
    pairs = pk.gram_pairs(k)
    got, want = got.double().cpu(), want.double().cpu()
    diag = {a: want[:, c] for c, (a, b) in enumerate(pairs) if a == b}
    scale = torch.stack([(diag[a] * diag[b]).sqrt() for a, b in pairs], 1)
    bad = ((got - want).abs() > 1e-5 * scale).nonzero()
    assert not len(bad), f"{len(bad)} sums off, first at {bad[0].tolist()}"


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 4, 8])
@pytest.mark.parametrize("rows", [(1,), (3, 1, 33), (2048, 5, 2049)])
def test_multi_gram_matches_plain(cuda, rows, k):
    layout = _layout(rows)
    m, *ds = _buffers(layout, cuda, 1 + k, seed=12)
    d = torch.stack(ds)
    n0 = pk.packed_multi_gram.launches
    got = pk.packed_multi_gram(m, d)
    torch.cuda.synchronize()
    assert pk.packed_multi_gram.launches == n0 + 1
    assert got.shape == (layout.n_rows, (k + 1) * (k + 2) // 2)
    _close_gram(got, pk.packed_multi_gram_ref(m, d), k)
    blocks = pk.multi_gram_blocks(m, d, layout)
    assert torch.equal(blocks, pk.multi_gram_blocks(m, d, layout))
    want = pk.multi_gram_blocks(m.cpu(), d.cpu(), layout)
    pairs = pk.gram_pairs(k)
    _close_gram(torch.stack([blocks[:, a, c] for a, c in pairs], 1),
                torch.stack([want[:, a, c] for a, c in pairs], 1), k)
    assert torch.equal(blocks, blocks.transpose(1, 2))


@pytest.mark.cuda
def test_multi_gram_refuses_more_than_its_instantiations(cuda):
    layout = _layout((2,))
    m, *ds = _buffers(layout, cuda, 1 + pk.MAX_GRAM_K + 1)
    with pytest.raises(ValueError, match="1..8"):
        pk.packed_multi_gram(m, torch.stack(ds))


# kernel launches per arrival (per barrier round for sync_baseline); a
# crashed worker's lost round launches nothing
LAUNCHES = {
    "paper_hetero_severe": {"packed_row_stats": 1, "packed_correct_outer": 1},
    "drop_stale": {"packed_row_stats": 1, "packed_correct_outer": 1},
    "dcasgd": {"packed_correct_outer_quad": 1},
    "delayed_nesterov": {"packed_correct_outer_acc": 1},
    "fedbuff": {"packed_correct_outer_acc": 1},
    "poly_stale": {"packed_correct_outer": 1},
    "sync_baseline": {"packed_correct_outer": 1},
    "noniid_dirichlet": {"packed_row_stats": 1, "packed_correct_outer": 1},
    "crash_rejoin": {"packed_row_stats": 1, "packed_correct_outer": 1},
    "elastic_membership": {"packed_row_stats": 1, "packed_correct_outer": 1},
    "int8_dylu": {"packed_row_stats": 1, "packed_correct_outer": 1,
                  "packed_rowabs": 1, "packed_quant": 1, "packed_dequant": 1},
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_smoke_scenario_on_the_card_matches_golden(cuda, name):
    from repro_torch.scenarios import registry, run
    scn = registry.get_scenario(name)
    kernels.reset_launch_counts()
    eng, hist = run.run(scn, "cuda")
    assert run.compare(scn, hist) == []
    applied = sum(not a["dropped"] for a in hist.arrivals)
    want = {k: LAUNCHES[name].get(k, 0) * applied
            for k in kernels.launch_counts()}
    assert kernels.launch_counts() == want
    assert eng.server._pbuf.device.type == "cuda"
    assert all(np.isfinite(e["mean"]) for e in hist.evals)


# the batched scenarios: an arrival committed on its own launches the
# single-arrival kernels, a fused run of K >= 2 arrivals one multi-Gram and
# one multi sweep, whatever K
@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hogwild_rampup", "trace_paced"])
def test_batched_scenario_on_the_card_matches_golden(cuda, name):
    from repro_torch.async_engine.engine import make_eval_fn
    from repro_torch.scenarios import registry, run
    scn = registry.get_scenario(name)
    eng = scn.build(device="cuda")
    runs = []
    step = eng.server._step_update_multi

    def fused(deltas, rhos, taus):
        before = kernels.launch_counts()
        step(deltas, rhos, taus)
        after = kernels.launch_counts()
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == {"packed_multi_gram": 1,
                                              "packed_multi_correct_outer": 1}
        runs.append(len(deltas))

    eng.server._step_update_multi = fused
    kernels.reset_launch_counts()
    hist = eng.run(eval_every=scn.eval_cadence,
                   eval_fn=make_eval_fn(eng, batch=scn.eval_batch))
    assert run.compare(scn, hist) == []
    alone = len(hist.arrivals) - sum(runs)
    assert runs and min(runs) >= 2
    want = {k: 0 for k in kernels.launch_counts()}
    want.update(packed_row_stats=alone, packed_correct_outer=alone,
                packed_multi_gram=len(runs),
                packed_multi_correct_outer=len(runs))
    assert kernels.launch_counts() == want
    assert eng.server._pbuf.device.type == "cuda"


# ---------------------------------------------------------------------------
# The per-leaf kernels (csrc/leaf.cu)
# ---------------------------------------------------------------------------

# (L, n): one block and stacked ones, n odd, around one 16-element unit of
# the elementwise sweeps' body (15-17), around the 4096 of a statistics
# chunk, and stacked blocks whose boundaries fall inside a float4 (4097,
# 128003), up to tinygpt-15m's embedding leaf (50257 x 256)
LEAF_SHAPES = [(1, 7), (1, 15), (1, 16), (1, 17), (1, 1023), (1, 1025),
               (4, 4097), (3, 128_003), (1, 12_865_792)]


def _leaf_tensors(shape, dev, n, seed=0, offset=0):
    """n random (L, n) fp32 tensors; with an offset, views that many
    elements into their storage (not 16-byte aligned for 1-3)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    size = shape[0] * shape[1]
    return [torch.randn(size + offset, generator=gen, device=dev)[offset:]
            .view(shape) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LEAF_SHAPES)
def test_block_stats_matches_plain(cuda, shape):
    u, v = _leaf_tensors(shape, cuda, 2)
    n0 = hk.block_stats.launches
    got = hk.block_stats(u, v)
    again = hk.block_stats(u, v)
    torch.cuda.synchronize()
    assert hk.block_stats.launches == n0 + 2
    assert got.shape == (shape[0], 3) and torch.equal(got, again)
    _close_sums(got, hk.block_stats_ref(u, v))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", LEAF_SHAPES)
def test_correct_apply_bit_identical_to_plain(cuda, shape, offset):
    """Every block its own (cu, cv); a float4 of the body that straddles
    two blocks (n % 4 != 0) must take each element's own."""
    u, v = _leaf_tensors(shape, cuda, 2, seed=1, offset=offset)
    gen = torch.Generator(device=cuda).manual_seed(2)
    cu = torch.rand(shape[0], generator=gen, device=cuda) + 0.5
    cv = torch.rand(shape[0], generator=gen, device=cuda) - 0.5
    assert len(set(cu.tolist())) == len(set(cv.tolist())) == shape[0]
    n0 = hk.correct_apply.launches
    got = hk.correct_apply(u, v, cu, cv)
    torch.cuda.synchronize()
    assert hk.correct_apply.launches == n0 + 1
    assert torch.equal(got, hk.correct_apply_ref(u, v, cu, cv))


@pytest.mark.cuda
@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", LEAF_SHAPES)
def test_outer_update_bit_identical_to_plain(cuda, shape, offset, in_place):
    """New outputs, or in place: out=(p, m), each element read and then
    written by one thread."""
    p, m, g = _leaf_tensors(shape, cuda, 3, seed=3, offset=offset)
    want = ok.outer_update_2d_ref(p, m, g, 0.7, 0.9, 0.447)
    n0 = ok.outer_update_2d.launches
    got = ok.outer_update_2d(p, m, g, 0.7, 0.9, 0.447,
                             out=(p, m) if in_place else None)
    torch.cuda.synchronize()
    assert ok.outer_update_2d.launches == n0 + 1
    assert (got[0].data_ptr() == p.data_ptr()) == in_place
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_per_leaf_heloco_arrival_launches_two_kernels_a_leaf(cuda):
    """One arrival on a per-leaf kernel server launches block_stats and
    correct_apply once per leaf, stacked or not, and no other kernel; its
    state stays on the card and within 3e-5 of the packed server's."""
    from repro_torch.async_engine.server import Synchronizer
    from repro_torch.configs.base import OuterOptConfig
    gen = torch.Generator(device=cuda).manual_seed(4)
    shapes = {"emb": (40, 30), "layers/w": (3, 4, 5), "layers/b": (3, 5),
              "norm": (129,)}
    init = {k: torch.randn(s, generator=gen, device=cuda)
            for k, s in shapes.items()}
    stacked = {"layers/w": 1, "layers/b": 1}
    leaf = Synchronizer(init, OuterOptConfig(), 4, stacked_axes=stacked,
                        use_kernel=True, packed=False)
    packed = Synchronizer(init, OuterOptConfig(), 4, stacked_axes=stacked)
    for step in range(3):
        delta = {k: 0.01 * torch.randn(s, generator=gen, device=cuda)
                 for k, s in shapes.items()}
        kernels.reset_launch_counts()
        leaf.on_arrival(delta, step, 0)
        counts = kernels.launch_counts()
        packed.on_arrival(delta, step, 0)
        want = {k: 0 for k in counts}
        want.update(block_stats=len(shapes), correct_apply=len(shapes))
        assert counts == want
    got, ref = leaf.state, packed.state
    for k in shapes:
        assert got.params[k].device.type == "cuda"
        torch.testing.assert_close(got.params[k], ref.params[k], rtol=3e-5,
                                   atol=3e-5)
        torch.testing.assert_close(got.momentum[k], ref.momentum[k],
                                   rtol=3e-5, atol=3e-5)


# ---------------------------------------------------------------------------
# per-tensor int8 (csrc/quantize.cu)
# ---------------------------------------------------------------------------

def _int8_input(case, n, dev):
    gen = torch.Generator(device=dev).manual_seed(n)
    x = 3.0 * torch.randn(n + 1, generator=gen, device=dev)
    if case == "ties":
        k = min(n, 128)
        x[:k] = (torch.arange(k, device=dev, dtype=torch.float32) - 64 + 0.5) \
            * 0.5
        x[0] = 63.5
    elif case == "zero":
        x.zero_()
    elif case == "nan":
        x[n // 2] = float("nan")
    # "unaligned": a view one element in, so the kernels take no vector body
    return x[1:] if case == "unaligned" else x[:n]


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "ties", "zero", "nan",
                                  "unaligned"])
@pytest.mark.parametrize("n", [1, 7, 15, 16, 17, 4096, 4099, 1_000_003,
                               4_800_015, 4_800_017, 12_865_792])
def test_per_tensor_int8_kernels_bit_identical_to_plain(cuda, n, case):
    """The edges of the vector body's 16-element units (15, 16, 17), runs
    of 16k +- 1 elements longer than one wave of the grid (4,325,376
    elements on 132 SMs), the embedding's length; dequantize_2d also on q
    offset by 1, 2 and 3 bytes (no vector body)."""
    x = _int8_input(case, n, cuda)
    n0 = (qk.absmax.launches, qk.quantize_2d.launches,
          qk.dequantize_2d.launches)
    amax = qk.absmax(x)
    q, s = qk.quantize_2d(x, amax)
    back = qk.dequantize_2d(q, s)
    clipped = qk.quantize_2d(x, torch.full((1,), 1.0, device=cuda))
    torch.cuda.synchronize()
    assert (qk.absmax.launches, qk.quantize_2d.launches,
            qk.dequantize_2d.launches) == (n0[0] + 1, n0[1] + 2, n0[2] + 1)
    assert _same(amax, qk.absmax_ref(x))
    want_q, want_s = qk.quantize_2d_ref(x)
    assert _same(q, want_q) and _same(s, want_s)
    assert _same(back, qk.dequantize_2d_ref(want_q, want_s))
    for a, b in zip(clipped, qk.quantize_2d_ref(
            x, torch.full((1,), 1.0, device=cuda))):
        assert _same(a, b)
    if case == "ties" and n >= 128:
        assert s.item() == 0.5 and q[1:5].tolist() == [-62, -62, -60, -60]
    padded = torch.cat([q, torch.zeros(3, dtype=torch.int8, device=cuda)])
    for off in (1, 2, 3):
        view = padded[off:off + n]
        assert _same(qk.dequantize_2d(view, s), qk.dequantize_2d_ref(view, s))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.37, 1.0 / 3.0, 0.0123, 7.77e-9])
def test_quantize_2d_near_half_integer_quotients(cuda, scale):
    """quantize_2d's body rounds x * (1/s) and leaves the IEEE division to
    the quotients within |q0| * 2^-21 of a half-integer: near every one,
    in the body and on the element path (x offset by one), bit for bit."""
    x = qk.near_half_quotients(scale, cuda, random=1 << 20)
    amax = torch.full((1,), 127.0 * scale, device=cuda)
    for t in (x, x[1:]):
        got, want = qk.quantize_2d(t, amax), qk.quantize_2d_ref(t, amax)
        torch.cuda.synchronize()
        assert _same(got[0], want[0]) and _same(got[1], want[1])


# ---------------------------------------------------------------------------
# flash_attention_fwd (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("shape", [
    (3, 256, 256), (2, 200, 200), (2, 128, 384), (2, 320, 320),
    (2, 1000, 1000), (2, 200, 1000), (2, 1000, 200), (16, 2048, 2048),
    (2, 1, 300), (40, 1000, 1000), (70, 200, 1000)],
    ids=["square", "ragged", "rectangular", "odd_kv_tiles", "ragged_1000",
         "sq_lt_skv", "sq_gt_skv", "multi_wave", "one_row",
         "multi_wave_ragged", "multi_wave_sq_lt_skv"])
def test_flash_attention_matches_plain(cuda, shape, d, dtype, causal):
    """The kernel's edges: an odd number of kv tiles (the two warpgroups get
    unequal halves), ragged Sq and Skv, causal with Sq < Skv and Sq > Skv,
    grids of more than one wave (bf16 D = 128 there takes 128-row q tiles,
    one per warpgroup), one query row."""
    bh, sq, skv = shape
    gen = torch.Generator(device=cuda).manual_seed(d + sq)
    q = torch.randn((bh, sq, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((bh, skv, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    n0 = fa.flash_attention_fwd.launches
    got = fa.flash_attention_fwd(q, k, v, causal=causal, q_chunk=sq,
                                 kv_chunk=skv)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), fa.flash_attention_fwd_ref(
        q, k, v, causal).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_flash_attention_same_bits_twice(cuda, dtype, d):
    """The two warpgroups' states merge in a fixed order: two launches on
    the same inputs give the same bits, at a width the kernel is built for
    and at two padded ones (80 on width 128, 256 with 32-row kv tiles in
    fp32)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((4, 1000, d), generator=gen,
                           device=cuda).to(dtype) for _ in range(3))
    for causal in (True, False):
        a = fa.flash_attention_fwd(q, k, v, causal=causal, q_chunk=1000,
                                   kv_chunk=1000)
        b = fa.flash_attention_fwd(q, k, v, causal=causal, q_chunk=1000,
                                   kv_chunk=1000)
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [16, 48, 80, 144, 192, 208, 256])
@pytest.mark.parametrize("shape", [
    (3, 256, 256), (2, 200, 200), (2, 128, 384), (2, 1000, 200),
    (2, 1, 300), (64, 128, 128), (40, 1000, 1000)],
    ids=["square", "ragged", "sq_lt_skv", "sq_gt_skv", "one_row",
         "serve_shape", "multi_wave"])
def test_flash_attention_mma_route_matches_plain(cuda, shape, d, dtype,
                                                 causal):
    """The head dims the retired mma route served, now on the TMA + wgmma
    (bf16) and 3xTF32 (fp32) kernel at a padded width: every padded width
    (48 on 64, 80 on 128, 144 and 192 on 192, 208 and 256 on 256; 16 on
    32) with a dim below it, the smoke configs' 16, hubert's and zamba2's
    80, paligemma's 256; ragged Sq and Skv, causal with Sq < Skv and Sq >
    Skv, one query row, a prefill's BH of 64, and a grid of more than one
    wave."""
    bh, sq, skv = shape
    gen = torch.Generator(device=cuda).manual_seed(d + sq)
    q = torch.randn((bh, sq, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((bh, skv, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    n0 = fa.flash_attention_fwd.launches
    got = fa.flash_attention_fwd(q, k, v, causal=causal, q_chunk=sq,
                                 kv_chunk=skv)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), fa.flash_attention_fwd_ref(
        q, k, v, causal).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_does_not_run(cuda):
    for d in (24, 272):     # not a multiple of 16, or past 256
        q = torch.zeros((2, 64, d), device=cuda)
        with pytest.raises(ValueError):
            fa.flash_attention_fwd(q, q, q)
    h = torch.zeros((2, 64, 32), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(h, h, h)


@pytest.mark.cuda
def test_full_width_prefill_launches_flash_once_per_layer(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models import attention as attn_lib
    cfg = get_config("tinygpt-15m")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cuda)
    prompts = torch.randint(0, cfg.vocab_size, (2, 128),
                            generator=torch.Generator().manual_seed(1)).to(cuda)
    kernels.reset_launch_counts()
    logits, caches = model.prefill(params, prompts, 130)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = dict.fromkeys(counts, 0)
    assert counts == {**want, "flash_attention_fwd": cfg.n_layers}
    assert torch.isfinite(logits).all() and logits.dtype == torch.bfloat16
    kernels.reset_launch_counts()
    step, _ = model.decode(params, logits.argmax(-1), caches, 128)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == want and torch.isfinite(step).all()
    kernel = attn_lib.flash_attention_fwd
    attn_lib.flash_attention_fwd = (
        lambda q, k, v, *, causal=True, q_chunk=128, kv_chunk=128:
        fa.flash_attention_fwd_ref(q, k, v, causal))
    try:
        plain, _ = model.prefill(params, prompts, 130)
    finally:
        attn_lib.flash_attention_fwd = kernel
    err = (logits.float() - plain.float()).abs().max().item()
    assert err <= 2e-2 * plain.float().abs().max().item(), err


FAMILY_ARCHS = ("qwen2-7b", "granite-3-8b", "command-r-35b", "starcoder2-15b",
                "granite-moe-1b-a400m", "llama4-scout-17b-a16e",
                "hubert-xlarge", "paligemma-3b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_smoke_prefill_on_the_card(cuda, arch):
    """Each attention family at smoke width (fp32, D = 16, padded to 32):
    a prefill on the card launches flash_attention_fwd once a layer and
    nothing else, and its logits and caches are the CPU port's within 1e-4
    and 1e-5 of their largest |value| (fp32 on both sides; cuBLAS sums in
    another order than the CPU)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    cfg = get_config(arch + "-smoke")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = serve.make_inputs(cfg, 2, 24, 0, "cpu")
    want, want_caches = model.prefill(params, batch, 30)
    on_card = {k: v.to(cuda) for k, v in params.items()}
    kernels.reset_launch_counts()
    got, caches = model.prefill(on_card, {k: v.to(cuda) for k, v in
                                          batch.items()}, 30)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0),
                      "flash_attention_fwd": cfg.n_layers}
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err
    for kv in ("k", "v"):
        c = caches[kv].cpu()
        assert (c - want_caches[kv]).abs().max().item() <= \
            1e-5 * want_caches[kv].abs().max().item()


def _flat_state(tree, prefix=""):
    """A cache tree (dicts, tuples, tensors) by ``/``-joined path."""
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_state(v, f"{prefix}{k}/"))
    return out


def _tree_to(tree, device):
    """A copy of a cache tree (dicts, tuples, tensors) on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tuple(_tree_to(v, device) for v in tree)


@pytest.mark.cuda
@pytest.mark.parametrize("arch, sites", [("zamba2-2.7b", 2),
                                         ("xlstm-125m", 0)])
def test_recurrent_smoke_serving_on_the_card(cuda, arch, sites):
    """The recurrent families at smoke width (fp32): a prefill of 32 tokens
    on the card launches flash_attention_fwd once at each of zamba2's 2
    shared-block sites (xlstm never) and nothing else, and its logits are
    the plain path's (the flash kernel's plain version on the card) within
    1e-4 of their largest |value|. Then 4 greedy decode steps, each from
    the CPU port's caches of the step before, launch nothing. At the
    prefill and every step: logits within 1e-4 of their largest |value| of
    the CPU port's; every cache on the card, of the CPU's dtype, within
    1e-5 of the larger of 1 and its largest |value|; a bf16 conv window
    also within one bf16 step (2 ** -7 of the value): cuBLAS sums in
    another order, and a value near a rounding midpoint rounds to a
    neighbour. (Each step starts from the CPU's caches: a window value
    one bf16 step apart feeds the next step's keys and moves the mLSTM's
    matrix memory by ~3e-4 of its scale, so a free-running chain would
    hold the rounding of a tie, not the card's step.)"""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models import attention as attn_lib
    cfg = get_config(arch + "-smoke")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    on_card = {k: v.to(cuda) for k, v in params.items()}
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    want, want_caches = model.prefill(params, tokens, 36)
    none = dict.fromkeys(kernels.launch_counts(), 0)
    kernels.reset_launch_counts()
    got, caches = model.prefill(on_card, tokens.to(cuda), 36)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**none, "flash_attention_fwd": sites}
    kernel = attn_lib.flash_attention_fwd
    attn_lib.flash_attention_fwd = (
        lambda q, k, v, causal=True, **_: fa.flash_attention_fwd_ref(
            q, k, v, causal))
    try:
        plain, _ = model.prefill(on_card, tokens.to(cuda), 36)
    finally:
        attn_lib.flash_attention_fwd = kernel
    assert (got - plain).abs().max().item() <= \
        1e-4 * plain.abs().max().item()
    for i in range(5):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        err = (got.cpu() - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), (i, err)
        flat, want_flat = _flat_state(caches), _flat_state(want_caches)
        assert set(flat) == set(want_flat)
        for k, c in flat.items():
            w = want_flat[k]
            assert c.device.type == "cuda" and c.dtype == w.dtype, (i, k)
            diff = (c.cpu().float() - w.float()).abs()
            if k.endswith("conv"):
                diff[diff <= w.float().abs() * 2.0 ** -7] = 0
            assert diff.max().item() <= \
                1e-5 * max(1.0, w.float().abs().max().item()), (i, k)
        if i == 4:
            break
        tok = want.argmax(-1)
        start = _tree_to(want_caches, cuda)
        kernels.reset_launch_counts()
        got, caches = model.decode(on_card, tok.to(cuda), start, 32 + i)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == none
        want, want_caches = model.decode(params, tok, want_caches, 32 + i)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_recurrent_smoke_training_on_the_card_matches_golden(cuda, arch):
    """``paper_hetero_severe`` with the arch at smoke width on the card:
    the golden's arrivals (they depend only on paces and schedules), one
    packed_row_stats and one packed_correct_outer an applied arrival,
    finite evals."""
    from repro_torch.scenarios import registry, run
    scn = registry.get_scenario("paper_hetero_severe").overridden(arch=arch)
    kernels.reset_launch_counts()
    eng, hist = run.run(scn, "cuda")
    assert run.compare(scn, hist) == []
    applied = sum(not a["dropped"] for a in hist.arrivals)
    assert kernels.launch_counts() == {
        **dict.fromkeys(kernels.launch_counts(), 0),
        "packed_row_stats": applied, "packed_correct_outer": applied}
    assert all(t.device.type == "cuda"
               for t in eng.server.state.params.values())
    assert all(np.isfinite(e["mean"]) for e in hist.evals)


@pytest.mark.cuda
def test_checkpoint_from_the_card_restores_bit_for_bit(cuda, tmp_path):
    from repro_torch.checkpoint import ckpt
    gen = torch.Generator(device=cuda).manual_seed(7)
    tree = {part: {f"layer_{i:02d}/w": torch.randn((257, 33), generator=gen,
                                                  device=cuda)
                   for i in range(3)}
            for part in ("params", "momentum", "aux")}
    tree["step"] = 11
    digest = ckpt.save(str(tmp_path / "card.npz"), tree, {"t": 1})
    host = {k: ({p: t.cpu() for p, t in v.items()} if isinstance(v, dict)
                else v) for k, v in tree.items()}
    assert ckpt.save(str(tmp_path / "host.npz"), host) == digest
    like = {k: ({p: torch.zeros_like(t) for p, t in v.items()}
                if isinstance(v, dict) else 0) for k, v in tree.items()}
    got, meta = ckpt.restore(str(tmp_path / "card.npz"), like)
    assert meta == {"t": 1} and got["step"] == 11
    for part in ("params", "momentum", "aux"):
        for p, t in tree[part].items():
            assert got[part][p].device.type == "cuda"
            assert torch.equal(got[part][p], t)


def _save_and_resume(scn, device, ckpt_dir):
    """``scn`` run to 6 commits with a checkpoint every 6, then a fresh
    engine restored from it and run on to 12; the resumed run's history."""
    import dataclasses
    first = scn.build(device=device)
    first.cfg = dataclasses.replace(first.cfg, outer_steps=6)
    first.run(ckpt_every=6, ckpt_dir=str(ckpt_dir))
    eng = scn.build(device=device)
    eng.restore(str(ckpt_dir / "step_6.npz"))
    assert eng.restored_arrivals == 6
    return eng.run()


@pytest.mark.cuda
def test_full_width_resume_has_the_arrivals_of_the_cpu(cuda, tmp_path):
    from repro_torch.launch.train import FULL_WIDTH
    from repro_torch.scenarios import registry, run
    scn = registry.get_scenario("paper_hetero_severe")
    card = _save_and_resume(scn.overridden(**FULL_WIDTH), "cuda",
                            tmp_path / "card")
    cpu = _save_and_resume(scn, "cpu", tmp_path / "cpu")
    assert len(card.arrivals) == 6
    assert run.arrival_rows(card) == run.arrival_rows(cpu)
    assert card.final_time == cpu.final_time


@pytest.mark.cuda
def test_concurrent_load_from_four_threads_gives_one_handle(cuda):
    """Four threads load every source at once (building what is not built
    yet, deleting nothing): each source yields one handle."""
    import threading
    from repro_torch.kernels import _build
    barrier = threading.Barrier(4)
    got = {name: [] for name in _build.SOURCES}

    def call():
        barrier.wait()
        for name in _build.SOURCES:
            got[name].append(_build.load(name))

    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    for name, handles in got.items():
        assert len(handles) == 4 and len({id(h) for h in handles}) == 1, name


@pytest.mark.cuda
def test_wallclock_int8_worker_threads_launch_their_sweeps(cuda):
    """``int8_dylu`` on the deterministic wall-clock runtime at smoke width:
    the golden's arrivals, the server's sweeps once per applied arrival,
    and the int8 sweeps, launched from the worker threads, once per
    round."""
    from repro_torch.scenarios import registry, run
    scn = registry.get_scenario("int8_dylu").overridden(engine="wallclock")
    eng = scn.build(device="cuda")
    kernels.reset_launch_counts()
    hist = eng.run()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert run.arrival_rows(hist) == run.load_golden("int8_dylu")["arrivals"]
    rounds = eng.stats_summary()["rounds"]
    applied = sum(not a["dropped"] for a in hist.arrivals)
    want = dict.fromkeys(counts, 0)
    want.update(packed_row_stats=applied, packed_correct_outer=applied,
                packed_rowabs=rounds, packed_quant=rounds,
                packed_dequant=rounds)
    assert counts == want and rounds >= applied


@pytest.mark.cuda
@pytest.mark.parametrize("name, overrides", [
    ("wallclock_hetero", {}), ("int8_dylu", {"engine": "wallclock"})])
def test_wallclock_pins_workers_round_robin_on_several_cards(
        cuda, monkeypatch, name, overrides):
    """With more than one card, the runtime runs worker ``wid``'s rounds on
    card ``wid % n`` and commits on the engine's: the golden's arrivals,
    and the final parameters within ``_cmp_fingerprint``'s tolerance of a
    one-card sim run of the same config from the same bits."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    from repro_torch import bridge
    from repro_torch.async_engine import runtime as runtime_lib
    from repro_torch.scenarios import registry, run, trace
    scn = registry.get_scenario(name).overridden(**overrides)
    twin = scn.overridden(engine="sim", mode="deterministic", faults=None)
    sim = twin.build(device="cuda")
    init = bridge.to_numpy(sim.server.state.params)
    sim_hist = sim.run()
    seen = set()
    execute = runtime_lib.execute_round

    def on_card(task, **kw):
        dev = next(iter(task.params.values())).device
        assert dev == torch.device("cuda", torch.cuda.current_device())
        seen.add((task.wid, dev.index))
        return execute(task, **kw)

    monkeypatch.setattr(runtime_lib, "execute_round", on_card)
    eng = scn.build(device="cuda", init_params=init)
    hist = eng.run()
    torch.cuda.synchronize()
    assert run.arrival_rows(hist) == run.load_golden(name)["arrivals"]
    assert run.arrival_rows(hist) == run.arrival_rows(sim_hist)
    assert seen == {(w, w % n) for w in range(scn.n_workers)}
    assert all(t.device == torch.device("cuda", 0)
               for t in eng.server.state.params.values())
    fails = []
    trace._cmp_fingerprint(
        fails, trace.param_fingerprint(eng.server.state.params),
        trace.param_fingerprint(sim.server.state.params))
    assert fails == []


@pytest.mark.cuda
@pytest.mark.parametrize("name, overrides", [
    ("socket_hetero", {}),
    ("int8_dylu", {"engine": "wallclock", "transport": "socket"})])
def test_socket_worker_processes_on_the_card(cuda, name, overrides):
    """The deterministic runtime over worker processes on the card, at
    smoke width: the golden's arrivals, the final parameters within
    ``_cmp_fingerprint``'s tolerance of the card's sim twin from the same
    bits, the server's sweeps once per applied arrival in the parent, and
    under int8 the int8 sweeps once per round in the children (their own
    counts, reported at their graceful stop)."""
    from repro_torch import bridge
    from repro_torch.scenarios import registry, run, trace
    scn = registry.get_scenario(name).overridden(**overrides)
    twin = scn.overridden(engine="sim", mode="deterministic", faults=None,
                          transport="inproc")
    sim = twin.build(device="cuda")
    init = bridge.to_numpy(sim.server.state.params)
    sim.run()
    eng = scn.build(device="cuda", init_params=init)
    kernels.reset_launch_counts()
    hist = eng.run()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert run.arrival_rows(hist) == run.load_golden(name)["arrivals"]
    fails = []
    trace._cmp_fingerprint(
        fails, trace.param_fingerprint(eng.server.state.params),
        trace.param_fingerprint(sim.server.state.params))
    assert fails == []
    s = eng.stats_summary()
    applied = sum(not a["dropped"] for a in hist.arrivals)
    want = dict.fromkeys(counts, 0)
    want.update(packed_row_stats=applied, packed_correct_outer=applied)
    assert s["transport"] == "socket" and counts == want
    int8 = ("packed_rowabs", "packed_quant", "packed_dequant")
    assert s["child_launches"] == (
        dict.fromkeys(int8, s["rounds"]) if overrides else {})
    assert s["rounds"] >= applied


# ---------------------------------------------------------------------------
# Span tracing on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_traced_full_width_run_ends_in_the_untraced_digest(cuda):
    from repro_torch.launch.train import FULL_WIDTH
    from repro_torch.obs.spans import SpanTracer, validate_chrome_trace
    from repro_torch.scenarios import registry, run, trace
    scn = registry.get_scenario("paper_hetero_severe").overridden(
        **FULL_WIDTH)
    kernels.reset_launch_counts()
    off, _ = run.run(scn, "cuda")
    torch.cuda.synchronize()
    off_counts = kernels.launch_counts()
    tr = SpanTracer()
    kernels.reset_launch_counts()
    on, hist = run.run(scn, "cuda", tracer=tr)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == off_counts
    assert run.compare(scn, hist) == []
    assert trace.param_digest(on.server.state.params) == \
        trace.param_digest(off.server.state.params)
    doc = tr.to_chrome()
    assert validate_chrome_trace(doc) == []
    assert sum(e["name"] == "server_commit" for e in doc["traceEvents"]) \
        == len(hist.arrivals)


def _sleep_cycles_for(ms, dev):
    """Cycles of ``torch.cuda._sleep`` that hold the stream about ``ms``,
    and the device ms they took."""
    cycles = 10_000_000
    while True:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        took = a.elapsed_time(b)
        if took >= ms:
            return cycles, took
        cycles *= 2


@pytest.mark.cuda
def test_a_device_span_lasts_at_least_its_device_work(cuda):
    from repro_torch.obs.spans import SpanTracer
    cycles, dev_ms = _sleep_cycles_for(50.0, cuda)
    tr = SpanTracer()
    with tr.span("held", cat="compute"):
        torch.cuda._sleep(cycles)
    with tr.span("enqueued", cat="transport"):
        torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    dur = {e[0]: 1e3 * e[4] for e in tr._events}
    assert dur["held"] >= 0.95 * dev_ms, (dur, dev_ms)
    assert dur["enqueued"] < 0.5 * dev_ms, (dur, dev_ms)


@pytest.mark.cuda
def test_the_untraced_path_makes_no_event_and_no_synchronise(cuda,
                                                              monkeypatch):
    """A sim run on the card with the shared no-op tracer creates no CUDA
    event and calls no synchronise; traced, one event a device span."""
    from collections import Counter
    from repro_torch.obs.spans import DEVICE_CATS, SpanTracer
    from repro_torch.scenarios import registry, run
    calls = Counter()
    real_event = torch.cuda.Event

    class CountingEvent(real_event):
        def __new__(cls, *a, **k):
            calls["Event"] += 1
            return super().__new__(cls, *a, **k)

        def synchronize(self):
            calls["Event.synchronize"] += 1
            return super().synchronize()

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(torch.cuda, "Event", CountingEvent)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        counted("synchronize", torch.cuda.synchronize))
    monkeypatch.setattr(torch.cuda.Stream, "synchronize",
                        counted("Stream.synchronize",
                                torch.cuda.Stream.synchronize))
    scn = registry.get_scenario("paper_hetero_severe")
    run.run(scn, "cuda")
    assert calls == Counter()
    tr = SpanTracer()
    run.run(scn, "cuda", tracer=tr)
    device_spans = sum(e[1] in DEVICE_CATS for e in tr._events)
    assert device_spans > 0
    assert calls == Counter({"Event": device_spans,
                             "Event.synchronize": device_spans})


# ------------------------------------------------ the dist path on the card

def _dist_inputs(cfg, dev, seed=0):
    """Parameters of ``cfg`` drawn on ``dev``, a momentum per leaf of a
    cosine near 1, -1 or 0.1 to the pseudo-gradient (every branch of Alg.
    2), and two workers' trees, the arriving one theta + noise."""
    from repro_torch.models import Model
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(seed),
                             dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    mom, wp = {}, {}
    for i, (k, p) in enumerate(params.items()):
        noise = torch.randn(p.shape, generator=gen, device=dev)
        wp[k] = torch.stack([p - 0.05 * noise, p + 1e-3 * noise])
        a, b = ((1.0, 0.1), (-1.0, 0.1), (0.1, 1.0))[i % 3]
        mom[k] = 0.01 * (-a * noise + b * torch.randn(
            p.shape, generator=gen, device=dev))
    return params, mom, wp


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinygpt-15m", "granite-moe-1b-a400m-smoke"])
@pytest.mark.parametrize("int8", [False, True])
def test_outer_exchange_kernels_against_the_plain_path(cuda, arch, int8):
    """The exchange's kernel path (the default on the card) against its
    plain path on the same card: p', m' and the look-ahead within 1e-5 of
    each leaf's largest |value|, the same branch in every block, the int8
    round trip bit for bit; block_stats, correct_apply and outer_update_2d
    launched once a leaf (with int8 also absmax, quantize_2d and
    dequantize_2d) and nothing else."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import steps
    from repro_torch.launch.mesh import make_test_mesh
    cfg = get_config(arch)
    params, mom, wp = _dist_inputs(cfg, cuda)
    stacked = shd.stacked_axes_tree(params)
    kw = dict(h=H, outer_lr=0.7, mu=0.9, arriving_pod=1,
              stacked_axes=stacked, compress_int8=int8)
    mesh = make_test_mesh(multi_pod=True)
    kernels.reset_launch_counts()
    got = steps.make_outer_exchange(cfg, mesh, **kw)(params, mom, wp)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    names = ("block_stats", "correct_apply", "outer_update_2d") + (
        ("absmax", "quantize_2d", "dequantize_2d") if int8 else ())
    assert counts == {k: len(params) if k in names else 0 for k in counts}
    want = steps.make_outer_exchange(cfg, mesh, use_kernel=False, **kw)(
        params, mom, wp)
    for g, w in zip(got, want):
        for k in params:
            scale = float(w[k].abs().max()) or 1.0
            assert float((g[k].float() - w[k].float()).abs().max()) \
                <= 1e-5 * scale, k
    assert got[2][next(iter(params))].shape[0] == 2
    delta = {k: params[k].float() - wp[k][1].float() for k in params}
    if int8:
        for k, d in delta.items():
            assert torch.equal(steps.int8_roundtrip_leaf(d, use_kernel=True),
                               steps.int8_roundtrip_leaf(d)), k
        delta = {k: steps.int8_roundtrip_leaf(d) for k, d in delta.items()}
    kb = block_branches(delta, mom, H, stacked, use_kernel=True)
    pb = block_branches(delta, mom, H, stacked)
    codes = set()
    for k in kb:
        assert torch.equal(kb[k], pb[k]), k
        codes |= set(kb[k].tolist())
    assert {0, 1, 2} <= codes


@pytest.mark.cuda
def test_grad_accum_4_against_1_on_the_card(cuda):
    """granite-moe at smoke width in fp32, batch 4 x 128, dispatch groups of
    one microbatch's tokens: grad_accum=4 (the dry-run plan's) against 1 on
    the same batch, the loss within rtol 1e-5, the first moments within
    1e-4 of each leaf's largest |value|, the parameters within 5e-4 except
    where the gradient is inside that band of zero (by at most 2 lr
    there)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InnerOptConfig
    from repro_torch.dist import steps
    from repro_torch.models import Model
    cfg = get_config("granite-moe-1b-a400m-smoke")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                          group_size=128))
    inner = InnerOptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = Model(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                             cuda)
    tok = torch.randint(0, cfg.vocab_size, (4, 128), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    state = steps.init_train_state(params)
    acc, la = steps.make_train_step(cfg, inner, grad_accum=4)(state, batch)
    one, l1 = steps.make_train_step(cfg, inner)(state, batch)
    assert abs(la.item() - l1.item()) <= 1e-5 * abs(l1.item())
    for k, w in one.params.items():
        m = one.opt.mu[k]
        assert float((acc.opt.mu[k] - m).abs().max()) <= \
            1e-4 * float(m.abs().max()) + 1e-12, k
        diff = (acc.params[k] - w).abs()
        out = diff > 5e-4 * float(w.abs().max())
        assert bool((m.abs()[out] <= 1e-4 * float(m.abs().max())).all()), k
        assert bool((diff[out] <= 2 * inner.lr * (1 + inner.weight_decay
                                                  * w[out].abs()) + 1e-7)
                    .all()), k


@pytest.mark.cuda
def test_multipod_pods_stay_apart_bit_for_bit_on_the_card(cuda):
    """Two pods inside a one-card mesh with the specs placed (DTensors on
    the card, gathered for the checks): identical pods end bit for bit
    identical, different batches part, pod 0 is the single step's bits;
    the process group is gone after the mesh."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InnerOptConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import steps
    from repro_torch.launch.mesh import local_mesh, mesh_context
    from repro_torch.models import Model
    cfg = get_config("granite-moe-1b-a400m-smoke")
    inner = InnerOptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = Model(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                             cuda)
    tok = torch.randint(0, cfg.vocab_size, (2, 4, 32), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(2))
    with local_mesh(cuda) as mesh, mesh_context(mesh):
        pspecs = shd.param_specs(params, axis_sizes=mesh.axis_sizes)
        step = steps.make_multipod_train_step(cfg, inner, mesh,
                                              param_pspecs=pspecs)
        st = steps.init_train_state(params)
        same = {"tokens": torch.stack([tok[0], tok[0]]),
                "labels": torch.stack([tok[0], tok[0]])}
        ns, _ = step(steps.stack_pods([st, st]), same)
        for k, v in shd.gather_tree(ns.params).items():
            assert torch.equal(v[0], v[1]), k
        nd, losses = step(steps.stack_pods([st, st]),
                          {"tokens": tok, "labels": tok})
        single, loss0 = steps.make_train_step(cfg, inner,
                                              param_pspecs=pspecs)(
            st, {"tokens": tok[0], "labels": tok[0]})
        ns = ns._replace(params=shd.gather_tree(ns.params))
        nd = nd._replace(params=shd.gather_tree(nd.params))
        single = single._replace(params=shd.gather_tree(single.params))
        losses, loss0 = shd.gather(losses), shd.gather(loss0)
    assert not torch.distributed.is_initialized()
    assert torch.equal(losses[0], loss0)
    assert any(not torch.equal(v[0], v[1]) for v in nd.params.values())
    for k, v in single.params.items():
        assert torch.equal(nd.params[k][0], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_function_against_the_plain_attend_on_the_card(cuda, dtype):
    """The training attention (``models.attention.flash_attention``: queries
    in chunks, only q, k, v, out and lse saved) against the plain
    ``attend(use_flash=False)`` at (B 2, S 256, H 4, KV 2, D 32), four
    chunks of 64, causal and not: in fp32 the output within rtol 1e-5
    (atol 1e-6) and dq, dk, dv within 1e-4 of each one's largest |value|;
    in bf16 all four within 2e-2 of their largest |value| (the two paths
    round to bf16 at other points)."""
    from repro_torch.models import attention as attn_lib
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=gen, device=cuda).to(dt)
                   for shape in ((2, 256, 4, 32), (2, 256, 2, 32),
                                 (2, 256, 2, 32), (2, 256, 4, 32)))
    for causal in (True, False):
        runs = []
        for use_flash in (True, False):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attn_lib.attend(*leaves, causal=causal, q_chunk=64,
                                  use_flash=use_flash)
            runs.append([out.detach(),
                         *torch.autograd.grad(out, leaves, do)])
        for name, got, want in zip(("out", "dq", "dk", "dv"), *runs):
            assert got.dtype == dt, name
            got, want = got.float(), want.float()
            err = float((got - want).abs().max())
            top = float(want.abs().max())
            if dt == torch.bfloat16:
                assert err <= 2e-2 * top, (causal, name, err)
            elif name == "out":
                assert torch.allclose(got, want, rtol=1e-5, atol=1e-6), \
                    (causal, err)
            else:
                assert err <= 1e-4 * top, (causal, name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b-smoke", "zamba2-2.7b-smoke"])
def test_remat_on_against_off_on_the_card(cuda, arch):
    """``Model.loss`` and its gradients at smoke width on the card with
    ``cfg.remat`` on (qwen2-7b's stacked layers in checkpoints of 2,
    zamba2's super blocks one each) and off, q_chunk 8 at S 32: the loss
    and every gradient within 1e-4 of their largest |value| (bit-equal on
    the CPU; on the card an indexed backward adds with atomics, in any
    order)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    base = get_config(arch)
    tok = torch.randint(0, base.vocab_size, (2, 32), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    params = Model(base).init(torch.Generator(device=cuda).manual_seed(0),
                              cuda)
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat=remat, remat_group=2)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = Model(cfg).loss(leaves, batch, q_chunk=8)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True,
            materialize_grads=True)))
    (l_on, g_on), (l_off, g_off) = out
    assert abs(l_on.item() - l_off.item()) <= 1e-4 * abs(l_off.item())
    for k, a, b in zip(params, g_on, g_off):
        assert float((a - b).abs().max()) <= \
            1e-4 * float(b.abs().max()) + 1e-12, k


@pytest.mark.cuda
def test_an_engine_arrival_at_512_tokens_launches_two_kernels(cuda):
    """``paper_hetero_severe`` at smoke width with sequences of 512 tokens
    (attention in four chunks of 128) on the card: the golden's arrivals
    and one packed_row_stats and one packed_correct_outer an applied
    arrival, nothing else; finite evals."""
    from repro_torch.scenarios import registry, run
    scn = registry.get_scenario("paper_hetero_severe").overridden(
        seq_len=512)
    kernels.reset_launch_counts()
    eng, hist = run.run(scn, "cuda")
    assert run.compare(scn, hist) == []
    applied = sum(not a["dropped"] for a in hist.arrivals)
    assert applied > 0
    assert kernels.launch_counts() == {
        **dict.fromkeys(kernels.launch_counts(), 0),
        "packed_row_stats": applied, "packed_correct_outer": applied}
    assert all(np.isfinite(e["mean"]) for e in hist.evals)
