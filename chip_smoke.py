#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. build every CUDA source of ``src/repro_torch/csrc`` (one nvcc each, in
     parallel) and print the build seconds and the compiler's report;
  2. at the slice's shape (full-width tinygpt-15m packed: R = 125,128 rows
     in 43 blocks) hold each kernel against its plain PyTorch version
     (plain, stats and in-place variants; the accumulator kernel under a
     delayed-Nesterov boundary table and a FedBuff non-boundary one; the
     int8 sweeps on per-block scales with a block on exact .5 ties, an
     all-zero block and a clipped one; the K-stacked multi sweeps of the
     batched commit path at K = 4, plain, stats and in place, also bit for
     bit against four back-to-back launches of the matching single-arrival
     kernel, the accumulator one under a per-delta table whose second slot
     is a delayed-Nesterov boundary; the multi-Gram sweep's per-row and
     per-block sums) and time both with CUDA events (median of 30 runs
     after a warm-up), beside one PyTorch library call where there is one
     (one fake-quantize call against the int8 quant + dequant pair's sum;
     one ``torch.bmm`` over a pre-stacked basis for the Gram);
  3. run the slice's scenarios through ``repro_torch.scenarios`` at full
     tinygpt-15m width, batch 4 x 128, on cuda: ``paper_hetero_severe``
     (HeLoCo), the outer-method baselines ``delayed_nesterov``,
     ``fedbuff``, ``dcasgd``, ``poly_stale`` and ``sync_baseline``, then
     the engine axes ``noniid_dirichlet`` (Dirichlet mixtures),
     ``crash_rejoin``, ``elastic_membership`` and ``int8_dylu`` (DyLU with
     packed int8 compression and error feedback), then the batched commit
     path (``commit_batch = 4``): ``hogwild_rampup`` and ``trace_paced``,
     and ``fedbuff``, ``delayed_nesterov`` and ``dcasgd`` overridden with
     ``commit_batch=4``, each at its golden's full depth. Before each run
     every launch count is set to 0 and read after it: the arrivals must
     equal the committed golden trace's exactly (for the three overridden
     baselines, which have no golden, a CPU run of the port of the same
     override at smoke width: arrivals do not depend on width); each
     applied arrival committed on its own (barrier round) must launch the
     run's single-arrival kernels once, each fused run of K >= 2 arrivals
     exactly one multi sweep (plus one multi-Gram sweep for HeLoCo), and
     no other kernel may launch (a crashed worker's lost round launches
     nothing); every tensor must stay on the card, and the eval losses
     must be finite;
  4. print the card's name and power limit, the kernel summary line, and
     the ``{"ok": true, ...}`` line last.

Without a CUDA device, or without the rest of the repository, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Datasheet peaks (NVIDIA H100 data sheet; dense, no sparsity): memory
# bytes/s and fp32 (non-tensor-core) flop/s, by product name fragment.
PEAKS = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12), "": (3.35e12, 67e12)}

ITERS = 30
# the batched commit path's flush depth in the kernel phase
K_MULTI = 4
# per-row / per-block sums (fp32, another summation order): each entry within
# TOL_SUM of its own scale, sqrt(uu*vv) for a dot product (Cauchy-Schwarz
# bounds it) and the value itself for a sum of squares
TOL_SUM = 1e-5

# The slice: each scenario at full width, batch 4 x 128 (the launcher's
# --full-width), with the overrides named, the kernels each arrival that
# commits on its own (barrier round) launches once, and the kernels each
# fused run of K >= 2 arrivals launches once. None of these runs drops an
# arrival, so int8_dylu's worker rounds (three compression sweeps each)
# are its applied arrivals too.
HELOCO = ("packed_row_stats", "packed_correct_outer")
HELOCO_MULTI = ("packed_multi_gram", "packed_multi_correct_outer")
INT8 = ("packed_rowabs", "packed_quant", "packed_dequant")
ACC, ACC_MULTI = ("packed_correct_outer_acc",), (
    "packed_multi_correct_outer_acc",)
BATCHED = {"commit_batch": 4}
SLICE = (
    ("paper_hetero_severe", {}, HELOCO, ()),
    ("delayed_nesterov", {}, ACC, ()),
    ("fedbuff", {}, ACC, ()),
    ("dcasgd", {}, ("packed_correct_outer_quad",), ()),
    ("poly_stale", {}, ("packed_correct_outer",), ()),
    ("sync_baseline", {}, ("packed_correct_outer",), ()),
    ("noniid_dirichlet", {}, HELOCO, ()),
    ("crash_rejoin", {}, HELOCO, ()),
    ("elastic_membership", {}, HELOCO, ()),
    ("int8_dylu", {}, HELOCO + INT8, ()),
    ("hogwild_rampup", {}, HELOCO, HELOCO_MULTI),
    ("trace_paced", {}, HELOCO, HELOCO_MULTI),
    ("fedbuff", BATCHED, ACC, ACC_MULTI),
    ("delayed_nesterov", BATCHED, ACC, ACC_MULTI),
    ("dcasgd", BATCHED, ("packed_correct_outer_quad",),
     ("packed_multi_correct_outer_quad",)),
)
REPLACES = {
    "packed_row_stats": "src/repro/kernels/packed.py:59",
    "packed_correct_outer": "src/repro/kernels/packed.py:175",
    "packed_correct_outer_quad": "src/repro/kernels/packed.py:262",
    "packed_correct_outer_acc": "src/repro/kernels/packed.py:355",
    "packed_rowabs": "src/repro/kernels/packed.py:710",
    "packed_quant": "src/repro/kernels/packed.py:731",
    "packed_dequant": "src/repro/kernels/packed.py:753",
    "packed_multi_correct_outer": "src/repro/kernels/packed.py:461",
    "packed_multi_correct_outer_quad": "src/repro/kernels/packed.py:529",
    "packed_multi_correct_outer_acc": "src/repro/kernels/packed.py:603",
    "packed_multi_gram": "src/repro/kernels/packed.py:664",
}
# (am, bm, ab, cg, cm, ca) of a delayed-Nesterov boundary arrival and of a
# FedBuff non-boundary one (cg = 0: the parameters come back unchanged)
ACC_TABLES = {"dn_boundary": (0.9, 0.025, 0.0, 1.0, 0.9, 0.0),
              "fedbuff_hold": (1.0, 0.0, 1.0, 0.0, 0.0, 0.0)}
# the multi accumulator sweep's per-delta table: delayed-Nesterov
# non-boundary rows, the second one a boundary
DN_HOLD = (1.0, 0.0, 1.0, 1.0, 0.9, 0.0)
MULTI_ACC_TABLE = tuple(zip(*[DN_HOLD, ACC_TABLES["dn_boundary"]]
                             + [DN_HOLD] * (K_MULTI - 2)))


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise AssertionError("unreachable")


def time_ms(fn, iters=ITERS, warmup=3):
    """Median milliseconds of ``fn`` over ``iters`` runs, each bracketed by
    its own CUDA events (the buffers exceed the 50 MB L2, so runs start cold)."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def check_sums(name, got, want):
    """Rows of (dot, uu, vv[, more sums of squares]) held entry by entry to
    TOL_SUM of their own scale (a (K, R, n) stack row by row). Returns the
    largest absolute difference."""
    got = got.reshape(-1, got.shape[-1]).double()
    want = want.reshape(-1, want.shape[-1]).double()
    scale = want.abs()
    scale[:, 0] = (want[:, 1] * want[:, 2]).sqrt()
    diff = (got - want).abs()
    bad = (diff > TOL_SUM * scale).nonzero()
    assert not len(bad), (f"{name}: {len(bad)} sums off, first at "
                          f"{bad[0].tolist()}: got {got[tuple(bad[0])].item()} "
                          f"want {want[tuple(bad[0])].item()}")
    return diff.max().item()


def check_update(name, torch, fn, state, want, stats_want):
    """``fn(*state, **kw)`` against the plain version's outputs ``want``:
    plain and stats variants and the in-place update bit for bit, the stats
    within TOL_SUM. Returns the largest stats difference."""
    got = fn(*state)
    with_stats = fn(*state, with_stats=True)
    copies = tuple(t.clone() for t in state)
    fn(*copies, out=copies)
    torch.cuda.synchronize()
    for label, outs in (("kernel", got), ("stats variant", with_stats),
                        ("in-place", copies)):
        for i, (g, w) in enumerate(zip(outs, want)):
            assert torch.equal(g, w), (
                f"{name} {label} output {i} differs from the plain version by "
                f"{(g - w).abs().max().item()}")
    return check_sums(f"{name} stats", with_stats[-1], stats_want)


def kernel_phase(torch, pk, compression, layout, dev, bw, flops):
    from repro_torch.configs.base import HeLoCoConfig
    R, B = layout.n_rows, layout.n_blocks
    gen = torch.Generator(device=dev).manual_seed(0)
    d, m, p, b = (torch.randn((R, 128), generator=gen, device=dev)
                  for _ in range(4))
    cu = torch.rand(B, generator=gen, device=dev) + 0.5
    cv = torch.rand(B, generator=gen, device=dev) - 0.5
    cq = -0.3 * torch.rand(B, generator=gen, device=dev)
    rb, _ = layout.device_tables(dev)
    eta, mu, rho = 0.7, 0.9, 0.5
    f4 = 4

    # -- packed_row_stats
    got = pk.packed_row_stats(d, m)
    want = pk.packed_row_stats_ref(d, m)
    torch.cuda.synchronize()
    err_rs = check_sums("packed_row_stats", got, want)
    blocks = pk.packed_stats(d, m, layout)
    again = pk.packed_stats(d, m, layout)
    assert torch.equal(blocks, again), "packed_stats is not deterministic"
    plain_blocks = torch.stack([want[a:b].sum(0)
                                for a, b in layout.block_row_ranges])
    err_ps = check_sums("packed_stats", blocks, plain_blocks)

    # -- the fused sweeps: plain, stats and in-place variants
    def co(*s, **kw):
        return pk.packed_correct_outer(*s, d, cu, cv, rb, eta, mu, rho, **kw)

    def quad(*s, **kw):
        return pk.packed_correct_outer_quad(*s, d, cu, cv, cq, rb, 0.07, mu,
                                            rho, **kw)

    def acc(table):
        def call(*s, **kw):
            return pk.packed_correct_outer_acc(*s, d, cu, cv, rb, eta, rho,
                                               *ACC_TABLES[table], **kw)
        return call

    ref = pk.packed_correct_outer_ref(p, m, d, cu, cv, rb, eta, mu, rho,
                                      with_stats=True)
    err_st = check_update("packed_correct_outer", torch, co, (p, m), ref[:2],
                          ref[2])
    ref = pk.packed_correct_outer_quad_ref(p, m, d, cu, cv, cq, rb, 0.07, mu,
                                           rho, with_stats=True)
    err_q = check_update("packed_correct_outer_quad", torch, quad, (p, m),
                         ref[:2], ref[2])
    err_a = 0.0
    for table in ACC_TABLES:
        ref = pk.packed_correct_outer_acc_ref(p, m, b, d, cu, cv, rb, eta,
                                              rho, *ACC_TABLES[table],
                                              with_stats=True)
        err_a = max(err_a, check_update(f"packed_correct_outer_acc[{table}]",
                                        torch, acc(table), (p, m, b),
                                        ref[:3], ref[3]))
    assert torch.equal(acc("fedbuff_hold")(p, m, b)[0], p), \
        "a FedBuff non-boundary arrival moved the parameters"
    print(f"kernels agree: row_stats err {err_rs:.3e}, block stats err "
          f"{err_ps:.3e}; correct_outer, quad and acc (both tables) "
          f"bit-identical to their plain versions in p'/m'/b', plain, stats "
          f"and in place; stats err {max(err_st, err_q, err_a):.3e} (each "
          f"sum within {TOL_SUM} of its own scale)")

    # -- the int8 sweeps, on the scales the compression path computes
    x, scale = int8_inputs(torch, compression, d, layout, dev)
    absmax = pk.packed_rowabs(x)
    q = pk.packed_quant(x, scale, rb)
    dec = pk.packed_dequant(q, scale, rb)
    torch.cuda.synchronize()
    for name, got, want in (
            ("packed_rowabs", absmax, pk.packed_rowabs_ref(x)),
            ("packed_quant", q, pk.packed_quant_ref(x, scale, rb)),
            ("packed_dequant", dec, pk.packed_dequant_ref(q, scale, rb))):
        assert got.dtype == want.dtype and torch.equal(got, want), (
            f"{name} differs from the plain version in "
            f"{(got != want).sum().item()} entries")
    ties = layout.block_row_ranges[0]
    assert scale[0].item() == 0.5 and torch.equal(
        q[ties[0], 1:5].cpu(), torch.tensor([-62, -62, -60, -60],
                                            dtype=torch.int8)), \
        "packed_quant does not round half to even"
    assert (q[slice(*layout.block_row_ranges[-1])].abs() == 127).any(), \
        "the clipped block has no clipped value"
    print("int8 sweeps agree: rowabs, quant and dequant bit-identical to "
          "their plain versions (ties to even, zero block, clip)")

    def bound(nbytes, nflops):
        t_b, t_f = nbytes / bw, nflops / flops
        return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")

    multi_rows = multi_phase(torch, pk, layout, dev, p, m, b, bound)

    n = R * 128
    plane, table_bytes = n * f4, R * 4
    outs = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(b))
    # the library yardsticks of the int8 sweeps, timed only: one call each
    # for rowabs and dequant (int8 times fp32 promotes to fp32), and one
    # fake-quantize call for the quant + dequant pair, set against the
    # pair's sum; PyTorch has no call for the int8 quant alone
    s_rows = scale[rb.long()].contiguous()
    zeros = torch.zeros(R, dtype=torch.int32, device=dev)
    library = {
        "packed_rowabs": lambda: torch.linalg.vector_norm(
            x, float("inf"), dim=1),
        "packed_dequant": lambda: torch.mul(q, s_rows[:, None]),
    }
    library_call = {
        "packed_rowabs": "torch.linalg.vector_norm(x, inf, dim=1)",
        "packed_dequant": "torch.mul(q, s[:, None])"}
    assert torch.equal(library["packed_dequant"](),
                       pk.packed_dequant_ref(q, scale, rb)), \
        "the dequant yardstick computes another function"
    pair = {"pair_ms": time_ms(lambda: pk.packed_dequant(
                pk.packed_quant(x, scale, rb), scale, rb)),
            "library_pair_ms": time_ms(
                lambda: torch.fake_quantize_per_channel_affine(
                    x, s_rows, zeros, 0, -127, 127)),
            "library_pair_call": "torch.fake_quantize_per_channel_affine"}
    int8_bytes = plane + n + table_bytes + B * f4   # fp32 + int8 + map/scales
    rows = []
    for name, fn, plain, nbytes, nflops, err in (
            ("packed_row_stats", lambda: pk.packed_row_stats(d, m),
             lambda: pk.packed_row_stats_ref(d, m),
             2 * plane + R * 3 * f4, 6 * n, err_rs),
            ("packed_correct_outer", lambda: co(p, m, out=outs[:2]),
             lambda: pk.packed_correct_outer_ref(p, m, d, cu, cv, rb, eta, mu,
                                                 rho),
             5 * plane + table_bytes + 2 * B * f4, 11 * n, 0.0),
            ("packed_correct_outer_quad", lambda: quad(p, m, out=outs[:2]),
             lambda: pk.packed_correct_outer_quad_ref(p, m, d, cu, cv, cq, rb,
                                                      0.07, mu, rho),
             5 * plane + table_bytes + 3 * B * f4, 15 * n, 0.0),
            ("packed_correct_outer_acc",
             lambda: acc("dn_boundary")(p, m, b, out=outs),
             lambda: pk.packed_correct_outer_acc_ref(
                 p, m, b, d, cu, cv, rb, eta, rho, *ACC_TABLES["dn_boundary"]),
             7 * plane + table_bytes + 2 * B * f4, 16 * n, 0.0),
            ("packed_rowabs", lambda: pk.packed_rowabs(x),
             lambda: pk.packed_rowabs_ref(x), plane + R * f4, 2 * n, 0.0),
            ("packed_quant", lambda: pk.packed_quant(x, scale, rb),
             lambda: pk.packed_quant_ref(x, scale, rb), int8_bytes, 5 * n,
             0.0),
            ("packed_dequant", lambda: pk.packed_dequant(q, scale, rb),
             lambda: pk.packed_dequant_ref(q, scale, rb), int8_bytes, 2 * n,
             0.0)):
        ms, plain_ms = time_ms(fn), time_ms(plain)
        b_ms, by = bound(nbytes, nflops)
        lib = library.get(name)
        rows.append({"name": name, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": by, "max_abs_err": err,
                     "library_ms": time_ms(lib) if lib else None,
                     "library_call": library_call.get(name),
                     **(pair if name in ("packed_quant", "packed_dequant")
                        else {}),
                     "bytes": nbytes, "flops": nflops, "R": R, "blocks": B})
    # off the main path or around the kernels: reported, not in the summary
    st_bytes = 5 * plane + table_bytes + 2 * B * f4 + R * 4 * f4
    print(json.dumps({
        "kernel": "packed_correct_outer(with_stats)",
        "kernel_ms": time_ms(lambda: co(p, m, with_stats=True, out=outs[:2])),
        "plain_ms": time_ms(lambda: pk.packed_correct_outer_ref(
            p, m, d, cu, cv, rb, eta, mu, rho, with_stats=True)),
        "bound_ms": bound(st_bytes, 17 * n)[0], "bytes": st_bytes,
        "on_main_path": False}))
    print(json.dumps({
        "kernel": "packed_correct_outer_acc[fedbuff_hold]",
        "kernel_ms": time_ms(lambda: acc("fedbuff_hold")(p, m, b, out=outs)),
        "on_main_path": True}))
    parts = pk.packed_row_stats(d, m)
    seg = layout.device_tables(dev)[1]
    print(json.dumps({
        "op": "packed_int8_roundtrip = rowabs + block max + scale + quant + "
              "dequant",
        "ms": time_ms(lambda: compression.packed_int8_roundtrip(x, layout)),
        **pair}))
    print(json.dumps({
        "op": "packed_stats = row stats kernel + segment sum",
        "ms": time_ms(lambda: pk.packed_stats(d, m, layout)),
        "segment_sum_ms": time_ms(lambda: torch.segment_reduce(
            parts.t().reshape(-1), "sum", lengths=seg)),
        "branch_scalars_ms": time_ms(lambda: pk.branch_scalars(
            blocks, HeLoCoConfig())),
    }))
    return rows + multi_rows


def check_gram(name, got, want, k):
    """Per-row (or per-block) Gram columns in the (a <= b) pair order, each
    within TOL_SUM of sqrt(G_aa * G_bb) (Cauchy-Schwarz bounds the entry).
    Returns the largest absolute difference."""
    from repro_torch.kernels.packed import gram_pairs
    pairs = gram_pairs(k)
    got, want = got.double(), want.double()
    diag = {a: want[:, c] for c, (a, b) in enumerate(pairs) if a == b}
    scale = want.new_empty(want.shape)
    for c, (a, b) in enumerate(pairs):
        scale[:, c] = (diag[a] * diag[b]).sqrt()
    diff = (got - want).abs()
    bad = (diff > TOL_SUM * scale).nonzero()
    assert not len(bad), (f"{name}: {len(bad)} sums off, first at "
                          f"{bad[0].tolist()}")
    return diff.max().item()


def multi_phase(torch, pk, layout, dev, p, m, b, bound):
    """The batched commit path's four kernels at K = K_MULTI: each held to
    its plain version (plain, stats, in place), each multi sweep bit for
    bit to K back-to-back launches of its single-arrival kernel, the Gram
    rows and blocks to the plain sums; then timed. Returns their rows."""
    k, R, B = K_MULTI, layout.n_rows, layout.n_blocks
    gen = torch.Generator(device=dev).manual_seed(1)
    D = torch.randn((k, R, 128), generator=gen, device=dev)
    CU = torch.rand((k, B), generator=gen, device=dev) + 0.5
    CV = torch.rand((k, B), generator=gen, device=dev) - 0.5
    CQ = -0.3 * torch.rand((k, B), generator=gen, device=dev)
    rb, _ = layout.device_tables(dev)
    eta, mu = 0.7, 0.9
    rhos = [0.5 / math.sqrt(1.0 + j) for j in range(k)]

    def multi(*s, **kw):
        return pk.packed_multi_correct_outer(*s, D, CU, CV, rb, eta, mu,
                                             rhos, **kw)

    def quad(*s, **kw):
        return pk.packed_multi_correct_outer_quad(*s, D, CU, CV, CQ, rb, 0.07,
                                                  mu, rhos, **kw)

    def acc(*s, **kw):
        return pk.packed_multi_correct_outer_acc(*s, D, CU, CV, rb, eta, rhos,
                                                 *MULTI_ACC_TABLE, **kw)

    def seq_multi(*s):
        for j in range(k):
            s = pk.packed_correct_outer(*s, D[j], CU[j], CV[j], rb, eta, mu,
                                        rhos[j])
        return s

    def seq_quad(*s):
        for j in range(k):
            s = pk.packed_correct_outer_quad(*s, D[j], CU[j], CV[j], CQ[j],
                                             rb, 0.07, mu, rhos[j])
        return s

    def seq_acc(*s):
        for j in range(k):
            s = pk.packed_correct_outer_acc(*s, D[j], CU[j], CV[j], rb, eta,
                                            rhos[j],
                                            *(c[j] for c in MULTI_ACC_TABLE))
        return s

    errs = []
    checks = (
        ("packed_multi_correct_outer", multi, seq_multi, (p, m),
         pk.packed_multi_correct_outer_ref(p, m, D, CU, CV, rb, eta, mu, rhos,
                                           with_stats=True)),
        ("packed_multi_correct_outer_quad", quad, seq_quad, (p, m),
         pk.packed_multi_correct_outer_quad_ref(p, m, D, CU, CV, CQ, rb, 0.07,
                                                mu, rhos, with_stats=True)),
        ("packed_multi_correct_outer_acc", acc, seq_acc, (p, m, b),
         pk.packed_multi_correct_outer_acc_ref(p, m, b, D, CU, CV, rb, eta,
                                               rhos, *MULTI_ACC_TABLE,
                                               with_stats=True)))
    for name, fn, seq, state, ref in checks:
        n = len(state)
        errs.append(check_update(name, torch, fn, state, ref[:n], ref[n]))
        chained = seq(*state)
        got = fn(*state)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, chained)):
            assert torch.equal(g, w), (
                f"{name} output {i} differs from {k} sequential launches of "
                f"the single-arrival kernel by {(g - w).abs().max().item()}")
    # the moments of the sequential launches against the multi stats
    s, moments = (p, m), []
    for j in range(k):
        out = pk.packed_correct_outer(*s, D[j], CU[j], CV[j], rb, eta, mu,
                                      rhos[j], with_stats=True)
        s, moments = out[:2], moments + [out[2]]
    stats_bitwise = torch.equal(multi(p, m, with_stats=True)[2],
                                torch.stack(moments))
    gram_rows = pk.packed_multi_gram(m, D)
    gram_want = pk.packed_multi_gram_ref(m, D)
    torch.cuda.synchronize()
    err_g = check_gram("packed_multi_gram", gram_rows, gram_want, k)
    blocks = pk.multi_gram_blocks(m, D, layout)
    assert torch.equal(blocks, pk.multi_gram_blocks(m, D, layout)), \
        "multi_gram_blocks is not deterministic"
    plain_blocks = torch.stack([gram_want[a:e].sum(0)
                                for a, e in layout.block_row_ranges])
    pairs = pk.gram_pairs(k)
    got_blocks = torch.stack([blocks[:, a, c] for a, c in pairs], dim=1)
    err_gb = check_gram("multi_gram_blocks", got_blocks, plain_blocks, k)
    # the library yardstick: one bmm over the pre-stacked basis (R, K+1,
    # 128), which gives every row's whole Gram matrix; the stack itself is
    # not timed
    basis = torch.cat([m[:, None], D.transpose(0, 1)], dim=1).contiguous()
    bmm = torch.bmm(basis, basis.transpose(1, 2))
    ai = torch.tensor([a for a, _ in pairs], device=dev)
    bi = torch.tensor([c for _, c in pairs], device=dev)
    check_gram("torch.bmm yardstick", bmm[:, ai, bi], gram_want, k)
    print(f"multi sweeps agree at K = {k}: plain, quad and acc (per-delta "
          f"table, a boundary in slot 1) bit-identical to their plain "
          f"versions and to {k} back-to-back single-arrival launches in "
          f"p'/m'/b', plain, stats and in place; stats err "
          f"{max(errs):.3e}, bitwise equal to the single kernel's: "
          f"{stats_bitwise}; Gram rows err {err_g:.3e}, blocks err "
          f"{err_gb:.3e} (each within {TOL_SUM} of sqrt(G_aa * G_bb))")

    f4, n = 4, R * 128
    plane, table_bytes = n * f4, R * 4
    coef = k * B * f4
    outs = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(b))
    n_pairs = len(pairs)
    rows = []
    for name, fn, plain, seq, nbytes, nflops, err, lib in (
            ("packed_multi_correct_outer", lambda: multi(p, m, out=outs[:2]),
             lambda: pk.packed_multi_correct_outer_ref(p, m, D, CU, CV, rb,
                                                       eta, mu, rhos),
             lambda: seq_multi(p, m),
             (4 + k) * plane + table_bytes + 2 * coef + 3 * k * f4,
             11 * k * n, errs[0], None),
            ("packed_multi_correct_outer_quad",
             lambda: quad(p, m, out=outs[:2]),
             lambda: pk.packed_multi_correct_outer_quad_ref(
                 p, m, D, CU, CV, CQ, rb, 0.07, mu, rhos),
             lambda: seq_quad(p, m),
             (4 + k) * plane + table_bytes + 3 * coef + 3 * k * f4,
             15 * k * n, errs[1], None),
            ("packed_multi_correct_outer_acc", lambda: acc(p, m, b, out=outs),
             lambda: pk.packed_multi_correct_outer_acc_ref(
                 p, m, b, D, CU, CV, rb, eta, rhos, *MULTI_ACC_TABLE),
             lambda: seq_acc(p, m, b),
             (6 + k) * plane + table_bytes + 2 * coef + 8 * k * f4,
             16 * k * n, errs[2], None),
            ("packed_multi_gram", lambda: pk.packed_multi_gram(m, D),
             lambda: pk.packed_multi_gram_ref(m, D), None,
             (1 + k) * plane + n_pairs * R * f4, 2 * n_pairs * n, err_g,
             lambda: torch.bmm(basis, basis.transpose(1, 2)))):
        b_ms, by = bound(nbytes, nflops)
        rows.append({
            "name": name, "ms": time_ms(fn), "plain_ms": time_ms(plain),
            "bound_ms": b_ms, "bound_by": by, "max_abs_err": err,
            "library_ms": time_ms(lib) if lib else None,
            "library_call": ("torch.bmm over a pre-stacked (R, K+1, 128) "
                             "basis (the stack not timed)" if lib else None),
            "sequential_ms": time_ms(seq) if seq else None,
            "K": k, "bytes": nbytes, "flops": nflops, "R": R, "blocks": B})
    print(json.dumps({
        "kernel": f"packed_multi_correct_outer(with_stats), K = {k}",
        "kernel_ms": time_ms(lambda: multi(p, m, with_stats=True,
                                           out=outs[:2])),
        "on_main_path": False}))
    print(json.dumps({
        "op": "multi_gram_blocks = multi-Gram kernel + segment sum + "
              "symmetric expand",
        "ms": time_ms(lambda: pk.multi_gram_blocks(m, D, layout))}))
    return rows


def int8_inputs(torch, compression, d, layout, dev):
    """A buffer and per-block scales for the int8 sweeps: ``d`` with block 0
    on exact .5 ties at scale 0.5 ((n + 0.5) * 0.5 with |max| 63.5) and
    block 1 all zero (the 1e-12 scale floor), the scales of the compression
    path, and the last block's cut to a quarter so that x / s leaves
    [-127, 127] (the clip)."""
    x = d.clone()
    (s0, e0), (s1, e1) = layout.block_row_ranges[:2]
    x[s0:e0] = (torch.arange(-64, 64, device=dev, dtype=torch.float32)
                + 0.5) * 0.5
    x[s0, 0] = 63.5
    x[s1:e1] = 0.0
    scale = compression.block_scales(x, layout)
    scale[-1] *= 0.25
    return x, scale


def cpu_arrivals(scn):
    """The arrival rows, inner steps (tokens over batch x sequence) and
    final time of the port's run of ``scn`` at smoke width on the CPU: the
    target of a card run that has no golden."""
    from repro_torch.scenarios import registry, run
    smoke = registry.get_scenario(scn.name).overridden(
        commit_batch=scn.commit_batch)
    _eng, hist = run.run(smoke, "cpu")
    return (run.arrival_rows(hist),
            hist.tokens // (smoke.batch_size * smoke.seq_len),
            hist.final_time)


def run_scenario(torch, pk, name, overrides, single, fused):
    """One slice scenario at full width on cuda, through the scenario layer,
    with ``overrides``. ``single``: the kernels an arrival committed on its
    own launches once; ``fused``: those a fused run of K >= 2 arrivals
    launches once. Returns (launch counts of this run, applied arrivals
    committed on their own, fused arrivals)."""
    from repro_torch.async_engine.engine import make_eval_fn
    from repro_torch.launch.train import FULL_WIDTH
    from repro_torch.scenarios import registry, run

    scn = registry.get_scenario(name).overridden(**FULL_WIDTH, **overrides)
    eng = scn.build(device="cuda")
    spans = {"inner_round": [], "server_step": [], "eval": []}
    flush_ms = {}                   # server ms of a fused run, by K
    fused_runs = []

    def timed(fn, bucket):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans[bucket].append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapper

    def fused_step(deltas, rhos, taus, _fn=eng.server._step_update_multi):
        """Times one fused run and holds it to one launch of each kernel in
        ``fused`` and of no other."""
        before = pk.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _fn(deltas, rhos, taus)
        torch.cuda.synchronize()
        flush_ms.setdefault(len(deltas), []).append(
            1e3 * (time.perf_counter() - t0))
        after = pk.launch_counts()
        diff = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
        assert diff == {k: 1 for k in fused}, \
            f"{name}: a fused run of {len(deltas)} launched {diff}"
        fused_runs.append(len(deltas))

    eng._execute = timed(eng._execute, "inner_round")
    eng.server.on_arrival = timed(eng.server.on_arrival, "server_step")
    eng.server.on_sync_round = timed(eng.server.on_sync_round, "server_step")
    eng.server._step_update_multi = fused_step
    eval_fn = timed(make_eval_fn(eng, batch=scn.eval_batch), "eval")
    target = cpu_arrivals(scn) if overrides else None
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    hist = eng.run(eval_every=scn.eval_cadence, eval_fn=eval_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = pk.launch_counts()

    if target is None:
        bad = run.compare(scn, hist)
        assert not bad, f"{name}: {bad}"
    else:
        rows = run.arrival_rows(hist)
        assert rows == target[0], f"{name} {overrides}: arrivals differ " \
            "from the port's CPU run at smoke width"
        steps = hist.tokens // (scn.batch_size * scn.seq_len)
        assert (steps, hist.final_time) == target[1:], \
            f"{name} {overrides}: inner steps or final time differ"
    applied = sum(not a["dropped"] for a in hist.arrivals)
    n_fused = sum(fused_runs)
    singles = applied - n_fused
    assert (len(fused_runs) > 0) == bool(fused), (name, fused_runs)
    want = {k: singles * (k in single) + len(fused_runs) * (k in fused)
            for k in counts}
    assert counts == want, f"{name}: launch counts {counts}, want {want}"
    srv = eng.server
    tensors = [srv._pbuf, srv._mbuf, *srv.state.params.values()]
    if srv._abuf is not None:
        tensors.append(srv._abuf)
    for w in eng.workers.values():
        tensors += [*w.opt.mu.values(), *w.opt.nu.values()]
        if w.ef is not None:                    # packed int8 error feedback
            tensors.append(w.ef)
    for task in eng._pending.values():          # rounds still in flight
        tensors += [*task.params.values(), *task.opt.mu.values()]
    assert all(t.device.type == "cuda" for t in tensors), \
        f"{name}: a tensor left the card"
    means = [e["mean"] for e in hist.evals]
    assert means and all(math.isfinite(x) for x in means), (name, means)
    server_ms_by_k = {1: statistics.median(spans["server_step"])} \
        if spans["server_step"] else {}
    server_ms_by_k.update({k: statistics.median(v)
                           for k, v in sorted(flush_ms.items())})
    print(json.dumps({
        "scenario": name, "overrides": overrides, "method": scn.method,
        "config": f"tinygpt-15m full width, {scn.n_workers} workers "
                  f"{scn.paces}, H={scn.inner_steps}, batch 4 x 128, "
                  f"commit_batch {scn.commit_batch}",
        "params": sum(t.numel() for t in srv.state.params.values()),
        "arrivals": len(hist.arrivals), "applied": applied,
        "fused_runs": fused_runs, "committed_alone": singles,
        "arrivals_equal": "golden" if target is None else
                          "port CPU run at smoke width",
        "launches": counts, "flush_totals": srv.flush_totals,
        "wall_s": wall, "wall_ms_per_arrival": 1e3 * wall / len(hist.arrivals),
        "median_ms": {k: statistics.median(v) for k, v in spans.items() if v},
        "first_ms": {k: v[0] for k, v in spans.items() if v},
        "server_ms_by_k": server_ms_by_k,
        "server_ms_all_by_k": {k: v for k, v in sorted(flush_ms.items())},
        "eval_means": means,
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}))
    return counts, singles, n_fused


def slice_phase(torch, pk):
    """Every slice scenario; returns per kernel (launches, arrivals of the
    runs it served: committed alone for a single-arrival kernel, fused for
    a multi one)."""
    totals = {k: [0, 0] for k in REPLACES}
    for name, overrides, single, fused in SLICE:
        counts, singles, n_fused = run_scenario(torch, pk, name, overrides,
                                                single, fused)
        for k in single:
            totals[k][0] += counts[k]
            totals[k][1] += singles
        for k in fused:
            totals[k][0] += counts[k]
            totals[k][1] += n_fused
        gc.collect()
        torch.cuda.empty_cache()
    return totals


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import compression
    from repro_torch.core.packing import build_layout
    from repro_torch.kernels import _build
    from repro_torch.kernels import packed as pk
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    bw, flops = peaks_for(name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    t0 = time.perf_counter()
    for src, (secs, log) in _build.build_all().items():
        print(f"build {src}.cu: {secs:.1f}s")
        print(log.strip())
    print(f"build phase: {time.perf_counter() - t0:.1f}s")

    layout = build_layout(Model(get_config("tinygpt-15m")).param_specs())
    assert (layout.n_rows, layout.n_blocks) == (125_128, 43), layout.n_rows
    rows = kernel_phase(torch, pk, compression, layout, torch.device("cuda"),
                        bw, flops)
    t0 = time.perf_counter()
    totals = slice_phase(torch, pk)
    print(f"slice phase: {time.perf_counter() - t0:.1f}s")

    kernels = []
    for r in rows:
        launches, arrivals = totals[r["name"]]
        print(json.dumps({"kernel": r["name"], "kernel_ms": r["ms"],
                          "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                          "bound_by": r["bound_by"], "bytes": r["bytes"],
                          "bandwidth_Bps": bw, "fp32_flops": flops,
                          "library_ms": r["library_ms"],
                          "library_call": r["library_call"],
                          "launches_per_arrival": launches / arrivals,
                          "R": r["R"], "blocks": r["blocks"]}))
        pair = {k: r[k] for k in ("pair_ms", "library_pair_ms",
                                  "library_pair_call") if k in r}
        extra = {k: r[k] for k in ("sequential_ms", "K") if k in r}
        kernels.append({
            "name": r["name"], "route": "cuda",
            "source": "src/repro_torch/csrc/packed.cu",
            "replaces": REPLACES[r["name"]],
            "launches": launches, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_call": r["library_call"],
            "launches_per_arrival": launches / arrivals, **pair, **extra})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
