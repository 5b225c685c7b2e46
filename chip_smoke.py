#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. build every CUDA source of ``src/repro_torch/csrc`` (one nvcc each, in
     parallel) and print the build seconds and the compiler's report;
  2. at the slice's shape (full-width tinygpt-15m packed: R = 125,128 rows
     in 43 blocks) hold each kernel against its plain PyTorch version
     (plain, stats and in-place variants; the accumulator kernel under a
     delayed-Nesterov boundary table and a FedBuff non-boundary one) and
     time both with CUDA events (median of 30 runs after a warm-up);
  3. run the slice's scenarios through ``repro_torch.scenarios`` at full
     tinygpt-15m width, batch 4 x 128, on cuda: ``paper_hetero_severe``
     (HeLoCo), then the outer-method baselines ``delayed_nesterov``,
     ``fedbuff``, ``dcasgd``, ``poly_stale`` and ``sync_baseline``, each at
     its golden's full depth. Before each run every launch count is set to
     0 and read after it: the arrivals must equal the committed golden
     trace's exactly, each applied arrival (barrier round) must launch the
     method's kernels once and no other kernel, every tensor must stay on
     the card, and the eval losses must be finite;
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
# per-row / per-block sums (fp32, another summation order): each entry within
# TOL_SUM of its own scale, sqrt(uu*vv) for a dot product (Cauchy-Schwarz
# bounds it) and the value itself for a sum of squares
TOL_SUM = 1e-5

# The slice: each scenario at full width, batch 4 x 128 (the launcher's
# --full-width), and the kernels each applied arrival (barrier round)
# launches once.
SLICE = (
    ("paper_hetero_severe", ("packed_row_stats", "packed_correct_outer")),
    ("delayed_nesterov", ("packed_correct_outer_acc",)),
    ("fedbuff", ("packed_correct_outer_acc",)),
    ("dcasgd", ("packed_correct_outer_quad",)),
    ("poly_stale", ("packed_correct_outer",)),
    ("sync_baseline", ("packed_correct_outer",)),
)
REPLACES = {
    "packed_row_stats": "src/repro/kernels/packed.py:59",
    "packed_correct_outer": "src/repro/kernels/packed.py:175",
    "packed_correct_outer_quad": "src/repro/kernels/packed.py:262",
    "packed_correct_outer_acc": "src/repro/kernels/packed.py:355",
}
# (am, bm, ab, cg, cm, ca) of a delayed-Nesterov boundary arrival and of a
# FedBuff non-boundary one (cg = 0: the parameters come back unchanged)
ACC_TABLES = {"dn_boundary": (0.9, 0.025, 0.0, 1.0, 0.9, 0.0),
              "fedbuff_hold": (1.0, 0.0, 1.0, 0.0, 0.0, 0.0)}


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
    TOL_SUM of their own scale. Returns the largest absolute difference."""
    got, want = got.double(), want.double()
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


def kernel_phase(torch, pk, layout, dev, bw, flops):
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

    def bound(nbytes, nflops):
        t_b, t_f = nbytes / bw, nflops / flops
        return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")

    n = R * 128
    plane, table_bytes = n * f4, R * 4
    outs = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(b))
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
             7 * plane + table_bytes + 2 * B * f4, 16 * n, 0.0)):
        ms, plain_ms = time_ms(fn), time_ms(plain)
        b_ms, by = bound(nbytes, nflops)
        rows.append({"name": name, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": by, "max_abs_err": err,
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
        "op": "packed_stats = row stats kernel + segment sum",
        "ms": time_ms(lambda: pk.packed_stats(d, m, layout)),
        "segment_sum_ms": time_ms(lambda: torch.segment_reduce(
            parts.t().reshape(-1), "sum", lengths=seg)),
        "branch_scalars_ms": time_ms(lambda: pk.branch_scalars(
            blocks, HeLoCoConfig())),
    }))
    return rows


def run_scenario(torch, pk, name, kernels):
    """One slice scenario at full width on cuda, through the scenario layer.
    Returns (launch counts of this run, applied arrivals)."""
    from repro_torch.async_engine.engine import make_eval_fn
    from repro_torch.launch.train import FULL_WIDTH
    from repro_torch.scenarios import registry, run

    scn = registry.get_scenario(name).overridden(**FULL_WIDTH)
    eng = scn.build(device="cuda")
    spans = {"inner_round": [], "server_step": [], "eval": []}

    def timed(fn, bucket):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans[bucket].append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapper

    eng._execute = timed(eng._execute, "inner_round")
    eng.server.on_arrival = timed(eng.server.on_arrival, "server_step")
    eng.server.on_sync_round = timed(eng.server.on_sync_round, "server_step")
    eval_fn = timed(make_eval_fn(eng, batch=scn.eval_batch), "eval")
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    hist = eng.run(eval_every=scn.eval_cadence, eval_fn=eval_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = pk.launch_counts()

    bad = run.compare(scn, hist)
    assert not bad, f"{name}: {bad}"
    applied = sum(not a["dropped"] for a in hist.arrivals)
    want = {k: (applied if k in kernels else 0) for k in counts}
    assert counts == want, f"{name}: launch counts {counts}, want {want}"
    srv = eng.server
    tensors = [srv._pbuf, srv._mbuf, *srv.state.params.values()]
    if srv._abuf is not None:
        tensors.append(srv._abuf)
    for w in eng.workers.values():
        tensors += [*w.opt.mu.values(), *w.opt.nu.values()]
    for task in eng._pending.values():          # rounds still in flight
        tensors += [*task.params.values(), *task.opt.mu.values()]
    assert all(t.device.type == "cuda" for t in tensors), \
        f"{name}: a tensor left the card"
    means = [e["mean"] for e in hist.evals]
    assert means and all(math.isfinite(x) for x in means), (name, means)
    print(json.dumps({
        "scenario": name, "method": scn.method,
        "config": f"tinygpt-15m full width, {scn.n_workers} workers "
                  f"{scn.paces}, H={scn.inner_steps}, batch 4 x 128",
        "params": sum(t.numel() for t in srv.state.params.values()),
        "arrivals": len(hist.arrivals), "applied": applied,
        "arrivals_equal_golden": True, "launches": counts,
        "wall_s": wall, "wall_ms_per_arrival": 1e3 * wall / len(hist.arrivals),
        "median_ms": {k: statistics.median(v) for k, v in spans.items()},
        "first_ms": {k: v[0] for k, v in spans.items()},
        "eval_means": means,
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}))
    return counts, applied


def slice_phase(torch, pk):
    """Every slice scenario; returns per kernel (launches, arrivals of the
    runs that use it)."""
    totals = {k: [0, 0] for k in REPLACES}
    for name, kernels in SLICE:
        counts, applied = run_scenario(torch, pk, name, kernels)
        for k in kernels:
            totals[k][0] += counts[k]
            totals[k][1] += applied
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
    rows = kernel_phase(torch, pk, layout, torch.device("cuda"), bw, flops)
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
                          "library_ms": None,
                          "launches_per_arrival": launches / arrivals,
                          "R": r["R"], "blocks": r["blocks"]}))
        kernels.append({
            "name": r["name"], "route": "cuda",
            "source": "src/repro_torch/csrc/packed.cu",
            "replaces": REPLACES[r["name"]],
            "launches": launches, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "launches_per_arrival": launches / arrivals})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
