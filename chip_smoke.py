#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. build every CUDA source of ``src/repro_torch/csrc`` (one nvcc each, in
     parallel) and print the build seconds and the compiler's report;
  2. at the main path's shape (full-width tinygpt-15m packed: R = 125,128
     rows in 43 blocks) hold each kernel against its plain PyTorch version
     and time both with CUDA events (median of 30 runs after a warm-up);
  3. run the slice through the user's entry points: full-width tinygpt-15m,
     4 workers at paces (1, 2, 6, 15), H = 2, 12 outer steps, non-IID fixed
     shards, HeLoCo, on cuda; the arrivals must equal the committed golden
     trace of ``paper_hetero_severe`` exactly, every kernel must have run
     once per arrival, and the eval losses must be finite;
  4. print the card's name and power limit, the kernel summary line, and
     the ``{"ok": true, ...}`` line last.

Without a CUDA device, or without the rest of the repository, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "results" / "golden" / "paper_hetero_severe.json"

# Datasheet peaks (NVIDIA H100 data sheet; dense, no sparsity): memory
# bytes/s and fp32 (non-tensor-core) flop/s, by product name fragment.
PEAKS = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12), "": (3.35e12, 67e12)}

ITERS = 30
# per-row / per-block sums (fp32, another summation order): each entry within
# TOL_SUM of its own scale, sqrt(uu*vv) for a dot product (Cauchy-Schwarz
# bounds it) and the value itself for a sum of squares
TOL_SUM = 1e-5


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


def kernel_phase(torch, pk, layout, dev, bw, flops):
    from repro_torch.configs.base import HeLoCoConfig
    R, B = layout.n_rows, layout.n_blocks
    gen = torch.Generator(device=dev).manual_seed(0)
    d, m, p = (torch.randn((R, 128), generator=gen, device=dev)
               for _ in range(3))
    cu = torch.rand(B, generator=gen, device=dev) + 0.5
    cv = torch.rand(B, generator=gen, device=dev) - 0.5
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

    # -- packed_correct_outer (plain and stats variants, in place)
    outs = (torch.empty_like(p), torch.empty_like(m))
    p1, m1 = pk.packed_correct_outer(p, m, d, cu, cv, rb, eta, mu, rho, out=outs)
    pr, mr, sr = pk.packed_correct_outer_ref(p, m, d, cu, cv, rb, eta, mu, rho,
                                             with_stats=True)
    p2, m2, s2 = pk.packed_correct_outer(p, m, d, cu, cv, rb, eta, mu, rho,
                                         with_stats=True)
    pi, mi = p.clone(), m.clone()
    pk.packed_correct_outer(pi, mi, d, cu, cv, rb, eta, mu, rho, out=(pi, mi))
    torch.cuda.synchronize()
    err_co = max((p1 - pr).abs().max().item(), (m1 - mr).abs().max().item())
    assert torch.equal(p1, pr) and torch.equal(m1, mr), \
        f"packed_correct_outer differs from its plain version by {err_co}"
    assert torch.equal(p2, p1) and torch.equal(m2, m1), \
        "stats variant changed p'/m' bits"
    assert torch.equal(pi, p1) and torch.equal(mi, m1), "in-place differs"
    err_st = check_sums("packed_correct_outer stats", s2, sr)
    print(f"kernels agree: row_stats err {err_rs:.3e}, block stats err "
          f"{err_ps:.3e}, correct_outer bit-identical, stats err "
          f"{err_st:.3e} (each sum within {TOL_SUM} of its own scale)")

    def bound(nbytes, nflops):
        t_b, t_f = nbytes / bw, nflops / flops
        return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")

    n = R * 128
    rs_bytes = 2 * n * f4 + R * 3 * f4
    co_bytes = 5 * n * f4 + R * 4 + 2 * B * f4
    rows = []
    for name, fn, plain, nbytes, nflops, err in (
            ("packed_row_stats", lambda: pk.packed_row_stats(d, m),
             lambda: pk.packed_row_stats_ref(d, m), rs_bytes, 6 * n, err_rs),
            ("packed_correct_outer",
             lambda: pk.packed_correct_outer(p, m, d, cu, cv, rb, eta, mu, rho,
                                             out=outs),
             lambda: pk.packed_correct_outer_ref(p, m, d, cu, cv, rb, eta, mu,
                                                 rho),
             co_bytes, 11 * n, err_co)):
        ms, plain_ms = time_ms(fn), time_ms(plain)
        b_ms, by = bound(nbytes, nflops)
        rows.append({"name": name, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": by, "max_abs_err": err,
                     "bytes": nbytes, "flops": nflops, "R": R, "blocks": B})
    # off the main path or around the kernels: reported, not in the summary
    st_bytes = co_bytes + R * 4 * f4
    print(json.dumps({
        "kernel": "packed_correct_outer(with_stats)",
        "kernel_ms": time_ms(lambda: pk.packed_correct_outer(
            p, m, d, cu, cv, rb, eta, mu, rho, with_stats=True, out=outs)),
        "plain_ms": time_ms(lambda: pk.packed_correct_outer_ref(
            p, m, d, cu, cv, rb, eta, mu, rho, with_stats=True)),
        "bound_ms": bound(st_bytes, 17 * n)[0], "bytes": st_bytes,
        "on_main_path": False}))
    parts = pk.packed_row_stats(d, m)
    seg = layout.device_tables(dev)[1]
    rows_ = seg[:layout.n_blocks]
    print(json.dumps({
        "op": "packed_stats = row stats kernel + segment sum",
        "ms": time_ms(lambda: pk.packed_stats(d, m, layout)),
        "segment_sum_ms": time_ms(lambda: torch.segment_reduce(
            parts.t().reshape(-1), "sum", lengths=seg)),
        # the same sums over the (R, 3) rows, axis 0: PyTorch's per-thread
        # loop over each segment, kept to show why the flat form is used
        "segment_sum_rows_ms": time_ms(lambda: torch.segment_reduce(
            parts[:layout.data_rows], "sum", lengths=rows_, axis=0)),
        "branch_scalars_ms": time_ms(lambda: pk.branch_scalars(
            blocks, HeLoCoConfig())),
    }))
    return rows


def slice_phase(torch, pk, golden):
    from repro_torch.async_engine.engine import make_engine, make_eval_fn
    from repro_torch.launch.train import parse_args, run_config_from_args

    args = parse_args(["--arch", "tinygpt-15m", "--workers", "4",
                       "--paces", "1,2,6,15", "--outer", "12", "--inner", "2",
                       "--batch", "4", "--seq", "128", "--eval-every", "3",
                       "--device", "cuda"])
    eng = make_engine(run_config_from_args(args), device="cuda")
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

    eng._obtain = timed(eng._obtain, "inner_round")
    eng.server.on_arrival = timed(eng.server.on_arrival, "server_step")
    eval_fn = timed(make_eval_fn(eng, batch=8), "eval")
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    hist = eng.run(eval_every=args.eval_every, eval_fn=eval_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = pk.launch_counts()

    rows = [[a["outer_step"], a["worker_id"],
             a["outer_step"] - 1 - a["staleness"], a["staleness"], a["lang"],
             a["rho"], a["sim_time"], bool(a["dropped"])]
            for a in hist.arrivals]
    assert json.loads(json.dumps(rows)) == golden["arrivals"], \
        f"arrivals differ from the golden:\n{rows}\n{golden['arrivals']}"
    n = len(rows)
    assert n == 12 and all(c == n for c in counts.values()), \
        f"launch counts {counts} after {n} arrivals"
    tensors = [eng.server._pbuf, eng.server._mbuf,
               *eng.server.state.params.values()]
    for w in eng.workers.values():
        tensors += [*w.opt.mu.values(), *w.opt.nu.values()]
    for task in eng._pending.values():          # rounds still in flight
        tensors += [*task.params.values(), *task.opt.mu.values()]
    assert all(t.device.type == "cuda" for t in tensors), "a tensor left the card"
    means = [e["mean"] for e in hist.evals]
    assert means and all(math.isfinite(x) for x in means), means
    for e in hist.evals:
        print(f"eval step {e['step']:3d}  t={e['time']:5.1f}s  "
              f"loss={e['mean']:.4f}  per_lang={e['per_lang']}")
    print(json.dumps({
        "slice": "tinygpt-15m full width, 4 workers (1,2,6,15), H=2, "
                 "12 arrivals, batch 4 x 128, heloco",
        "params": sum(t.numel() for t in eng.server.state.params.values()),
        "arrivals_equal_golden": True, "launches": counts,
        "wall_s": wall, "wall_ms_per_arrival": 1e3 * wall / n,
        "median_ms": {k: statistics.median(v) for k, v in spans.items()},
        "first_ms": {k: v[0] for k, v in spans.items()},
        "eval_means": means,
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}))
    return counts, n


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
    golden = json.loads(GOLDEN.read_text())

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
    counts, n_arrivals = slice_phase(torch, pk, golden)

    kernels = []
    for r in rows:
        print(json.dumps({"kernel": r["name"], "kernel_ms": r["ms"],
                          "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                          "bound_by": r["bound_by"], "bytes": r["bytes"],
                          "bandwidth_Bps": bw, "fp32_flops": flops,
                          "library_ms": None,
                          "launches_per_arrival": counts[r["name"]] / n_arrivals,
                          "R": r["R"], "blocks": r["blocks"]}))
        kernels.append({
            "name": r["name"], "route": "cuda",
            "source": "src/repro_torch/csrc/packed.cu",
            "replaces": {"packed_row_stats": "src/repro/kernels/packed.py:59",
                         "packed_correct_outer":
                             "src/repro/kernels/packed.py:175"}[r["name"]],
            "launches": counts[r["name"]], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
