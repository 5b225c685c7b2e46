"""Probe of the flash-attention kernel on the card: build it, check it over
the card tests' shapes, time it beside SDPA.

    PYTHONPATH=src python -m repro_torch.launch.flash_probe

Builds ``csrc/flash_attention.cu`` alone and prints the compiler's report
and each kernel's instruction counts (``cuobjdump -sass``: HGMMA, HMMA,
LDS, UTMALDG, SYNCS); holds ``flash_attention_fwd`` to its plain version
(bf16 within 2e-2, fp32 within 2e-5) and to a second launch on the same
inputs (the same bits) over the shapes of ``tests/test_torch_cuda.py``,
D in {32, 64, 128}, causal and not; then times it beside
``scaled_dot_product_attention`` at the serve shapes and at (BH 16, S 4096,
D 128), each call behind a hold of the stream (median of 20, device time).
Run from a copy of the repository whose kernel source was edited, it
measures the edit: the package and its build come from ``src`` of the
working directory. Exits 1 if a case disagrees; raises without a card.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

CASES = ((3, 256, 256), (2, 200, 200), (2, 128, 384), (2, 320, 320),
         (2, 1000, 1000), (2, 200, 1000), (2, 1000, 200), (2, 384, 128),
         (2, 1, 300), (2, 1, 1), (16, 2048, 2048), (40, 1000, 1000),
         (70, 200, 1000))
TIMED = ((32, 1024, 32), (32, 128, 32), (16, 4096, 128))
SASS_OPS = ("HGMMA", "HMMA", "LDS", "UTMALDG", "SYNCS")


def _time_ms(fn, iters=20):
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _report_build():
    for name, (secs, log) in _build.build_all(["flash_attention"]).items():
        print(f"build {name} {secs:.1f}s")
        print(log)
    from torch.utils.cpp_extension import CUDA_HOME
    tool = (os.path.join(CUDA_HOME, "bin", "cuobjdump") if CUDA_HOME
            else "cuobjdump")
    lib = _build.target("flash_attention")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            counts[cur] = {}
        for op in SASS_OPS:
            if cur and op in line:
                counts[cur][op] = counts[cur].get(op, 0) + 1
    for fn, c in counts.items():
        print(fn, c)


def main() -> int:
    dev = resolve_device("cuda")
    _report_build()
    gen = torch.Generator(device=dev).manual_seed(0)
    bad, maxerr = 0, {}
    for bh, sq, skv in CASES:
        for d in fa.HEAD_DIMS:
            if bh == 16 and d != 128:
                continue
            for dtype in (torch.bfloat16, torch.float32):
                q = torch.randn((bh, sq, d), generator=gen,
                                device=dev).to(dtype)
                k, v = (torch.randn((bh, skv, d), generator=gen,
                                    device=dev).to(dtype) for _ in range(2))
                for causal in (True, False):
                    got = fa.flash_attention_fwd(q, k, v, causal=causal,
                                                 q_chunk=sq, kv_chunk=skv)
                    want = fa.flash_attention_fwd_ref(q, k, v, causal)
                    err = (got.float() - want.float()).abs().max().item()
                    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
                    ok = torch.allclose(got.float(), want.float(), rtol=tol,
                                        atol=tol)
                    same = torch.equal(got, fa.flash_attention_fwd(
                        q, k, v, causal=causal, q_chunk=sq, kv_chunk=skv))
                    tag = "ok " if ok and same else "BAD"
                    bad += tag == "BAD"
                    maxerr[str(dtype)] = max(maxerr.get(str(dtype), 0), err)
                    print(tag, bh, sq, skv, d, dtype, causal, f"{err:.2e}",
                          same)
    sys.stdout.flush()
    for bh, s, d in TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn((bh, s, d), generator=gen,
                                   device=dev).to(dtype) for _ in range(3))
            for causal in (True, False):
                km = _time_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, causal=causal, q_chunk=s, kv_chunk=s))
                sm = _time_ms(lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=causal))
                print(f"time {bh} {s} {d} {dtype} causal={causal}: kernel "
                      f"{km:.4f} sdpa {sm:.4f} ratio {km / sm:.2f}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print("maxerr", maxerr)
    print("bad", bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
