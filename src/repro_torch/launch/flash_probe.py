"""Probe of the flash-attention kernel on the card: build it, check it over
the card tests' shapes, time it beside SDPA.

    PYTHONPATH=src python -m repro_torch.launch.flash_probe
    PYTHONPATH=src python -m repro_torch.launch.flash_probe --compare ROOT ...

Builds ``csrc/flash_attention.cu`` alone and prints the compiler's report
and each kernel's instruction counts (``cuobjdump -sass``: HGMMA, HMMA,
LDS, UTMALDG, SYNCS); holds ``flash_attention_fwd`` to its plain version
(bf16 within 2e-2, fp32 within 2e-5) and to a second launch on the same
inputs (the same bits) over the shapes of ``tests/test_torch_cuda.py``,
at D 16, 32, 64, 80, 128, 144 and 256 (every padded width), causal and
not; then times it beside ``scaled_dot_product_attention`` at the serve
shapes, at (BH 16, S 4096, D 128) and at hubert-xlarge's and
paligemma-3b's prefill shapes (D 80 and 256), each call behind a hold of
the stream (median of 20, device time).
Run from a copy of the repository whose kernel source was edited, it
measures the edit: the package and its build come from ``src`` of the
working directory. Exits 1 if a case disagrees; raises without a card.

``--compare`` times the kernels of several source trees in one call on one
card: for each ROOT (a checkout, or an unpacked commit such as the parent
under ``build/``) a process of its own imports ``ROOT/src``'s package,
builds into ``ROOT/build`` and times ``flash_attention_fwd`` and SDPA at
COMPARED, bf16 and fp32, causal and not, with q, k and v rotating over
copies that hold more than twice the L2 (inputs read from memory, as
``chip_smoke.py`` times them); the roots run in order and then in reverse
(parent, change, change, parent), one JSON line each.
"""
from __future__ import annotations

import json
import math
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
DIMS = (16, 32, 64, 80, 128, 144, 256)
TIMED = ((32, 1024, 32), (32, 128, 32), (16, 4096, 128), (64, 128, 80),
         (32, 384, 256))
SASS_OPS = ("HGMMA", "HMMA", "LDS", "UTMALDG", "SYNCS")
# (BH, Sq, Skv, D) for --compare: the families' prefill shapes (paligemma-3b
# at D 256 also at BH 16 and 8), chip_smoke's padded-width cases, the serve
# shape and the long D 128 one
COMPARED = ((32, 384, 384, 256), (16, 384, 384, 256), (8, 384, 384, 256),
            (64, 128, 128, 80), (112, 128, 128, 128), (64, 128, 128, 64),
            (16, 200, 200, 16), (2, 128, 384, 80), (2, 384, 128, 256),
            (32, 1024, 1024, 32), (16, 4096, 4096, 128))
L2_BYTES = 50 * 2 ** 20


def _cold(t):
    """A callable that returns t and clones of it in turn, together more
    than twice the L2."""
    copies = [t] + [t.clone() for _ in range(
        max(1, math.ceil(2 * L2_BYTES / (t.numel() * t.element_size()))))]
    state = {"i": -1}

    def take():
        state["i"] = (state["i"] + 1) % len(copies)
        return copies[state["i"]]
    return take


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


def time_compared() -> dict:
    """This process's package (``fa``) at COMPARED: (ms, SDPA ms) by case."""
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {"src": os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(fa.__file__))))}
    for bh, sq, skv, d in COMPARED:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((bh, sq, d), generator=gen, device=dev).to(dtype)
            k, v = (torch.randn((bh, skv, d), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            qs, ks, vs = _cold(q), _cold(k), _cold(v)
            for causal in (True, False):
                km = _time_ms(lambda: fa.flash_attention_fwd(
                    qs(), ks(), vs(), causal=causal, q_chunk=sq,
                    kv_chunk=skv))
                sm = _time_ms(lambda: F.scaled_dot_product_attention(
                    qs()[None], ks()[None], vs()[None], is_causal=causal))
                out[f"{bh},{sq},{skv},{d},{str(dtype)[6:]},"
                    f"{'causal' if causal else 'full'}"] = [km, sm]
            del q, k, v, qs, ks, vs
    return out


def compare(roots) -> int:
    """Each root's kernel at COMPARED, roots in order then in reverse."""
    script = os.path.abspath(__file__)
    for order in (roots, roots[::-1]):
        for root in order:
            root = os.path.abspath(root)
            subprocess.run([sys.executable, script, "--time-compared"],
                           cwd=root, check=True,
                           env={**os.environ,
                                "PYTHONPATH": os.path.join(root, "src")})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--compare"]:
        return compare(sys.argv[2:])
    if sys.argv[1:] == ["--time-compared"]:
        print("COMPARED " + json.dumps(time_compared()), flush=True)
        return 0
    dev = resolve_device("cuda")
    _report_build()
    gen = torch.Generator(device=dev).manual_seed(0)
    bad, maxerr = 0, {}
    for bh, sq, skv in CASES:
        for d in DIMS:
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
