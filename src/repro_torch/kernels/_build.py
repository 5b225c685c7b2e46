"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/kernels/lib<name>-<hash>.so`` at the checkout's root, then
loaded with ``ctypes``; ``bind`` also declares its entry points' argument
types, and ``launch`` calls one on the current stream. The hash covers the
source and the flags, so an edited source builds anew and an unchanged one
is reused. Nothing builds when a module is imported: the first launch on a
CUDA tensor builds, and ``build_all`` builds every source at once (one
``nvcc`` each, all started together).

Worker threads of the wall-clock runtime launch kernels beside the server
thread, so ``load`` checks, builds and opens a library under one lock (a
second caller waits for the first's build and gets its handle), each
build's temporary file names its process and thread, and ``count_launch``
bumps a wrapper's launch count under a lock of its own.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Mapping, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("packed", "leaf", "quantize", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """One more launch of ``wrapper``'s kernel, counted under a lock."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def temp_path(lib: Path) -> Path:
    """Where a build of ``lib`` writes before its atomic rename: named by
    process and thread, so concurrent builds never share the file."""
    return lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile every stale source in parallel. Returns ``{name: (seconds,
    compiler output)}`` (``(0.0, "cached")`` for an up-to-date library) and
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, out = {}, {}
    nvcc = None
    for name in names:
        lib = target(name)
        if lib.exists():
            out[name] = (0.0, "cached")
            continue
        nvcc = nvcc or _nvcc()
        tmp = temp_path(lib)
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed;
    every thread gets the one handle."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(target(name)))
            _LIBS[name] = lib
        return lib


def bind(name: str, signatures: Mapping[str, Sequence]) -> ctypes.CDLL:
    """``load(name)`` with the argument types of the named entry points
    declared; every entry point returns an int, ``cudaGetLastError()``."""
    lib = load(name)
    for fn, args in signatures.items():
        getattr(lib, fn).argtypes = list(args)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@functools.cache
def sm_count(index: int) -> int:
    """SM count of CUDA device ``index``, read once: it sizes each grid."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def ctas_per_sm(query, index: int, count: int) -> Tuple[int, ...]:
    """The resident CTAs one SM of CUDA device ``index`` holds of each of
    ``count`` kernels, from the C occupancy query ``query`` (``count`` int
    pointers)."""
    ctas = [ctypes.c_int() for _ in range(count)]
    with torch.cuda.device(index):
        err = query(*(ctypes.byref(c) for c in ctas))
    if err != 0:
        raise RuntimeError(f"{query.__name__}: CUDA error {err}")
    return tuple(c.value for c in ctas)


def check_cuda(*tensors: torch.Tensor):
    """Tensors a kernel reads element by element: on the card, contiguous."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"CUDA kernel given a {t.device} tensor")
        if not t.is_contiguous():
            raise ValueError("CUDA kernel needs contiguous tensors")


def launch(name: str, fn, device, *args):
    """Call the C launcher ``fn`` with ``args``, the device's SM count and
    its current stream; raise if the launch failed."""
    with torch.cuda.device(device):
        err = fn(*args, sm_count(device.index),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
