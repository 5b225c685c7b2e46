"""Kernels of the per-leaf HeLoCo correction (paper Alg. 2).

Port of ``repro/kernels/heloco_correct.py``. The correction of one leaf is
one reduction sweep and one elementwise sweep:

  block_stats    one read of (u, v) -> per block (u.v, u.u, v.v), (L, 3)
  correct_apply  one read of (u, v) -> out = cu*u + cv*v per block

A leaf is viewed as ``(L, n)``: L blocks of n contiguous elements, L the
product of its stacked layer axes (1 for a plain tensor), so one launch
covers every layer where the reference vmaps one launch per layer. The
elements are read as they lie, with a guarded tail, not padded to the
reference's (R, 128) TPU tiling.

correct_apply streams 16-byte accesses, 16 elements a lane, a CTA for every
256 such units (``tiling.plan``); a stacked leaf is one flat range whose
float4 each take their own block's scalars. On an NVIDIA H100 80GB HBM3 at
a 700 W power limit it takes 0.0555 ms on the tied embedding of
tinygpt-15m, read from memory, as ``torch.add`` does (``csrc/leaf.cu``).

Each wrapper launches the CUDA kernel of ``csrc/leaf.cu`` for a CUDA tensor
and raises if it cannot; it runs the plain PyTorch version beside it
(``*_ref``) only for a tensor on the CPU. Each wrapper counts its launches
in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tiling import aligned, plan

_ptr = ctypes.c_void_p
_SIGNATURES = {
    "block_stats_f32": [_ptr] * 4 + [ctypes.c_longlong] * 2 +
                       [ctypes.c_int] * 2 + [_ptr],
    "leaf_ctas_per_sm": [_ptr] * 3,
    "correct_apply_f32": [_ptr] * 5 + [ctypes.c_longlong] * 3 +
                         [ctypes.c_int] * 2 + [_ptr],
}
# block_stats: the least elements one CTA of the first pass sums (256
# threads, 16 each), and CTAs that fill the card (8 per SM)
_MIN_CHUNK = 4096
_CTAS_PER_SM = 8


@functools.cache
def _lib():
    return _build.bind("leaf", _SIGNATURES)


@functools.cache
def ctas_per_sm(index: int) -> Tuple[int, int, int]:
    """The resident CTAs one SM of CUDA device ``index`` holds of
    correct_apply on one block and on stacked blocks, and of outer_update
    (the CUDA occupancy query; ``chip_smoke.py`` reports them)."""
    return _build.ctas_per_sm(_lib().leaf_ctas_per_sm, index, 3)


def _check_blocks(*xs: torch.Tensor) -> torch.device:
    """Equal-shaped (L, n) fp32 tensors on one device."""
    for x in xs:
        if x.dim() != 2 or x.shape != xs[0].shape:
            raise ValueError(f"expected matching (L, n) blocks, got "
                             f"{tuple(x.shape)} and {tuple(xs[0].shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32 blocks, got {x.dtype}")
        if x.device != xs[0].device:
            raise ValueError("blocks on different devices")
    return xs[0].device


# ---------------------------------------------------------------------------
# block_stats
# ---------------------------------------------------------------------------

def block_stats_ref(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: (L, n) x 2 -> (L, 3) rows of (u.v, u.u, v.v)."""
    return torch.stack([(u * v).sum(1), (u * u).sum(1), (v * v).sum(1)],
                       dim=1)


def block_stats(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u, v: (L, n) fp32. One read of each; returns the per-block sums
    (u.v, u.u, v.v), (L, 3) fp32, added in a fixed order (two passes when a
    block is split over several CTAs)."""
    device = _check_blocks(u, v)
    if device.type == "cpu":
        return block_stats_ref(u, v)
    _build.check_cuda(u, v)
    blocks, n = u.shape
    sms = _build.sm_count(device.index)
    chunks = max(1, min(-(-n // _MIN_CHUNK), _CTAS_PER_SM * sms // blocks))
    out = torch.empty((blocks, 3), dtype=torch.float32, device=device)
    part = (torch.empty((blocks * chunks, 3), dtype=torch.float32,
                        device=device) if chunks > 1 else out)
    _build.launch("block_stats", _lib().block_stats_f32, device,
                  u.data_ptr(), v.data_ptr(), part.data_ptr(), out.data_ptr(),
                  blocks, n, chunks)
    _build.count_launch(block_stats)
    return out


block_stats.launches = 0


# ---------------------------------------------------------------------------
# correct_apply
# ---------------------------------------------------------------------------

def correct_apply_ref(u: torch.Tensor, v: torch.Tensor, cu: torch.Tensor,
                      cv: torch.Tensor) -> torch.Tensor:
    """Plain version: ``cu[l]*u + cv[l]*v`` for each block l."""
    return cu[:, None] * u + cv[:, None] * v


def correct_apply(u: torch.Tensor, v: torch.Tensor, cu: torch.Tensor,
                  cv: torch.Tensor) -> torch.Tensor:
    """u, v: (L, n) fp32; cu, cv: (L,) fp32 branch scalars on the same
    device, read there by the kernel (they never go to the host). One read
    of u and v; returns ``cu*u + cv*v`` per block, (L, n) fp32."""
    device = _check_blocks(u, v)
    for c in (cu, cv):
        if c.shape != (u.shape[0],) or c.dtype != torch.float32:
            raise ValueError("cu/cv must be (L,) float32")
        if c.device != device:
            raise ValueError("cu/cv must be on the blocks' device")
    if device.type == "cpu":
        return correct_apply_ref(u, v, cu, cv)
    _build.check_cuda(u, v, cu, cv)
    out = torch.empty_like(u)
    blocks, n = u.shape
    grid, units = plan(u.numel(), aligned((u, 16), (v, 16), (out, 16)))
    _build.launch("correct_apply", _lib().correct_apply_f32, device,
                  u.data_ptr(), v.data_ptr(), cu.data_ptr(), cv.data_ptr(),
                  out.data_ptr(), blocks, n, units, grid)
    _build.count_launch(correct_apply)
    return out


correct_apply.launches = 0

KERNEL_WRAPPERS = (block_stats, correct_apply)
