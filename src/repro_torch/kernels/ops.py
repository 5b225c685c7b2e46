"""Per-leaf entry points of the kernels: one tensor (a "leaf" of the
parameter dict) at a time.

Port of ``repro/kernels/ops.py``. The arrival hot path does not go through
these: the packed path (``kernels/packed.py`` over ``core/packing.py``)
takes the whole parameter dict as one buffer in O(1) launches. These
remain the per-leaf correctness path (``Synchronizer(packed=False,
use_kernel=True)``) and the entry point for single-tensor use.

Each leaf is cast to fp32 before its kernels and back to its dtype after,
so the kernels are fp32-only. A leaf is read as its contiguous elements,
not padded to the reference's (R, 128) TPU tiling (``_to_2d``); the results
are the same.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import HeLoCoConfig
from repro_torch.kernels import heloco_correct as hk
from repro_torch.kernels import outer_update as ok
from repro_torch.kernels.packed import branch_scalars


def heloco_correct_block(delta: torch.Tensor, mom: torch.Tensor,
                         h: HeLoCoConfig, stacked_axes: int = 0
                         ) -> torch.Tensor:
    """Alg. 2 on one leaf through the kernels: one statistics launch, the
    branch scalars on the device (``branch_scalars``, the same math as the
    reference's inline scalars), one apply launch.

    stacked_axes: leading layer axes of the leaf; each layer is its own
    block, all of them in one launch of each kernel (the reference vmaps
    one launch per layer). Returns the corrected leaf in ``delta``'s dtype.
    """
    blocks = math.prod(delta.shape[:stacked_axes])
    u = delta.float().reshape(blocks, -1).contiguous()
    v = mom.float().reshape(blocks, -1).contiguous()
    cu, cv = branch_scalars(hk.block_stats(u, v), h)
    return hk.correct_apply(u, v, cu, cv).reshape(delta.shape).to(delta.dtype)


def outer_update_block(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                       eta: float, mu: float, rho: float):
    """The fused Nesterov step of Eqs. 17-19 on one leaf in one launch.
    Returns (p' in ``p``'s dtype, m' in fp32)."""
    p_new, m_new = ok.outer_update_2d(p.float().contiguous(),
                                      m.float().contiguous(),
                                      g.float().contiguous(), eta, mu, rho)
    return p_new.to(p.dtype), m_new
