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
are the same, and the int8 payload ``q`` of ``quantize_block`` holds the n
elements flat, without the reference's zero padding.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import HeLoCoConfig
from repro_torch.kernels import heloco_correct as hk
from repro_torch.kernels import outer_update as ok
from repro_torch.kernels import quantize as qk
from repro_torch.kernels.packed import branch_scalars


def heloco_correct_leaves(deltas: Sequence[torch.Tensor],
                          moms: Sequence[torch.Tensor], h: HeLoCoConfig,
                          stacked_axes: Sequence[int], *,
                          reduce_stats: Optional[Sequence[Callable]] = None
                          ) -> List[torch.Tensor]:
    """Alg. 2 on many leaves through the kernels: one statistics launch per
    leaf, the branch scalars of every block at once on the device
    (``branch_scalars`` over the stacked (sum L, 3) stats, the same math as
    the reference's inline scalars, block by block), one apply launch per
    leaf reading its slice of them.

    stacked_axes[i]: leading layer axes of leaf i; each layer is its own
    block, all of them in one launch of each kernel (the reference vmaps
    one launch per layer). Returns the corrected leaves in their dtypes.
    ``reduce_stats[i](stats)``: leaf i's per-block sums over the whole
    leaf, when ``deltas[i]`` is one rank's shard of it (a sum over the
    ranks that hold its other shards).
    """
    us, vs, stats = [], [], []
    for i, (d, m, nax) in enumerate(zip(deltas, moms, stacked_axes)):
        blocks = math.prod(d.shape[:nax])
        us.append(d.float().reshape(blocks, -1).contiguous())
        vs.append(m.float().reshape(blocks, -1).contiguous())
        stats.append(hk.block_stats(us[-1], vs[-1]))
        if reduce_stats is not None:
            stats[-1] = reduce_stats[i](stats[-1])
    cu, cv = branch_scalars(torch.cat(stats), h)
    out, first = [], 0
    for d, u, v in zip(deltas, us, vs):
        last = first + u.shape[0]
        out.append(hk.correct_apply(u, v, cu[first:last], cv[first:last])
                   .reshape(d.shape).to(d.dtype))
        first = last
    return out


def heloco_correct_block(delta: torch.Tensor, mom: torch.Tensor,
                         h: HeLoCoConfig, stacked_axes: int = 0
                         ) -> torch.Tensor:
    """Alg. 2 on one leaf through the kernels (``heloco_correct_leaves`` of
    one leaf): one statistics launch, the branch scalars on the device, one
    apply launch. Returns the corrected leaf in ``delta``'s dtype."""
    return heloco_correct_leaves([delta], [mom], h, [stacked_axes])[0]


def outer_update_block(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                       eta: float, mu: float, rho: float):
    """The fused Nesterov step of Eqs. 17-19 on one leaf in one launch.
    Returns (p' in ``p``'s dtype, m' in fp32)."""
    p_new, m_new = ok.outer_update_2d(p.float().contiguous(),
                                      m.float().contiguous(),
                                      g.float().contiguous(), eta, mu, rho)
    return p_new.to(p.dtype), m_new


def quantize_block(x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tensor int8 of one tensor in two launches (absmax, quantize).
    Returns (q: the n elements flat, int8; scale: 0-d fp32; n: (1,) int32),
    all on ``x``'s device, n filled there so that the host does not wait on
    the stream. The reference's q is the same values padded with zeros to
    its (R, 128) tiling."""
    q, scale = qk.quantize_2d(x.float().contiguous())
    n = torch.full((1,), x.numel(), dtype=torch.int32, device=x.device)
    return q.reshape(-1), scale.reshape(()), n


def dequantize_block(q: torch.Tensor, scale: torch.Tensor, shape,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``quantize_block``'s payload back to a tensor of ``shape`` and
    ``dtype`` in one launch; q may also carry the reference's zero padding
    after its n elements."""
    n = math.prod(shape)
    x = qk.dequantize_2d(q.contiguous(), scale)
    return x.reshape(-1)[:n].reshape(shape).to(dtype)
