"""HeLoCo on the packed outer state: momentum-guided look-ahead (Eq. 5) and
the per-block directional correction of stale pseudo-gradients fused with
the Nesterov outer update (Alg. 1-2, Eqs. 7-19).

Port of the packed path of ``repro/core/heloco.py``. An arrival is at
most one statistics sweep plus one fused correct+outer sweep over the
packed (R, 128) buffers: two kernel launches at most, whatever the number
of tensors, and one for every method but HeLoCo.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import HeLoCoConfig
from repro_torch.core import methods as _methods
from repro_torch.core import packing
from repro_torch.kernels import packed as pk


def lookahead_packed(pbuf: torch.Tensor, mbuf: torch.Tensor,
                     outer_lr: float, mu: float) -> torch.Tensor:
    """theta_bar = theta - eta * mu * m (Eq. 5), on packed buffers."""
    return pbuf - float(np.float32(outer_lr * mu)) * mbuf


def apply_arrival_packed(pbuf: torch.Tensor, mbuf: torch.Tensor,
                         delta: Mapping[str, torch.Tensor], layout, *,
                         method, outer_lr: float, mu: float, h: HeLoCoConfig,
                         rho: float = 1.0, tau: float = 0.0,
                         abuf: Optional[torch.Tensor] = None,
                         phase: Optional[int] = None,
                         out: Optional[Tuple[torch.Tensor, ...]] = None):
    """Process one arrival on the packed (R, 128) outer state.

    delta: the arriving pseudo-gradient dict (packed here); abuf: the
    method's packed accumulator (buffered methods only); phase: the
    outer-step index at arrival (only buffered schedules read it). Returns
    (pbuf', mbuf'), or (pbuf', mbuf', abuf') for buffered methods; ``out``
    names the output buffers (the state itself for an in-place update).

    Every registered method reduces to per-block scalars (cu, cv, cq), so an
    arrival is at most one statistics sweep (HeLoCo) plus one fused sweep:
    the accumulator kernel for a custom schedule, the quadratic kernel for a
    ``cq`` term, else the plain correct+outer kernel.
    """
    m = _methods.resolve(method)
    dbuf = packing.pack(layout, delta)
    ctx = _methods.ArrivalCtx(outer_lr=outer_lr, mu=mu, h=h, rho=rho,
                              tau=tau, phase=phase, layout=layout)
    cu, cv, cq = m.packed_coeffs(m, ctx, dbuf, mbuf)
    row_block, _ = layout.device_tables(pbuf.device)
    if m.custom_update:
        if cq is not None:
            raise NotImplementedError(
                f"method {m.name!r}: a quadratic (cq) term combined with "
                "a custom schedule is not supported on the packed path")
        if abuf is None:
            abuf = packing.zeros(layout, pbuf.device)
        if out is not None and len(out) == 2:
            out = (*out, abuf)
        res = pk.packed_correct_outer_acc(
            pbuf, mbuf, abuf, dbuf, cu, cv, row_block, outer_lr, rho,
            *_methods.schedule_coeffs(m, ctx), out=out)
        return res if m.uses_buffer else res[:2]
    if cq is not None:
        return pk.packed_correct_outer_quad(pbuf, mbuf, dbuf, cu, cv, cq,
                                            row_block, outer_lr, mu, rho,
                                            out=out)
    return pk.packed_correct_outer(pbuf, mbuf, dbuf, cu, cv, row_block,
                                   outer_lr, mu, rho, out=out)


def momentum_decay_packed(pbuf: torch.Tensor, mbuf: torch.Tensor,
                          outer_lr: float, mu: float, method="heloco",
                          rho: float = 1.0, tau: float = 0.0,
                          abuf: Optional[torch.Tensor] = None,
                          phase: Optional[int] = None):
    """Dropped-arrival step (App. A.6) on packed state: the method applied
    to a zero pseudo-gradient, with no correction sweep. Returns (p', m'),
    or (p', m', b') for buffered methods."""
    m = _methods.resolve(method)
    ctx = _methods.ArrivalCtx(outer_lr=outer_lr, mu=mu, rho=rho, tau=tau,
                              phase=phase)
    if m.custom_update:
        return _methods.scheduled_decay_packed(m, ctx, pbuf, mbuf, abuf)
    c_m, c_p = _methods.decay_coeffs(m, ctx)
    return (pbuf - float(np.float32(outer_lr) * c_p) * mbuf,
            float(c_m) * mbuf)
