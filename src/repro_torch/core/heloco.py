"""HeLoCo on the packed outer state: momentum-guided look-ahead (Eq. 5) and
the per-block directional correction of stale pseudo-gradients fused with
the Nesterov outer update (Alg. 1-2, Eqs. 7-19).

Port of the packed path of ``repro/core/heloco.py``. An arrival is one
statistics sweep plus one fused correct+outer sweep over the packed
(R, 128) buffers: two kernel launches whatever the number of tensors.
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
                         out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Process one arrival on the packed (R, 128) outer state.

    delta: the arriving pseudo-gradient dict (packed here). Returns
    (pbuf', mbuf'); ``out=(pbuf, mbuf)`` updates the state in place.
    """
    m = _methods.resolve(method)
    dbuf = packing.pack(layout, delta)
    ctx = _methods.ArrivalCtx(outer_lr=outer_lr, mu=mu, h=h, rho=rho,
                              tau=tau, layout=layout)
    cu, cv = m.packed_coeffs(m, ctx, dbuf, mbuf)
    row_block, _ = layout.device_tables(pbuf.device)
    return pk.packed_correct_outer(pbuf, mbuf, dbuf, cu, cv, row_block,
                                   outer_lr, mu, rho, out=out)


def momentum_decay_packed(pbuf: torch.Tensor, mbuf: torch.Tensor,
                          outer_lr: float, mu: float, method="heloco",
                          rho: float = 1.0, tau: float = 0.0):
    """Dropped-arrival step (App. A.6) on packed state: the method applied
    to a zero pseudo-gradient, with no correction sweep."""
    m = _methods.resolve(method)
    ctx = _methods.ArrivalCtx(outer_lr=outer_lr, mu=mu, rho=rho, tau=tau)
    c_m, c_p = _methods.decay_coeffs(m, ctx)
    return (pbuf - float(np.float32(outer_lr) * c_p) * mbuf,
            float(c_m) * mbuf)
