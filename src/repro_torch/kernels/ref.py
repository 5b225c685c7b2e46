"""Plain oracles of the per-leaf kernel paths: the paper's equations as
written, the ground truth ``kernels/ops.py`` is held to.

Port of ``repro/kernels/ref.py``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import HeLoCoConfig
from repro_torch.core.heloco import correct_block
from repro_torch.kernels.quantize import QMAX, SCALE_FLOOR


def ref_heloco_correct(delta: torch.Tensor, mom: torch.Tensor,
                       h: HeLoCoConfig) -> torch.Tensor:
    """The paper-equation implementation of Alg. 2 (``core/heloco.py``)."""
    return correct_block(delta, mom, h)


def ref_outer_update(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                     eta: float, mu: float, rho: float):
    """Eqs. 17-19 with each Python constant rounded to fp32 where it meets
    an fp32 value, as the reference's jnp does. Returns (p', m' fp32)."""
    f = np.float32
    gf = float(f(rho)) * g.float()
    m_new = float(f(mu)) * m.float() + float(f(1.0 - mu)) * gf
    p_new = p.float() - float(f(eta)) * (gf + float(f(mu)) * m_new)
    return p_new.to(p.dtype), m_new


def ref_quantize(x: torch.Tensor):
    """Per-tensor int8: (q int8 of x's shape, scale 0-d fp32), scale =
    max(max|x|, 1e-12) / 127 and q = clip(round(x / scale), -127, 127),
    with IEEE divisions; a NaN quotient gives 0."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(), SCALE_FLOOR) / torch.tensor(
        float(QMAX), device=x.device)
    q = torch.clamp(torch.round(xf / scale), -QMAX, QMAX)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8), scale


def ref_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
