"""Plain oracles of the per-leaf kernel paths: the paper's equations as
written, the ground truth ``kernels/ops.py`` is held to.

Port of ``repro/kernels/ref.py``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import HeLoCoConfig
from repro_torch.core.heloco import correct_block


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
