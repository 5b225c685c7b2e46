"""AdamW inner optimizer with global-norm clipping.

Port of ``repro/optim/adamw.py`` with the reference's order of operations
(``torch.optim.AdamW`` orders them differently): clip by the global norm,
count from 1, bias-correct both moments, and decay decoupled as
``pf - lr*(step + wd*pf)``. Host scalars (lr, bias corrections) are fp32,
as the reference computes them.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import InnerOptConfig
from repro_torch.optim.schedules import constant, cosine_warmup

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    mu: Params
    nu: Params
    count: int


def init_adam(params: Mapping[str, torch.Tensor]) -> AdamState:
    z = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
    return AdamState(mu=z, nu={k: torch.zeros_like(v) for k, v in z.items()},
                     count=0)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads: Mapping[str, torch.Tensor],
                        max_norm: float) -> Params:
    gn = global_norm(grads)
    scale = torch.clamp_max(gn.new_full((), max_norm)
                            / torch.clamp_min(gn, 1e-9), 1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: AdamState,
                 cfg: InnerOptConfig):
    """Returns (new_params, new_state); inputs are left untouched."""
    if cfg.grad_clip > 0:
        grads = clip_by_global_norm(grads, cfg.grad_clip)
    count = state.count + 1
    sched = cosine_warmup if cfg.schedule == "cosine" else constant
    lr = float(sched(count, cfg.lr, warmup_steps=cfg.warmup_steps,
                     total_steps=cfg.total_steps))
    f = np.float32
    bc1 = float(f(1.0) - f(cfg.b1) ** f(count))
    bc2 = float(f(1.0) - f(cfg.b2) ** f(count))
    b1, b2 = cfg.b1, cfg.b2
    mu2, nu2, out = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        mu2[k] = b1 * state.mu[k] + (1 - b1) * g
        nu2[k] = b2 * state.nu[k] + (1 - b2) * torch.square(g)
        step = (mu2[k] / bc1) / (torch.sqrt(nu2[k] / bc2) + cfg.eps)
        pf = p.float()
        out[k] = (pf - lr * (step + cfg.weight_decay * pf)).to(p.dtype)
    return out, AdamState(mu=mu2, nu=nu2, count=count)
