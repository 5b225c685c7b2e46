"""Inner (worker-local) training loop: H AdamW steps from a look-ahead
initialization, producing a pseudo-gradient (paper Eqs. 2-3).

Port of ``repro/train/inner.py``."""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import InnerOptConfig
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamState, adamw_update

Params = Dict[str, torch.Tensor]


class InnerResult(NamedTuple):
    params: Params
    opt: AdamState
    losses: torch.Tensor      # (H,)


def batch_to_device(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Token/label arrays -> int64 tensors on ``device`` (other keys dropped)."""
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device, torch.long)
            for k in ("tokens", "labels")}


def run_inner(model: Model, inner_cfg: InnerOptConfig,
              params: Mapping[str, torch.Tensor], opt: AdamState, sampler,
              h_steps: int, step_offset: int = 0) -> InnerResult:
    """H local steps; data drawn from ``sampler.sample(step)`` per step.
    ``params`` and ``opt`` are not modified (every step makes new tensors),
    so the caller keeps theta_bar for the pseudo-gradient."""
    device = next(iter(params.values())).device
    losses = []
    for h in range(h_steps):
        batch = batch_to_device(sampler.sample(step_offset + h), device)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = model.loss(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        params, opt = adamw_update({k: v.detach() for k, v in leaves.items()},
                                   dict(zip(leaves, grads)), opt, inner_cfg)
        losses.append(loss.detach())
    return InnerResult(params=params, opt=opt, losses=torch.stack(losses))


def pseudo_gradient(theta_init: Mapping[str, torch.Tensor],
                    theta_final: Mapping[str, torch.Tensor]) -> Params:
    """Delta = theta_bar - theta_H (descent displacement, Eq. 3)."""
    return {k: theta_init[k].float() - theta_final[k].float()
            for k in theta_init}


@torch.no_grad()
def eval_loss(model: Model, params: Mapping[str, torch.Tensor],
              batch: Mapping[str, np.ndarray]) -> float:
    device = next(iter(params.values())).device
    return float(model.loss(params, batch_to_device(batch, device)))
