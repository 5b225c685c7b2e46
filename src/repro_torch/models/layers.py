"""Shared building blocks of the dense transformer: layernorm, RoPE, the gelu
MLP, the tied embedding, and the fp32 cross-entropy.

Port of ``repro/models/layers.py``. Each module declares its parameters on
the ``meta`` device under the reference's leaf names; values are supplied
per call (``Model.loss``), so one module serves every worker. Compute runs
in ``cfg.compute_dtype``; parameters are stored in ``cfg.param_dtype``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def meta_param(cfg: ModelConfig, *shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=getattr(torch, cfg.param_dtype),
                                    device="meta"))


class LayerNorm(nn.Module):
    """Layernorm computed in fp32 and cast back to the input's dtype."""

    def __init__(self, cfg: ModelConfig, d: int):
        super().__init__()
        self.eps = cfg.norm_eps
        self.scale = meta_param(cfg, d)
        self.bias = meta_param(cfg, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + self.eps)
        out = out * self.scale.float() + self.bias.float()
        return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S). Half-split rotation in fp32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    ang = positions[..., None].float() * freqs                  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                          # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class MLP(nn.Module):
    """gelu MLP; ``jax.nn.gelu`` defaults to the tanh approximation."""

    def __init__(self, cfg: ModelConfig, d: int, ff: int):
        super().__init__()
        self.w_in = meta_param(cfg, d, ff)
        self.w_down = meta_param(cfg, ff, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(x @ self.w_in.to(x.dtype), approximate="tanh")
        return h @ self.w_down.to(x.dtype)


class Embed(nn.Module):
    """Token embedding, tied with the output head."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.tok = meta_param(cfg, cfg.vocab_size, cfg.d_model)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.tok.to(dtype_of(self.cfg))[tokens]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.tok.to(x.dtype).T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy over ``mask``, computed in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    mask = mask.float()
    return ((logz - ll) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
