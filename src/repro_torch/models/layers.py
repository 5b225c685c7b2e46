"""Shared building blocks: norms, RoPE, MLPs, embeddings and the LM head,
and the fp32 cross-entropy.

Port of ``repro/models/layers.py``. Functions take their parameters as a
dict of tensors under the reference's leaf names (``{"scale", "bias"}``,
``{"w_gate", "w_up", "w_down", ...}``), so one model object serves every
worker. Compute runs in ``cfg.compute_dtype``; parameters are stored in
``cfg.param_dtype``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = Dict[str, torch.Tensor]
Shapes = Dict[str, Tuple[Tuple[int, ...], str]]   # leaf -> (shape, dtype)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_shapes(cfg: ModelConfig, d: int) -> Shapes:
    """``init_norm``'s leaves: a scale, and a bias for layernorm only."""
    out = {"scale": ((d,), cfg.param_dtype)}
    if cfg.norm == "layernorm":
        out["bias"] = ((d,), cfg.param_dtype)
    return out


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Layernorm or RMSNorm, computed in fp32 and cast back to x's dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        var = (xf ** 2).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    return out.to(x.dtype)


def rmsnorm_gated(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Mamba2's gated RMSNorm, norm(x * silu(z)) * scale: the gate in x's
    dtype, the norm in fp32, cast back to x's dtype."""
    xf = (x * F.silu(z)).float()
    var = (xf ** 2).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over seq, the reference's Mamba2 ``_conv1d``
    and xLSTM ``_causal_conv``. x: (B,S,C); w: (K,C). Returns (silu(conv
    + b) (B,S,C), the last K-1 inputs (B,K-1,C) in x's dtype): ``cache``
    (the previous call's window) before ``x``, zeros without one."""
    k = w.shape[0]
    if cache is None:
        cache = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    ext = torch.cat([cache.to(x.dtype), x], dim=1)           # (B, S+K-1, C)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + ext[:, i: i + x.shape[1]] * w[i].to(x.dtype)
    out = F.silu(out + b.to(x.dtype))
    return out, ext[:, ext.shape[1] - (k - 1):]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_shapes(cfg: ModelConfig, d: int, ff: int) -> Shapes:
    """``init_mlp``'s leaves: w_gate, w_up, w_down (swiglu, geglu) or w_in,
    w_down (gelu), with their biases under ``mlp_bias``."""
    pd = cfg.param_dtype
    if cfg.mlp_act in ("swiglu", "geglu"):
        out = {"w_gate": ((d, ff), pd), "w_up": ((d, ff), pd)}
    else:
        out = {"w_in": ((d, ff), pd)}
    out["w_down"] = ((ff, d), pd)
    if cfg.mlp_bias:
        for name in (("b_gate", "b_up") if cfg.mlp_act in ("swiglu", "geglu")
                     else ("b_in",)):
            out[name] = ((ff,), pd)
        out["b_down"] = ((d,), pd)
    return out


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp_act in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        if cfg.mlp_bias:
            g = g + p["b_gate"].to(dt)
            u = u + p["b_up"].to(dt)
        h = (F.silu(g) if cfg.mlp_act == "swiglu" else gelu(g)) * u
    else:
        h = x @ p["w_in"].to(dt)
        if cfg.mlp_bias:
            h = h + p["b_in"].to(dt)
        h = gelu(h)
    out = h @ p["w_down"].to(dt)
    if cfg.mlp_bias:
        out = out + p["b_down"].to(dt)
    return out


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------

def embed_shapes(cfg: ModelConfig) -> Shapes:
    """``init_embed``'s leaves: the token table, and the output head when
    the embeddings are not tied."""
    out = {"tok": ((cfg.vocab_size, cfg.d_model), cfg.param_dtype)}
    if not cfg.tied_embeddings:
        out["lm_head"] = ((cfg.d_model, cfg.vocab_size), cfg.param_dtype)
    return out


def embed_tokens(p: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    x = p["tok"].to(dtype_of(cfg))[tokens]
    if cfg.embed_scale:
        # sqrt(d_model) cast to the compute dtype first, as the reference
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def lm_logits(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tied_embeddings:
        return x @ p["tok"].to(x.dtype).T
    return x @ p["lm_head"].to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy over ``mask``, computed in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    mask = mask.float()
    return ((logz - ll) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
