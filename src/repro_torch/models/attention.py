"""Grouped-query attention, training path.

Port of the training path of ``repro/models/attention.py``: q/k/v
projections with RoPE on q and k, causal attention with fp32 scores and a
masked fp32 softmax, and the output projection, as plain PyTorch ops under
autograd. The reference computes the same function through a chunked
custom-vjp; the chunking only bounds memory.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, meta_param

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = meta_param(cfg, d, h, hd)
        self.wk = meta_param(cfg, d, kv, hd)
        self.wv = meta_param(cfg, d, kv, hd)
        self.wo = meta_param(cfg, h, hd, d)


def qkv_project(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(dt))
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool) -> torch.Tensor:
    """q: (B,S,H,D); k, v: (B,S,KV,D) -> (B,S,H,D). Scores are the fp32
    products of the compute-dtype inputs, as the reference accumulates them."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    scores = torch.einsum("bckgd,bskd->bkgcs", qg.float(), k.float()) \
        * hd ** -0.5
    if causal:
        idx = torch.arange(s, device=q.device)
        scores = scores.masked_fill(idx[None, :] > idx[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgcs,bskd->bckgd", probs, v)
    return out.reshape(b, s, h, hd)


def attn_output(p: Attention, ctx: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", ctx, p.wo.to(ctx.dtype))
