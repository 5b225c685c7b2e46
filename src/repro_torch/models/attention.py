"""Grouped-query attention: the training path and the KV-cache serving path.

Port of ``repro/models/attention.py``. Training: q/k/v projections (with
their biases under ``qkv_bias``) and RoPE on q and k, attention (causal, or
not for an encoder) with fp32 scores and a masked fp32
softmax, and the output projection, as plain PyTorch ops under autograd.
The reference computes the same function through a chunked custom-vjp; the
chunking only bounds memory.

Serving: prefill attends over the fresh prompt through the flash-attention
forward kernel (``kernels/flash_attention.py``; its plain version on the
CPU), and decode attends one query against the first ``pos + 1`` rows of a
KV cache in plain PyTorch, as the reference leaves decode to jnp.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.models.layers import Params, Shapes, apply_rope

NEG_INF = -1e30


def attention_shapes(cfg: ModelConfig) -> Shapes:
    """``init_attention``'s leaves: wq, wk, wv, wo, and the q, k, v biases
    under ``qkv_bias``."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pd = cfg.param_dtype
    out = {"wq": ((d, h, hd), pd), "wk": ((d, kv, hd), pd),
           "wv": ((d, kv, hd), pd), "wo": ((h, hd, d), pd)}
    if cfg.qkv_bias:
        out.update(bq=((h, hd), pd), bk=((kv, hd), pd), bv=((kv, hd), pd))
    return out


def qkv_project(p: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v (B, S, heads, D) in x's dtype: the projections, the biases
    (before RoPE) and RoPE on q and k."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
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


def attn_output(p: Params, ctx: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", ctx, p["wo"].to(ctx.dtype))


# ---------------------------------------------------------------------------
# Serving: prefill attention and the KV cache
# ---------------------------------------------------------------------------

def prefill_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool) -> torch.Tensor:
    """q: (B,S,H,D); k, v: (B,S,KV,D) -> (B,S,H,D) through one launch of
    ``flash_attention_fwd`` over (B*H, S, D): heads grouped into the batch
    axis, each kv head broadcast to its H/KV query heads (GQA). The kernel
    tiles by its own sizes, so the chunks are S and divide any S."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]

    def heads(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, s, hd).contiguous()

    out = flash_attention_fwd(heads(q), heads(k.repeat_interleave(g, dim=2)),
                              heads(v.repeat_interleave(g, dim=2)),
                              causal=causal, q_chunk=s, kv_chunk=s)
    return out.reshape(b, h, s, hd).permute(0, 2, 1, 3)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_len, kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype,
                             device=device)}


def cache_write(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                v_new: torch.Tensor, pos: int) -> Dict[str, torch.Tensor]:
    """Write (B, S_new, KV, D) at position ``pos``. In place (the reference
    returns new arrays; writing in place saves a copy of the cache per layer
    and token); returns ``cache``."""
    s = k_new.shape[1]
    cache["k"][:, pos:pos + s] = k_new.to(cache["k"].dtype)
    cache["v"][:, pos:pos + s] = v_new.to(cache["v"].dtype)
    return cache


def decode_attend(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  pos: int, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: x (B,1,d), cache (B,T,KV,D), pos an int. Writes the
    token's k and v at ``pos`` and attends over the cache with the rows at
    or past ``kv_valid = pos + 1`` masked: fp32 scores, a masked fp32
    softmax, probabilities in the compute dtype times v, as the reference's
    jnp path."""
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    q, k_new, v_new = qkv_project(p, x, cfg, positions)
    cache = cache_write(cache, k_new, v_new, pos)
    k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, 1, kvh, h // kvh, hd)
    scores = torch.einsum("bckgd,bskd->bkgcs", qg.float(), k.float()) \
        * hd ** -0.5
    valid = torch.arange(k.shape[1], device=x.device) < pos + 1
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bkgcs,bskd->bckgd", probs, v).reshape(b, 1, h, hd)
    return attn_output(p, ctx), cache
