"""Grouped-query attention: the training path and the KV-cache serving path.

Port of ``repro/models/attention.py``. Training: q/k/v projections (with
their biases under ``qkv_bias``) and RoPE on q and k, attention (causal, or
not for an encoder) and the output projection. Attention goes through
``flash_attention``, the reference's custom-vjp (``_make_flash``) as a
``torch.autograd.Function``: queries in chunks of ``q_chunk``, each chunk's
fp32 scores against the whole key sequence, and only (q, k, v, out, lse)
saved for the backward, which recomputes each chunk's scores. So a layer
keeps no (S, S) block per head for autograd, and the scores live one chunk
at a time. ``attend(use_flash=False)`` is the plain version the tests hold
it to: the whole fp32 score matrix and a softmax under autograd.

Serving: prefill attends over the fresh prompt through the flash-attention
forward kernel (``kernels/flash_attention.py``; its plain version on the
CPU), and decode attends one query against the first ``pos + 1`` rows of a
KV cache in plain PyTorch, as the reference leaves decode to jnp.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def _chunk_scores(qc: torch.Tensor, k: torch.Tensor, q_idx: torch.Tensor,
                  kv_valid: int, causal: bool, scale: float) -> torch.Tensor:
    """One query chunk's masked fp32 scores: qc (B,C,KV,G,D), k (B,S,KV,D)
    -> (B,KV,G,C,S), the products of the compute-dtype inputs accumulated
    in fp32 (the reference's ``preferred_element_type``), times D^-0.5,
    -1e30 past ``kv_valid`` and, causal, past each query's position."""
    s = torch.einsum("bckgd,bskd->bkgcs", qc.float(), k.float()) * scale
    kv_idx = torch.arange(k.shape[1], device=k.device)
    mask = kv_idx[None, :] < kv_valid
    if causal:
        mask = mask & (kv_idx[None, :] <= q_idx[:, None])
    return s.masked_fill(~mask, NEG_INF)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_make_flash``: q5 (B,S,KV,G,D) in ``n`` chunks of
    ``c`` queries against k, v (B,S_kv,KV,D). Forward per chunk
    (``_flash_chunk_fwd``): m = max s, p = exp(s - m), l = sum p, lse = m +
    log l, out = (p / l in q's dtype) v. Backward per chunk
    (``_flash_chunk_bwd``): p = exp(s - lse), dv = p^T do, dp = do v^T and
    delta = sum do * out in fp32, ds = p (dp - delta) D^-0.5, dq and dk
    from ds in q's dtype; dk and dv summed over chunks in fp32."""

    @staticmethod
    def forward(ctx, q5, k, v, causal: bool, q_offset: int, kv_valid: int,
                n: int):
        scale = q5.shape[-1] ** -0.5
        c = q5.shape[1] // n
        out = torch.empty_like(q5)
        lses = []
        for i in range(n):
            sl = slice(i * c, (i + 1) * c)
            q_idx = q_offset + torch.arange(sl.start, sl.stop,
                                            device=q5.device)
            s = _chunk_scores(q5[:, sl], k, q_idx, kv_valid, causal, scale)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            del s
            l = p.sum(-1, keepdim=True)
            lses.append((m + torch.log(l))[..., 0])
            out[:, sl] = torch.einsum("bkgcs,bskd->bckgd",
                                      (p / l).to(q5.dtype), v)
            del p
        ctx.save_for_backward(q5, k, v, out, torch.stack(lses, 1))
        ctx.causal, ctx.q_offset, ctx.kv_valid, ctx.n = (causal, q_offset,
                                                         kv_valid, n)
        return out

    @staticmethod
    def backward(ctx, do):
        q5, k, v, out, lse = ctx.saved_tensors
        scale = q5.shape[-1] ** -0.5
        c = q5.shape[1] // ctx.n
        dq = torch.empty_like(q5)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for i in range(ctx.n):
            sl = slice(i * c, (i + 1) * c)
            qc, doc = q5[:, sl], do[:, sl]
            q_idx = ctx.q_offset + torch.arange(sl.start, sl.stop,
                                                device=q5.device)
            s = _chunk_scores(qc, k, q_idx, ctx.kv_valid, ctx.causal, scale)
            p = torch.exp(s - lse[:, i, ..., None])
            del s
            dv += torch.einsum("bkgcs,bckgd->bskd", p.to(doc.dtype),
                               doc).float()
            dp = torch.einsum("bckgd,bskd->bkgcs", doc.float(), v.float())
            delta = torch.einsum("bckgd,bckgd->bkgc", doc.float(),
                                 out[:, sl].float())
            ds = (p * (dp - delta[..., None]) * scale).to(q5.dtype)
            del p, dp
            dq[:, sl] = torch.einsum("bkgcs,bskd->bckgd", ds, k)
            dk += torch.einsum("bkgcs,bckgd->bskd", ds, qc).float()
            del ds
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0,
                    kv_valid: Optional[int] = None,
                    q_chunk: int = 128) -> torch.Tensor:
    """Memory-lean training attention: q (B,Sq,H,D), k, v (B,Skv,KV,D) ->
    (B,Sq,H,D) through ``_FlashAttention``. Queries go in chunks of
    ``min(q_chunk, Sq)``; a chunk that does not divide Sq makes the whole
    sequence one chunk, as the reference's ``flash_attention``. Rows at or
    past ``kv_valid`` (default Skv) are masked."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    q5 = q.reshape(b, sq, kvh, h // kvh, hd)
    q_chunk = min(q_chunk, sq)
    n = sq // q_chunk if sq % q_chunk == 0 else 1
    out = _FlashAttention.apply(q5, k, v, causal, q_offset,
                                k.shape[1] if kv_valid is None
                                else int(kv_valid), n)
    return out.reshape(b, sq, h, hd)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, q_chunk: int = 128,
           use_flash: bool = True) -> torch.Tensor:
    """q: (B,S,H,D); k, v: (B,S,KV,D) -> (B,S,H,D). ``use_flash`` routes
    through ``flash_attention`` in chunks of ``q_chunk``, as the
    reference's ``attend``; ``use_flash=False`` is the plain version the
    tests hold it to: the whole fp32 score matrix (the fp32 products of the
    compute-dtype inputs, as the reference accumulates them) and a masked
    fp32 softmax under autograd."""
    if use_flash:
        return flash_attention(q, k, v, causal=causal, q_chunk=q_chunk)
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
