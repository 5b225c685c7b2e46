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

Placed (DTensor) activations: ``_constrain_heads`` pins q with its batch
over ``act_batch_axes`` and its heads over ``act_model_axis``, where the
reference's ``qkv_project`` pins it. The attention itself runs on each
rank's local shard under ``local_map`` (``sharding.on_shards``): the
training Function and prefill on the batch shard and the rank's q heads,
with k and v gathered over the head axis and each rank taking the kv
heads its q heads read (GQA: q head h reads kv head h // G, and the kv
heads need not divide the axis; their gradient is a ``Partial`` sum over
it); decode on the batch shard of the cache with all heads and the whole
sequence gathered, its new k and v written back at the cache's own
placements. A head count that does not divide the axis is gathered
rather than sharded unevenly.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.models.layers import (Params, Shapes, apply_rope, placed,
                                      tp_product)

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


def _constrain_heads(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The reference's ``_constrain_heads``: a placed (B,S,H,D) ``t`` with
    its batch over ``act_batch_axes`` and its heads over
    ``act_model_axis``; a no-op unless both are set, on a whole tensor and
    on an abstract mesh. Heads that do not divide the axis are sharded
    unevenly, where the reference pads."""
    if not cfg.act_model_axis or not cfg.act_batch_axes:
        return t
    from repro_torch.dist.sharding import Spec, current_mesh, place
    mesh = current_mesh()
    if mesh is None or mesh.device_mesh is None or not placed(t):
        return t
    return place(t, Spec((tuple(cfg.act_batch_axes), None,
                          cfg.act_model_axis, None)), mesh, even=False)


def qkv_project(p: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v (B, S, heads, D) in x's dtype: the projections, the biases
    (before RoPE) and RoPE on q and k; q pinned before and after RoPE, as
    the reference pins it. A placed ``x`` projects on each rank's batch
    shard, the weights' heads split over the model axis where the rules
    shard them so (``layers.tp_product``)."""
    dt = x.dtype

    def proj(xl, wl):
        return torch.einsum("bsd,dhk->bshk", xl, wl.to(dt))
    if placed(x):
        tp = cfg.act_model_axis or "model"
        q, k, v = (tp_product(proj, x, p[w], axis=tp, w_dim=1, out_dim=2)
                   for w in ("wq", "wk", "wv"))
    else:
        q, k, v = (proj(x, p[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = _constrain_heads(q, cfg)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = _constrain_heads(q, cfg)
    return q, k, v


def _on_head_shards(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """``fn(q, k, v)`` of (B,S,H,D) and (B,S,KV,D) local tensors on each
    rank's shard of placed ones: the batch over q's batch axes, q's heads
    over the axis it shards them on (when they divide it), k and v gathered
    over that axis; each rank passes ``fn`` the kv heads its q heads read,
    a contiguous slice when its heads are whole groups, else one kv head
    for each q head. Returns ``fn``'s output at q's placements."""
    from torch.distributed.tensor import Shard
    from repro_torch.dist.sharding import (batch_axes_of, mesh_axes,
                                           on_shards, placements_by_axis)
    dm = q.device_mesh
    h, kvh = q.shape[2], k.shape[2]
    head = next((a for a, pl in mesh_axes(q).items()
                 if pl == Shard(2) and h % dm.size(
                     dm.mesh_dim_names.index(a)) == 0), None)
    batch = {a: 0 for a in batch_axes_of(q)}
    q_pl = placements_by_axis(dm, {**batch, **({head: 2} if head else {})})
    kv_pl = placements_by_axis(dm, batch)
    kv_grad = placements_by_axis(dm, batch, partial=(head,) if head else ())
    lo = dm.get_local_rank(head) * (h // dm.size(
        dm.mesh_dim_names.index(head))) if head else 0
    g = h // kvh

    def local(ql, kl, vl):
        n = ql.shape[2]
        if lo % g == 0 and n % g == 0:
            cut = slice(lo // g, (lo + n) // g)
            return fn(ql, kl[:, :, cut], vl[:, :, cut])
        idx = torch.div(torch.arange(lo, lo + n, device=ql.device), g,
                        rounding_mode="floor")
        return fn(ql, kl[:, :, idx], vl[:, :, idx])

    return on_shards(local, (q, k, v), (q_pl, kv_pl, kv_pl), (q_pl,),
                     device_mesh=dm, in_grad_placements=(q_pl, kv_grad,
                                                         kv_grad))


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
    past ``kv_valid`` (default Skv) are masked. Placed tensors run it on
    each rank's shard (``_on_head_shards``)."""
    if placed(q):
        return _on_head_shards(
            lambda ql, kl, vl: flash_attention(
                ql, kl, vl, causal=causal, q_offset=q_offset,
                kv_valid=kv_valid, q_chunk=q_chunk), q, k, v)
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


def _out_proj(ctx: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", ctx, wo.to(ctx.dtype))


def attn_output(p: Params, ctx: torch.Tensor, cfg: Optional[ModelConfig] = None
                ) -> torch.Tensor:
    """The output projection; a placed ``ctx`` with its heads over the
    model axis contracts them there (a row product, summed over it)."""
    if placed(ctx):
        tp = (cfg.act_model_axis if cfg is not None else "") or "model"
        return tp_product(_out_proj, ctx, p["wo"], axis=tp, w_dim=0,
                          x_dim=2)
    return _out_proj(ctx, p["wo"])


# ---------------------------------------------------------------------------
# Serving: prefill attention and the KV cache
# ---------------------------------------------------------------------------

def prefill_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool) -> torch.Tensor:
    """q: (B,S,H,D); k, v: (B,S,KV,D) -> (B,S,H,D) through one launch of
    ``flash_attention_fwd`` over (B*H, S, D): heads grouped into the batch
    axis, each kv head broadcast to its H/KV query heads (GQA). The kernel
    tiles by its own sizes, so the chunks are S and divide any S. Placed
    tensors launch it once on each rank's shard (``_on_head_shards``)."""
    if placed(q):
        return _on_head_shards(
            lambda ql, kl, vl: prefill_attend(ql, kl, vl, causal=causal),
            q, k, v)
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


def _decode_ctx(q: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int
                ) -> torch.Tensor:
    """One query against the cache's first ``pos + 1`` rows: fp32 scores, a
    masked fp32 softmax, probabilities in q's dtype times v."""
    k, v = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, 1, kvh, h // kvh, hd)
    scores = torch.einsum("bckgd,bskd->bkgcs", qg.float(), k.float()) \
        * hd ** -0.5
    valid = torch.arange(k.shape[1], device=q.device) < pos + 1
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgcs,bskd->bckgd", probs, v).reshape(b, 1, h, hd)


def _decode_on_shards(q, k_new, v_new, cache: Dict[str, torch.Tensor],
                      pos: int) -> torch.Tensor:
    """``_decode_ctx`` of placed tensors on each rank's batch shard of the
    cache (batch-sharded caches; a sequence-sharded cache is gathered
    whole), every head and the whole sequence gathered: the token's k and v
    written at ``pos`` into the gathered cache, which goes back into
    ``cache`` at the cache's own placements (on a mesh where nothing was
    gathered, the write lands in the cache itself)."""
    from repro_torch.dist.sharding import (batch_axes_of, on_shards,
                                           placements_by_axis)
    dm = cache["k"].device_mesh
    pl = placements_by_axis(dm, {a: 0 for a in batch_axes_of(cache["k"])})

    def local(ql, kn, vn, ck, cv):
        local_cache = cache_write({"k": ck, "v": cv}, kn, vn, pos)
        return _decode_ctx(ql, local_cache, pos), ck, cv

    ctx, ck, cv = on_shards(local, (q, k_new, v_new, cache["k"], cache["v"]),
                            (pl,) * 5, (pl,) * 3, device_mesh=dm)
    for name, new in (("k", ck), ("v", cv)):
        if new.to_local().data_ptr() != cache[name].to_local().data_ptr():
            cache[name].copy_(new.redistribute(dm, cache[name].placements))
    return ctx


def decode_attend(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  pos: int, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: x (B,1,d), cache (B,T,KV,D), pos an int. Writes the
    token's k and v at ``pos`` and attends over the cache with the rows at
    or past ``kv_valid = pos + 1`` masked: fp32 scores, a masked fp32
    softmax, probabilities in the compute dtype times v, as the reference's
    jnp path. A placed cache runs on each rank's shard
    (``_decode_on_shards``)."""
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    q, k_new, v_new = qkv_project(p, x, cfg, positions)
    if placed(cache["k"]):
        ctx = _decode_on_shards(q, k_new, v_new, cache, pos)
    else:
        cache = cache_write(cache, k_new, v_new, pos)
        ctx = _decode_ctx(q, cache, pos)
    return attn_output(p, ctx, cfg), cache
