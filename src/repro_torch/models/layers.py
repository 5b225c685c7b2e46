"""Shared building blocks: norms, RoPE, MLPs, embeddings and the LM head,
and the fp32 cross-entropy.

Port of ``repro/models/layers.py``. Functions take their parameters as a
dict of tensors under the reference's leaf names (``{"scale", "bias"}``,
``{"w_gate", "w_up", "w_down", ...}``), so one model object serves every
worker. Compute runs in ``cfg.compute_dtype``; parameters are stored in
``cfg.param_dtype``.

Placed (DTensor) activations: ``constrain_acts`` is the reference's pin at
block boundaries. The norms and RoPE run as DTensor operations; the
``local_map`` sites (``sharding.on_shards``) are every product
(``tp_product``: the attention projections tensor-parallel over the
heads; the MLP and the LM head on the batch shard with their weights
gathered), the embedding (DTensor's index strategy does not take a
sharded table with sharded indices) and the loss's sums, and the
recurrent mixers (``mixer_on_batch_shard``).
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


def constrain_acts(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Pin activations at block boundaries, the reference's
    ``constrain_acts``: a no-op unless ``cfg.act_batch_axes`` is set.
    Otherwise a placed (DTensor) ``x`` goes to the ambient mesh
    (``sharding.current_mesh``) with its batch over ``act_batch_axes`` and,
    under ``cfg.seq_parallel`` with ``x.ndim >= 3``, its sequence over
    ``act_model_axis or "model"`` (Megatron-SP). A sequence that does not
    divide that axis is sharded unevenly, where the reference pads. A
    whole tensor (an unplaced step) and an abstract mesh (the dry-run's)
    leave ``x`` as it is."""
    if not cfg.act_batch_axes:
        return x
    from repro_torch.dist.sharding import Spec, current_mesh, place
    mesh = current_mesh()
    if mesh is None or mesh.device_mesh is None or not placed(x):
        return x
    seq = (cfg.act_model_axis or "model") if (
        cfg.seq_parallel and x.ndim >= 3) else None
    spec = Spec((tuple(cfg.act_batch_axes), seq) + (None,) * (x.ndim - 2))
    return place(x, spec, mesh, even=False)


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


def placed(x) -> bool:
    """Whether ``x`` is a DTensor: a placed step's activation."""
    from repro_torch.dist.sharding import is_placed
    return is_placed(x)


def tp_product(fn, x: torch.Tensor, w: torch.Tensor, *, axis: str,
               w_dim: int, x_dim: Optional[int] = None,
               out_dim: Optional[int] = None) -> torch.Tensor:
    """``fn(x, w)``, a product, of a placed ``x`` and weight ``w`` on each
    rank's batch shard (``local_map``), tensor-parallel over ``axis``:
      - column (``x_dim`` None): ``x`` whole over ``axis``; where ``w``
        shards its dim ``w_dim`` over it, each rank takes its part of
        ``w`` and the output's dim ``out_dim`` is sharded alike (x's
        gradient a ``Partial`` sum over ``axis``), else ``w`` is whole;
      - row (``x_dim`` given): where ``x`` shards its dim ``x_dim`` over
        ``axis``, ``w``'s dim ``w_dim`` is cut alike and the output is a
        ``Partial`` sum over ``axis``, else both are whole.
    ``w``'s other shards are gathered (FSDP's all-gather) and its gradient
    is a sum over the batch axes. DTensor's own product would merge the
    batch and sequence dims, each sharded over its axis, and cannot part
    them again evenly, so every product runs here."""
    from torch.distributed.tensor import Shard
    from repro_torch.dist.sharding import (batch_axes_of, mesh_axes,
                                           on_shards, placements_by_axis)
    dm = x.device_mesh
    batch = {a: 0 for a in batch_axes_of(x)}
    sizes = dict(zip(dm.mesh_dim_names, dm.shape))
    if x_dim is None:
        tp = mesh_axes(w).get(axis) == Shard(w_dim) and sizes[axis] > 1
    else:
        tp = mesh_axes(x).get(axis) == Shard(x_dim) and sizes[axis] > 1
    cut = {axis: w_dim} if tp else {}
    x_pl = placements_by_axis(dm, {**batch, **({axis: x_dim}
                                               if tp and x_dim is not None
                                               else {})})
    w_pl = placements_by_axis(dm, cut)
    if x_dim is None:
        out_pl = placements_by_axis(dm, {**batch, **({axis: out_dim}
                                                     if tp else {})})
        x_grad = placements_by_axis(dm, batch,
                                    partial=(axis,) if tp else ())
    else:
        out_pl = placements_by_axis(dm, batch, partial=(axis,) if tp else ())
        x_grad = x_pl
    w_grad = placements_by_axis(dm, cut, partial=tuple(batch))
    return on_shards(fn, (x, w), (x_pl, w_pl), (out_pl,), device_mesh=dm,
                     in_grad_placements=(x_grad, w_grad))


def mixer_on_batch_shard(fn, p: Params, x: torch.Tensor, cfg: ModelConfig,
                         state=None, return_state: bool = False, *,
                         like=None):
    """A recurrent mixer ``fn(p, x, cfg, state, return_state)`` of a
    placed ``x`` on each rank's batch shard, its weights gathered whole
    (``sharding.on_batch_shard``, as training runs it): (output, the
    mixer's state or None). A serving state is a tree of ``like``'s
    structure (the mixer's zero state; dicts and tuples kept) whose leaves
    are DTensors with their batch dim (0) over ``x``'s batch axes: each
    rank reads its shard of every leaf, and the state ``fn`` returns comes
    back as DTensors at that placement, one ``local_map`` output a leaf.
    No leaf is gathered."""
    from torch.utils._pytree import tree_flatten, tree_unflatten
    from repro_torch.dist.sharding import (batch_axes_of, on_batch_shard,
                                           on_shards, placements_by_axis)
    if state is None and not return_state:
        return on_batch_shard(lambda xl, w: fn(w, xl, cfg)[0], x, p), None
    dm = x.device_mesh
    rows = placements_by_axis(dm, {a: 0 for a in batch_axes_of(x)})
    whole = placements_by_axis(dm)
    names = list(p)
    leaves, tree = tree_flatten(like if state is None else state)
    ins = [] if state is None else leaves

    def local(xl, *ts):
        st = (None if state is None else
              tree_unflatten(list(ts[len(names):]), tree))
        y, new = fn(dict(zip(names, ts[:len(names)])), xl, cfg, state=st,
                    return_state=return_state)
        return (y, *tree_flatten(new)[0])

    out = on_shards(local, (x, *p.values(), *ins),
                    (rows,) + (whole,) * len(names) + (rows,) * len(ins),
                    (rows,) * (1 + len(leaves)), device_mesh=dm)
    return out[0], tree_unflatten(list(out[1:]), tree)


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
    """The MLP; a placed ``x`` runs on each rank's batch shard with the
    weights gathered (``sharding.on_batch_shard``)."""
    if placed(x):
        from repro_torch.dist.sharding import on_batch_shard
        return on_batch_shard(lambda xl, w: apply_mlp(w, xl, cfg), x, p)
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


def _embed(tok: torch.Tensor, tokens: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    # F.embedding, not tok[tokens]: on the CPU the indexed gather's
    # backward (index_put_ with accumulate) adds a repeated token's rows in
    # an order that depends on the intra-op threads, so two identical pods
    # parted at 4 threads; the embedding's backward adds them in a fixed
    # order, the one-thread index_put_'s bits at any thread count
    x = F.embedding(tokens, tok.to(dtype_of(cfg)))
    if cfg.embed_scale:
        # sqrt(d_model) cast to the compute dtype first, as the reference
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def embed_tokens(p: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The token table's rows. Placed tokens index a gathered table on
    each rank's batch shard (``local_map``: DTensor's index strategy does
    not take a sharded table with sharded indices)."""
    if placed(tokens):
        from repro_torch.dist.sharding import on_batch_shard
        return on_batch_shard(lambda t, w: _embed(w["tok"], t, cfg), tokens,
                              {"tok": p["tok"]})
    return _embed(p["tok"], tokens, cfg)


def lm_logits(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The LM head; a placed ``x`` runs on each rank's batch shard with the
    table gathered."""
    if placed(x):
        from repro_torch.dist.sharding import on_batch_shard
        return on_batch_shard(lambda xl, w: lm_logits(w, xl, cfg), x, p)
    if cfg.tied_embeddings:
        return x @ p["tok"].to(x.dtype).T
    return x @ p["lm_head"].to(x.dtype)


def _nll_sums(logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    mask = mask.float()
    return ((logz - ll) * mask).sum(), mask.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy over ``mask``, computed in fp32. Placed
    logits take their sums on each rank's batch shard (``local_map``),
    added over the batch axes before the division."""
    if placed(logits):
        from repro_torch.dist.sharding import (batch_axes_of, on_shards,
                                               placements_by_axis)
        dm = logits.device_mesh
        axes = batch_axes_of(logits)
        rows = placements_by_axis(dm, {a: 0 for a in axes})
        summed = placements_by_axis(dm, partial=axes)
        num, den = on_shards(_nll_sums, (logits, labels, mask),
                             (rows, rows, rows), (summed, summed),
                             device_mesh=dm)
    else:
        num, den = _nll_sums(logits, labels, mask)
    return num / torch.clamp_min(den, 1.0)
