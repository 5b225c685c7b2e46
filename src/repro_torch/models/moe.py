"""Mixture-of-Experts FFN: top-k token-choice routing with capacity-based
dispatch, in token groups.

Port of ``repro/models/moe.py``. Tokens are processed in groups of
``cfg.moe.group_size``; each group routes in fp32 (the router is fp32
whatever ``param_dtype``), keeps the top k experts of each token with their
probabilities renormalised, and places the (token, choice) pairs in
token-major order (token 0's k choices, then token 1's, ...) into per-expert
slots; a pair past its expert's capacity is dropped. The experts are plain
batched matmuls, as the reference leaves them to XLA outside any kernel.
A Switch-style load-balance loss is returned beside the output.

Top-k: ``jax.lax.top_k`` breaks ties toward the lower index; a stable
descending sort does the same, where ``torch.topk`` promises no order.

Placed (DTensor) activations: ``apply_moe`` is the ``local_map`` site
(``sharding.on_batch_shard``). ``route``'s stable sort and the dispatch's
``index_add`` have no DTensor sharding strategy, so the token groups run
on each rank's batch shard (the whole batch when a group spans shards),
with the router, the experts and the shared expert gathered.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, Shapes, placed


def moe_shapes(cfg: ModelConfig) -> Shapes:
    """``init_moe``'s leaves: the fp32 router (d, E), the experts' w_gate,
    w_up (E, d, ff) and w_down (E, ff, d), and the shared expert's
    ``shared/w_*`` under ``shared_expert``."""
    pd = cfg.param_dtype
    d, e, ff = cfg.d_model, cfg.moe.n_experts, cfg.moe.expert_d_ff
    out = {"router": ((d, e), "float32"), "w_gate": ((e, d, ff), pd),
           "w_up": ((e, d, ff), pd), "w_down": ((e, ff, d), pd)}
    if cfg.moe.shared_expert:
        out.update({"shared/w_gate": ((d, ff), pd),
                    "shared/w_up": ((d, ff), pd),
                    "shared/w_down": ((ff, d), pd)})
    return out


def expert_capacity(cfg: ModelConfig, group: int) -> int:
    m = cfg.moe
    c = int(math.ceil(m.top_k * group / m.n_experts * m.capacity_factor))
    return max(4, -(-c // 4) * 4)  # round up to multiple of 4


def route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest probabilities of each row and their indices, ties to
    the lower index (``jax.lax.top_k``'s order)."""
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_p[:, :k], top_i[:, :k]


def _group_moe(p: Params, xg: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xg: (g, d) -> (out (g, d), aux loss scalar)."""
    m = cfg.moe
    g, d = xg.shape
    e, k = m.n_experts, m.top_k
    cap = expert_capacity(cfg, g)
    dt = xg.dtype

    logits = xg.float() @ p["router"]                       # (g, E) fp32
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = route(probs, k)                          # (g, k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # Switch-style load-balance aux loss.
    density = F.one_hot(top_i[:, 0], e).float().mean(0)
    aux = e * torch.sum(density * probs.mean(0))

    expert_of = top_i.reshape(-1)                           # (g*k,)
    sel = F.one_hot(expert_of, e)                           # (g*k, E)
    pos = ((torch.cumsum(sel, 0) - sel) * sel).sum(-1)      # (g*k,)
    within = pos < cap
    gate_of = torch.where(within, top_p.reshape(-1), 0.0)
    x_rep = torch.repeat_interleave(xg, k, dim=0)           # (g*k, d)
    slot_c = torch.clamp_max(pos, cap - 1)

    if m.dispatch == "einsum":
        # one-hot matmul dispatch: O(T*E*C*d), purely dense
        oh_e = F.one_hot(expert_of, e).to(dt) * within[:, None].to(dt)
        oh_c = F.one_hot(slot_c, cap).to(dt)
        dispatch = oh_e[:, :, None] * oh_c[:, None, :]      # (g*k, E, C)
        expert_in = torch.einsum("tec,td->ecd", dispatch, x_rep)
    else:
        # scatter dispatch: O(T*d). Slots are unique among within-capacity
        # pairs; a dropped pair adds a zero row.
        slot = expert_of * cap + slot_c                      # (g*k,)
        contrib = torch.where(within[:, None], x_rep,
                              torch.zeros((), dtype=dt, device=xg.device))
        expert_in = torch.zeros((e * cap, d), dtype=dt, device=xg.device) \
            .index_add(0, slot, contrib).reshape(e, cap, d)

    h_gate = torch.bmm(expert_in, p["w_gate"].to(dt))
    h_up = torch.bmm(expert_in, p["w_up"].to(dt))
    expert_out = torch.bmm(F.silu(h_gate) * h_up, p["w_down"].to(dt))

    if m.dispatch == "einsum":
        combine = dispatch * gate_of[:, None, None].to(dt)  # (g*k, E, C)
        out = torch.einsum("tec,ecd->td", combine, expert_out)
    else:
        gathered = expert_out.reshape(e * cap, d)[slot]     # (g*k, d)
        out = gathered * (gate_of * within).to(dt)[:, None]
    out = out.reshape(g, k, d).sum(1)

    if m.shared_expert:
        sh = F.silu(xg @ p["shared/w_gate"].to(dt)) * \
            (xg @ p["shared/w_up"].to(dt))
        out = out + sh @ p["shared/w_down"].to(dt)
    return out, aux


def _groups(p: Params, x: torch.Tensor, cfg: ModelConfig, gsz: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    outs, auxs = zip(*(_group_moe(p, xg, cfg)
                       for xg in x.reshape(b * s // gsz, gsz, d)))
    return torch.stack(outs).reshape(b, s, d), torch.stack(auxs).mean()


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux): token groups of ``group_size`` (or all
    tokens when fewer), aux the mean over groups. A placed ``x`` runs on
    each rank's batch shard with the MoE's weights gathered (the routing's
    stable sort and the dispatch's scatter have no DTensor sharding
    strategy), when the shard holds whole groups; else on the whole batch.
    The aux is then the mean of the shards' means."""
    from repro_torch.dist.sharding import batch_shards, on_batch_shard
    b, s, d = x.shape
    t = b * s
    gsz = min(cfg.moe.group_size, t)
    if t % gsz:
        raise ValueError(f"{t} tokens are not whole groups of {gsz}")
    if not placed(x):
        return _groups(p, x, cfg, gsz)
    n = batch_shards(x)
    keep = b % n == 0 and (b // n * s) % gsz == 0
    out, aux = on_batch_shard(lambda xl, w: _groups(w, xl, cfg, gsz), x, p,
                              keep_batch=keep, sums=1)
    return out, (aux / n if keep and n > 1 else aux)
