"""Mamba2 (State-Space Duality) block.

Port of ``repro/models/mamba2.py``. Training and prefill run the chunked
SSD algorithm: the sequence is split into chunks of length Q, each chunk
computes its quadratic intra-chunk part, and a Python loop over the chunks
carries the SSM state (B, H, P, N) in fp32 where the reference runs a
``lax.scan``. Decode is the exact one-step recurrence. The reference has no
Pallas kernel here: every op is plain PyTorch, in the reference's dtypes
and at its rounding points (the conv state is rounded to bf16 after a
prefill and after every decode step, whatever the compute dtype).

Placed (DTensor) activations: ``apply_mamba2`` is the ``local_map`` site
(``layers.mixer_on_batch_shard``): the causal conv's window over the
sequence and the SSD chunk loop's carried state have no DTensor sharding
strategy, so the mixer runs on each rank's batch shard, the whole sequence
and its weights gathered. In serving, its state (both leaves) lies on the
same batch shard: read there in decode, returned there as DTensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (Params, Shapes, causal_conv,
                                      mixer_on_batch_shard, placed,
                                      rmsnorm_gated, softplus)

State = Dict[str, torch.Tensor]          # {"ssm": (B,H,P,N) fp32,
                                         #  "conv": (B,K-1,C) bf16}


def ssm_dims(cfg: ModelConfig) -> Dict[str, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return dict(d_inner=d_inner, n_heads=n_heads, conv_dim=conv_dim,
                d_state=s.d_state, head_dim=s.head_dim, n_groups=s.n_groups,
                conv_kernel=s.conv_kernel)


def mamba2_shapes(cfg: ModelConfig) -> Shapes:
    """``init_mamba2``'s leaves; ``a_log``, ``d_skip`` and ``dt_bias`` are
    fp32 whatever ``param_dtype`` is."""
    pd = cfg.param_dtype
    dm = ssm_dims(cfg)
    d, h = cfg.d_model, dm["n_heads"]
    in_dim = 2 * dm["d_inner"] + 2 * dm["n_groups"] * dm["d_state"] + h
    return {"w_in": ((d, in_dim), pd),
            "conv_w": ((dm["conv_kernel"], dm["conv_dim"]), pd),
            "conv_b": ((dm["conv_dim"],), pd),
            "a_log": ((h,), "float32"), "d_skip": ((h,), "float32"),
            "dt_bias": ((h,), "float32"),
            "norm_scale": ((dm["d_inner"],), pd),
            "w_out": ((dm["d_inner"], d), pd)}


def init_scale(leaf: str, cfg: ModelConfig) -> float:
    """The normal draws' scale of a drawn leaf (``init_mamba2``)."""
    return {"w_in": cfg.d_model ** -0.5, "conv_w": 0.5,
            "w_out": ssm_dims(cfg)["d_inner"] ** -0.5}[leaf]


def fixed_value(leaf: str, shape, device) -> Optional[torch.Tensor]:
    """The leaves ``init_mamba2`` sets rather than draws, in fp32 (None for
    a drawn one): A's log spaced over [1, 16] by head, D ones, zero biases,
    the gated norm's ones."""
    if leaf == "a_log":
        a = torch.log(torch.linspace(1.0, 16.0, shape[-1], device=device))
        return a.expand(shape)
    if leaf in ("d_skip", "norm_scale"):
        return torch.ones(shape, device=device)
    if leaf in ("conv_b", "dt_bias"):
        return torch.zeros(shape, device=device)
    return None


def _split_in(proj: torch.Tensor, dm: Dict[str, int]):
    di, gn, h = dm["d_inner"], dm["n_groups"] * dm["d_state"], dm["n_heads"]
    z = proj[..., :di]
    xbc = proj[..., di: di + di + 2 * gn]
    dt = proj[..., di + di + 2 * gn:]
    assert dt.shape[-1] == h
    return z, xbc, dt


def _ssd_chunk(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
               a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SSD chunk. state: (B,H,P,N) fp32; x (B,L,H,P); dt (B,L,H) fp32;
    a (H,) fp32; bm/cm (B,L,G,N). Returns (state', y (B,L,H,P))."""
    l, h = x.shape[1], x.shape[2]
    rep = h // bm.shape[2]
    dt_a = dt * a[None, None, :]                                   # (B,L,H)
    cum = torch.cumsum(dt_a, dim=1)
    # inter-chunk: the carried state's contribution; groups repeated over
    # heads as jnp.repeat does (each group's heads adjacent)
    cm_h = cm.repeat_interleave(rep, dim=2)                        # (B,L,H,N)
    bm_h = bm.repeat_interleave(rep, dim=2)
    decay_in = torch.exp(cum)
    y_inter = torch.einsum("blhn,bhpn->blhp", cm_h * decay_in[..., None],
                           state)
    # intra-chunk (quadratic in L), masked with -inf before exp
    seg = cum[:, :, None, :] - cum[:, None, :, :]                  # (B,L,M,H)
    mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    seg = seg.masked_fill(~mask[None, :, :, None], float("-inf"))
    decay = torch.exp(seg)
    scores = torch.einsum("blhn,bmhn->blmh", cm_h, bm_h)           # x's dtype
    w = scores * decay * dt[:, None, :, :]
    y_intra = torch.einsum("blmh,bmhp->blhp", w.to(x.dtype), x)
    # state update
    decay_out = torch.exp(cum[:, -1:, :] - cum)
    contrib = torch.einsum("blhn,blhp->bhpn",
                           (bm_h * (decay_out * dt)[..., None]).float(),
                           x.float())
    state = state * torch.exp(cum[:, -1])[:, :, None, None] + contrib
    return state, y_inter.to(x.dtype) + y_intra


def ssd_forward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bm: torch.Tensor, cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); dt: (B,S,H) fp32 (post-softplus); bm/cm: (B,S,G,N).
    Chunks of ``min(chunk, S)``, which must divide S. Returns (y (B,S,H,P),
    final_state (B,H,P,N) fp32)."""
    b, s, h, p = x.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    state = init_state
    if state is None:
        state = torch.zeros((b, h, p, bm.shape[-1]), dtype=torch.float32,
                            device=x.device)
    ys = []
    for c in range(0, s, chunk):
        cut = slice(c, c + chunk)
        state, y = _ssd_chunk(state, x[:, cut], dt[:, cut], a, bm[:, cut],
                              cm[:, cut])
        ys.append(y)
    return torch.cat(ys, dim=1), state


def ssd_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
             a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact one-step recurrence (decode). state: (B,H,P,N) fp32;
    x (B,H,P); dt (B,H) fp32; a (H,); bm/cm (B,G,N). Returns (y (B,H,P)
    fp32, state')."""
    rep = x.shape[1] // bm.shape[1]
    bm_h = bm.repeat_interleave(rep, dim=1)                        # (B,H,N)
    cm_h = cm.repeat_interleave(rep, dim=1)
    contrib = torch.einsum("bhn,bhp->bhpn", bm_h.float() * dt[..., None],
                           x.float())
    s1 = state * torch.exp(dt * a[None, :])[:, :, None, None] + contrib
    return torch.einsum("bhpn,bhn->bhp", s1, cm_h.float()), s1


def apply_mamba2(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[State] = None, return_state: bool = False
                 ) -> Tuple[torch.Tensor, Optional[State]]:
    """The Mamba2 mixer. x: (B,S,d). With ``state`` (decode, S = 1) the
    exact one-step recurrence from it; with ``return_state`` (prefill) the
    end-of-sequence state. Either returns {"ssm": (B,H,P,N) fp32, "conv":
    (B,K-1,C) bf16} beside the output; None otherwise. A placed ``x`` runs
    on each rank's batch shard, a state's leaves on it too
    (``layers.mixer_on_batch_shard``)."""
    if placed(x):
        return mixer_on_batch_shard(apply_mamba2, p, x, cfg, state,
                                    return_state,
                                    like=init_mamba2_state(cfg, 1, "meta"))
    dm = ssm_dims(cfg)
    dt_ = x.dtype
    bsz, s = x.shape[0], x.shape[1]
    proj = x @ p["w_in"].to(dt_)
    z, xbc, dt_raw = _split_in(proj, dm)
    xbc, new_conv = causal_conv(xbc, p["conv_w"], p["conv_b"],
                                state["conv"] if state is not None else None)
    di = dm["d_inner"]
    g, n = dm["n_groups"], dm["d_state"]
    xs = xbc[..., :di]
    bm = xbc[..., di: di + g * n].reshape(bsz, s, g, n)
    cm = xbc[..., di + g * n:].reshape(bsz, s, g, n)
    h, hd = dm["n_heads"], dm["head_dim"]
    xh = xs.reshape(bsz, s, h, hd)
    dt = softplus(dt_raw.float() + p["dt_bias"])                    # (B,S,H)
    a = -torch.exp(p["a_log"])                                      # (H,) < 0

    if state is not None:  # exact recurrent decode (S == 1)
        y, s1 = ssd_step(state["ssm"], xh[:, 0], dt[:, 0], a, bm[:, 0],
                         cm[:, 0])
        y = y[:, None].to(dt_)
        new_state = {"ssm": s1, "conv": new_conv.to(torch.bfloat16)}
    else:
        y, s1 = ssd_forward(xh, dt, a, bm, cm, cfg.ssm.chunk_size)
        new_state = ({"ssm": s1, "conv": new_conv.to(torch.bfloat16)}
                     if return_state else None)
    y = y + xh * p["d_skip"][None, None, :, None].to(dt_)
    y = rmsnorm_gated(y.reshape(bsz, s, di), z, p["norm_scale"])
    return y @ p["w_out"].to(dt_), new_state


def init_mamba2_state(cfg: ModelConfig, batch: int, device) -> State:
    """Zero state: the SSM's fp32, the conv window's bf16."""
    dm = ssm_dims(cfg)
    return {"ssm": torch.zeros((batch, dm["n_heads"], dm["head_dim"],
                                dm["d_state"]), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, dm["conv_kernel"] - 1,
                                 dm["conv_dim"]), dtype=torch.bfloat16,
                                device=device)}
