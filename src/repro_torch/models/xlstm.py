"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel training form
and exact recurrent decode) and sLSTM (scalar memory, exponential gating,
sequential over time).

Port of ``repro/models/xlstm.py``. The chunkwise mLSTM carries per head
(C (P,P), n (P), m (the max-state, from 0.0)); within a chunk the
quadratic attention-like form runs, and a Python loop over the chunks
carries the state where the reference runs a ``lax.scan``. Masked log
weights are ``NEG`` = -1e30, not -inf (-inf would make the max-state NaN).
The sLSTM runs a Python loop over time. The reference has no Pallas kernel
here: every op is plain PyTorch, in the reference's dtypes. The conv
window is rounded to bf16 after a prefill only; a decode step returns it
in the compute dtype.

Placed (DTensor) activations: ``apply_mlstm_block`` and
``apply_slstm_block`` are the ``local_map`` sites
(``layers.mixer_on_batch_shard``): the conv window, the mLSTM chunk loop
and the sLSTM loop over time have no DTensor sharding strategy, so each
mixer runs on each rank's batch shard, the whole sequence and its weights
gathered. In serving, its state (every leaf of the (C, n, m) or (c, n, m,
h) tuple and the conv window) lies on the same batch shard: read there in
decode, returned there as DTensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (Params, Shapes, causal_conv, gelu,
                                      log_sigmoid, mixer_on_batch_shard,
                                      placed)

NEG = -1e30

MState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]     # C, n, m
SState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def mlstm_dims(cfg: ModelConfig) -> Dict[str, int]:
    di = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    h = cfg.n_heads
    return dict(d_inner=di, n_heads=h, head_dim=di // h)


def slstm_dims(cfg: ModelConfig) -> Dict[str, int]:
    d = cfg.d_model
    h = cfg.n_heads
    ff = int(round(cfg.xlstm.proj_factor_slstm * d))
    return dict(d=d, n_heads=h, head_dim=d // h, d_ff=ff)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def mlstm_shapes(cfg: ModelConfig) -> Shapes:
    """``init_mlstm``'s leaves; the gate projections and biases fp32."""
    pd = cfg.param_dtype
    dm = mlstm_dims(cfg)
    d, di, h = cfg.d_model, dm["d_inner"], dm["n_heads"]
    return {"w_up": ((d, 2 * di), pd),
            "conv_w": ((cfg.xlstm.conv_kernel, di), pd),
            "conv_b": ((di,), pd),
            "w_q": ((di, di), pd), "w_k": ((di, di), pd),
            "w_v": ((di, di), pd),
            "w_i": ((di, h), "float32"), "b_i": ((h,), "float32"),
            "w_f": ((di, h), "float32"), "b_f": ((h,), "float32"),
            "headnorm": ((di,), pd), "w_down": ((di, d), pd)}


def slstm_shapes(cfg: ModelConfig) -> Shapes:
    """``init_slstm``'s leaves: the conv, per gate an input projection,
    a block-diagonal recurrence (H, P, P) and an fp32 bias, the group
    norm's scale and the gated FFN under ``ffn/``."""
    pd = cfg.param_dtype
    dm = slstm_dims(cfg)
    d, h, hd, ff = dm["d"], dm["n_heads"], dm["head_dim"], dm["d_ff"]
    out = {"conv_w": ((cfg.xlstm.conv_kernel, d), pd), "conv_b": ((d,), pd)}
    for gate in ("z", "i", "f", "o"):
        out[f"w_{gate}"] = ((d, d), pd)
        out[f"r_{gate}"] = ((h, hd, hd), pd)
        out[f"b_{gate}"] = ((d,), "float32")
    out["groupnorm"] = ((d,), pd)
    out.update({"ffn/w_gate": ((d, ff), pd), "ffn/w_up": ((d, ff), pd),
                "ffn/w_down": ((ff, d), pd)})
    return out


def init_scale(kind: str, leaf: str, cfg: ModelConfig) -> float:
    """The normal draws' scale of a drawn leaf of an ``mlstm`` or ``slstm``
    block (``leaf`` relative to the block, ``ffn/w_down`` for the sLSTM's
    FFN)."""
    if leaf == "conv_w":
        return 0.5
    if kind == "mlstm":
        return cfg.d_model ** -0.5 if leaf == "w_up" else \
            mlstm_dims(cfg)["d_inner"] ** -0.5
    dm = slstm_dims(cfg)
    if leaf.startswith("r_"):
        return dm["head_dim"] ** -0.5
    if leaf == "ffn/w_down":
        return dm["d_ff"] ** -0.5
    return dm["d"] ** -0.5


def fixed_value(leaf: str, shape, device) -> Optional[torch.Tensor]:
    """The leaves ``init_mlstm``/``init_slstm`` set rather than draw, in
    fp32 (None for a drawn one): the forget gates' bias 3, the other gate
    biases and the conv's zero, the norms' ones."""
    if leaf == "b_f":
        return torch.full(shape, 3.0, device=device)
    if leaf in ("b_i", "b_z", "b_o", "conv_b"):
        return torch.zeros(shape, device=device)
    if leaf in ("headnorm", "groupnorm"):
        return torch.ones(shape, device=device)
    return None


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_chunk(carry: MState, q, k, v, logi, logf
                 ) -> Tuple[MState, torch.Tensor]:
    """carry: (C (B,H,P,P), n (B,H,P), m (B,H)) fp32. q, k, v (B,L,H,P);
    logi, logf (B,L,H) fp32. Returns (carry', y (B,L,H,P) fp32)."""
    c_prev, n_prev, m_prev = carry
    l, p = q.shape[1], q.shape[3]
    qf = q.float() * p ** -0.5
    kf = k.float()
    vf = v.float()
    fcum = torch.cumsum(logf, dim=1)                               # (B,L,H)
    # intra-chunk log weights: D[l,m] = fcum_l - fcum_m + logi_m (m <= l)
    dmat = fcum[:, :, None, :] - fcum[:, None, :, :] + logi[:, None, :, :]
    mask = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
    dmat = dmat.masked_fill(~mask[None, :, :, None], NEG)          # (B,L,M,H)
    inter_log = fcum + m_prev[:, None, :]                          # (B,L,H)
    m_loc = torch.maximum(dmat.amax(dim=2), inter_log)
    w_intra = torch.exp(dmat - m_loc[:, :, None, :])
    w_inter = torch.exp(inter_log - m_loc)
    scores = torch.einsum("blhp,bmhp->blmh", qf, kf)
    num = (torch.einsum("blmh,bmhp->blhp", scores * w_intra, vf)
           + torch.einsum("blhp,bhpq->blhq", qf * w_inter[..., None], c_prev))
    # denominator: q_l . n_l, n_l the decayed n_prev plus the weighted keys
    qn = (torch.einsum("blmh,blmh->blh", w_intra, scores)
          + torch.einsum("blhp,bhp->blh", qf * w_inter[..., None], n_prev))
    den = torch.maximum(qn.abs(), torch.exp(-m_loc))
    y = num / den[..., None]
    # carry update
    flast = fcum[:, -1]                                            # (B,H)
    m_new = torch.maximum(flast + m_prev,
                          (flast[:, None] - fcum + logi).amax(dim=1))
    wk = torch.exp(flast[:, None] - fcum + logi - m_new[:, None])  # (B,L,H)
    decay = torch.exp(flast + m_prev - m_new)
    c_new = (c_prev * decay[:, :, None, None]
             + torch.einsum("blhp,blhq->bhpq", kf * wk[..., None], vf))
    n_new = n_prev * decay[:, :, None] + (kf * wk[..., None]).sum(dim=1)
    return (c_new, n_new, m_new), y


def mlstm_sequence(q, k, v, logi, logf, chunk: int,
                   state: Optional[MState] = None
                   ) -> Tuple[torch.Tensor, MState]:
    """Chunkwise mLSTM. q, k, v: (B,S,H,P); logi/logf: (B,S,H) fp32.
    Chunks of ``min(chunk, S)``, which must divide S; the max-state starts
    at 0.0. Returns (y (B,S,H,P) fp32, (C, n, m))."""
    b, s, h, p = q.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    if state is None:
        state = (q.new_zeros((b, h, p, p), dtype=torch.float32),
                 q.new_zeros((b, h, p), dtype=torch.float32),
                 q.new_zeros((b, h), dtype=torch.float32))
    ys = []
    for c in range(0, s, chunk):
        cut = slice(c, c + chunk)
        state, y = _mlstm_chunk(state, q[:, cut], k[:, cut], v[:, cut],
                                logi[:, cut], logf[:, cut])
        ys.append(y)
    return torch.cat(ys, dim=1), state


def mlstm_step(q, k, v, logi, logf, state: MState
               ) -> Tuple[torch.Tensor, MState]:
    """Exact recurrent step. q, k, v: (B,H,P); logi/logf: (B,H)."""
    c_prev, n_prev, m_prev = state
    p = q.shape[-1]
    qf = q.float() * p ** -0.5
    kf = k.float()
    vf = v.float()
    m_new = torch.maximum(logf + m_prev, logi)
    fz = torch.exp(logf + m_prev - m_new)
    iz = torch.exp(logi - m_new)
    c_new = (c_prev * fz[..., None, None]
             + iz[..., None, None] * kf[..., :, None] * vf[..., None, :])
    n_new = n_prev * fz[..., None] + iz[..., None] * kf
    num = torch.einsum("bhp,bhpq->bhq", qf, c_new)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", qf, n_new).abs(),
                        torch.exp(-m_new))
    return num / den[..., None], (c_new, n_new, m_new)


def apply_mlstm_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      state: Optional[Dict] = None,
                      return_state: bool = False):
    """The mLSTM block's mixer (pre-norm residual around it). x: (B,S,d).
    With ``state`` (decode, S = 1): {"mlstm": (C, n, m), "conv"} in and
    out, the conv in x's dtype; with ``return_state`` (prefill) the
    end-of-sequence state, the conv in bf16. A placed ``x`` runs on each
    rank's batch shard, a state's leaves on it too
    (``layers.mixer_on_batch_shard``)."""
    if placed(x):
        return mixer_on_batch_shard(apply_mlstm_block, p, x, cfg, state,
                                    return_state,
                                    like=init_mlstm_state(cfg, 1, "meta"))
    dm = mlstm_dims(cfg)
    h, hd = dm["n_heads"], dm["head_dim"]
    dt = x.dtype
    b, s, _ = x.shape
    up = x @ p["w_up"].to(dt)
    xm, z = up.chunk(2, dim=-1)
    xc, new_conv = causal_conv(xm, p["conv_w"], p["conv_b"],
                               state["conv"] if state is not None else None)
    q = (xc @ p["w_q"].to(dt)).reshape(b, s, h, hd)
    k = (xc @ p["w_k"].to(dt)).reshape(b, s, h, hd)
    v = (xm @ p["w_v"].to(dt)).reshape(b, s, h, hd)
    logi = xm.float() @ p["w_i"] + p["b_i"]
    logf = log_sigmoid(xm.float() @ p["w_f"] + p["b_f"])
    if state is not None:
        y, new_m = mlstm_step(q[:, 0], k[:, 0], v[:, 0], logi[:, 0],
                              logf[:, 0], state["mlstm"])
        y = y[:, None]
        new_state = {"mlstm": new_m, "conv": new_conv}
    else:
        y, mstate = mlstm_sequence(q, k, v, logi, logf, cfg.xlstm.chunk_size)
        new_state = ({"mlstm": mstate, "conv": new_conv.to(torch.bfloat16)}
                     if return_state else None)
    # headwise RMSNorm, then flatten
    yf = y.float()
    y = (yf * torch.rsqrt((yf ** 2).mean(-1, keepdim=True) + 1e-5)).to(dt)
    y = y.reshape(b, s, dm["d_inner"]) * p["headnorm"].to(dt)
    return (y * F.silu(z)) @ p["w_down"].to(dt), new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_cell(p: Params, xz, xi, xf, xo, state: SState,
                n_heads: int) -> SState:
    """One time step. x*: (B,d) fp32 pre-activations (the input part).
    state: (c, n, m, h), each (B,d) fp32."""
    c, n, m, hprev = state
    b, d = xz.shape
    hh = hprev.reshape(b, n_heads, d // n_heads)

    def rec(name):
        return torch.einsum("bhp,hpq->bhq", hh,
                            p[f"r_{name}"].float()).reshape(b, d)

    zt = torch.tanh(xz + rec("z"))
    it = xi + rec("i")                       # log-space input gate
    ft = log_sigmoid(xf + rec("f"))          # log forget gate
    ot = torch.sigmoid(xo + rec("o"))
    m_new = torch.maximum(ft + m, it)
    iz = torch.exp(it - m_new)
    fz = torch.exp(ft + m - m_new)
    c_new = fz * c + iz * zt
    n_new = fz * n + iz
    h_new = ot * c_new / torch.clamp_min(n_new, 1e-6)
    return (c_new, n_new, m_new, h_new)


def apply_slstm_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      state: Optional[Dict] = None,
                      return_state: bool = False):
    """The sLSTM block's mixer with its post-FFN. x: (B,S,d). With
    ``state`` (decode, S = 1): {"slstm": (c, n, m, h), "conv"} in and out,
    the conv in x's dtype; with ``return_state`` (prefill) the
    end-of-sequence state, the conv in bf16. A placed ``x`` runs on each
    rank's batch shard, a state's leaves on it too
    (``layers.mixer_on_batch_shard``)."""
    if placed(x):
        return mixer_on_batch_shard(apply_slstm_block, p, x, cfg, state,
                                    return_state,
                                    like=init_slstm_state(cfg, 1, "meta"))
    dt = x.dtype
    b, s, d = x.shape
    xc, new_conv = causal_conv(x, p["conv_w"], p["conv_b"],
                               state["conv"] if state is not None else None)
    xz = (xc @ p["w_z"].to(dt)).float() + p["b_z"]
    xi = (xc @ p["w_i"].to(dt)).float() + p["b_i"]
    xf = (xc @ p["w_f"].to(dt)).float() + p["b_f"]
    xo = (x @ p["w_o"].to(dt)).float() + p["b_o"]
    if state is not None:
        st = _slstm_cell(p, xz[:, 0], xi[:, 0], xf[:, 0], xo[:, 0],
                         state["slstm"], cfg.n_heads)
        h = st[3][:, None].to(dt)
        new_state = {"slstm": st, "conv": new_conv}
    else:
        st = tuple(x.new_zeros((b, d), dtype=torch.float32)
                   for _ in range(4))
        hs = []
        for t in range(s):
            st = _slstm_cell(p, xz[:, t], xi[:, t], xf[:, t], xo[:, t], st,
                             cfg.n_heads)
            hs.append(st[3])
        h = torch.stack(hs, dim=1).to(dt)
        new_state = ({"slstm": st, "conv": new_conv.to(torch.bfloat16)}
                     if return_state else None)
    # group norm (per head), then the gated FFN
    hf = h.float().reshape(b, s, cfg.n_heads, -1)
    mu = hf.mean(-1, keepdim=True)
    var = ((hf - mu) ** 2).mean(-1, keepdim=True)
    hf = ((hf - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, d)
    h = hf.to(dt) * p["groupnorm"].to(dt)
    ff = gelu(h @ p["ffn/w_gate"].to(dt)) * (h @ p["ffn/w_up"].to(dt))
    return h + ff @ p["ffn/w_down"].to(dt), new_state


def init_mlstm_state(cfg: ModelConfig, batch: int, device) -> Dict:
    dm = mlstm_dims(cfg)
    h, hd, di = dm["n_heads"], dm["head_dim"], dm["d_inner"]
    f32 = dict(dtype=torch.float32, device=device)
    return {"mlstm": (torch.zeros((batch, h, hd, hd), **f32),
                      torch.zeros((batch, h, hd), **f32),
                      torch.zeros((batch, h), **f32)),
            "conv": torch.zeros((batch, cfg.xlstm.conv_kernel - 1, di),
                                dtype=torch.bfloat16, device=device)}


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> Dict:
    d = cfg.d_model
    return {"slstm": tuple(torch.zeros((batch, d), dtype=torch.float32,
                                       device=device) for _ in range(4)),
            "conv": torch.zeros((batch, cfg.xlstm.conv_kernel - 1, d),
                                dtype=torch.bfloat16, device=device)}
