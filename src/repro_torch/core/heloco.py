"""HeLoCo: momentum-guided look-ahead worker initialization (Eq. 5) and the
per-block directional correction of stale pseudo-gradients (Alg. 1-2,
Eqs. 7-19).

Port of ``repro/core/heloco.py``. A "block" is a leaf tensor of the
parameter dict, the paper's granularity; a leaf with stacked leading layer
axes is one block per layer (``stacked_axes``: path -> number of layer
axes). Two arrival implementations share the same math:

  apply_arrival         per-leaf path over the parameter dict, the
                        correctness reference; with ``use_kernel`` the
                        correction of each leaf runs through the per-leaf
                        kernels (``kernels/ops.py``), two launches a leaf
  apply_arrival_packed  the fast path over the packed (R, 128) buffers: at
                        most one statistics sweep plus one fused
                        correct+outer sweep, two kernel launches at most,
                        whatever the number of tensors, and one for every
                        method but HeLoCo. A flush of K coalesced arrivals
                        (``apply_arrivals_packed``) is at most two launches
                        too: one Gram sweep (HeLoCo) and one K-chained fused
                        sweep.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import HeLoCoConfig
from repro_torch.core import methods as _methods
from repro_torch.core import packing
from repro_torch.kernels import ops
from repro_torch.kernels import packed as pk
from repro_torch.telemetry import stats as _stats

Params = Dict[str, torch.Tensor]
f32 = np.float32


class OuterState(NamedTuple):
    """Outer params + Nesterov momentum + outer step t (+ the method's
    gradient accumulator, buffered methods only)."""
    params: Params
    momentum: Params
    step: int
    aux: Optional[Params] = None


def init_outer_state(params: Mapping[str, torch.Tensor],
                     with_aux: bool = False) -> OuterState:
    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}
    return OuterState(params=dict(params), momentum=zeros(), step=0,
                      aux=zeros() if with_aux else None)


# ---------------------------------------------------------------------------
# Eq. 5: momentum-guided look-ahead worker initialization
# ---------------------------------------------------------------------------

def lookahead_init(state: OuterState, outer_lr: float, mu: float) -> Params:
    """theta_bar = theta - eta * mu * m (HeLoCo + MLA worker init)."""
    c = float(f32(outer_lr * mu))
    return {k: (p.float() - c * state.momentum[k]).to(p.dtype)
            for k, p in state.params.items()}


# ---------------------------------------------------------------------------
# Eqs. 7-16 / Alg. 2: per-block directional correction
# ---------------------------------------------------------------------------

def _correct_rows(u: torch.Tensor, v: torch.Tensor,
                  h: HeLoCoConfig) -> torch.Tensor:
    """Alg. 2 on each row of (L, n) fp32 blocks u against v."""
    nu = torch.linalg.vector_norm(u, dim=1, keepdim=True)
    nv = torch.linalg.vector_norm(v, dim=1, keepdim=True)
    u_hat = u / torch.clamp_min(nu, h.eps)
    v_hat = v / torch.clamp_min(nv, h.eps)
    c = (u_hat * v_hat).sum(1, keepdim=True)                     # Eq. 8
    conf = nu / (nu + h.kappa * nv + h.eps)                      # Eq. 15

    # anti-aligned branch (Eqs. 10-11)
    beta = torch.clamp_max(h.k_s * (-c) * conf, h.beta_max)
    anti = u - beta * c * nu * v_hat

    # weakly aligned branch (Eqs. 12-14)
    lam = torch.clamp_max(h.k_d * (1.0 - c) * conf, 1.0)
    u_tilde = (1.0 - lam) * u_hat + lam * v_hat
    nt = torch.linalg.vector_norm(u_tilde, dim=1, keepdim=True)
    weak = nu * u_tilde / torch.clamp_min(nt, h.eps)

    corrected = torch.where(c >= h.c_ok, u, torch.where(c < 0.0, anti, weak))
    degenerate = (nu < h.eps) | (nv < h.eps)
    return torch.where(degenerate, u, corrected)


def correct_block(delta: torch.Tensor, mom: torch.Tensor,
                  h: HeLoCoConfig) -> torch.Tensor:
    """Correct one tensor block against its momentum block: with the cosine
    c of the two flattened blocks,
      c >= c_ok          keep
      c < 0              damp the anti-momentum component   (Eqs. 10-11)
      0 <= c < c_ok      norm-preserving rotation toward v  (Eqs. 12-14)
      a degenerate norm  pass through
    """
    out = _correct_rows(delta.float().reshape(1, -1),
                        mom.float().reshape(1, -1), h)
    return out.reshape(delta.shape).to(delta.dtype)


def block_correct(delta: Mapping[str, torch.Tensor],
                  momentum: Mapping[str, torch.Tensor], h: HeLoCoConfig,
                  stacked_axes: Optional[Mapping[str, int]] = None,
                  use_kernel: bool = False,
                  reduce_stats: Optional[Mapping[str, Callable]] = None
                  ) -> Params:
    """Alg. 2 over the whole pseudo-gradient dict.

    stacked_axes: path -> number of leading layer axes of that leaf (absent:
    none); each layer of a stacked leaf is its own block. use_kernel: correct
    each leaf through the per-leaf kernels (``kernels/ops.py``), two
    launches a leaf whatever its layer count, with the branch scalars of
    all blocks in one ``branch_scalars`` call. reduce_stats: path -> the
    leaf's per-block sums over the whole leaf from this rank's shard's;
    the sums are only separable on the kernels' route, so a shard takes it
    (their plain versions for CPU tensors)."""
    stacked_axes = stacked_axes or {}
    if reduce_stats is not None and not use_kernel \
            and next(iter(delta.values())).device.type != "cpu":
        raise ValueError("a shard's statistics are reduced on the kernels' "
                         "route: use_kernel=True on the card")
    if use_kernel or reduce_stats is not None:
        keys = list(delta)
        return dict(zip(keys, ops.heloco_correct_leaves(
            [delta[k] for k in keys], [momentum[k] for k in keys], h,
            [int(stacked_axes.get(k, 0)) for k in keys],
            reduce_stats=None if reduce_stats is None
            else [reduce_stats[k] for k in keys])))
    out = {}
    for k, d in delta.items():
        nax = int(stacked_axes.get(k, 0))
        blocks = math.prod(d.shape[:nax])
        rows = _correct_rows(d.float().reshape(blocks, -1),
                             momentum[k].float().reshape(blocks, -1), h)
        out[k] = rows.reshape(d.shape).to(d.dtype)
    return out


# ---------------------------------------------------------------------------
# Eqs. 17-19: per-leaf outer update (Nesterov / MLA / HeLoCo)
# ---------------------------------------------------------------------------

def outer_update(state: OuterState, g: Mapping[str, torch.Tensor],
                 outer_lr: float, mu: float, rho: float = 1.0) -> OuterState:
    """m' = mu m + (1-mu) rho G;  theta' = theta - eta (rho G + mu m').

    Plain tensor math, as the reference leaves it to XLA outside any kernel,
    in the reference's order: ``((1-mu)*rho)*G``, where the fused kernel
    (``kernels/outer_update.py``) takes ``(1-mu)*(rho*G)``."""
    mu_, eta = float(f32(mu)), float(f32(outer_lr))
    w = float(f32(1.0 - mu) * f32(rho))
    rho_ = float(f32(rho))
    momentum, params = {}, {}
    for k, p in state.params.items():
        gf = g[k].float()
        momentum[k] = mu_ * state.momentum[k] + w * gf
        params[k] = (p.float() - eta * (rho_ * gf + mu_ * momentum[k])
                     ).to(p.dtype)
    return OuterState(params=params, momentum=momentum, step=state.step + 1,
                      aux=state.aux)


# ---------------------------------------------------------------------------
# Method dispatch on the per-leaf path. Per-method behaviour lives in the
# ``core.methods`` registry; the drivers below are method-agnostic.
# ---------------------------------------------------------------------------

def mla_correct(delta: Mapping[str, torch.Tensor],
                momentum: Mapping[str, torch.Tensor], outer_lr: float,
                mu: float, tau: float, tau_clip: float = 10.0) -> Params:
    """Momentum Look-Ahead (Ajanthan et al. 2025): one uniform
    staleness-proportional shift of the whole pseudo-gradient along the
    momentum, Delta' = Delta + eta * mu * min(tau, clip)/clip * m."""
    scale = float(_methods.tau_scaled(tau, tau_clip, outer_lr * mu))
    return {k: (d.float() + scale * momentum[k]).to(d.dtype)
            for k, d in delta.items()}


def momentum_decay_update(state: OuterState, outer_lr: float, mu: float,
                          method="heloco", rho: float = 1.0, tau: float = 0.0,
                          phase: Optional[int] = None) -> OuterState:
    """Outer step of a dropped stale arrival (App. A.6) on the per-leaf
    state: the method applied to a zero pseudo-gradient, with no
    correction and no zero dict made (one for a custom schedule)."""
    m = _methods.resolve(method)
    ctx = _methods.ArrivalCtx(outer_lr=outer_lr, mu=mu, rho=rho, tau=tau,
                              phase=phase)
    if m.custom_update:
        return _methods.scheduled_decay_update(m, ctx, state)
    c_m, c_p = _methods.decay_coeffs(m, ctx)
    step = float(f32(outer_lr) * c_p)
    return OuterState(
        params={k: (p.float() - step * state.momentum[k]).to(p.dtype)
                for k, p in state.params.items()},
        momentum={k: float(c_m) * mm for k, mm in state.momentum.items()},
        step=state.step + 1, aux=state.aux)


def apply_arrival(state: OuterState, delta: Mapping[str, torch.Tensor], *,
                  method, outer_lr: float, mu: float, h: HeLoCoConfig,
                  rho: float = 1.0, tau: float = 0.0,
                  stacked_axes: Optional[Mapping[str, int]] = None,
                  use_kernel: bool = False,
                  phase: Optional[int] = None, with_stats: bool = False):
    """Process one arriving pseudo-gradient through the chosen method on the
    per-leaf state (for a sync method ``delta`` is the workers' average).
    ``phase``: the outer-step index at arrival, read only by buffered
    schedules. ``with_stats``: also return the (4,) telemetry moments of
    the arrival (``telemetry.stats.reference_moments`` of the same
    correction, so the correction runs once either way)."""
    m = _methods.resolve(method)
    ctx = _methods.ArrivalCtx(outer_lr=outer_lr, mu=mu, h=h, rho=rho,
                              tau=tau, phase=phase, stacked_axes=stacked_axes,
                              use_kernel=use_kernel)
    g = m.correct(m, ctx, delta, state.momentum)
    moments = (_stats.reference_moments(delta, state.momentum, g)
               if with_stats else None)
    if m.custom_update:
        new = _methods.scheduled_outer_update(m, ctx, state, g)
    else:
        new = outer_update(state, g, outer_lr, mu, rho=rho)
    return (new, moments) if with_stats else new


def apply_arrivals(state: OuterState, deltas, *, method, outer_lr: float,
                   mu: float, h: HeLoCoConfig, rhos=None, taus=None,
                   phases=None,
                   stacked_axes: Optional[Mapping[str, int]] = None,
                   use_kernel: bool = False) -> OuterState:
    """Per-leaf reference of a batched flush: K sequential ``apply_arrival``
    steps with per-delta rho, tau and phase, the semantics
    ``apply_arrivals_packed`` reproduces."""
    k = len(deltas)
    rhos = [1.0] * k if rhos is None else list(rhos)
    taus = [0.0] * k if taus is None else list(taus)
    phases = [None] * k if phases is None else list(phases)
    for delta, rho, tau, phase in zip(deltas, rhos, taus, phases):
        state = apply_arrival(state, delta, method=method, outer_lr=outer_lr,
                              mu=mu, h=h, rho=rho, tau=tau, phase=phase,
                              stacked_axes=stacked_axes,
                              use_kernel=use_kernel)
    return state


# ---------------------------------------------------------------------------
# Packed fast path: the same math on one flat buffer, O(1) kernel launches
# ---------------------------------------------------------------------------


def lookahead_packed(pbuf: torch.Tensor, mbuf: torch.Tensor,
                     outer_lr: float, mu: float) -> torch.Tensor:
    """theta_bar = theta - eta * mu * m (Eq. 5), on packed buffers."""
    return pbuf - float(np.float32(outer_lr * mu)) * mbuf


def apply_arrival_packed(pbuf: torch.Tensor, mbuf: torch.Tensor,
                         delta, layout, *,
                         method, outer_lr: float, mu: float, h: HeLoCoConfig,
                         rho: float = 1.0, tau: float = 0.0,
                         abuf: Optional[torch.Tensor] = None,
                         phase: Optional[int] = None,
                         out: Optional[Tuple[torch.Tensor, ...]] = None,
                         with_stats: bool = False):
    """Process one arrival on the packed (R, 128) outer state.

    delta: the arriving pseudo-gradient, a dict (packed here) or a
    ``packing.Packed`` buffer (taken as it is); abuf: the
    method's packed accumulator (buffered methods only); phase: the
    outer-step index at arrival (only buffered schedules read it). Returns
    (pbuf', mbuf'), or (pbuf', mbuf', abuf') for buffered methods; ``out``
    names the output buffers (the state itself for an in-place update).
    ``with_stats``: also return the (R, 4) per-row telemetry moments
    ``[d.m, d.d, m.m, |g_unweighted - d|^2]`` as the last element, an
    extra output of the same fused sweep (same launches, same p'/m' bits).

    Every registered method reduces to per-block scalars (cu, cv, cq), so an
    arrival is at most one statistics sweep (HeLoCo) plus one fused sweep:
    the accumulator kernel for a custom schedule, the quadratic kernel for a
    ``cq`` term, else the plain correct+outer kernel.
    """
    m = _methods.resolve(method)
    dbuf = packing.pack(layout, delta)
    ctx = _methods.ArrivalCtx(outer_lr=outer_lr, mu=mu, h=h, rho=rho,
                              tau=tau, phase=phase, layout=layout)
    cu, cv, cq = m.packed_coeffs(m, ctx, dbuf, mbuf)
    row_block, _ = layout.device_tables(pbuf.device)
    if m.custom_update:
        if cq is not None:
            raise NotImplementedError(
                f"method {m.name!r}: a quadratic (cq) term combined with "
                "a custom schedule is not supported on the packed path")
        if abuf is None:
            abuf = packing.zeros(layout, pbuf.device)
        if out is not None and len(out) == 2:
            out = (*out, abuf)
        res = pk.packed_correct_outer_acc(
            pbuf, mbuf, abuf, dbuf, cu, cv, row_block, outer_lr, rho,
            *_methods.schedule_coeffs(m, ctx), out=out,
            with_stats=with_stats)
        return _drop_acc(res, m, with_stats)
    if cq is not None:
        return pk.packed_correct_outer_quad(pbuf, mbuf, dbuf, cu, cv, cq,
                                            row_block, outer_lr, mu, rho,
                                            out=out, with_stats=with_stats)
    return pk.packed_correct_outer(pbuf, mbuf, dbuf, cu, cv, row_block,
                                   outer_lr, mu, rho, out=out,
                                   with_stats=with_stats)


def _drop_acc(res, m, with_stats: bool):
    """An accumulator sweep's (p', m', b'[, stats]) without b' for a method
    that keeps no buffer."""
    if m.uses_buffer:
        return res
    return (res[0], res[1], res[3]) if with_stats else res[:2]


def apply_arrivals_packed(pbuf: torch.Tensor, mbuf: torch.Tensor,
                          deltas, layout, *, method, outer_lr: float,
                          mu: float, h: HeLoCoConfig, rhos, taus,
                          abuf: Optional[torch.Tensor] = None, phases=None,
                          out: Optional[Tuple[torch.Tensor, ...]] = None,
                          with_stats: bool = False):
    """Process K coalesced arrivals on the packed outer state in at most two
    kernel launches (one multi-Gram sweep for HeLoCo, one K-chained fused
    sweep), where the sequential path takes up to 2K.

    deltas: K pseudo-gradients (dicts or ``packing.Packed``) in commit
    order, stacked into one (K, R, 128) buffer on the state's device; rhos /
    taus: K scalars each; phases: K outer-step indices (buffered schedules
    only). The result is that of K sequential ``apply_arrival_packed``
    calls with the momentum evolving between them: the same arithmetic per
    element, with the coefficients each application would have seen
    (HeLoCo's from the Gram matrices, fp32-close). Returns and ``out`` as
    ``apply_arrival_packed``; ``with_stats`` adds the (K, R, 4) per-row
    moments, slice j against the momentum as of application j (same
    launch).
    """
    m = _methods.resolve(method)
    k = len(deltas)
    dstack = torch.empty((k, layout.n_rows, pbuf.shape[1]),
                         dtype=torch.float32, device=pbuf.device)
    for j, d in enumerate(deltas):
        packing.pack(layout, d, out=dstack[j])
    phases = [None] * k if phases is None else list(phases)
    ctxs = [_methods.ArrivalCtx(outer_lr=outer_lr, mu=mu, h=h, rho=rho,
                                tau=tau, phase=phase, layout=layout)
            for rho, tau, phase in zip(rhos, taus, phases)]
    cu, cv, cq = _methods.multi_packed_coeffs(m, ctxs, dstack, mbuf)
    row_block, _ = layout.device_tables(pbuf.device)
    if m.custom_update:
        if cq is not None:
            raise NotImplementedError(
                f"method {m.name!r}: a quadratic (cq) term combined with "
                "a custom schedule is not supported on the packed path")
        if abuf is None:
            abuf = packing.zeros(layout, pbuf.device)
        if out is not None and len(out) == 2:
            out = (*out, abuf)
        res = pk.packed_multi_correct_outer_acc(
            pbuf, mbuf, abuf, dstack, cu, cv, row_block, outer_lr, list(rhos),
            *_methods.multi_schedule_coeffs(m, ctxs), out=out,
            with_stats=with_stats)
        return _drop_acc(res, m, with_stats)
    if cq is not None:
        return pk.packed_multi_correct_outer_quad(
            pbuf, mbuf, dstack, cu, cv, cq, row_block, outer_lr, mu,
            list(rhos), out=out, with_stats=with_stats)
    return pk.packed_multi_correct_outer(pbuf, mbuf, dstack, cu, cv,
                                         row_block, outer_lr, mu, list(rhos),
                                         out=out, with_stats=with_stats)


def momentum_decay_packed(pbuf: torch.Tensor, mbuf: torch.Tensor,
                          outer_lr: float, mu: float, method="heloco",
                          rho: float = 1.0, tau: float = 0.0,
                          abuf: Optional[torch.Tensor] = None,
                          phase: Optional[int] = None):
    """Dropped-arrival step (App. A.6) on packed state: the method applied
    to a zero pseudo-gradient, with no correction sweep. Returns (p', m'),
    or (p', m', b') for buffered methods."""
    m = _methods.resolve(method)
    ctx = _methods.ArrivalCtx(outer_lr=outer_lr, mu=mu, rho=rho, tau=tau,
                              phase=phase)
    if m.custom_update:
        return _methods.scheduled_decay_packed(m, ctx, pbuf, mbuf, abuf)
    c_m, c_p = _methods.decay_coeffs(m, ctx)
    return (pbuf - float(np.float32(outer_lr) * c_p) * mbuf,
            float(c_m) * mbuf)
