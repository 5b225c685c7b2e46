"""The pluggable outer-method layer: one registry the server, the engines
and the scenarios read.

Port of ``repro/core/methods.py``. An :class:`OuterMethod` holds every
per-method behaviour the server reads:

  * ``correct``: the per-leaf correction of a pseudo-gradient dict against
    the momentum dict, the math the paper states (the per-leaf path,
    ``core/heloco.py:apply_arrival``);
  * ``packed_coeffs``: the per-block triple ``(cu, cv, cq)`` with
    ``g = cu*Delta + cv*m + cq*Delta^2*m`` (``cq`` None when a method has no
    quadratic term), so ``kernels/packed.py`` never branches on names;
  * ``decay_scale``: the scalar ``s`` with ``G = s*m`` when a dropped
    arrival's pseudo-gradient is suppressed;
  * ``outer_coeffs``: the outer-update schedule ``(am, bm, ab, cg, cm[,
    ca])``; None means the standard Nesterov update of Eqs. 17-19, and a
    ``buffer_period > 0`` adds a gradient accumulator (delayed Nesterov,
    FedBuff);
  * ``packed_multi_coeffs``: the per-delta ``(cu, cv, cq)`` tables of a
    flush of K coalesced arrivals, for a method whose coefficients read the
    momentum (HeLoCo); None evaluates ``packed_coeffs`` per delta;
  * look-ahead participation, the Table-3 defaults and the benchmark-dialect
    aliases.

Generalized update (one fused packed sweep, see ``kernels/packed.py``):

    G    = rho * (cu*Delta + cv*m + cq*Delta^2*m)
    acc  = b + G
    m'   = am*m + bm*acc
    b'   = ab*acc
    p'   = p - eta*(cg*G + ca*acc + cm*m')

On the per-leaf path a custom schedule runs the same update leaf by leaf
(``scheduled_outer_update``), with the accumulator dict in
``OuterState.aux``.

Scalars: the reference computes every host-side scalar of these hooks in
jitted fp32, where a Python constant becomes fp32 before it meets an fp32
value. The port repeats that with numpy float32, operation by operation,
and with XLA's folding of ``c * min(tau, clip) / clip`` into
``min(tau, clip) * (c / clip)``. XLA's CPU backend also fuses a multiply
and an add into one rounding (the dropped-arrival coefficients); the port
rounds each op, as its kernels do, which can move those scalars by 1 ulp.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import HeLoCoConfig
from repro_torch.kernels import packed as pk

f32 = np.float32


@dataclass(frozen=True)
class ArrivalCtx:
    """Per-arrival inputs threaded to every hook."""
    outer_lr: float
    mu: float
    h: Optional[HeLoCoConfig] = None
    rho: float = 1.0
    tau: float = 0.0                 # staleness
    phase: Optional[int] = None      # outer-step index at arrival (None =
    # step 0); only buffered schedules read it
    stacked_axes: Optional[Mapping[str, int]] = None   # per-leaf path:
    # leading layer axes of each stacked leaf
    use_kernel: bool = False         # per-leaf path: HeLoCo through kernels
    reduce_stats: Optional[Mapping[str, Callable]] = None   # per-leaf path,
    # a rank's shards: leaf path -> its per-block sums over the whole leaf
    layout: Any = None               # packing.BlockLayout (packed path)


def _phase(ctx: ArrivalCtx) -> int:
    return 0 if ctx.phase is None else int(ctx.phase)


def tau_scaled(tau: float, clip: float, c) -> np.float32:
    """``c * min(tau, clip) / clip`` as the reference's jitted fp32 computes
    it: XLA folds ``c / clip`` into one constant."""
    return f32(min(f32(tau), f32(clip))) * (f32(c) / f32(clip))


@dataclass(frozen=True)
class OuterMethod:
    """Definition of one outer method (see the module docstring)."""
    name: str
    description: str
    # -- Table-3 outer-optimizer defaults (paper Appendix A.5) --------------
    outer_lr: float
    momentum: float = 0.9
    weight_factor: str = "base"      # "base" sqrt(k)/k | "average" 1/k | "one"
    lookahead_init: bool = False     # Eq. 5 look-ahead participation
    # -- identity -----------------------------------------------------------
    aliases: Tuple[str, ...] = ()    # benchmark-dialect names ("async-heloco")
    sync: bool = False               # barrier method: engines run sync rounds
    outer_lr_cap: Optional[float] = None   # launcher clamp (async Nesterov)
    # -- method constants ---------------------------------------------------
    tau_clip: float = 0.0            # staleness normalization clip (0 = n/a)
    dc_lambda: float = 0.0           # delay-compensation strength (dcasgd)
    stale_alpha: float = 0.0         # polynomial staleness exponent
    buffer_period: int = 0           # >0: gradient accumulator, momentum
    # refresh every N arrivals (delayed Nesterov / FedBuff)
    batchable: bool = True           # False: the server's commit buffer
    # commits every arrival of this method on its own
    # -- hooks --------------------------------------------------------------
    correct: Callable = None         # (m, ctx, delta, momentum) -> g dict
    packed_coeffs: Callable = None   # (m, ctx, dbuf, mbuf) -> (cu, cv, cq)
    packed_multi_coeffs: Callable = None   # (m, ctxs, dstack, mbuf) ->
    # (cu, cv, cq) as (K, B) tables; None: packed_coeffs per delta
    decay_scale: Callable = None     # (m, ctx) -> s, with G = s*m when dropped
    outer_coeffs: Callable = None    # (m, ctx) -> (am, bm, ab, cg, cm[, ca])

    def __post_init__(self):
        if self.weight_factor not in ("base", "average", "one"):
            raise ValueError(self.weight_factor)
        if self.correct is None or self.packed_coeffs is None:
            raise ValueError(f"method {self.name!r} needs correct and "
                             "packed_coeffs hooks")
        if self.decay_scale is None:
            object.__setattr__(self, "decay_scale", _zero_decay)

    @property
    def uses_buffer(self) -> bool:
        return self.buffer_period > 0

    @property
    def custom_update(self) -> bool:
        """True when the outer update deviates from the standard Nesterov
        schedule (extra state and/or non-default coefficients)."""
        return self.uses_buffer or self.outer_coeffs is not None

    def defaults(self) -> Dict[str, Any]:
        """The Table-3 preset row."""
        return dict(outer_lr=self.outer_lr, momentum=self.momentum,
                    weight_factor=self.weight_factor,
                    lookahead_init=self.lookahead_init)


_REGISTRY: Dict[str, OuterMethod] = {}
_ALIASES: Dict[str, str] = {}


def register(m: OuterMethod) -> OuterMethod:
    if m.name in _REGISTRY or m.name in _ALIASES:
        raise ValueError(f"duplicate outer method name {m.name!r}")
    for a in m.aliases:
        if a in _ALIASES or a in _REGISTRY:
            raise ValueError(f"duplicate outer method alias {a!r}")
    _REGISTRY[m.name] = m
    for a in m.aliases:
        _ALIASES[a] = m.name
    return m


def get(name: str) -> OuterMethod:
    """Look up a method by canonical name or benchmark-dialect alias."""
    try:
        return _REGISTRY[_ALIASES.get(name, name)]
    except KeyError:
        raise KeyError(f"unknown outer method {name!r}; registered: "
                       f"{', '.join(sorted(_REGISTRY))} (aliases: "
                       f"{', '.join(sorted(_ALIASES))})") from None


def resolve(method) -> OuterMethod:
    """Accept an OuterMethod instance or any registered name/alias."""
    return method if isinstance(method, OuterMethod) else get(method)


def canonical(name: str) -> str:
    return get(name).name


def cli_names() -> List[str]:
    """Canonical names + aliases (the launcher's --method choices)."""
    return sorted(_REGISTRY) + sorted(_ALIASES)


def method_table() -> Dict[str, Dict[str, Any]]:
    """Table-3 defaults keyed by canonical name."""
    return {m.name: m.defaults() for m in _REGISTRY.values()}


def alias_table() -> Dict[str, str]:
    """Benchmark-dialect alias -> canonical name, in registration order."""
    return dict(_ALIASES)


# ---------------------------------------------------------------------------
# Schedule scalars
# ---------------------------------------------------------------------------

def standard_coeffs(mu):
    """(am, bm, ab, cg, cm) of the plain Nesterov schedule (Eqs. 17-19)."""
    return mu, 1.0 - mu, 0.0, 1.0, mu


def schedule_coeffs(m: OuterMethod, ctx: ArrivalCtx):
    """The method's 6-tuple ``(am, bm, ab, cg, cm, ca)``; a 5-tuple hook gets
    ``ca = 0``."""
    c = m.outer_coeffs(m, ctx) if m.outer_coeffs else standard_coeffs(ctx.mu)
    return (*c, 0.0) if len(c) == 5 else c


def multi_schedule_coeffs(m: OuterMethod, ctxs):
    """:func:`schedule_coeffs` over a flush: six (K,) fp32 vectors ``(am, bm,
    ab, cg, cm, ca)``, each delta's boundary state in its own slot of the
    multi accumulator kernel's scalar table."""
    rows = [schedule_coeffs(m, ctx) for ctx in ctxs]
    return tuple(np.array([r[i] for r in rows], np.float32)
                 for i in range(6))


def multi_packed_coeffs(m: OuterMethod, ctxs, dstack, mbuf):
    """Per-delta coefficient tables for a flush of K coalesced arrivals.

    ctxs: one :class:`ArrivalCtx` per delta, in commit order; dstack:
    (K, R, 128). Returns ``(cu, cv, cq)``, each (K, B) (``cq`` None without
    a quadratic term): the coefficients application j would see on the
    sequential path, against the momentum as of that application. The
    default evaluates ``packed_coeffs`` per delta against the flush-time
    momentum, exact when the hook never reads ``mbuf``; a hook that reads it
    (HeLoCo's) brings its own ``packed_multi_coeffs``."""
    if m.packed_multi_coeffs is not None:
        return m.packed_multi_coeffs(m, ctxs, dstack, mbuf)
    outs = [m.packed_coeffs(m, ctx, dstack[j], mbuf)
            for j, ctx in enumerate(ctxs)]
    cu = torch.stack([o[0] for o in outs])
    cv = torch.stack([o[1] for o in outs])
    if outs[0][2] is None:
        return cu, cv, None
    return cu, cv, torch.stack([o[2] for o in outs])


def decay_coeffs(m: OuterMethod, ctx: ArrivalCtx):
    """Scalars of a dropped arrival's outer step for methods on the standard
    schedule. With the pseudo-gradient suppressed the corrected gradient is
    G = s*m (``decay_scale``), so
      m' = c_m m;  theta' = theta - eta c_p m."""
    g = f32(ctx.rho) * f32(m.decay_scale(m, ctx))
    c_m = f32(ctx.mu) + f32(1.0 - ctx.mu) * g
    c_p = g + f32(ctx.mu) * c_m
    return c_m, c_p


def scheduled_outer_update(m: OuterMethod, ctx: ArrivalCtx, state, g):
    """Per-leaf generalized outer step (see the module docstring) for
    methods whose schedule is not plain Nesterov (``custom_update``), leaf
    by leaf with the accumulator dict in ``state.aux``."""
    from repro_torch.core.heloco import OuterState
    rho = f32(ctx.rho)
    am, bm, ab, cg, cm, ca = (f32(c) for c in schedule_coeffs(m, ctx))
    # the fp32 scalars as Python floats; the reference's ``cg * rho * g``
    # multiplies the two scalars first
    eta, rho, am, bm, ab, cg_rho, cm, ca = (float(c) for c in (
        f32(ctx.outer_lr), rho, am, bm, ab, cg * rho, cm, ca))
    params, momentum, aux = {}, {}, {}
    for k, p in state.params.items():
        gf = g[k].float()
        b = (state.aux[k] if state.aux is not None
             else torch.zeros_like(state.momentum[k]))
        acc = b + rho * gf
        momentum[k] = am * state.momentum[k] + bm * acc
        params[k] = (p.float() - eta * (cg_rho * gf + ca * acc
                                        + cm * momentum[k])).to(p.dtype)
        aux[k] = ab * acc
    return OuterState(params=params, momentum=momentum, step=state.step + 1,
                      aux=aux if m.uses_buffer else None)


def scheduled_decay_update(m: OuterMethod, ctx: ArrivalCtx, state):
    """Per-leaf dropped-arrival step for ``custom_update`` methods: the
    generalized update applied to the collapsed gradient G = s*m
    (``decay_scale``), one dict made."""
    s = float(f32(m.decay_scale(m, ctx)))
    return scheduled_outer_update(
        m, ctx, state, {k: s * mm for k, mm in state.momentum.items()})


def scheduled_decay_packed(m: OuterMethod, ctx: ArrivalCtx, pbuf, mbuf,
                           abuf=None):
    """Packed dropped-arrival step for ``custom_update`` methods: the
    generalized update applied to G = s*m. Plain elementwise tensor math, as
    the reference leaves it to XLA outside its kernels. Returns (p', m') or
    (p', m', b') for buffered methods."""
    eta = float(f32(ctx.outer_lr))
    am, bm, ab, cg, cm, ca = (float(f32(c)) for c in schedule_coeffs(m, ctx))
    s = float(f32(ctx.rho) * f32(m.decay_scale(m, ctx)))
    if abuf is None:
        abuf = torch.zeros_like(mbuf)
    g = s * mbuf
    acc = abuf + g
    m_new = am * mbuf + bm * acc
    p_new = pbuf - eta * (cg * g + ca * acc + cm * m_new)
    if m.uses_buffer:
        return p_new, m_new, ab * acc
    return p_new, m_new


# ---------------------------------------------------------------------------
# Hook implementations
# ---------------------------------------------------------------------------

def _zero_decay(m, ctx):
    """Zero delta collapses to G = 0 (heloco / nesterov / dcasgd / DN)."""
    return 0.0


def _identity_correct(m, ctx, delta, momentum):
    """Nesterov family: the pseudo-gradient is applied as it is."""
    return delta


def _full(ctx, dbuf, value) -> torch.Tensor:
    """A (B,) fp32 vector of one scalar on the buffers' device."""
    return torch.full((ctx.layout.n_blocks,), float(f32(value)),
                      dtype=torch.float32, device=dbuf.device)


def _plain_packed_coeffs(m, ctx, dbuf, mbuf):
    return _full(ctx, dbuf, 1.0), _full(ctx, dbuf, 0.0), None


# -- HeLoCo (paper Alg. 2) ---------------------------------------------------

def _heloco_correct(m, ctx, delta, momentum):
    from repro_torch.core.heloco import block_correct
    return block_correct(delta, momentum, ctx.h,
                         stacked_axes=ctx.stacked_axes,
                         use_kernel=ctx.use_kernel,
                         reduce_stats=ctx.reduce_stats)


def _heloco_packed_coeffs(m, ctx, dbuf, mbuf):
    stats = pk.packed_stats(dbuf, mbuf, ctx.layout)
    cu, cv = pk.branch_scalars(stats, ctx.h)
    return cu, cv, None


def _heloco_multi_coeffs(m, ctxs, dstack, mbuf):
    """Evolving-momentum branch statistics for K coalesced deltas from one
    Gram sweep. After j applications the momentum lies in span[m0, d_1..d_j];
    tracking its basis coordinates ``alpha`` (B, K+1) per block turns every
    (dot, uu, vv) the sequential path would measure into O(B K^2) math on
    the per-block Gram matrices, with no further O(d) pass. fp32-close to
    the sequential statistics, not bitwise (another summation order)."""
    layout = ctxs[0].layout
    k = dstack.shape[0]
    gram = pk.multi_gram_blocks(mbuf, dstack, layout)     # (B, K+1, K+1)
    alpha = torch.zeros((layout.n_blocks, k + 1), dtype=torch.float32,
                        device=mbuf.device)
    alpha[:, 0] = 1.0                                     # m_cur = 1 * m0
    cus, cvs = [], []
    for j, ctx in enumerate(ctxs):
        e = j + 1                                         # basis slot of d_j
        dot = (alpha * gram[:, e, :]).sum(1)
        uu = gram[:, e, e]
        vv = (alpha * torch.einsum("btu,bu->bt", gram, alpha)).sum(1)
        cu, cv = pk.branch_scalars(torch.stack([dot, uu, vv], dim=1), ctx.h)
        cus.append(cu)
        cvs.append(cv)
        # m' = mu*m + (1-mu)*rho*(cu*d_j + cv*m), in basis coordinates
        w = float(f32(1.0 - ctx.mu) * f32(ctx.rho))
        alpha = alpha * (float(f32(ctx.mu)) + w * cv)[:, None]
        alpha[:, e] += w * cu
    return torch.stack(cus), torch.stack(cvs), None


# -- MLA (momentum look-ahead; Ajanthan et al. 2025) -------------------------

def _mla_scale(m, ctx):
    return tau_scaled(ctx.tau, m.tau_clip, ctx.outer_lr * ctx.mu)


def _mla_correct(m, ctx, delta, momentum):
    from repro_torch.core.heloco import mla_correct
    return mla_correct(delta, momentum, ctx.outer_lr, ctx.mu, ctx.tau,
                       tau_clip=m.tau_clip)


def _mla_packed_coeffs(m, ctx, dbuf, mbuf):
    return _full(ctx, dbuf, 1.0), _full(ctx, dbuf, _mla_scale(m, ctx)), None


def _mla_decay_scale(m, ctx):
    """MLA of a zero delta is the nonzero G = eta*mu*tau_norm * m."""
    return _mla_scale(m, ctx)


# -- delayed Nesterov (Liu et al. 2024, Asynchronous Local-SGD) --------------

def _boundary(m, ctx) -> np.float32:
    return f32((_phase(ctx) + 1) % m.buffer_period == 0)


def _dn_outer_coeffs(m, ctx):
    """Buffer incoming (weighted) pseudo-gradients; every N-th arrival the
    momentum refreshes from the buffer average and the buffer resets:

      non-boundary:  b' = b + G;   m' = m;             p' = p - eta(G + mu m')
      boundary:      b' = 0;       m' = mu m + (1-mu)(b+G)/N;  same p' form
    """
    boundary = _boundary(m, ctx)
    am = f32(1.0) - boundary * f32(1.0 - ctx.mu)
    bm = boundary * f32((1.0 - ctx.mu) / m.buffer_period)
    ab = f32(1.0) - boundary
    return am, bm, ab, 1.0, ctx.mu


# -- FedBuff (Nguyen et al. 2022): K-arrival buffered aggregation ------------

def _fedbuff_outer_coeffs(m, ctx):
    """Buffer incoming (weighted) pseudo-gradients; the server only steps
    at every K-th arrival, applying the buffer average through the plain
    Nesterov update, then resets the buffer:

      non-boundary:  b' = b + G;  m' = m;  p' = p
      boundary:      gbar = (b+G)/K;  m' = mu m + (1-mu) gbar;  b' = 0
                     p' = p - eta*(gbar + mu m')
    """
    k = m.buffer_period
    boundary = _boundary(m, ctx)
    am = f32(1.0) - boundary * f32(1.0 - ctx.mu)
    bm = boundary * f32((1.0 - ctx.mu) / k)
    ab = f32(1.0) - boundary
    cm = boundary * f32(ctx.mu)
    ca = boundary / f32(k)
    return am, bm, ab, 0.0, cm, ca


# -- polynomial staleness weighting (Xie et al. 2019 style) ------------------

def _poly_weight(m, ctx) -> np.float32:
    return (f32(1.0) + f32(ctx.tau)) ** f32(-m.stale_alpha)


def _poly_correct(m, ctx, delta, momentum):
    """Damp the whole pseudo-gradient by (1 + tau)^-alpha (tau = 0 is plain
    Nesterov)."""
    w = float(_poly_weight(m, ctx))
    return {k: (w * d.float()).to(d.dtype) for k, d in delta.items()}


def _poly_packed_coeffs(m, ctx, dbuf, mbuf):
    return (_full(ctx, dbuf, _poly_weight(m, ctx)), _full(ctx, dbuf, 0.0),
            None)


# -- DC-ASGD-style delay compensation (Zheng et al. 2017) --------------------

def _dcasgd_coef(m, ctx) -> np.float32:
    return tau_scaled(ctx.tau, m.tau_clip, -(m.dc_lambda * ctx.outer_lr))


def _dcasgd_correct(m, ctx, delta, momentum):
    """Taylor-style compensation of a stale pseudo-gradient along the
    momentum: g~ = Delta - lambda * eta * tau_norm * (Delta (.) Delta (.) m),
    summed as the reference writes it, Delta + ((coef*Delta)*Delta)*m."""
    coef = float(_dcasgd_coef(m, ctx))
    out = {}
    for k, d in delta.items():
        df = d.float()
        out[k] = (df + coef * df * df * momentum[k].float()).to(d.dtype)
    return out


def _dcasgd_packed_coeffs(m, ctx, dbuf, mbuf):
    """The same compensation as the quadratic term of the fused sweep."""
    return (_full(ctx, dbuf, 1.0), _full(ctx, dbuf, 0.0),
            _full(ctx, dbuf, _dcasgd_coef(m, ctx)))


# ---------------------------------------------------------------------------
# The registered methods (paper Table 3 + the async Local-SGD baselines)
# ---------------------------------------------------------------------------

register(OuterMethod(
    name="heloco",
    description="Per-tensor-block directional correction of stale "
                "pseudo-gradients + momentum-guided look-ahead (paper "
                "Alg. 1-2).",
    outer_lr=0.7, momentum=0.9, weight_factor="base", lookahead_init=True,
    aliases=("async-heloco",), correct=_heloco_correct,
    packed_coeffs=_heloco_packed_coeffs,
    packed_multi_coeffs=_heloco_multi_coeffs))

register(OuterMethod(
    name="mla",
    description="Momentum Look-Ahead: uniform staleness-proportional "
                "extrapolation along the momentum (Ajanthan et al. 2025).",
    outer_lr=0.7, momentum=0.9, weight_factor="base", lookahead_init=True,
    aliases=("async-mla",), tau_clip=10.0, correct=_mla_correct,
    packed_coeffs=_mla_packed_coeffs, decay_scale=_mla_decay_scale))

register(OuterMethod(
    name="nesterov",
    description="Plain asynchronous Nesterov outer optimizer (async "
                "DiLoCo baseline; needs the reduced Table-3 outer LR).",
    outer_lr=0.07, momentum=0.9, weight_factor="base", lookahead_init=False,
    aliases=("async-nesterov",), outer_lr_cap=0.07,
    correct=_identity_correct, packed_coeffs=_plain_packed_coeffs))

register(OuterMethod(
    name="sync_nesterov",
    description="Synchronous DiLoCo/Nesterov barrier baseline: the "
                "slowest worker gates every round.",
    outer_lr=0.7, momentum=0.9, weight_factor="average",
    lookahead_init=False, aliases=("sync-nesterov",), sync=True,
    correct=_identity_correct, packed_coeffs=_plain_packed_coeffs))

register(OuterMethod(
    name="delayed_nesterov",
    description="Delayed Nesterov (Liu et al. 2024): buffer incoming "
                "pseudo-gradients, momentum step every N arrivals.",
    outer_lr=0.7, momentum=0.9, weight_factor="base", lookahead_init=False,
    aliases=("async-delayed-nesterov", "dn"), buffer_period=4,
    correct=_identity_correct, packed_coeffs=_plain_packed_coeffs,
    outer_coeffs=_dn_outer_coeffs))

register(OuterMethod(
    name="fedbuff",
    description="FedBuff-style buffered asynchronous aggregation: the "
                "server averages every K incoming pseudo-gradients into "
                "one outer Nesterov step (Nguyen et al. 2022).",
    outer_lr=0.7, momentum=0.9, weight_factor="one", lookahead_init=False,
    aliases=("async-fedbuff",), buffer_period=4,
    correct=_identity_correct, packed_coeffs=_plain_packed_coeffs,
    outer_coeffs=_fedbuff_outer_coeffs))

register(OuterMethod(
    name="poly_stale",
    description="Polynomial staleness weighting: the pseudo-gradient is "
                "damped by (1+tau)^-alpha before the Nesterov outer step "
                "(staleness-aware async SGD baseline).",
    outer_lr=0.07, momentum=0.9, weight_factor="base", lookahead_init=False,
    aliases=("async-poly-stale",), outer_lr_cap=0.07, stale_alpha=0.5,
    correct=_poly_correct, packed_coeffs=_poly_packed_coeffs))

register(OuterMethod(
    name="dcasgd",
    description="DC-ASGD-style Taylor delay compensation of stale "
                "pseudo-gradients, scaled by staleness tau.",
    outer_lr=0.07, momentum=0.9, weight_factor="base", lookahead_init=False,
    aliases=("async-dcasgd",), outer_lr_cap=0.07, tau_clip=10.0,
    dc_lambda=1.0, correct=_dcasgd_correct,
    packed_coeffs=_dcasgd_packed_coeffs))
