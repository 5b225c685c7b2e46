"""The pluggable outer-method layer: one registry the server, the engines
and the scenarios read.

Port of ``repro/core/methods.py`` on its packed path. An
:class:`OuterMethod` holds every per-method behaviour the server reads:

  * ``packed_coeffs``: the per-block triple ``(cu, cv, cq)`` with
    ``g = cu*Delta + cv*m + cq*Delta^2*m`` (``cq`` None when a method has no
    quadratic term), so ``kernels/packed.py`` never branches on names;
  * ``decay_scale``: the scalar ``s`` with ``G = s*m`` when a dropped
    arrival's pseudo-gradient is suppressed;
  * ``outer_coeffs``: the outer-update schedule ``(am, bm, ab, cg, cm[,
    ca])``; None means the standard Nesterov update of Eqs. 17-19, and a
    ``buffer_period > 0`` adds a gradient accumulator (delayed Nesterov,
    FedBuff);
  * look-ahead participation, the Table-3 defaults and the benchmark-dialect
    aliases.

Generalized update (one fused packed sweep, see ``kernels/packed.py``):

    G    = rho * (cu*Delta + cv*m + cq*Delta^2*m)
    acc  = b + G
    m'   = am*m + bm*acc
    b'   = ab*acc
    p'   = p - eta*(cg*G + ca*acc + cm*m')

The reference's per-leaf ``correct`` hooks (its correctness path and the
dist outer exchange) wait for the port's per-leaf path, ROADMAP A16; its
``packed_multi_coeffs`` hooks wait for the batched commit path, A11.

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
from typing import Any, Callable, Dict, List, Optional, Tuple

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
    layout: Any = None               # packing.BlockLayout (packed path)


def _phase(ctx: ArrivalCtx) -> int:
    return 0 if ctx.phase is None else int(ctx.phase)


def _tau_scaled(ctx: ArrivalCtx, clip: float, c) -> np.float32:
    """``c * min(tau, clip) / clip`` as the reference's jitted fp32 computes
    it: XLA folds ``c / clip`` into one constant."""
    return f32(min(f32(ctx.tau), f32(clip))) * (f32(c) / f32(clip))


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
    batchable: bool = True           # False: a commit buffer must flush
    # around every arrival of this method (read by A11's batched path)
    # -- hooks --------------------------------------------------------------
    packed_coeffs: Callable = None   # (m, ctx, dbuf, mbuf) -> (cu, cv, cq)
    decay_scale: Callable = None     # (m, ctx) -> s, with G = s*m when dropped
    outer_coeffs: Callable = None    # (m, ctx) -> (am, bm, ab, cg, cm[, ca])

    def __post_init__(self):
        if self.weight_factor not in ("base", "average", "one"):
            raise ValueError(self.weight_factor)
        if self.packed_coeffs is None:
            raise ValueError(f"method {self.name!r} needs a packed_coeffs hook")
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


def decay_coeffs(m: OuterMethod, ctx: ArrivalCtx):
    """Scalars of a dropped arrival's outer step for methods on the standard
    schedule. With the pseudo-gradient suppressed the corrected gradient is
    G = s*m (``decay_scale``), so
      m' = c_m m;  theta' = theta - eta c_p m."""
    g = f32(ctx.rho) * f32(m.decay_scale(m, ctx))
    c_m = f32(ctx.mu) + f32(1.0 - ctx.mu) * g
    c_p = g + f32(ctx.mu) * c_m
    return c_m, c_p


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


def _full(ctx, dbuf, value) -> torch.Tensor:
    """A (B,) fp32 vector of one scalar on the buffers' device."""
    return torch.full((ctx.layout.n_blocks,), float(f32(value)),
                      dtype=torch.float32, device=dbuf.device)


def _plain_packed_coeffs(m, ctx, dbuf, mbuf):
    return _full(ctx, dbuf, 1.0), _full(ctx, dbuf, 0.0), None


# -- HeLoCo (paper Alg. 2) ---------------------------------------------------

def _heloco_packed_coeffs(m, ctx, dbuf, mbuf):
    stats = pk.packed_stats(dbuf, mbuf, ctx.layout)
    cu, cv = pk.branch_scalars(stats, ctx.h)
    return cu, cv, None


# -- MLA (momentum look-ahead; Ajanthan et al. 2025) -------------------------

def _mla_scale(m, ctx):
    return _tau_scaled(ctx, m.tau_clip, ctx.outer_lr * ctx.mu)


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

def _poly_packed_coeffs(m, ctx, dbuf, mbuf):
    """Damp the whole pseudo-gradient by (1 + tau)^-alpha (tau = 0 is plain
    Nesterov)."""
    w = (f32(1.0) + f32(ctx.tau)) ** f32(-m.stale_alpha)
    return _full(ctx, dbuf, w), _full(ctx, dbuf, 0.0), None


# -- DC-ASGD-style delay compensation (Zheng et al. 2017) --------------------

def _dcasgd_packed_coeffs(m, ctx, dbuf, mbuf):
    """Taylor-style compensation of a stale pseudo-gradient along the
    momentum: g~ = Delta - lambda * eta * tau_norm * (Delta (.) Delta (.) m),
    the quadratic term of the fused sweep."""
    coef = _tau_scaled(ctx, m.tau_clip, -(m.dc_lambda * ctx.outer_lr))
    return _full(ctx, dbuf, 1.0), _full(ctx, dbuf, 0.0), _full(ctx, dbuf, coef)


# ---------------------------------------------------------------------------
# The registered methods (paper Table 3 + the async Local-SGD baselines)
# ---------------------------------------------------------------------------

register(OuterMethod(
    name="heloco",
    description="Per-tensor-block directional correction of stale "
                "pseudo-gradients + momentum-guided look-ahead (paper "
                "Alg. 1-2).",
    outer_lr=0.7, momentum=0.9, weight_factor="base", lookahead_init=True,
    aliases=("async-heloco",), packed_coeffs=_heloco_packed_coeffs))

register(OuterMethod(
    name="mla",
    description="Momentum Look-Ahead: uniform staleness-proportional "
                "extrapolation along the momentum (Ajanthan et al. 2025).",
    outer_lr=0.7, momentum=0.9, weight_factor="base", lookahead_init=True,
    aliases=("async-mla",), tau_clip=10.0,
    packed_coeffs=_mla_packed_coeffs, decay_scale=_mla_decay_scale))

register(OuterMethod(
    name="nesterov",
    description="Plain asynchronous Nesterov outer optimizer (async "
                "DiLoCo baseline; needs the reduced Table-3 outer LR).",
    outer_lr=0.07, momentum=0.9, weight_factor="base", lookahead_init=False,
    aliases=("async-nesterov",), outer_lr_cap=0.07,
    packed_coeffs=_plain_packed_coeffs))

register(OuterMethod(
    name="sync_nesterov",
    description="Synchronous DiLoCo/Nesterov barrier baseline: the "
                "slowest worker gates every round.",
    outer_lr=0.7, momentum=0.9, weight_factor="average",
    lookahead_init=False, aliases=("sync-nesterov",), sync=True,
    packed_coeffs=_plain_packed_coeffs))

register(OuterMethod(
    name="delayed_nesterov",
    description="Delayed Nesterov (Liu et al. 2024): buffer incoming "
                "pseudo-gradients, momentum step every N arrivals.",
    outer_lr=0.7, momentum=0.9, weight_factor="base", lookahead_init=False,
    aliases=("async-delayed-nesterov", "dn"), buffer_period=4,
    packed_coeffs=_plain_packed_coeffs, outer_coeffs=_dn_outer_coeffs))

register(OuterMethod(
    name="fedbuff",
    description="FedBuff-style buffered asynchronous aggregation: the "
                "server averages every K incoming pseudo-gradients into "
                "one outer Nesterov step (Nguyen et al. 2022).",
    outer_lr=0.7, momentum=0.9, weight_factor="one", lookahead_init=False,
    aliases=("async-fedbuff",), buffer_period=4,
    packed_coeffs=_plain_packed_coeffs, outer_coeffs=_fedbuff_outer_coeffs))

register(OuterMethod(
    name="poly_stale",
    description="Polynomial staleness weighting: the pseudo-gradient is "
                "damped by (1+tau)^-alpha before the Nesterov outer step "
                "(staleness-aware async SGD baseline).",
    outer_lr=0.07, momentum=0.9, weight_factor="base", lookahead_init=False,
    aliases=("async-poly-stale",), outer_lr_cap=0.07, stale_alpha=0.5,
    packed_coeffs=_poly_packed_coeffs))

register(OuterMethod(
    name="dcasgd",
    description="DC-ASGD-style Taylor delay compensation of stale "
                "pseudo-gradients, scaled by staleness tau.",
    outer_lr=0.07, momentum=0.9, weight_factor="base", lookahead_init=False,
    aliases=("async-dcasgd",), outer_lr_cap=0.07, tau_clip=10.0,
    dc_lambda=1.0, packed_coeffs=_dcasgd_packed_coeffs))
