"""The outer-method registry, as far as this port reaches.

Port of ``repro/core/methods.py``: an :class:`OuterMethod` holds every
per-method behaviour the server reads, and the registry resolves names and
benchmark-dialect aliases. The port registers ``heloco`` on the packed
path: its ``packed_coeffs`` hook returns the per-block ``(cu, cv)`` with
``g = cu*Delta + cv*m``, and a dropped arrival collapses to ``G = 0``.
The other methods come later.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import HeLoCoConfig
from repro_torch.kernels import packed as pk


@dataclass(frozen=True)
class ArrivalCtx:
    """Per-arrival inputs threaded to every hook."""
    outer_lr: float
    mu: float
    h: Optional[HeLoCoConfig] = None
    rho: float = 1.0
    tau: float = 0.0                 # staleness
    layout: Any = None               # packing.BlockLayout (packed path)


@dataclass(frozen=True)
class OuterMethod:
    """Definition of one outer method (the hooks the port's server reads)."""
    name: str
    description: str
    # Table-3 outer-optimizer defaults (paper Appendix A.5)
    outer_lr: float
    momentum: float = 0.9
    weight_factor: str = "base"      # "base" sqrt(k)/k | "average" 1/k | "one"
    lookahead_init: bool = False     # Eq. 5 look-ahead participation
    aliases: Tuple[str, ...] = ()
    packed_coeffs: Callable = None   # (m, ctx, dbuf, mbuf) -> (cu, cv)
    decay_scale: Callable = None     # (m, ctx) -> s, with G = s*m when dropped

    def __post_init__(self):
        if self.weight_factor not in ("base", "average", "one"):
            raise ValueError(self.weight_factor)
        if self.packed_coeffs is None:
            raise ValueError(f"method {self.name!r} needs a packed_coeffs hook")
        if self.decay_scale is None:
            object.__setattr__(self, "decay_scale", _zero_decay)


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
                       f"{', '.join(sorted(_REGISTRY))}") from None


def resolve(method) -> OuterMethod:
    """Accept an OuterMethod instance or any registered name/alias."""
    return method if isinstance(method, OuterMethod) else get(method)


def cli_names() -> List[str]:
    return sorted(_REGISTRY) + sorted(_ALIASES)


def standard_coeffs(mu):
    """(am, bm, ab, cg, cm) of the plain Nesterov schedule (Eqs. 17-19)."""
    return mu, 1.0 - mu, 0.0, 1.0, mu


def decay_coeffs(m: OuterMethod, ctx: ArrivalCtx):
    """Scalars of a dropped arrival's outer step. With the pseudo-gradient
    suppressed the corrected gradient is G = s*m, so
      m' = c_m m;  theta' = theta - eta c_p m.
    Computed in fp32, as the reference computes them on device."""
    f = np.float32
    am, bm, _ab, cg, cm = standard_coeffs(ctx.mu)
    g = f(ctx.rho) * f(m.decay_scale(m, ctx))
    c_m = f(am) + f(bm) * g
    c_p = f(cg) * g + f(cm) * c_m
    return c_m, c_p


def _zero_decay(m, ctx):
    """Zero delta collapses to G = 0."""
    return 0.0


def _heloco_packed_coeffs(m, ctx, dbuf, mbuf):
    stats = pk.packed_stats(dbuf, mbuf, ctx.layout)
    return pk.branch_scalars(stats, ctx.h)


register(OuterMethod(
    name="heloco",
    description="Per-tensor-block directional correction of stale "
                "pseudo-gradients + momentum-guided look-ahead (paper "
                "Alg. 1-2).",
    outer_lr=0.7, momentum=0.9, weight_factor="base", lookahead_init=True,
    aliases=("async-heloco",), packed_coeffs=_heloco_packed_coeffs))
