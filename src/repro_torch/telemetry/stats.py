"""Update-quality statistics: the Section-5 diagnostics of one arrival.

Port of ``repro/telemetry/stats.py``. Four per-arrival scalars:

  cos_align       cosine(Delta, m): alignment of the incoming
                  pseudo-gradient with the outer momentum;
  corrected_frac  ||g - Delta|| / ||Delta||: how much the method's
                  correction moved (0 for identity methods);
  delta_norm      ||Delta||;
  momentum_norm   ||m||.

All four derive from four global moments ``[Delta.m, Delta.Delta, m.m,
|g - Delta|^2]`` (``g`` is the method's corrected gradient before the
arrival weight rho). On the packed path the moments are an extra (R, 4)
output of the fused correct+outer sweep the arrival launches anyway
(``kernels/packed.py``'s ``with_stats``), so telemetry adds no launch. This
module holds the moments -> stats conversion (host floats, the reference's
arithmetic) and the per-leaf references in plain torch that the kernel
moments are held to, which are also the per-leaf server's own stats.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

import torch

# Moment vector layout (the columns of the packed sweeps' stats output).
MOMENT_FIELDS = ("dot_dm", "delta_sq", "mom_sq", "err_sq")
N_MOMENTS = len(MOMENT_FIELDS)


@dataclass(frozen=True)
class UpdateStats:
    """The derived per-arrival diagnostics (plain floats, JSON-ready)."""
    cos_align: float
    corrected_frac: float
    delta_norm: float
    momentum_norm: float


def stats_from_moments(moments) -> UpdateStats:
    """(4,) moments -> UpdateStats; one device-to-host copy for a tensor.
    Degenerate norms (dropped arrivals, zero momentum at t = 0) give 0 for
    the ratios they enter."""
    if isinstance(moments, torch.Tensor):
        moments = moments.detach().reshape(-1).tolist()
    dot, dd, mm, ee = (float(x) for x in moments)
    dn = math.sqrt(max(dd, 0.0))
    mn = math.sqrt(max(mm, 0.0))
    cos = dot / (dn * mn) if dn > 0.0 and mn > 0.0 else 0.0
    frac = math.sqrt(max(ee, 0.0)) / dn if dn > 0.0 else 0.0
    return UpdateStats(cos_align=max(-1.0, min(1.0, cos)),
                       corrected_frac=frac,
                       delta_norm=dn, momentum_norm=mn)


def reference_moments(delta: Mapping[str, torch.Tensor],
                      momentum: Mapping[str, torch.Tensor],
                      corrected: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Per-leaf reference of the kernel moments: (4,) fp32 ``[Delta.m,
    Delta.Delta, m.m, |corrected - Delta|^2]`` summed over every leaf
    (``corrected`` is the method's unweighted g)."""
    parts = []
    for k, d in delta.items():
        d = d.float().reshape(-1)
        m = momentum[k].float().reshape(-1)
        e = corrected[k].float().reshape(-1) - d
        parts.append(torch.stack([torch.dot(d, m), torch.dot(d, d),
                                  torch.dot(m, m), torch.dot(e, e)]))
    return torch.stack(parts).sum(0)


def reference_moments_multi(state, deltas: Sequence[Mapping[str, torch.Tensor]],
                            *, method, outer_lr: float, mu: float, h,
                            rhos, taus, phases=None,
                            stacked_axes: Optional[Mapping[str, int]] = None
                            ) -> torch.Tensor:
    """Per-leaf reference of the K-stacked sweeps' moments: (K, 4) fp32,
    slice j against the momentum as of application j (the momentum evolves
    between slices as ``core/heloco.py:apply_arrivals`` evolves it)."""
    from repro_torch.core import heloco as _heloco
    from repro_torch.core import methods as _methods
    m = _methods.resolve(method)
    phases = [None] * len(deltas) if phases is None else list(phases)
    rows = []
    for delta, rho, tau, phase in zip(deltas, rhos, taus, phases):
        ctx = _methods.ArrivalCtx(outer_lr=outer_lr, mu=mu, h=h, rho=rho,
                                  tau=tau, phase=phase,
                                  stacked_axes=stacked_axes)
        corrected = m.correct(m, ctx, delta, state.momentum)
        rows.append(reference_moments(delta, state.momentum, corrected))
        state = _heloco.apply_arrival(state, delta, method=m,
                                      outer_lr=outer_lr, mu=mu, h=h,
                                      rho=rho, tau=tau, phase=phase,
                                      stacked_axes=stacked_axes)
    return torch.stack(rows)


def momentum_only_moments(momentum_sq) -> torch.Tensor:
    """Moments of a suppressed (dropped) arrival: Delta = 0, so only the
    momentum norm is defined."""
    msq = torch.as_tensor(momentum_sq, dtype=torch.float32)
    z = torch.zeros((), dtype=torch.float32, device=msq.device)
    return torch.stack([z, z, msq, z])
