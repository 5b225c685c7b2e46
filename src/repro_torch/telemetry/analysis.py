"""Section-5 analyses over telemetry streams.

A copy of ``repro/telemetry/analysis.py``: pure functions from record
lists (``repro_torch.telemetry.schema``) to plain dict/list artifacts,
equal to the reference's on the same records.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.telemetry.schema import ArrivalMetrics, EvalMetrics


def _mean(xs: Sequence[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def staleness_alignment(arrivals: Sequence[ArrivalMetrics],
                        include_dropped: bool = False) -> List[Dict]:
    """Staleness -> update-quality curve (paper Fig. "alignment decays
    with staleness"): one point per observed staleness value with the
    mean cosine alignment and mean corrected-mass fraction."""
    by_tau: Dict[int, List[ArrivalMetrics]] = defaultdict(list)
    for a in arrivals:
        if a.cos_align is None or (a.dropped and not include_dropped):
            continue
        by_tau[a.staleness].append(a)
    return [{
        "staleness": tau,
        "n": len(group),
        "mean_cos_align": _mean([a.cos_align for a in group]),
        "mean_corrected_frac": _mean([a.corrected_frac for a in group]),
        "mean_delta_norm": _mean([a.delta_norm for a in group]),
    } for tau, group in sorted(by_tau.items())]


def per_language_curves(evals: Sequence[EvalMetrics]
                        ) -> Dict[str, List[Tuple[int, float]]]:
    """lang -> [(outer_step, loss), ...] (Fig. 3 per-language curves)."""
    out: Dict[str, List[Tuple[int, float]]] = defaultdict(list)
    for e in evals:
        for lang, loss in e.per_lang.items():
            out[lang].append((e.outer_step, loss))
    return dict(out)


def per_language_final(evals: Sequence[EvalMetrics]) -> Dict[str, float]:
    return dict(evals[-1].per_lang) if evals else {}


def language_spread(evals: Sequence[EvalMetrics]) -> Optional[float]:
    """max - min final per-language loss: the paper's fairness-under-
    non-IID summary number (lower = more even across languages)."""
    final = per_language_final(evals)
    if not final:
        return None
    return max(final.values()) - min(final.values())


def summarize(arrivals: Sequence[ArrivalMetrics],
              evals: Sequence[EvalMetrics]) -> Dict:
    """One-paragraph view of a stream (used by run_cached + the CLI)."""
    live = [a for a in arrivals if not a.dropped and a.cos_align is not None]
    return {
        "arrivals": len(arrivals),
        "dropped": sum(1 for a in arrivals if a.dropped),
        "mean_staleness": _mean([a.staleness for a in arrivals]),
        "mean_cos_align": _mean([a.cos_align for a in live]),
        "mean_corrected_frac": _mean([a.corrected_frac for a in live]),
        "final_mean_loss": evals[-1].mean_loss if evals else None,
        "language_spread": language_spread(evals),
        "tokens_total": arrivals[-1].tokens_total if arrivals else 0,
    }
