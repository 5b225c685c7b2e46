"""Deterministic synthetic "multilingual" corpus for non-IID experiments.

Each language (= shard = data domain) is a distinct stochastic process over
its own token sub-range plus a shared token pool, mimicking the paper's
multilingual mC4 setup: distributions differ per shard (non-IID) but share
structure. Sequences come from a per-language affine bigram process with
Zipf-distributed innovations — cheap, deterministic, and learnable, so
validation loss decreases with training and differs measurably across
languages (what Fig. 3 needs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

LANGS = ("de", "en", "es", "fr", "it")


@dataclass(frozen=True)
class LanguageSpec:
    lang: str
    index: int
    vocab_size: int          # model vocab
    lo: int                  # language-private token range [lo, hi)
    hi: int
    shared_lo: int           # shared token range
    shared_hi: int
    a: int                   # affine bigram multiplier
    b: int                   # affine bigram offset
    noise: float             # innovation probability
    share_p: float           # probability of emitting a shared token


def make_language_specs(vocab_size: int, n_langs: int = 5,
                        seed: int = 0) -> List[LanguageSpec]:
    rng = np.random.default_rng(seed)
    shared = max(8, vocab_size // 8)
    per = (vocab_size - shared) // n_langs
    specs = []
    for i in range(n_langs):
        lo = shared + i * per
        specs.append(LanguageSpec(
            lang=LANGS[i % len(LANGS)] + ("" if i < len(LANGS) else str(i)),
            index=i,
            vocab_size=vocab_size,
            lo=lo, hi=lo + per,
            shared_lo=0, shared_hi=shared,
            a=int(rng.integers(3, 17)) * 2 + 1,
            b=int(rng.integers(1, per)),
            noise=0.12 + 0.03 * i,
            share_p=0.15,
        ))
    return specs


def sample_tokens(spec: LanguageSpec, batch: int, seq: int,
                  rng: np.random.Generator) -> np.ndarray:
    """(batch, seq+1) int32 token ids from language `spec`."""
    width = spec.hi - spec.lo
    out = np.empty((batch, seq + 1), np.int64)
    state = rng.integers(0, width, size=batch)
    zipf = np.minimum(rng.zipf(1.5, size=(batch, seq + 1)), width) - 1
    noise_mask = rng.random((batch, seq + 1)) < spec.noise
    share_mask = rng.random((batch, seq + 1)) < spec.share_p
    shared_tok = rng.integers(spec.shared_lo, spec.shared_hi,
                              size=(batch, seq + 1))
    for t in range(seq + 1):
        state = (spec.a * state + spec.b) % width
        state = np.where(noise_mask[:, t], (state + zipf[:, t]) % width, state)
        out[:, t] = np.where(share_mask[:, t], shared_tok[:, t],
                             spec.lo + state)
    return out.astype(np.int32)


def mixture_weights(n_langs: int, alpha: float, wid: int,
                    seed: int = 0) -> np.ndarray:
    """Per-worker language mixture ~ Dirichlet(alpha): the paper's
    data-heterogeneity axis between one-shard-per-worker (alpha -> 0) and
    the IID global mixture (alpha -> inf). Deterministic in (seed, wid)."""
    rng = np.random.default_rng([seed, 7919, wid])
    return rng.dirichlet(np.full(n_langs, float(alpha)))


class ShardSampler:
    """Deterministic batch stream for one worker.

    non-IID: the worker draws from a single language, or — when `mixture`
    is given — each sequence from its per-worker language mixture
    (Dirichlet non-IID, see `mixture_weights`).
    IID: the worker draws each sequence from a uniformly random language
    (the global mixture), so all workers share one distribution.
    """

    def __init__(self, specs: Sequence[LanguageSpec], lang_index: Optional[int],
                 batch: int, seq: int, seed: int,
                 mixture: Optional[Sequence[float]] = None):
        self.specs = list(specs)
        self.lang_index = lang_index
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.mixture = None if mixture is None else np.asarray(mixture, float)

    def sample(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + (self.lang_index or 0) * 101 + step)
            % (2 ** 63))
        if self.mixture is not None:
            langs = rng.choice(len(self.specs), size=self.batch,
                               p=self.mixture / self.mixture.sum())
            toks = np.concatenate([
                sample_tokens(self.specs[li], 1, self.seq, rng)
                for li in langs], axis=0)
        elif self.lang_index is None:  # IID mixture
            langs = rng.integers(0, len(self.specs), size=self.batch)
            toks = np.concatenate([
                sample_tokens(self.specs[li], 1, self.seq, rng)
                for li in langs], axis=0)
        else:
            toks = sample_tokens(self.specs[self.lang_index], self.batch,
                                 self.seq, rng)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def eval_batches(specs: Sequence[LanguageSpec], batch: int, seq: int,
                 seed: int = 10_007) -> List[dict]:
    """Held-out per-language eval batches (Fig. 3 protocol)."""
    rng = np.random.default_rng(seed)
    out = []
    for spec in specs:
        toks = sample_tokens(spec, batch, seq, rng)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "lang": spec.lang})
    return out
