"""The synchronizer (outer-optimizer server) for asynchronous
low-communication training.

Port of ``repro/async_engine/server.py:Synchronizer`` on its packed path
with one commit per arrival, no compression and no telemetry. The outer
state lives packed: params, momentum and, for buffered methods, the
gradient accumulator are flattened once into fp32 (R, 128) buffers on the
device, every arrival rewrites them in place with the packed kernels, and
the dict view is unpacked only on demand (``state``, ``worker_init``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, NamedTuple, Optional

import torch

from repro_torch.configs.base import OuterOptConfig
from repro_torch.core import methods as outer_methods
from repro_torch.core import packing
from repro_torch.core.heloco import (
    apply_arrival_packed, lookahead_packed, momentum_decay_packed,
)

Params = Dict[str, torch.Tensor]


class OuterState(NamedTuple):
    """Outer params + Nesterov momentum + outer step t (+ the method's
    gradient accumulator, buffered methods only)."""
    params: Params
    momentum: Params
    step: int
    aux: Optional[Params] = None


@dataclass
class ArrivalRecord:
    outer_step: int
    worker_id: int
    staleness: int
    rho: float
    sim_time: float
    lang: str = ""
    dropped: bool = False


class Synchronizer:
    def __init__(self, init_params: Mapping[str, torch.Tensor],
                 cfg: OuterOptConfig, n_workers: int, commit_batch: int = 1):
        if cfg.compression != "none":
            raise NotImplementedError(
                f"compression={cfg.compression!r}: the port's server takes "
                "uncompressed pseudo-gradients only (ROADMAP A9)")
        if commit_batch != 1:
            raise NotImplementedError(
                f"commit_batch={commit_batch}: the port commits one arrival "
                "at a time (batched commits are ROADMAP A11)")
        self.cfg = cfg
        self.method = outer_methods.resolve(cfg.method)
        self.n_workers = n_workers
        self.records: List[ArrivalRecord] = []
        # idempotent-commit ledger: commit_key -> record already produced,
        # so a replayed delivery can never step the outer state twice
        self._committed: dict = {}
        self.layout = packing.build_layout(init_params)
        self._pbuf = packing.pack(self.layout, init_params)
        self._mbuf = packing.zeros(self.layout, self._pbuf.device)
        self._abuf = (packing.zeros(self.layout, self._pbuf.device)
                      if self.method.uses_buffer else None)
        # the schedule hooks read only (phase + 1) % buffer_period
        self._phase_period = self.method.buffer_period or 1
        self._step = 0
        self._state_cache: Optional[OuterState] = None

    # -- outer state view -----------------------------------------------------
    @property
    def state(self) -> OuterState:
        """Dict view of the outer state (unpacked on demand, cached)."""
        if self._state_cache is None:
            self._state_cache = OuterState(
                params=packing.unpack(self.layout, self._pbuf),
                momentum=packing.unpack(self.layout, self._mbuf,
                                        dtype=torch.float32),
                step=self._step,
                aux=(packing.unpack(self.layout, self._abuf,
                                    dtype=torch.float32)
                     if self._abuf is not None else None))
        return self._state_cache

    @property
    def t(self) -> int:
        return self._step

    # -- worker initialization ------------------------------------------------
    def worker_init(self, wid: Optional[int] = None) -> Params:
        """Parameters handed to a newly available worker: the Eq. 5
        look-ahead for methods that take part in it, else theta_t. ``wid``
        mirrors the reference signature; the hub hands every worker the
        same state."""
        if self.cfg.lookahead_init and self.method.lookahead_init:
            return packing.unpack(self.layout, lookahead_packed(
                self._pbuf, self._mbuf, self.cfg.outer_lr, self.cfg.momentum))
        return packing.unpack(self.layout, self._pbuf)

    # -- arrival weighting ----------------------------------------------------
    def _rho(self, tau: int) -> float:
        k = max(self.n_workers, 1)
        if self.cfg.weight_factor == "base":
            rho = math.sqrt(k) / k
        elif self.cfg.weight_factor == "average":
            rho = 1.0 / k
        else:
            rho = 1.0
        if self.cfg.delay_weighting:
            rho = rho / math.sqrt(1.0 + tau)
        return rho

    # -- outer-step drivers ---------------------------------------------------
    def _step_update(self, delta: Mapping[str, torch.Tensor], rho: float,
                     tau: float):
        # The reference donates p/m(/b) to its jitted step; here the fused
        # sweep writes p', m' (and b') over p, m (and b). Each element is
        # read and written at the same index by the same thread, so the
        # in-place update is safe, and it saves the (R, 128) allocations.
        apply_arrival_packed(
            self._pbuf, self._mbuf, delta, self.layout, method=self.method,
            outer_lr=self.cfg.outer_lr, mu=self.cfg.momentum,
            h=self.cfg.heloco, rho=rho, tau=tau, abuf=self._abuf,
            phase=self.t % self._phase_period,
            out=(self._pbuf, self._mbuf, self._abuf)[
                :2 if self._abuf is None else 3])
        self._step += 1
        self._state_cache = None

    def _step_decay(self, rho: float, tau: float):
        """Dropped arrival (App. A.6): momentum-decay-only outer step."""
        out = momentum_decay_packed(
            self._pbuf, self._mbuf, self.cfg.outer_lr, self.cfg.momentum,
            method=self.method, rho=rho, tau=tau, abuf=self._abuf,
            phase=self.t % self._phase_period)
        self._pbuf, self._mbuf = out[:2]
        if self._abuf is not None:
            self._abuf = out[2]
        self._step += 1
        self._state_cache = None

    # -- arrival processing ---------------------------------------------------
    def on_arrival(self, delta: Mapping[str, torch.Tensor], s_i: int,
                   worker_id: int, sim_time: float = 0.0, lang: str = "",
                   commit_key=None) -> ArrivalRecord:
        """Apply one pseudo-gradient arrival. A ``commit_key`` seen before
        returns the original record and leaves the outer state untouched."""
        if commit_key is not None:
            prior = self._committed.get(commit_key)
            if prior is not None:
                return prior
        tau = self.t - s_i
        dropped = (self.cfg.drop_stale_after is not None
                   and tau > self.cfg.drop_stale_after)
        rho = self._rho(tau)
        if dropped:
            self._step_decay(rho, tau)
        else:
            self._step_update(delta, rho, tau)
        rec = ArrivalRecord(outer_step=self.t, worker_id=worker_id,
                            staleness=tau, rho=rho, sim_time=sim_time,
                            lang=lang, dropped=dropped)
        self.records.append(rec)
        if commit_key is not None:
            self._committed[commit_key] = rec
        return rec

    # -- sync round (barrier) -------------------------------------------------
    def on_sync_round(self, deltas: List[Mapping[str, torch.Tensor]],
                      sim_time: float = 0.0) -> ArrivalRecord:
        """Synchronous DiLoCo: average the workers' pseudo-gradients, one
        outer step. The average adds the workers in order and then divides,
        as the reference does (another summation order changes the bits)."""
        k = len(deltas)
        avg = {p: sum(d[p].float() for d in deltas) / k for p in deltas[0]}
        # sync-nesterov in the paper uses average weighting: G = mean(Delta)
        self._step_update(avg, 1.0, 0.0)
        rec = ArrivalRecord(outer_step=self.t, worker_id=-1, staleness=0,
                            rho=1.0, sim_time=sim_time)
        self.records.append(rec)
        return rec
