"""The synchronizer (outer-optimizer server) for asynchronous
low-communication training.

Port of ``repro/async_engine/server.py:Synchronizer``. A pseudo-gradient
arrives as a dict or, from the packed int8 round-trip, as a
``packing.Packed`` buffer, which the packed arrival path takes as it is.
By default the outer state lives packed: params, momentum and, for
buffered methods, the gradient accumulator are flattened once into fp32
(R, 128) buffers on the device, every arrival rewrites them in place with
the packed kernels, and the dict view is unpacked only on demand
(``state``, ``worker_init``).

``packed=False`` keeps the per-leaf path instead, the correctness
reference: the state is an ``OuterState`` of dicts and each arrival goes
through ``core/heloco.py:apply_arrival`` leaf by leaf; with
``use_kernel=True`` HeLoCo's correction of each leaf runs through the
per-leaf kernels (``kernels/ops.py``: two launches a leaf). Dropped stale
arrivals take a momentum-decay-only step on either path.

With ``commit_batch = K > 1`` arrivals can be parked in a commit buffer
(``buffer_arrival``) and committed together (``flush``): on the packed path
a run of two or more applied arrivals goes through one K-stacked fused
sweep (``apply_arrivals_packed``), everything else through ``on_arrival``.

``telemetry=True`` attaches the update-quality stats of each arrival to its
record (``telemetry/stats.py``). On the packed path the moments are the
extra (R, 4) or (K, R, 4) output of the sweep the arrival launches anyway,
summed on the device; a dropped arrival's are the momentum's norm alone;
the per-leaf path takes ``reference_moments`` of its own correction. They
reach the host once per commit call: a (4,) copy per arrival, a (K, 4) one
per fused run.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, NamedTuple, Optional, Union

import torch

from repro_torch.configs.base import OuterOptConfig
from repro_torch.core import methods as outer_methods
from repro_torch.core import packing
from repro_torch.core.heloco import (
    OuterState, apply_arrival, apply_arrival_packed, apply_arrivals_packed,
    init_outer_state, lookahead_init, lookahead_packed, momentum_decay_packed,
    momentum_decay_update,
)
from repro_torch.telemetry import stats as _ts

Params = Dict[str, torch.Tensor]
Delta = Union[Mapping[str, torch.Tensor], packing.Packed]


def _mean(xs: List[torch.Tensor]) -> torch.Tensor:
    """Sum in order, then divide by the count."""
    return packing.true_div(sum(xs), len(xs))


def _mbuf_moments(mbuf: torch.Tensor) -> torch.Tensor:
    """Telemetry moments of a suppressed arrival on the packed path."""
    return _ts.momentum_only_moments((mbuf * mbuf).sum())


def _decay_moments(momentum: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Telemetry moments of a suppressed arrival on the per-leaf path: the
    momentum's squares summed leaf by leaf."""
    return _ts.momentum_only_moments(
        sum((x.float() ** 2).sum() for x in momentum.values()))


class _Pending(NamedTuple):
    """One buffered, not yet committed arrival (see ``buffer_arrival``)."""
    delta: Delta
    s_i: int
    worker_id: int
    sim_time: float
    lang: str
    commit_key: object


@dataclass
class ArrivalRecord:
    outer_step: int
    worker_id: int
    staleness: int
    rho: float
    sim_time: float
    lang: str = ""
    dropped: bool = False
    # update-quality diagnostics (set only when the synchronizer runs with
    # telemetry=True; see repro_torch.telemetry.stats)
    cos_align: Optional[float] = None
    corrected_frac: Optional[float] = None
    delta_norm: Optional[float] = None
    momentum_norm: Optional[float] = None


class Synchronizer:
    def __init__(self, init_params: Mapping[str, torch.Tensor],
                 cfg: OuterOptConfig, n_workers: int,
                 stacked_axes: Optional[Mapping[str, int]] = None,
                 use_kernel: bool = False, packed: bool = True,
                 telemetry: bool = False, commit_batch: int = 1):
        """stacked_axes: path -> leading layer axes of a stacked leaf (each
        layer its own block); use_kernel: HeLoCo's per-leaf correction
        through the kernels (per-leaf path only); packed: the packed fast
        path (True) or the per-leaf path; telemetry: attach each arrival's
        update-quality stats to its record."""
        self.cfg = cfg
        self.method = outer_methods.resolve(cfg.method)
        self.n_workers = n_workers
        self.stacked_axes = stacked_axes
        self.use_kernel = use_kernel
        self.packed = packed
        self.telemetry = telemetry
        # the last commit's (4,) moments (telemetry only): on the device
        # until _attach_stats reads them
        self._last_moments: Optional[torch.Tensor] = None
        self.records: List[ArrivalRecord] = []
        # idempotent-commit ledger: commit_key -> record already produced,
        # so a replayed delivery can never step the outer state twice
        self._committed: dict = {}
        # the commit buffer: up to commit_batch parked arrivals, committed
        # by flush() (on batch-full here, at eval boundaries and the run's
        # end by the engine)
        self.commit_batch = max(1, int(commit_batch))
        self._pending: List[_Pending] = []
        self._pending_keys: set = set()
        # one event per flush (depth, why it fired, fused vs sequential
        # commits), cleared by the engine; running totals beside it
        self.flush_log: List[dict] = []
        self.flush_totals: dict = {"flushes": 0, "fused": 0,
                                   "sequential": 0, "depth_max": 0}
        # the schedule hooks read only (phase + 1) % buffer_period
        self._phase_period = self.method.buffer_period or 1
        if not packed:
            self.layout = None
            self._state = init_outer_state(
                init_params, with_aux=self.method.uses_buffer)
            return
        self.layout = packing.build_layout(init_params, stacked_axes)
        self._pbuf = packing.pack(self.layout, init_params)
        self._mbuf = packing.zeros(self.layout, self._pbuf.device)
        self._abuf = (packing.zeros(self.layout, self._pbuf.device)
                      if self.method.uses_buffer else None)
        self._step = 0
        self._state_cache: Optional[OuterState] = None

    # -- outer state view -----------------------------------------------------
    @property
    def state(self) -> OuterState:
        """Dict view of the outer state (on the packed path unpacked on
        demand, cached)."""
        if not self.packed:
            return self._state
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

    @state.setter
    def state(self, value: OuterState):
        if not self.packed:
            self._state = value
            return
        self._pbuf = packing.pack(self.layout, value.params)
        self._mbuf = packing.pack(self.layout, value.momentum)
        if self.method.uses_buffer:
            self._abuf = (packing.pack(self.layout, value.aux)
                          if value.aux is not None
                          else packing.zeros(self.layout, self._pbuf.device))
        self._step = int(value.step)
        self._state_cache = None

    @property
    def t(self) -> int:
        return self._step if self.packed else self._state.step

    # -- worker initialization ------------------------------------------------
    def worker_init(self, wid: Optional[int] = None) -> Params:
        """Parameters handed to a newly available worker: the Eq. 5
        look-ahead for methods that take part in it, else theta_t. ``wid``
        mirrors the reference signature; the hub hands every worker the
        same state."""
        if not self.packed:
            if self.cfg.lookahead_init and self.method.lookahead_init:
                return lookahead_init(self._state, self.cfg.outer_lr,
                                      self.cfg.momentum)
            return dict(self._state.params)
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
    def _step_update(self, delta: Delta, rho: float, tau: float):
        if not self.packed:
            if isinstance(delta, packing.Packed):
                raise TypeError("the per-leaf path takes a dict of leaves, "
                                "not a packed buffer")
            res = apply_arrival(
                self._state, delta, method=self.method,
                outer_lr=self.cfg.outer_lr, mu=self.cfg.momentum,
                h=self.cfg.heloco, rho=rho, tau=tau,
                stacked_axes=self.stacked_axes, use_kernel=self.use_kernel,
                phase=self.t % self._phase_period, with_stats=self.telemetry)
            if self.telemetry:
                self._state, self._last_moments = res
            else:
                self._state = res
            return
        # The reference donates p/m(/b) to its jitted step; here the fused
        # sweep writes p', m' (and b') over p, m (and b). Each element is
        # read and written at the same index by the same thread, so the
        # in-place update is safe, and it saves the (R, 128) allocations.
        res = apply_arrival_packed(
            self._pbuf, self._mbuf, delta, self.layout, method=self.method,
            outer_lr=self.cfg.outer_lr, mu=self.cfg.momentum,
            h=self.cfg.heloco, rho=rho, tau=tau, abuf=self._abuf,
            phase=self.t % self._phase_period,
            out=(self._pbuf, self._mbuf, self._abuf)[
                :2 if self._abuf is None else 3],
            with_stats=self.telemetry)
        if self.telemetry:
            self._last_moments = res[-1].sum(0)
        self._step += 1
        self._state_cache = None

    def _step_update_multi(self, deltas: List[Delta], rhos: List[float],
                           taus: List[float]):
        """Commit K arrivals through one K-stacked fused sweep, in place.
        Their rho, tau and phase enter host-side scalars, which reach the
        device in one copy: the kernel's (K, n) scalar table. Returns the
        (K, 4) telemetry moments on the host, one copy for the run (None
        without telemetry)."""
        k = len(deltas)
        res = apply_arrivals_packed(
            self._pbuf, self._mbuf, deltas, self.layout, method=self.method,
            outer_lr=self.cfg.outer_lr, mu=self.cfg.momentum,
            h=self.cfg.heloco, rhos=rhos, taus=taus, abuf=self._abuf,
            phases=[(self._step + j) % self._phase_period for j in range(k)],
            out=(self._pbuf, self._mbuf, self._abuf)[
                :2 if self._abuf is None else 3],
            with_stats=self.telemetry)
        self._step += k
        self._state_cache = None
        return res[-1].sum(1).cpu() if self.telemetry else None

    def _step_decay(self, rho: float, tau: float):
        """Dropped arrival (App. A.6): momentum-decay-only outer step."""
        if not self.packed:
            if self.telemetry:
                self._last_moments = _decay_moments(self._state.momentum)
            self._state = momentum_decay_update(
                self._state, self.cfg.outer_lr, self.cfg.momentum,
                method=self.method, rho=rho, tau=tau,
                phase=self.t % self._phase_period)
            return
        if self.telemetry:
            self._last_moments = _mbuf_moments(self._mbuf)
        out = momentum_decay_packed(
            self._pbuf, self._mbuf, self.cfg.outer_lr, self.cfg.momentum,
            method=self.method, rho=rho, tau=tau, abuf=self._abuf,
            phase=self.t % self._phase_period)
        self._pbuf, self._mbuf = out[:2]
        if self._abuf is not None:
            self._abuf = out[2]
        self._step += 1
        self._state_cache = None

    def _attach_stats(self, rec: ArrivalRecord) -> ArrivalRecord:
        """Fold the last step's telemetry moments into the record."""
        if self.telemetry and self._last_moments is not None:
            s = _ts.stats_from_moments(self._last_moments)
            rec.cos_align = s.cos_align
            rec.corrected_frac = s.corrected_frac
            rec.delta_norm = s.delta_norm
            rec.momentum_norm = s.momentum_norm
        return rec

    # -- arrival processing ---------------------------------------------------
    def on_arrival(self, delta: Delta, s_i: int,
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
        rec = self._attach_stats(
            ArrivalRecord(outer_step=self.t, worker_id=worker_id,
                          staleness=tau, rho=rho, sim_time=sim_time,
                          lang=lang, dropped=dropped))
        self.records.append(rec)
        if commit_key is not None:
            self._committed[commit_key] = rec
        return rec

    # -- batched arrival processing -------------------------------------------
    @property
    def pending(self) -> int:
        """Arrivals parked in the commit buffer, awaiting ``flush``."""
        return len(self._pending)

    def buffer_arrival(self, delta: Delta, s_i: int, worker_id: int,
                       sim_time: float = 0.0, lang: str = "",
                       commit_key=None) -> Optional[List[ArrivalRecord]]:
        """Park one arrival in the commit buffer. Returns the flushed
        records when this arrival filled the batch, None while it is still
        coalescing. An arrival whose ``commit_key`` is in the ledger or
        already buffered is dropped here: ``on_arrival``'s idempotence,
        extended to buffered redelivery."""
        if commit_key is not None:
            if (commit_key in self._committed
                    or commit_key in self._pending_keys):
                return None
            self._pending_keys.add(commit_key)
        self._pending.append(_Pending(delta, s_i, worker_id, sim_time, lang,
                                      commit_key))
        if len(self._pending) >= self.commit_batch:
            return self.flush("batch-full")
        return None

    def flush(self, reason: str = "batch-full") -> List[ArrivalRecord]:
        """Commit every buffered arrival in buffering order and return their
        records. On the packed path a run of two or more consecutive applied
        arrivals of a batchable method commits through one fused K-stacked
        sweep; a dropped arrival (App. A.6), a run of one, a non-batchable
        method and the per-leaf path go through the exact ``on_arrival``, so
        a batch of one equals the unbatched server bit for bit. ``reason``
        (batch-full | eval | close) is recorded in ``flush_log``, nothing
        else reads it."""
        pending, self._pending = self._pending, []
        self._pending_keys = set()
        if not pending:
            return []
        n = len(pending)
        n_fused = 0
        # every commit, applied or dropped, advances t by one, so arrival j
        # of the flush sees tau_j = (t0 + j) - s_i_j whatever path it takes
        t0 = self.t
        drop_after = self.cfg.drop_stale_after
        drops = [drop_after is not None and (t0 + j) - a.s_i > drop_after
                 for j, a in enumerate(pending)]
        batchable = self.packed and self.method.batchable
        recs: List[ArrivalRecord] = []
        i = 0
        while i < n:
            j = i
            if batchable and not drops[i]:
                while j < n and not drops[j]:
                    j += 1
            if j - i < 2:
                a = pending[i]
                recs.append(self.on_arrival(a.delta, a.s_i, a.worker_id,
                                            a.sim_time, a.lang, a.commit_key))
                i += 1
                continue
            run = pending[i:j]
            t_run = self.t
            taus = [t_run + idx - a.s_i for idx, a in enumerate(run)]
            rhos = [self._rho(tau) for tau in taus]
            moments = self._step_update_multi([a.delta for a in run], rhos,
                                              taus)
            for idx, a in enumerate(run):
                rec = ArrivalRecord(outer_step=t_run + idx + 1,
                                    worker_id=a.worker_id,
                                    staleness=taus[idx], rho=rhos[idx],
                                    sim_time=a.sim_time, lang=a.lang)
                if moments is not None:
                    self._last_moments = moments[idx]
                rec = self._attach_stats(rec)
                self.records.append(rec)
                if a.commit_key is not None:
                    self._committed[a.commit_key] = rec
                recs.append(rec)
            n_fused += len(run)
            i = j
        self.flush_log.append({"depth": n, "reason": str(reason),
                               "fused": n_fused, "sequential": n - n_fused})
        self.flush_totals["flushes"] += 1
        self.flush_totals["fused"] += n_fused
        self.flush_totals["sequential"] += n - n_fused
        self.flush_totals["depth_max"] = max(self.flush_totals["depth_max"],
                                             n)
        return recs

    # -- sync round (barrier) -------------------------------------------------
    def on_sync_round(self, deltas: List[Delta],
                      sim_time: float = 0.0) -> ArrivalRecord:
        """Synchronous DiLoCo: average the workers' pseudo-gradients, one
        outer step. The average adds the workers in order and then divides,
        as the reference does (another summation order changes the bits);
        packed deltas average buffer by buffer."""
        if isinstance(deltas[0], packing.Packed):
            avg = packing.Packed(_mean([d.buf for d in deltas]))
        else:
            avg = {p: _mean([d[p].float() for d in deltas])
                   for p in deltas[0]}
        # sync-nesterov in the paper uses average weighting: G = mean(Delta)
        self._step_update(avg, 1.0, 0.0)
        rec = self._attach_stats(
            ArrivalRecord(outer_step=self.t, worker_id=-1, staleness=0,
                          rho=1.0, sim_time=sim_time))
        self.records.append(rec)
        return rec

    def set_n_workers(self, n: int):
        """Elastic membership: the live worker count the arrival weight
        ``rho`` is computed from."""
        self.n_workers = n
