"""The virtual-clock training engine of the port.

Port of the part of ``repro/async_engine/engine.py`` that a run with one
commit per arrival uses: workers at fixed paces on fixed or flexible
language shards or on Dirichlet language mixtures, DyLU's pace-scaled local
steps, a virtual-clock event queue of worker returns and restarts, crashes
with a scheduled rejoin, elastic joins and leaves, the functional inner
round (``execute_round``) with pseudo-gradient compression and error
feedback, the server-side commit through the packed ``Synchronizer``, the
barrier rounds of a synchronous method, and the per-language eval
protocol. Only *time* is simulated; the inner rounds run for real on the
engine's device.

The arrival sequence depends only on paces, H, the schedule and the
failure and membership events, so it equals the reference's exactly. A
``RunConfig`` axis the port does not run yet raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.async_engine.server import Synchronizer
from repro_torch.configs.base import RunConfig
from repro_torch.core.compression import roundtrip_with_error_feedback
from repro_torch.data.synthetic import (
    ShardSampler, eval_batches, make_language_specs, mixture_weights,
)
from repro_torch.device import resolve_device
from repro_torch.models.transformer import build_model
from repro_torch.optim.adamw import AdamState, init_adam
from repro_torch.train.inner import eval_loss, pseudo_gradient, run_inner

Params = Dict[str, torch.Tensor]

# RunConfig axes the port's engine does not run yet: (field, default,
# ROADMAP item).
UNPORTED_AXES = (
    ("topology", "hub", "A14"),
    ("commit_batch", 1, "A11"),
    ("batch_rampup", None, "A11"),
)


def unported_axes(run_cfg: RunConfig) -> List[str]:
    """The axes of ``run_cfg`` set away from their defaults that the port
    cannot run yet, each with its ROADMAP item."""
    return [f"{name}={getattr(run_cfg, name)!r} (ROADMAP {item})"
            for name, default, item in UNPORTED_AXES
            if getattr(run_cfg, name) != default]


@dataclass
class Worker:
    wid: int
    pace: float = 1.0                # seconds per inner step (virtual)
    lang: Optional[int] = None       # fixed shard, or the mixture's dominant
    mixture: Optional[Tuple[float, ...]] = None  # Dirichlet language mixture
    opt: Optional[AdamState] = None  # carried across rounds
    ef: Any = None                   # error feedback of the compression
    inner_step_count: int = 0        # lifetime steps (LR schedule offset)
    alive: bool = True
    generation: int = 0              # bumped on a crash: its return is stale
    pending_task_id: Optional[int] = None  # the round in flight

    @property
    def in_flight(self) -> bool:
        return self.pending_task_id is not None


@dataclass
class FailureEvent:
    """A worker crash at ``time`` (its round in flight is lost) and its
    rejoin ``restart_delay`` simulated seconds later."""
    time: float
    wid: int
    restart_delay: float = 60.0


@dataclass
class ElasticEvent:
    """A worker joins (at ``pace``, on shard ``lang``) or leaves at ``time``."""
    time: float
    action: str                      # "join" | "leave"
    wid: int
    pace: float = 1.0
    lang: Optional[int] = None


class EventQueue:
    """Virtual-clock events ``(time, kind, wid, generation)``, kind "return"
    or "restart", popped in (time, push order), the order of the
    reference's vectorized queue."""

    def __init__(self):
        self._heap: List[Tuple[float, int, str, int, int]] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, time: float, kind: str, wid: int, gen: int):
        heapq.heappush(self._heap,
                       (float(time), self._seq, kind, int(wid), int(gen)))
        self._seq += 1

    def pop(self) -> Tuple[float, str, int, int]:
        time, _seq, kind, wid, gen = heapq.heappop(self._heap)
        return time, kind, wid, gen


@dataclass
class History:
    arrivals: List[Dict] = field(default_factory=list)
    evals: List[Dict] = field(default_factory=list)
    tokens: int = 0
    comm_bytes: int = 0
    final_time: float = 0.0


@dataclass
class RoundTask:
    """Snapshot of one dispatched inner round; ``execute_round`` reads only
    this, never the live ``Worker``."""
    task_id: int
    wid: int
    generation: int
    params: Params
    opt: AdamState
    ef: Any
    s_i: int
    h_steps: int
    lang: Optional[int]
    inner_step_offset: int
    mixture: Optional[Tuple[float, ...]] = None


@dataclass
class RoundResult:
    wid: int
    generation: int
    delta: Any                       # Params, or packing.Packed under int8
    opt: AdamState
    ef: Any
    nbytes: int
    s_i: int
    h_steps: int
    lang: Optional[int]


def execute_round(task: RoundTask, *, model, cfg: RunConfig, specs,
                  layout=None) -> RoundResult:
    """The functional inner round: H AdamW steps from the task's params on
    the worker's shard or mixture, then the pseudo-gradient, compressed
    with error feedback when the run asks for it (int8 through the packed
    ``layout``, the server's, when one is given)."""
    sampler = ShardSampler(specs, task.lang, cfg.batch_size, cfg.seq_len,
                           seed=cfg.seed * 977 + task.wid,
                           mixture=task.mixture)
    result = run_inner(model, cfg.inner, task.params, task.opt, sampler,
                       task.h_steps, step_offset=task.inner_step_offset)
    delta = pseudo_gradient(task.params, result.params)
    delta, ef, nbytes = roundtrip_with_error_feedback(
        delta, task.ef, cfg.outer.compression, cfg.outer.topk_ratio,
        layout=layout)
    if not cfg.outer.error_feedback:
        ef = None
    return RoundResult(wid=task.wid, generation=task.generation, delta=delta,
                       opt=result.opt, ef=ef, nbytes=nbytes, s_i=task.s_i,
                       h_steps=task.h_steps, lang=task.lang)


class EngineBase:
    """Shared engine: bookkeeping, dispatch, commit, and the event loop.
    Subclasses say where a captured round goes (``_submit``) and how its
    result comes back (``_obtain``)."""

    def __init__(self, run_cfg: RunConfig, *, device="cuda",
                 init_params: Optional[Mapping[str, np.ndarray]] = None,
                 failures: Optional[List[FailureEvent]] = None,
                 elastic: Optional[List[ElasticEvent]] = None):
        """``init_params``: start from these parameters (numpy arrays keyed
        by path, see ``bridge``) instead of a fresh draw from ``run_cfg.seed``;
        the port's counterpart of the reference's ``restore``, used to start
        both packages from the same bits. ``failures``/``elastic``: crash and
        membership events, applied in time order."""
        missing = unported_axes(run_cfg)
        if missing:
            raise NotImplementedError(
                "the port's engine does not run " + "; ".join(missing))
        self.cfg = run_cfg
        self.device = resolve_device(device)
        self.model = build_model(run_cfg.model)
        self.specs = make_language_specs(run_cfg.model.vocab_size,
                                         n_langs=max(run_cfg.n_workers, 2),
                                         seed=run_cfg.seed)
        if init_params is None:
            gen = torch.Generator().manual_seed(run_cfg.seed)
            params = self.model.init(gen, self.device)
        else:
            params = bridge.to_torch(init_params, self.device)
            if set(params) != set(self.model.param_specs()):
                raise ValueError("init_params do not match the model's leaves")
        self.server = Synchronizer(params, run_cfg.outer, run_cfg.n_workers,
                                   commit_batch=run_cfg.commit_batch)
        self.workers: Dict[int, Worker] = {}
        for wid in range(run_cfg.n_workers):
            pace = run_cfg.worker_paces[wid % len(run_cfg.worker_paces)]
            mixture = self._mixture_for(wid)
            if mixture is not None:
                lang = int(np.argmax(mixture))   # dominant shard (accounting)
            else:
                lang = (wid % len(self.specs)) if run_cfg.non_iid else None
            self.workers[wid] = Worker(wid=wid, pace=pace, lang=lang,
                                       mixture=mixture, opt=init_adam(params))
        self.failures = sorted(failures or [], key=lambda f: f.time)
        self.elastic = sorted(elastic or [], key=lambda e: e.time)
        self.lang_tokens = np.zeros(len(self.specs), np.int64)
        self.history = History()
        self.time = 0.0
        self._events = EventQueue()
        self._task_counter = 0
        # DyLU's reference pace: set here and on membership changes only,
        # never on a crash or a restart (as the reference does)
        self._min_pace = self._min_alive_pace()

    # -------------------------------------------------------- engine hooks
    def _submit(self, task: RoundTask) -> None:
        raise NotImplementedError

    def _obtain(self, w: Worker) -> RoundResult:
        raise NotImplementedError

    def _drop_round(self, w: Worker) -> None:
        """The worker's round in flight is lost (crash or leave)."""

    # ------------------------------------------------------------------ utils
    def _alive(self) -> List[Worker]:
        return [w for w in self.workers.values() if w.alive]

    def _min_alive_pace(self) -> float:
        return min((w.pace for w in self._alive()), default=1.0)

    def _mixture_for(self, wid: int) -> Optional[Tuple[float, ...]]:
        """Per-worker Dirichlet language mixture, deterministic in (seed,
        wid), so the same across a crash and for a joining worker."""
        if not (self.cfg.non_iid and self.cfg.mixture_alpha):
            return None
        return tuple(mixture_weights(len(self.specs), self.cfg.mixture_alpha,
                                     wid, seed=self.cfg.seed))

    def _h_steps(self, w: Worker) -> int:
        """H, or under DyLU H scaled by the fastest live pace over this
        worker's, at least 1."""
        if self.cfg.dylu:
            return max(1, int(round(self.cfg.inner_steps *
                                    self._min_pace / w.pace)))
        return self.cfg.inner_steps

    def _pick_lang(self, w: Worker) -> Optional[int]:
        if not self.cfg.non_iid:
            return None
        if w.mixture is not None:        # the mixture samples; lang is
            return w.lang                # its dominant shard, for accounting
        if self.cfg.shard_assignment == "flexible":
            return int(np.argmin(self.lang_tokens))
        return w.lang

    # --------------------------------------------------------------- dispatch
    def _make_task(self, w: Worker) -> RoundTask:
        """Capture the worker's initialization and round snapshot."""
        self._task_counter += 1
        w.pending_task_id = self._task_counter
        return RoundTask(task_id=self._task_counter, wid=w.wid,
                         generation=w.generation,
                         params=self.server.worker_init(w.wid), opt=w.opt,
                         ef=w.ef, s_i=self.server.t, h_steps=self._h_steps(w),
                         lang=self._pick_lang(w), mixture=w.mixture,
                         inner_step_offset=w.inner_step_count)

    def _dispatch(self, w: Worker):
        """Capture the round, schedule its virtual return, submit it."""
        task = self._make_task(w)
        self._events.push(self.time + task.h_steps * w.pace, "return", w.wid,
                          w.generation)
        self._submit(task)

    def _execute(self, task: RoundTask) -> RoundResult:
        layout = (self.server.layout
                  if self.cfg.outer.compression == "int8" else None)
        return execute_round(task, model=self.model, cfg=self.cfg,
                             specs=self.specs, layout=layout)

    # ----------------------------------------------------------------- commit
    def _commit_worker(self, w: Worker, res: RoundResult):
        """Fold a completed round back into the worker and the shared token
        and communication accounting (the order of commits is the history)."""
        w.opt = res.opt
        w.ef = res.ef
        w.inner_step_count += res.h_steps
        w.pending_task_id = None
        toks = res.h_steps * self.cfg.batch_size * self.cfg.seq_len
        self.history.tokens += toks
        if res.lang is not None:
            self.lang_tokens[res.lang] += toks
        self.history.comm_bytes += res.nbytes

    def _commit(self, w: Worker, res: RoundResult):
        self._commit_worker(w, res)
        rec = self.server.on_arrival(
            res.delta, res.s_i, res.wid, sim_time=self.time,
            lang=(self.specs[res.lang].lang if res.lang is not None
                  else "iid"))
        self.history.arrivals.append(dict(rec.__dict__))
        return rec

    def _eval(self, eval_fn):
        ev = eval_fn(self.server.state.params, self.server.t, self.time)
        self.history.evals.append(ev)

    # -------------------------------------------------------------- main loop
    def run(self, eval_every: int = 0,
            eval_fn: Optional[Callable[[Params, int, float], Dict]] = None
            ) -> History:
        """Run to ``outer_steps`` commits: barrier rounds for a synchronous
        method, else the asynchronous event loop."""
        if self.server.method.sync:
            self._run_sync(eval_every, eval_fn)
        else:
            self._run_async(eval_every, eval_fn)
        return self._finalize(eval_fn)

    def _post_commit(self, eval_every, eval_fn):
        if eval_every and eval_fn and self.server.t % eval_every == 0:
            self._eval(eval_fn)

    def _finalize(self, eval_fn) -> History:
        self.history.final_time = self.time
        if eval_fn and (not self.history.evals
                        or self.history.evals[-1]["step"] != self.server.t):
            self._eval(eval_fn)
        return self.history

    def _run_async(self, eval_every, eval_fn):
        """Virtual-clock event loop until ``outer_steps`` commits. Before an
        event takes effect, the failure and membership events due by its
        time are applied (still at the previous event's clock, so a joining
        worker's first return is scheduled from there). A return commits
        one arrival and re-dispatches its worker; a restart revives a
        crashed worker and dispatches it; the return of a lost round is
        skipped."""
        for w in self.workers.values():
            self._dispatch(w)
        fail_idx = el_idx = 0
        target = self.cfg.outer_steps
        while self.server.t < target and len(self._events):
            time, kind, wid, gen = self._events.pop()
            while (fail_idx < len(self.failures)
                   and self.failures[fail_idx].time <= time):
                self._handle_failure(self.failures[fail_idx])
                fail_idx += 1
            while (el_idx < len(self.elastic)
                   and self.elastic[el_idx].time <= time):
                self._handle_elastic(self.elastic[el_idx])
                el_idx += 1
            self.time = time
            w = self.workers.get(wid)
            if kind == "restart":
                if w is not None:
                    w.alive = True
                    self._dispatch(w)
                continue
            if w is None or not w.alive or gen != w.generation:
                continue                 # the lost round's stale return
            self._commit(w, self._obtain(w))
            self._post_commit(eval_every, eval_fn)
            if self.server.t < target:
                self._dispatch(w)

    def _run_sync(self, eval_every, eval_fn):
        """Barrier rounds: every worker runs one round from the same outer
        state, the slowest gates the clock, and the server takes one step
        on the workers' average pseudo-gradient."""
        while self.server.t < self.cfg.outer_steps:
            workers = self._alive()
            round_time = max(self._h_steps(w) * w.pace for w in workers)
            tasks = [self._make_task(w) for w in workers]
            results = [self._execute(t) for t in tasks]
            for w, res in zip(workers, results):
                self._commit_worker(w, res)
            self.time += round_time
            rec = self.server.on_sync_round([r.delta for r in results],
                                            sim_time=self.time)
            self.history.arrivals.append(dict(rec.__dict__))
            self._post_commit(eval_every, eval_fn)

    # ------------------------------------------------------- fault tolerance
    def _crash_worker(self, w: Worker):
        """The worker's round in flight is lost: its return turns stale
        (generation bump) and its error feedback is cleared."""
        self._drop_round(w)
        w.alive = False
        w.generation += 1
        w.ef = None
        w.pending_task_id = None

    def _handle_failure(self, ev: FailureEvent):
        w = self.workers.get(ev.wid)
        if w is None:
            return
        self._crash_worker(w)
        self._events.push(ev.time + ev.restart_delay, "restart", w.wid,
                          w.generation)

    def _handle_elastic(self, ev: ElasticEvent):
        """A joining worker starts from the current outer state with fresh
        AdamW moments and step count 0; a leaving one loses its round in
        flight. Either way ``rho`` follows the live worker count and DyLU
        its fastest live pace."""
        if ev.action == "join":
            if ev.wid in self.workers:
                raise ValueError(f"worker {ev.wid} joins but is a member")
            mixture = self._mixture_for(ev.wid)
            lang = (int(np.argmax(mixture)) if mixture is not None
                    else ev.lang)
            w = Worker(wid=ev.wid, pace=ev.pace, lang=lang, mixture=mixture,
                       opt=init_adam(self.server.state.params))
            self.workers[ev.wid] = w
            self.server.set_n_workers(len(self._alive()))
            self._dispatch(w)
        elif ev.action == "leave":
            w = self.workers.pop(ev.wid, None)
            if w is not None:
                self._drop_round(w)
            self.server.set_n_workers(len(self._alive()))
        else:
            raise ValueError(f"elastic action {ev.action!r}")
        self._min_pace = self._min_alive_pace()


ENGINES = ("sim",)


def make_engine(run_cfg: RunConfig, engine: str = "sim", *, device="cuda",
                init_params: Optional[Mapping[str, np.ndarray]] = None,
                failures: Optional[List[FailureEvent]] = None,
                elastic: Optional[List[ElasticEvent]] = None):
    """Build a training engine; the port has the virtual-clock simulator."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    from repro_torch.async_engine.simulator import AsyncSimulator
    return AsyncSimulator(run_cfg, device=device, init_params=init_params,
                          failures=failures, elastic=elastic)


def make_eval_fn(engine, batch: int = 16, seq: Optional[int] = None):
    """Per-language + mean validation loss (Fig. 2/3 protocol)."""
    seq = seq or engine.cfg.seq_len
    batches = eval_batches(engine.specs, batch, seq,
                           seed=engine.cfg.seed + 4242)

    def eval_fn(params, step, time):
        per = {b["lang"]: eval_loss(engine.model, params, b) for b in batches}
        mean = float(np.mean(list(per.values())))
        return {"step": step, "time": time, "mean": mean, "per_lang": per}

    return eval_fn
