"""The virtual-clock training engine of the port.

Port of the part of ``repro/async_engine/engine.py`` that a run with one
commit per arrival uses: workers at fixed paces on fixed or flexible
language shards, a virtual-clock event queue, the functional inner round
(``execute_round``), the server-side commit through the packed
``Synchronizer``, the barrier rounds of a synchronous method, and the
per-language eval protocol. Only *time* is simulated; the inner rounds run
for real on the engine's device.

The arrival sequence depends only on paces, H and the schedule, so it
equals the reference's exactly. A ``RunConfig`` axis the port does not run
yet raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.async_engine.server import Synchronizer
from repro_torch.configs.base import RunConfig
from repro_torch.data.synthetic import (
    ShardSampler, eval_batches, make_language_specs,
)
from repro_torch.device import resolve_device
from repro_torch.models.transformer import build_model
from repro_torch.optim.adamw import AdamState, init_adam
from repro_torch.train.inner import eval_loss, pseudo_gradient, run_inner

Params = Dict[str, torch.Tensor]

# RunConfig axes the port's engine does not run yet: (field, default,
# ROADMAP item); compression is the outer config's.
UNPORTED_AXES = (
    ("mixture_alpha", None, "A7, engine axes"),
    ("dylu", False, "A7, engine axes"),
    ("topology", "hub", "A14"),
    ("commit_batch", 1, "A11"),
    ("batch_rampup", None, "A11"),
    ("compression", "none", "A9"),
)


def unported_axes(run_cfg: RunConfig) -> List[str]:
    """The axes of ``run_cfg`` set away from their defaults that the port
    cannot run yet, each with its ROADMAP item."""
    out = []
    for name, default, item in UNPORTED_AXES:
        value = getattr(run_cfg.outer if name == "compression" else run_cfg,
                        name)
        if value != default:
            out.append(f"{name}={value!r} (ROADMAP {item})")
    return out


@dataclass
class Worker:
    wid: int
    pace: float = 1.0                # seconds per inner step (virtual)
    lang: Optional[int] = None       # fixed shard (non-IID)
    opt: Optional[AdamState] = None  # carried across rounds
    inner_step_count: int = 0        # lifetime steps (data stream offset)
    pending_task_id: Optional[int] = None


class EventQueue:
    """Virtual-clock worker-return events ordered by (time, push order), the
    order of the reference's vectorized queue."""

    def __init__(self):
        self._heap: List[Tuple[float, int, int]] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, time: float, wid: int):
        heapq.heappush(self._heap, (float(time), self._seq, int(wid)))
        self._seq += 1

    def pop(self) -> Tuple[float, int]:
        time, _seq, wid = heapq.heappop(self._heap)
        return time, wid


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
    params: Params
    opt: AdamState
    s_i: int
    h_steps: int
    lang: Optional[int]
    inner_step_offset: int


@dataclass
class RoundResult:
    wid: int
    delta: Params
    opt: AdamState
    nbytes: int
    s_i: int
    h_steps: int
    lang: Optional[int]


def execute_round(task: RoundTask, *, model, cfg: RunConfig, specs) -> RoundResult:
    """The functional inner round: H AdamW steps from the task's params on
    the worker's shard, then the uncompressed pseudo-gradient."""
    sampler = ShardSampler(specs, task.lang, cfg.batch_size, cfg.seq_len,
                           seed=cfg.seed * 977 + task.wid)
    result = run_inner(model, cfg.inner, task.params, task.opt, sampler,
                       task.h_steps, step_offset=task.inner_step_offset)
    delta = pseudo_gradient(task.params, result.params)
    nbytes = sum(x.numel() * 4 for x in delta.values())
    return RoundResult(wid=task.wid, delta=delta,
                       opt=result.opt, nbytes=nbytes, s_i=task.s_i,
                       h_steps=task.h_steps, lang=task.lang)


class EngineBase:
    """Shared engine: bookkeeping, dispatch, commit, and the event loop.
    Subclasses say where a captured round goes (``_submit``) and how its
    result comes back (``_obtain``)."""

    def __init__(self, run_cfg: RunConfig, *, device="cuda",
                 init_params: Optional[Mapping[str, np.ndarray]] = None):
        """``init_params``: start from these parameters (numpy arrays keyed
        by path, see ``bridge``) instead of a fresh draw from ``run_cfg.seed``;
        the port's counterpart of the reference's ``restore``, used to start
        both packages from the same bits."""
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
            lang = (wid % len(self.specs)) if run_cfg.non_iid else None
            self.workers[wid] = Worker(wid=wid, pace=pace, lang=lang,
                                       opt=init_adam(params))
        self.lang_tokens = np.zeros(len(self.specs), np.int64)
        self.history = History()
        self.time = 0.0
        self._events = EventQueue()
        self._task_counter = 0

    # -------------------------------------------------------- engine hooks
    def _submit(self, task: RoundTask) -> None:
        raise NotImplementedError

    def _obtain(self, w: Worker) -> RoundResult:
        raise NotImplementedError

    # ------------------------------------------------------------------ utils
    def _h_steps(self, w: Worker) -> int:
        return self.cfg.inner_steps

    def _pick_lang(self, w: Worker) -> Optional[int]:
        if not self.cfg.non_iid:
            return None
        if self.cfg.shard_assignment == "flexible":
            return int(np.argmin(self.lang_tokens))
        return w.lang

    # --------------------------------------------------------------- dispatch
    def _make_task(self, w: Worker) -> RoundTask:
        """Capture the worker's initialization and round snapshot."""
        self._task_counter += 1
        w.pending_task_id = self._task_counter
        return RoundTask(task_id=self._task_counter, wid=w.wid,
                         params=self.server.worker_init(w.wid), opt=w.opt,
                         s_i=self.server.t, h_steps=self._h_steps(w),
                         lang=self._pick_lang(w),
                         inner_step_offset=w.inner_step_count)

    def _dispatch(self, w: Worker):
        """Capture the round, schedule its virtual return, submit it."""
        task = self._make_task(w)
        self._events.push(self.time + task.h_steps * w.pace, w.wid)
        self._submit(task)

    def _execute(self, task: RoundTask) -> RoundResult:
        return execute_round(task, model=self.model, cfg=self.cfg,
                             specs=self.specs)

    # ----------------------------------------------------------------- commit
    def _commit_worker(self, w: Worker, res: RoundResult):
        """Fold a completed round back into the worker and the shared token
        and communication accounting (the order of commits is the history)."""
        w.opt = res.opt
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
        """Virtual-clock event loop: every pop commits one arrival and
        re-dispatches its worker until ``outer_steps`` commits."""
        for w in self.workers.values():
            self._dispatch(w)
        target = self.cfg.outer_steps
        while self.server.t < target and len(self._events):
            self.time, wid = self._events.pop()
            w = self.workers[wid]
            self._commit(w, self._obtain(w))
            self._post_commit(eval_every, eval_fn)
            if self.server.t < target:
                self._dispatch(w)

    def _run_sync(self, eval_every, eval_fn):
        """Barrier rounds: every worker runs one round from the same outer
        state, the slowest gates the clock, and the server takes one step
        on the workers' average pseudo-gradient."""
        while self.server.t < self.cfg.outer_steps:
            workers = list(self.workers.values())
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


ENGINES = ("sim",)


def make_engine(run_cfg: RunConfig, engine: str = "sim", *, device="cuda",
                init_params: Optional[Mapping[str, np.ndarray]] = None):
    """Build a training engine; the port has the virtual-clock simulator."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    from repro_torch.async_engine.simulator import AsyncSimulator
    return AsyncSimulator(run_cfg, device=device, init_params=init_params)


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
