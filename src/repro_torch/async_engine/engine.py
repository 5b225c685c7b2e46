"""The virtual-clock training engine of the port.

Port of the simulated-clock part of ``repro/async_engine/engine.py``:
workers at fixed paces on fixed or flexible language shards or on
Dirichlet language mixtures, DyLU's pace-scaled local steps, the
struct-of-arrays worker store (``WorkerArena``), a vectorised virtual-clock
event queue of worker returns and restarts, crashes with a scheduled
rejoin, elastic joins and leaves, the functional inner round
(``execute_round``) with pseudo-gradient compression and error feedback and
the hogwild batch ramp-up, the server-side commit through the packed
``Synchronizer`` (one arrival at a time, or a same-tick batch through its
commit buffer with ``commit_batch > 1``), or through a ``PeerMixer`` of
per-worker replicas on a ring or gossip topology, the barrier rounds of a
synchronous method, and the per-language eval protocol. Only *time* is
simulated; the inner rounds run for real on the engine's device.

Run control, as the reference's: a ``Budget`` stops a run at a token count
or at a horizon of the virtual clock (the paper's Table 2 protocol), a
checkpoint of the outer state is written every ``ckpt_every`` commits
(``checkpoint/ckpt.py``, the reference's file format), ``restore`` resumes
from one (the rounds in flight are lost, as on a real restart), and
``request_stop`` ends a run at the next commit.

With a ``telemetry.TelemetryRecorder`` the engine streams one "arrival"
record per commit (with the server's update-quality stats), one "flush"
record per commit-buffer flush, one "eval" record per evaluation and, every
``runtime_record_every`` commits, a "runtime" snapshot of worker
membership. The hooks only observe: no RNG, no tensor is touched, and the
server's stats are extra outputs of the kernels it launches anyway. With an
``obs.spans.SpanTracer`` it records the reference's spans: ``worker_round``
and ``compress_roundtrip`` in ``execute_round``, ``server_commit``,
``server_commit_batch``, ``eval`` and ``checkpoint`` on the server side
(on the card each ends when its device work has run; see ``obs.spans``).

The arrival sequence depends only on paces, H, the schedule, the batching
and the failure and membership events, so it equals the reference's
exactly. A ``RunConfig`` axis the port does not run yet raises
``NotImplementedError`` naming its ROADMAP item.

The wall-clock ``runtime.ConcurrentRuntime`` runs this engine with eager
rounds in worker threads; the hooks it overrides are ``_submit``,
``_obtain``, ``_drop_round``, ``_on_worker_removed``, ``_sleep_per_step``,
``_use_virtual_clock`` and ``_execute_sync``.
"""
from __future__ import annotations

import os
import time as _time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.async_engine.server import Synchronizer
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import RunConfig
from repro_torch.core.compression import roundtrip_with_error_feedback
from repro_torch.data.synthetic import (
    ShardSampler, eval_batches, make_language_specs, mixture_weights,
)
from repro_torch.device import resolve_device
from repro_torch.models.transformer import build_model
from repro_torch.obs.spans import NULL_TRACER
from repro_torch.optim.adamw import AdamState, init_adam
from repro_torch.train.inner import eval_loss, pseudo_gradient, run_inner

Params = Dict[str, torch.Tensor]

# RunConfig axes the port's engine does not run yet: (field, default,
# ROADMAP item). Every axis of RunConfig runs, and so does every Scenario
# axis (``scenarios/spec.py:Scenario.unported_axes``).
UNPORTED_AXES: Tuple[Tuple[str, Any, str], ...] = ()


def unported_axes(run_cfg: RunConfig) -> List[str]:
    """The axes of ``run_cfg`` set away from their defaults that the port
    cannot run yet, each with its ROADMAP item."""
    return [f"{name}={getattr(run_cfg, name)!r} (ROADMAP {item})"
            for name, default, item in UNPORTED_AXES
            if getattr(run_cfg, name) != default]


class WorkerArena:
    """Struct-of-arrays store of the per-worker engine state.

    Every scalar field lives in one flat numpy array indexed by slot, so
    the aggregates the engine asks for (the live count behind ``rho``, the
    fastest live pace behind DyLU) are one masked reduction each instead of
    a walk over worker objects. ``Worker`` objects are views of a slot.
    Slots are recycled: a leave releases its slot (dropping the object
    cells, so optimizer state does not outlive the worker) and a later join
    reuses it; a released view must not be read after its slot is taken
    again.
    """

    SCALAR_FIELDS = (
        ("wid", np.int64, -1),
        ("pace", np.float64, 1.0),       # seconds per inner step (virtual)
        ("inner_step_count", np.int64, 0),  # lifetime steps (LR schedule)
        ("generation", np.int64, 0),     # bumped on a crash: stale return
        ("pending_task", np.int64, -1),  # the round in flight (-1: none)
        ("round_seq", np.int64, 0),      # rounds dispatched (lifetime)
    )
    BOOL_FIELDS = (("used", True), ("alive", True))
    OBJECT_FIELDS = ("lang", "mixture", "opt", "ef")

    def __init__(self, capacity: int = 64):
        cap = max(1, int(capacity))
        self.cols: Dict[str, np.ndarray] = {}
        for name, dt, _default in self.SCALAR_FIELDS:
            self.cols[name] = np.zeros(cap, dt)
        for name, _default in self.BOOL_FIELDS:
            self.cols[name] = np.zeros(cap, bool)
        for name in self.OBJECT_FIELDS:
            self.cols[name] = np.empty(cap, object)
        self._free = list(range(cap - 1, -1, -1))

    def _grow(self):
        old = len(self.cols["wid"])
        for name, arr in self.cols.items():
            ext = (np.empty(old, object) if arr.dtype == object
                   else np.zeros(old, arr.dtype))
            self.cols[name] = np.concatenate([arr, ext])
        self._free.extend(range(2 * old - 1, old - 1, -1))

    def alloc(self, wid: int) -> int:
        if not self._free:
            self._grow()
        slot = self._free.pop()
        for name, _dt, default in self.SCALAR_FIELDS:
            self.cols[name][slot] = default
        for name, default in self.BOOL_FIELDS:
            self.cols[name][slot] = default
        for name in self.OBJECT_FIELDS:
            self.cols[name][slot] = None
        self.cols["wid"][slot] = wid
        return slot

    def release(self, slot: int):
        self.cols["used"][slot] = False
        self.cols["alive"][slot] = False
        for name in self.OBJECT_FIELDS:
            self.cols[name][slot] = None
        self._free.append(slot)

    def n_alive(self) -> int:
        return int(np.count_nonzero(self.cols["used"] & self.cols["alive"]))

    def n_in_flight(self) -> int:
        return int(np.count_nonzero(self.cols["used"]
                                    & (self.cols["pending_task"] >= 0)))

    def min_alive_pace(self, default: float = 1.0) -> float:
        mask = self.cols["used"] & self.cols["alive"]
        if not mask.any():
            return default
        return float(self.cols["pace"][mask].min())


def _column(name, cast=None):
    def get(self):
        v = self.arena.cols[name][self.slot]
        return v if cast is None else cast(v)

    def set(self, value):
        self.arena.cols[name][self.slot] = value

    return property(get, set)


class Worker:
    """View of one ``WorkerArena`` slot with the attributes of a worker.
    Made without an arena (standalone use) it gets a one-slot arena of its
    own."""

    __slots__ = ("arena", "slot")

    def __init__(self, wid: int, pace: float = 1.0,
                 lang: Optional[int] = None,
                 mixture: Optional[Tuple[float, ...]] = None,
                 opt: Any = None, ef: Any = None, *,
                 arena: Optional[WorkerArena] = None):
        self.arena = arena if arena is not None else WorkerArena(1)
        self.slot = self.arena.alloc(wid)
        self.pace = pace
        self.lang = lang          # fixed shard, or the mixture's dominant
        self.mixture = mixture    # Dirichlet language mixture
        self.opt = opt            # AdamState carried across rounds
        self.ef = ef              # error feedback of the compression

    wid = property(lambda self: int(self.arena.cols["wid"][self.slot]))
    pace = _column("pace", float)
    inner_step_count = _column("inner_step_count", int)
    generation = _column("generation", int)
    round_seq = _column("round_seq", int)
    alive = _column("alive", bool)
    lang = _column("lang")
    mixture = _column("mixture")
    opt = _column("opt")
    ef = _column("ef")

    @property
    def pending_task_id(self) -> Optional[int]:
        v = int(self.arena.cols["pending_task"][self.slot])
        return None if v < 0 else v

    @pending_task_id.setter
    def pending_task_id(self, value: Optional[int]):
        self.arena.cols["pending_task"][self.slot] = \
            -1 if value is None else int(value)

    @property
    def in_flight(self) -> bool:
        return self.pending_task_id is not None

    def __repr__(self):
        return (f"Worker(wid={self.wid}, pace={self.pace}, "
                f"alive={self.alive}, in_flight={self.in_flight})")


class EventQueue:
    """Vectorised virtual-clock event queue.

    Events are (time, seq, kind, wid, gen) rows in numpy columns sorted by
    (time, seq), the push order breaking ties. Pushes are staged and merged
    at the next pop, and ``pop_batch`` takes a run of same-tick returns as
    one slice. The engine reports each event a crash or leave made stale
    (``note_stale``) and each stale event that reached a pop
    (``note_skip``); ``maybe_compact`` filters the dead ones out in one pass
    once they outnumber the live ones."""

    KIND_RETURN = 0
    KIND_RESTART = 1
    _KINDS = {"return": KIND_RETURN, "restart": KIND_RESTART}
    _NAMES = ("return", "restart")
    _COMPACT_MIN = 64                # not worth it below this many entries

    def __init__(self):
        self._time = np.empty(0, np.float64)
        self._seq = np.empty(0, np.int64)
        self._kind = np.empty(0, np.int8)
        self._wid = np.empty(0, np.int64)
        self._gen = np.empty(0, np.int64)
        self._head = 0               # consumed prefix of the sorted columns
        self._staging: List[Tuple] = []
        self._next_seq = 0
        self.stale = 0               # known-dead entries still queued
        self.stale_skipped = 0       # dead entries that reached a pop
        self.compactions = 0

    def __len__(self) -> int:
        return (len(self._time) - self._head) + len(self._staging)

    def push(self, time: float, kind: str, wid: int, gen: int):
        self._staging.append((float(time), self._next_seq,
                              self._KINDS[kind], int(wid), int(gen)))
        self._next_seq += 1

    def clear(self):
        self.__init__()

    def note_stale(self, n: int = 1):
        self.stale += n

    def note_skip(self):
        self.stale_skipped += 1
        self.stale = max(0, self.stale - 1)

    def _merge(self):
        if not self._staging:
            return
        t, s, k, w, g = (np.asarray(c) for c in zip(*self._staging))
        self._staging = []
        t = np.concatenate([self._time[self._head:], t.astype(np.float64)])
        s = np.concatenate([self._seq[self._head:], s.astype(np.int64)])
        k = np.concatenate([self._kind[self._head:], k.astype(np.int8)])
        w = np.concatenate([self._wid[self._head:], w.astype(np.int64)])
        g = np.concatenate([self._gen[self._head:], g.astype(np.int64)])
        order = np.lexsort((s, t))
        self._time, self._seq = t[order], s[order]
        self._kind, self._wid, self._gen = k[order], w[order], g[order]
        self._head = 0

    def pop_batch(self, max_n: int = 1) -> List[Tuple[float, str, int, int]]:
        """Pop the head event; when it is a "return", also pop up to
        ``max_n - 1`` further same-tick returns in push order. A same-tick
        "restart" ends the batch, so the global event order holds."""
        self._merge()
        if self._head >= len(self._time):
            return []
        i = self._head
        if self._kind[i] != self.KIND_RETURN or max_n <= 1:
            end = i + 1
        else:
            tick_end = int(np.searchsorted(self._time, self._time[i],
                                           side="right"))
            nonret = np.nonzero(self._kind[i:tick_end] != self.KIND_RETURN)[0]
            end = i + int(nonret[0]) if len(nonret) else tick_end
            end = min(end, i + max_n)
        rows = [(float(self._time[j]), self._NAMES[self._kind[j]],
                 int(self._wid[j]), int(self._gen[j]))
                for j in range(i, end)]
        self._head = end
        return rows

    def maybe_compact(self, keep) -> bool:
        """Drop dead entries once they outnumber live ones. ``keep(kind,
        wid, gen) -> bool`` decides."""
        n = len(self)
        if n < self._COMPACT_MIN or 2 * self.stale <= n:
            return False
        self._merge()
        mask = np.fromiter(
            (keep(self._NAMES[self._kind[j]], int(self._wid[j]),
                  int(self._gen[j]))
             for j in range(self._head, len(self._time))),
            bool, count=len(self._time) - self._head)
        for name in ("_time", "_seq", "_kind", "_wid", "_gen"):
            setattr(self, name, getattr(self, name)[self._head:][mask])
        self._head = 0
        self.stale = 0
        self.compactions += 1
        return True


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


#: most recent arrivals kept in History.arrivals
HISTORY_WINDOW = 4096


@dataclass
class History:
    """Run history. ``arrivals`` is a ring of the most recent ``window``
    arrival records, so a run of many arrivals keeps bounded memory;
    ``total_arrivals`` counts every commit."""
    arrivals: List[Dict] = field(default_factory=list)
    evals: List[Dict] = field(default_factory=list)
    tokens: int = 0
    comm_bytes: int = 0
    final_time: float = 0.0
    total_arrivals: int = 0
    window: int = HISTORY_WINDOW

    def append_arrival(self, rec: Dict):
        self.arrivals.append(rec)
        self.total_arrivals += 1
        if len(self.arrivals) > self.window:
            del self.arrivals[:len(self.arrivals) - self.window]

    def summary(self) -> Dict:
        return {
            "outer_steps": self.total_arrivals,
            "tokens": self.tokens,
            "comm_bytes": self.comm_bytes,
            "final_time": self.final_time,
            "final_eval": self.evals[-1] if self.evals else None,
        }


@dataclass(frozen=True)
class Budget:
    """Stopping rule of a budgeted comparison (paper Table 2): train to a
    fixed token count or a fixed horizon of the virtual clock instead of a
    fixed number of outer steps, within one outer round of the target:

      fixed_tokens     stop at the first commit whose cumulative token
                       count reaches ``amount``;
      fixed_wallclock  never commit an arrival past ``amount`` seconds of
                       engine time; the run stops at the last arrival
                       inside the horizon.

    The configured ``outer_steps`` stays a hard cap on top."""
    kind: str                        # "fixed_tokens" | "fixed_wallclock"
    amount: float

    KINDS = ("fixed_tokens", "fixed_wallclock")

    def __post_init__(self):
        assert self.kind in self.KINDS, self.kind
        assert self.amount > 0, self.amount

    def over_time(self, t: float) -> bool:
        return self.kind == "fixed_wallclock" and t > self.amount + 1e-9

    def over_tokens(self, tokens: int) -> bool:
        return self.kind == "fixed_tokens" and tokens >= self.amount


@dataclass
class RoundTask:
    """Snapshot of one dispatched inner round; ``execute_round`` reads only
    this, never the live ``Worker``, so a crash injected while it runs in
    another thread cannot race it (the stale result is dropped)."""
    task_id: int                     # engine-unique, even across a rejoin
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
    batch_size: int = 0              # per-round mini-batch (0: the config's;
    # nonzero under the hogwild ramp-up, RunConfig.batch_rampup)
    round_seq: int = 0               # the worker's round count
    sleep_per_step: float = 0.0      # free-running pace throttle (wall s)
    device: Any = None               # where the round runs (None: anywhere)


@dataclass
class RoundResult:
    task_id: int
    wid: int
    generation: int
    delta: Any                       # Params, or packing.Packed under int8
    opt: AdamState
    ef: Any
    nbytes: int
    s_i: int
    h_steps: int
    lang: Optional[int]
    batch_size: int = 0              # the round's mini-batch (0: the config's)
    round_seq: int = 0
    compute_seconds: float = 0.0     # host seconds of the round


def execute_round(task: RoundTask, *, model, cfg: RunConfig, specs,
                  layout=None, tracer=None) -> RoundResult:
    """The functional inner round: H AdamW steps from the task's params on
    the worker's shard or mixture, then the pseudo-gradient, compressed
    with error feedback when the run asks for it (int8 through the packed
    ``layout``, the server's, when one is given). ``tracer``: spans
    ``worker_round`` (the steps and the pseudo-gradient) and
    ``compress_roundtrip``."""
    tracer = tracer if tracer is not None else NULL_TRACER
    t0 = _time.perf_counter()
    with tracer.span("worker_round", cat="compute", wid=task.wid,
                     s_i=task.s_i, h=task.h_steps):
        sampler = ShardSampler(specs, task.lang,
                               task.batch_size or cfg.batch_size,
                               cfg.seq_len, seed=cfg.seed * 977 + task.wid,
                               mixture=task.mixture)
        result = run_inner(model, cfg.inner, task.params, task.opt, sampler,
                           task.h_steps, step_offset=task.inner_step_offset)
        delta = pseudo_gradient(task.params, result.params)
    with tracer.span("compress_roundtrip", cat="compute", wid=task.wid):
        delta, ef, nbytes = roundtrip_with_error_feedback(
            delta, task.ef, cfg.outer.compression, cfg.outer.topk_ratio,
            layout=layout)
    if not cfg.outer.error_feedback:
        ef = None
    return RoundResult(task_id=task.task_id, wid=task.wid,
                       generation=task.generation, delta=delta,
                       opt=result.opt, ef=ef, nbytes=nbytes, s_i=task.s_i,
                       h_steps=task.h_steps, lang=task.lang,
                       batch_size=task.batch_size, round_seq=task.round_seq,
                       compute_seconds=_time.perf_counter() - t0)


class EngineBase:
    """Shared engine: bookkeeping, dispatch, commit, and the event loop.
    Subclasses say where a captured round goes (``_submit``) and how its
    result comes back (``_obtain``)."""

    ENGINE_NAME = "sim"              # telemetry RunMeta.engine vocabulary

    def __init__(self, run_cfg: RunConfig, *, device="cuda",
                 init_params: Optional[Mapping[str, np.ndarray]] = None,
                 failures: Optional[List[FailureEvent]] = None,
                 elastic: Optional[List[ElasticEvent]] = None,
                 telemetry=None, tracer=None, runtime_record_every: int = 0):
        """``init_params``: start from these parameters (numpy arrays keyed
        by path, see ``bridge``) instead of a fresh draw from ``run_cfg.seed``;
        the port's counterpart of the reference's ``restore``, used to start
        both packages from the same bits. ``failures``/``elastic``: crash and
        membership events, applied in time order. ``telemetry``: a
        ``telemetry.TelemetryRecorder`` (or None) the run streams its
        records into; ``tracer``: an ``obs.spans.SpanTracer`` (None: the
        shared no-op) timing rounds, commits, evals and checkpoints;
        ``runtime_record_every``: a "runtime" record every N commits (0:
        none)."""
        missing = unported_axes(run_cfg)
        if missing:
            raise NotImplementedError(
                "the port's engine does not run " + "; ".join(missing))
        if run_cfg.model.frontend.kind != "none":
            # as the reference's: its sampler yields tokens, no frame
            # features or patch embeddings
            raise ValueError(f"{run_cfg.model.name}: the engine trains "
                             "token models; the sampler yields no "
                             f"{run_cfg.model.frontend.kind} inputs")
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
        self.telemetry = telemetry
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.runtime_record_every = int(runtime_record_every or 0)
        if run_cfg.topology != "hub":
            # NoLoCo-style exchange: per-worker replicas and pairwise peer
            # averaging instead of a hub server
            from repro_torch.async_engine.topology import PeerMixer
            self.server = PeerMixer(params, run_cfg.outer, run_cfg.n_workers,
                                    kind=run_cfg.topology, seed=run_cfg.seed)
        else:
            self.server = Synchronizer(params, run_cfg.outer,
                                       run_cfg.n_workers,
                                       telemetry=telemetry is not None,
                                       commit_batch=run_cfg.commit_batch)
        self.arena = WorkerArena(capacity=max(run_cfg.n_workers, 4))
        self.workers: Dict[int, Worker] = {}
        for wid in range(run_cfg.n_workers):
            pace = run_cfg.worker_paces[wid % len(run_cfg.worker_paces)]
            mixture = self._mixture_for(wid)
            if mixture is not None:
                lang = int(np.argmax(mixture))   # dominant shard (accounting)
            else:
                lang = (wid % len(self.specs)) if run_cfg.non_iid else None
            self.workers[wid] = Worker(wid=wid, pace=pace, lang=lang,
                                       mixture=mixture, opt=init_adam(params),
                                       arena=self.arena)
        self.failures = sorted(failures or [], key=lambda f: f.time)
        self.elastic = sorted(elastic or [], key=lambda e: e.time)
        self.lang_tokens = np.zeros(len(self.specs), np.int64)
        self.history = History()
        self.time = 0.0
        self._events = EventQueue()
        self._task_counter = 0
        # DyLU's reference pace: set here and on membership changes only,
        # never on a crash or a restart (as the reference does)
        self._min_pace = self.arena.min_alive_pace()
        self._stop = False               # set by request_stop
        self.restored_arrivals = 0       # commits counted by a restored ckpt

    def request_stop(self) -> None:
        """End the run at the next commit boundary. The server state stays
        consistent: a checkpoint taken after ``run`` returns is a valid
        resume point."""
        self._stop = True

    # -------------------------------------------------------- engine hooks
    def _submit(self, task: RoundTask) -> None:
        raise NotImplementedError

    def _obtain(self, w: Worker) -> RoundResult:
        raise NotImplementedError

    def _drop_round(self, w: Worker) -> None:
        """The worker's round in flight is lost (crash or leave)."""

    def _on_worker_removed(self, w: Worker) -> None:
        """An elastic leave (the runtime stops the worker's thread)."""

    def _sleep_per_step(self, w: Worker) -> float:
        """Wall-clock pace throttle (free-running runtime only)."""
        return 0.0

    def _use_virtual_clock(self) -> bool:
        """Whether dispatches schedule virtual return events (not in the
        free-running runtime, where arrival order is real)."""
        return True

    def _execute_sync(self, tasks: List[RoundTask]) -> List[RoundResult]:
        """A barrier round's inner rounds (the runtime runs them in
        parallel threads)."""
        return [self._execute(t) for t in tasks]

    # ------------------------------------------------------------------ utils
    def _event_is_live(self, kind: str, wid: int, gen: int) -> bool:
        """Compaction predicate: a restart always stays; a return stays
        while it is the live worker's round in flight."""
        if kind == "restart":
            return True
        w = self.workers.get(wid)
        return w is not None and w.alive and w.generation == gen

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
        w.round_seq += 1
        return RoundTask(task_id=self._task_counter, wid=w.wid,
                         generation=w.generation,
                         params=self.server.worker_init(w.wid), opt=w.opt,
                         ef=w.ef, s_i=self.server.t, h_steps=self._h_steps(w),
                         lang=self._pick_lang(w), mixture=w.mixture,
                         inner_step_offset=w.inner_step_count,
                         batch_size=self._round_batch(),
                         round_seq=w.round_seq,
                         sleep_per_step=self._sleep_per_step(w),
                         device=self.device)

    def _round_batch(self) -> int:
        """The round's mini-batch under the hogwild ramp-up
        (``RunConfig.batch_rampup``): linear from ``batch_size`` at t = 0 to
        the target at the last outer step, rounded half to even as Python's
        ``round``; 0 (the config's batch) without it."""
        target = self.cfg.batch_rampup
        if not target:
            return 0
        frac = min(1.0, self.server.t / max(self.cfg.outer_steps - 1, 1))
        return max(1, int(round(self.cfg.batch_size
                                + frac * (target - self.cfg.batch_size))))

    def _dispatch(self, w: Worker):
        """Capture the round, schedule its virtual return, submit it."""
        task = self._make_task(w)
        if self._use_virtual_clock():
            self._events.push(self.time + task.h_steps * w.pace, "return",
                              w.wid, w.generation)
        self._submit(task)

    def _execute(self, task: RoundTask) -> RoundResult:
        layout = (self.server.layout
                  if self.cfg.outer.compression == "int8" else None)
        return execute_round(task, model=self.model, cfg=self.cfg,
                             specs=self.specs, layout=layout,
                             tracer=self.tracer)

    # ----------------------------------------------------------------- commit
    def _commit_worker(self, w: Worker, res: RoundResult):
        """Fold a completed round back into the worker and the shared token
        and communication accounting (the order of commits is the history)."""
        w.opt = res.opt
        w.ef = res.ef
        w.inner_step_count += res.h_steps
        w.pending_task_id = None
        toks = (res.h_steps * (res.batch_size or self.cfg.batch_size)
                * self.cfg.seq_len)
        self.history.tokens += toks
        if res.lang is not None:
            self.lang_tokens[res.lang] += toks
        self.history.comm_bytes += res.nbytes

    def _lang_name(self, res: RoundResult) -> str:
        return self.specs[res.lang].lang if res.lang is not None else "iid"

    def _commit(self, w: Worker, res: RoundResult):
        self._commit_worker(w, res)
        with self.tracer.span("server_commit", cat="server", wid=res.wid,
                              s_i=res.s_i):
            rec = self.server.on_arrival(res.delta, res.s_i, res.wid,
                                         sim_time=self.time,
                                         lang=self._lang_name(res))
        self.history.append_arrival(dict(rec.__dict__))
        if self.telemetry is not None:
            self.telemetry.record_arrival(rec, mixture=w.mixture,
                                          tokens_total=self.history.tokens)
        return rec

    def _commit_batch(self, pairs: List[Tuple[Worker, RoundResult]],
                      reason: str = "batch-full"):
        """Commit a batch of same-tick arrivals through the server's commit
        buffer: one fused multi-apply for each run of applied arrivals
        instead of one outer step each. ``reason`` labels the last flush
        (why the batch was capped: batch-full, eval or close)."""
        recs = []
        with self.tracer.span("server_commit_batch", cat="server",
                              k=len(pairs)):
            for w, res in pairs:
                self._commit_worker(w, res)
                out = self.server.buffer_arrival(res.delta, res.s_i, res.wid,
                                                 sim_time=self.time,
                                                 lang=self._lang_name(res))
                if out:
                    recs.extend(out)
            recs.extend(self.server.flush(reason))
        for (w, _res), rec in zip(pairs, recs):
            self.history.append_arrival(dict(rec.__dict__))
            if self.telemetry is not None:
                self.telemetry.record_arrival(
                    rec, mixture=w.mixture, tokens_total=self.history.tokens)
        self._drain_flush_log()
        return recs

    def _drain_flush_log(self):
        """Turn the server's flush events into "flush" telemetry records and
        clear them (a ``PeerMixer`` keeps no such log)."""
        log = getattr(self.server, "flush_log", None)
        if not log:
            return
        if self.telemetry is not None:
            for ev in log:
                self.telemetry.record_flush(outer_step=self.server.t,
                                            sim_time=self.time, **ev)
        log.clear()

    def _eval(self, eval_fn):
        with self.tracer.span("eval", cat="eval", step=self.server.t):
            ev = eval_fn(self.server.state.params, self.server.t, self.time)
        self.history.evals.append(ev)
        if self.telemetry is not None:
            self.telemetry.record_eval(ev)

    # ----------------------------------------------- runtime health records
    def _runtime_snapshot(self) -> Dict:
        """Worker-membership health view (pure observation)."""
        return {"workers_alive": self.arena.n_alive(),
                "workers_total": len(self.workers),
                "in_flight": self.arena.n_in_flight()}

    def _record_runtime(self):
        if self.telemetry is None:
            return
        self.telemetry.record_runtime(outer_step=self.server.t,
                                      sim_time=self.time,
                                      **self._runtime_snapshot())

    def _ensure_telemetry_meta(self):
        if self.telemetry is not None:
            self.telemetry.ensure_meta(
                method=self.server.method.name, engine=self.ENGINE_NAME,
                n_workers=self.cfg.n_workers,
                outer_steps=self.cfg.outer_steps, seed=self.cfg.seed,
                non_iid=self.cfg.non_iid,
                mixture_alpha=self.cfg.mixture_alpha)

    # -------------------------------------------------------------- main loop
    def run(self, eval_every: int = 0,
            eval_fn: Optional[Callable[[Params, int, float], Dict]] = None,
            ckpt_every: int = 0, ckpt_dir: str = "",
            budget: Optional[Budget] = None) -> History:
        """Run to ``outer_steps`` commits: barrier rounds for a synchronous
        method, else the asynchronous event loop. ``ckpt_every``: write
        ``ckpt_dir/step_<t>.npz`` every that many commits; ``budget``: stop
        earlier at a token count or a clock horizon; ``request_stop``: stop
        at the next commit."""
        self._ensure_telemetry_meta()
        if self.server.method.sync:
            self._run_sync(eval_every, eval_fn, ckpt_every, ckpt_dir, budget)
        else:
            self._run_async(eval_every, eval_fn, ckpt_every, ckpt_dir, budget)
        return self._finalize(eval_fn)

    def _post_commit(self, eval_every, eval_fn, ckpt_every, ckpt_dir):
        t = self.server.t
        if eval_every and eval_fn and t % eval_every == 0:
            self._eval(eval_fn)
        if ckpt_every and ckpt_dir and t % ckpt_every == 0:
            with self.tracer.span("checkpoint", cat="ckpt", step=t):
                self.checkpoint(ckpt_dir)
        if (self.telemetry is not None and self.runtime_record_every
                and self.history.total_arrivals
                % self.runtime_record_every == 0):
            self._record_runtime()

    def _finalize(self, eval_fn) -> History:
        self.history.final_time = self.time
        if eval_fn and (not self.history.evals
                        or self.history.evals[-1]["step"] != self.server.t):
            self._eval(eval_fn)
        if self.telemetry is not None and self.runtime_record_every:
            self._record_runtime()           # end-of-run snapshot
        return self.history

    def _run_async(self, eval_every, eval_fn, ckpt_every, ckpt_dir, budget):
        """Virtual-clock event loop until ``outer_steps`` commits, the
        budget or a stop request.

        Each step pops the next event; with ``commit_batch > 1`` a return
        takes up to that many same-tick returns with it (a same-tick
        restart ends the batch), capped so that an eval or checkpoint
        boundary or the last step lands exactly at a batch's end; the
        tightest cap names the flush's reason. An event past a clock
        budget's horizon ends the run uncommitted. Before the batch takes
        effect, the failure and membership events due by its time are
        applied (still at the previous event's clock, so a joining worker's
        first return is scheduled from there). A restart revives a crashed worker and
        dispatches it; the return of a lost round is skipped. The ready
        returns commit, one on its own and several through the server's
        commit buffer, and only then is each of their workers dispatched
        again, so every one of them starts from the state after the whole
        batch. A token budget ends the run after the commit that reaches
        it. ``commit_batch = 1`` is the sequential path. Workers that are
        in flight already (dispatched by ``restore``) are not dispatched
        again."""
        for w in self.workers.values():
            if w.alive and not w.in_flight:
                self._dispatch(w)
        fail_idx = el_idx = 0
        target = self.cfg.outer_steps
        commit_batch = max(1, int(self.cfg.commit_batch))
        while self.server.t < target and len(self._events) and not self._stop:
            # min takes the first of equal caps: a batch that ends on an
            # eval or checkpoint boundary still reads "batch-full"
            limits = [(commit_batch, "batch-full"),
                      (target - self.server.t, "close")]
            if eval_every:
                limits.append((eval_every - self.server.t % eval_every,
                               "eval"))
            if ckpt_every:
                limits.append((ckpt_every - self.server.t % ckpt_every,
                               "ckpt"))
            cap, flush_reason = min(limits, key=lambda kv: kv[0])
            events = self._events.pop_batch(cap)
            time = events[0][0]
            if budget is not None and budget.over_time(time):
                break                    # never commit past the horizon
            while (fail_idx < len(self.failures)
                   and self.failures[fail_idx].time <= time):
                self._handle_failure(self.failures[fail_idx])
                fail_idx += 1
            while (el_idx < len(self.elastic)
                   and self.elastic[el_idx].time <= time):
                self._handle_elastic(self.elastic[el_idx])
                el_idx += 1
            self.time = time
            ready: List[Worker] = []
            for _t, kind, wid, gen in events:
                w = self.workers.get(wid)
                if kind == "restart":
                    if w is not None:
                        w.alive = True
                        self._dispatch(w)
                    continue
                if w is None or not w.alive or gen != w.generation:
                    self._events.note_skip()
                    continue             # the lost round's stale return
                ready.append(w)
            if not ready:
                continue
            if len(ready) == 1:
                self._commit(ready[0], self._obtain(ready[0]))
            else:
                self._commit_batch([(w, self._obtain(w)) for w in ready],
                                   reason=flush_reason)
            self._post_commit(eval_every, eval_fn, ckpt_every, ckpt_dir)
            if budget is not None and budget.over_tokens(self.history.tokens):
                break
            for w in ready:
                if self.server.t < target:
                    self._dispatch(w)

    def _run_sync(self, eval_every, eval_fn, ckpt_every, ckpt_dir, budget):
        """Barrier rounds: every worker runs one round from the same outer
        state, the slowest gates the clock, and the server takes one step
        on the workers' average pseudo-gradient. A round that would end
        past a clock budget's horizon is not run."""
        while self.server.t < self.cfg.outer_steps and not self._stop:
            workers = [w for w in self.workers.values() if w.alive]
            round_time = max(self._h_steps(w) * w.pace for w in workers)
            if budget is not None and budget.over_time(self.time + round_time):
                break
            tasks = [self._make_task(w) for w in workers]
            results = self._execute_sync(tasks)
            for w, res in zip(workers, results):
                self._commit_worker(w, res)
            self.time += round_time
            rec = self.server.on_sync_round([r.delta for r in results],
                                            sim_time=self.time)
            self.history.append_arrival(dict(rec.__dict__))
            if self.telemetry is not None:
                self.telemetry.record_arrival(
                    rec, tokens_total=self.history.tokens)
            self._post_commit(eval_every, eval_fn, ckpt_every, ckpt_dir)
            if budget is not None and budget.over_tokens(self.history.tokens):
                break

    # ------------------------------------------------------- fault tolerance
    def _crash_worker(self, w: Worker):
        """The worker's round in flight is lost: its return turns stale
        (generation bump) and its error feedback is cleared."""
        if w.in_flight and self._use_virtual_clock():
            self._events.note_stale()    # its return event is now dead
        self._drop_round(w)
        w.alive = False
        w.generation += 1
        w.ef = None
        w.pending_task_id = None
        self._events.maybe_compact(self._event_is_live)

    def _handle_failure(self, ev: FailureEvent):
        w = self.workers.get(ev.wid)
        if w is None:
            return
        self._crash_worker(w)
        self._events.push(ev.time + ev.restart_delay, "restart", w.wid,
                          w.generation)

    def _handle_elastic(self, ev: ElasticEvent):
        """A joining worker starts from the current outer state with fresh
        AdamW moments and step count 0 in a slot of its own; a leaving one
        loses its round in flight and frees its slot. Either way ``rho``
        follows the arena's live count and DyLU its fastest live pace.

        A join of a wid that is already a member replaces ``workers[wid]``
        and leaves the old slot allocated and alive, as the reference does:
        the old worker counts in ``n_alive`` (and so in ``rho``) from then
        on, though no event reaches it any more. Its parked round can never
        be obtained, so it is dropped at once."""
        if ev.action == "join":
            old = self.workers.get(ev.wid)
            if old is not None:
                self._drop_round(old)
            mixture = self._mixture_for(ev.wid)
            lang = (int(np.argmax(mixture)) if mixture is not None
                    else ev.lang)
            w = Worker(wid=ev.wid, pace=ev.pace, lang=lang, mixture=mixture,
                       opt=init_adam(self.server.state.params),
                       arena=self.arena)
            self.workers[ev.wid] = w
            self.server.set_n_workers(self.arena.n_alive())
            self._dispatch(w)
        elif ev.action == "leave":
            w = self.workers.pop(ev.wid, None)
            if w is not None:
                if w.in_flight and self._use_virtual_clock():
                    self._events.note_stale()
                w.generation += 1
                self._drop_round(w)
                self._on_worker_removed(w)
                self.arena.release(w.slot)
                self._events.maybe_compact(self._event_is_live)
            self.server.set_n_workers(self.arena.n_alive())
        else:
            raise ValueError(f"elastic action {ev.action!r}")
        self._min_pace = self.arena.min_alive_pace(default=1.0)

    # ---------------------------------------------------------- checkpointing
    def server_tree(self) -> Dict:
        """The outer state as the checkpoint's tree: params, momentum, the
        step and, for a buffered method, its accumulator."""
        state = self.server.state
        tree = {"params": state.params, "momentum": state.momentum,
                "step": state.step}
        if state.aux is not None:
            tree["aux"] = state.aux
        return tree

    def checkpoint(self, ckpt_dir: str) -> str:
        path = os.path.join(ckpt_dir, f"step_{self.server.t}.npz")
        meta = {"time": self.time, "tokens": int(self.history.tokens),
                "arrivals": self.history.total_arrivals}
        ckpt.save(path, self.server_tree(), meta)
        return path

    def restore(self, path: str):
        """Resume from a checkpoint: the outer state (through the server's
        state setter, which packs it, or sets every replica of a
        ``PeerMixer``), the clock and the token count. The rounds in flight
        are lost, as on a real restart: the event queue is cleared and
        every live worker is dispatched afresh from the restored state;
        the workers' own optimizer state is kept."""
        state = self.server.state
        tree, meta = ckpt.restore(path, self.server_tree())
        self.server.state = state._replace(
            params=tree["params"], momentum=tree["momentum"],
            step=tree["step"], aux=tree.get("aux", state.aux))
        self.time = float(meta.get("time", 0.0))
        self.history.tokens = int(meta.get("tokens", 0))
        # a resumed run counts restored_arrivals + its own commits
        self.restored_arrivals = int(meta.get("arrivals", 0))
        self._stop = False
        self._events.clear()
        for w in self.workers.values():
            self._drop_round(w)
            w.generation += 1
            w.pending_task_id = None
            if w.alive:
                self._dispatch(w)


ENGINES = ("sim", "wallclock")


def make_engine(run_cfg: RunConfig, engine: Optional[str] = None, *,
                device="cuda",
                init_params: Optional[Mapping[str, np.ndarray]] = None,
                failures: Optional[List[FailureEvent]] = None,
                elastic: Optional[List[ElasticEvent]] = None,
                telemetry=None, tracer=None,
                runtime_record_every: Optional[int] = None, **runtime_kw):
    """Build a training engine: "sim" (the default, the virtual clock) or
    "wallclock" (the threaded ``runtime.ConcurrentRuntime``; the keywords
    ``mode``, ``pace_scale``, ``faults``, ``transport``, ... go to it).

    ``telemetry``: an optional ``telemetry.TelemetryRecorder`` the run
    streams arrival, flush, eval, runtime and fault records into, and
    ``tracer``: an optional ``obs.spans.SpanTracer`` recording round,
    transport, commit, eval and checkpoint spans (both observation, not
    configuration). ``runtime_record_every``: a "runtime" record every N
    commits (None defers to a Scenario's ``telemetry_every``; 0 disables).
    Also takes a ``repro_torch.scenarios`` ``Scenario`` as the first
    argument: its ``materialize()`` then names the run config, the engine,
    the runtime's options and the schedules, and only ``device``,
    ``init_params``, ``telemetry``, ``tracer`` and
    ``runtime_record_every`` may be given beside it."""
    if hasattr(run_cfg, "materialize"):          # a Scenario
        if engine is not None or failures or elastic or runtime_kw:
            raise TypeError("pass the engine choice, schedules and options "
                            "inside the Scenario, not alongside it")
        return run_cfg.build(device=device, init_params=init_params,
                             telemetry=telemetry, tracer=tracer,
                             runtime_record_every=runtime_record_every)
    engine = engine or "sim"
    kw = dict(device=device, init_params=init_params, failures=failures,
              elastic=elastic, telemetry=telemetry, tracer=tracer,
              runtime_record_every=runtime_record_every or 0)
    if engine == "sim":
        if runtime_kw:
            raise TypeError(f"the simulator takes no runtime options: "
                            f"{runtime_kw}")
        from repro_torch.async_engine.simulator import AsyncSimulator
        return AsyncSimulator(run_cfg, **kw)
    if engine == "wallclock":
        from repro_torch.async_engine.runtime import ConcurrentRuntime
        return ConcurrentRuntime(run_cfg, **kw, **runtime_kw)
    raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")


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
