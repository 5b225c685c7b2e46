"""Wall-clock concurrent runtime: real asynchronous workers behind the
shared engine API. Port of ``repro/async_engine/runtime.py``.

Each worker runs in a thread of its own, executes the same functional
inner round as the simulator (``execute_round``) and pushes its
pseudo-gradient through a ``Transport``; the server thread drains arrivals
and applies them through the packed ``Synchronizer`` while the other
workers keep computing. Every thread issues its work on the device's
default stream, so program order alone orders a round after the snapshot
it reads and a commit after the round that made its delta, and a run's
bits do not depend on how the threads interleave. Each worker thread
builds a model object of its own (a model holds only its config, so this
costs nothing). With more than one visible card, worker ``wid`` runs on card
``wid % n`` (its inputs are moved there and its results back).

Two commit orders:

  mode="deterministic" (default)
      The virtual-clock event loop of ``EngineBase`` runs unchanged on the
      server thread; only the compute is eager (handed to the worker thread
      when the round is captured). Arrivals commit in virtual-deadline
      order whichever thread finishes first, so a run reproduces the
      simulator's arrival sequence exactly and its parameters bit for bit.

  mode="free"
      True arrival order: the first pseudo-gradient through the transport
      is applied first. ``pace_scale`` maps the configured virtual paces
      onto wall-clock sleeps (a worker at pace p takes at least
      ``h * p * pace_scale`` wall seconds a round), and failure and
      membership times live on the same scaled clock.

The channel is never trusted. Every message is a framed ``Envelope``
(monotonic per-worker seq, generation, CRC32 of the payload); a worker
resends an unacknowledged frame with exponential backoff and jitter, and
the server's ``DeliveryTracker`` dedups redeliveries, rejects frames whose
checksum fails and quarantines a worker after K consecutive corrupt
frames. ``faults=FaultSpec(...)`` wraps the channel in the deterministic
fault injector; a deterministic-mode run commits the same history under
any eventually-delivering fault pattern. In free mode workers also beat on
a heartbeat side channel, and a liveness monitor routes a silent worker
through the crash and rejoin machinery.

A crash bumps the worker's generation, so its round in flight, which still
lands through the transport, is dropped at the server. A worker's thread
is torn down only on an elastic leave or at shutdown.

``transport="socket"`` runs each worker in a process of its own instead
(``async_engine/proc.py``): the same protocol and commit orders over a
socket rendezvous and length-prefixed frames, the children injecting the
run's faults on their side of the wire. A worker process that dies outside
a graceful stop is respawned, and the round it held is resubmitted from the
same snapshot, so a deterministic run keeps its bits through a kill.

Observability: with a ``tracer`` the worker threads record their rounds'
spans and their ``ReliableSender``'s transport spans in it. Over processes,
with a tracer or a ``telemetry`` recorder, each child runs its own tracer
and wire counters and ships them every few rounds and once at its graceful
stop (a ``("ctrl", "obs", ...)`` frame); ``_on_obs`` merges the spans as a
process row of that child's pid and writes one "transport" record a frame,
and ``assert_child_reports`` fails a run in which a child never reported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue as _queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.async_engine.engine import (
    EngineBase, History, RoundResult, RoundTask, Worker, execute_round,
)
from repro_torch.async_engine.faults import (
    DELIVERY_COUNTERS, DeliveryTracker, FaultSpec, FaultyTransport,
)
from repro_torch.async_engine.proc import (
    WorkerExit, WorkerFatal, WorkerProcessPool, device_result,
)
from repro_torch.async_engine.transport import (
    Ack, AckWaiter, Envelope, InProcTransport, KIND_ERROR, KIND_HEARTBEAT,
    KIND_RESULT, ReliableSender, Transport, TransportClosed,
    TransportTimeout, payload_crc,
)
from repro_torch.configs.base import RunConfig
from repro_torch.core.packing import Packed
from repro_torch.models.transformer import build_model

#: transport backends by name
TRANSPORTS = ("inproc", "socket")
#: seconds the server waits for any arrival before it calls a worker wedged
RESULT_TIMEOUT = 600.0
#: respawns of a worker process for one round before the run fails
MAX_RESPAWNS_PER_ROUND = 3


@dataclass
class RoundError:
    """A worker thread raised; carried to the server and raised there."""
    wid: int
    generation: int
    round_seq: int
    error: str


def _to(x, device):
    """``x`` (tensor, ``Packed``, dict or NamedTuple of them) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, Packed):
        return Packed(x.buf.to(device))
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    return x


class ConcurrentRuntime(EngineBase):
    ENGINE_NAME = "wallclock"

    #: ack wait on a fault-free channel before a (harmless) resend
    _RELIABLE_ACK_TIMEOUT = 5.0

    def __init__(self, run_cfg: RunConfig, *, device="cuda",
                 init_params=None, failures=None, elastic=None,
                 transport: Optional[Any] = None,
                 mode: str = "deterministic",
                 pace_scale: float = 0.0,
                 faults: Optional[FaultSpec] = None,
                 telemetry=None, tracer=None, runtime_record_every: int = 0):
        if mode not in ("deterministic", "free"):
            raise ValueError(f"mode must be 'deterministic' or 'free': {mode}")
        if faults is not None and faults.partitions and mode != "free":
            raise ValueError(
                "partition windows are defined on the free-running virtual "
                "clock; deterministic mode has no wall-to-virtual coupling "
                "to evaluate them against (use mode='free')")
        kind = "inproc"
        if isinstance(transport, str):
            if transport not in TRANSPORTS:
                raise ValueError(f"transport must be one of {TRANSPORTS} "
                                 f"or a Transport instance: {transport!r}")
            kind, transport = transport, None
        super().__init__(run_cfg, device=device, init_params=init_params,
                         failures=failures, elastic=elastic,
                         telemetry=telemetry, tracer=tracer,
                         runtime_record_every=runtime_record_every)
        self.mode = mode
        self._run_t0: Optional[float] = None
        self.pace_scale = pace_scale
        self.faults = faults
        # backpressure: two frames a worker in flight
        self._capacity = max(2 * len(self.workers), 4)
        self.transport_kind = kind
        self._pool: Optional[WorkerProcessPool] = None
        # wid -> (incarnation, task) of the last round handed to a process
        self._last_task: Dict[int, tuple] = {}
        self._respawns: Dict[int, int] = {}             # task_id -> count
        self._proc_counters = {"proc_exits": 0, "proc_restarts": 0}
        self._child_launches: Dict[str, int] = {}
        self._own_transport = transport is None
        self._free_t0: Optional[float] = None
        self._channel_counters: Dict[str, Dict[str, int]] = {}
        # the children's obs frames arrive on the pool's reader threads, so
        # merging them into the tracer and the recorder takes _obs_lock;
        # _child_wire keeps the latest cumulative counters per (wid, pid)
        self._obs_lock = threading.Lock()
        self._child_wire: Dict[tuple, Dict[str, Any]] = {}
        if kind == "socket":
            # the heartbeat sink first: the pool routes child beacons to it
            self._hb_channel: Transport = self._heartbeat_channel()
            self.transport: Transport = self._data_channel()
        else:
            if transport is not None and faults is not None:
                transport = self._wrap(transport, stream=0)
            self.transport = transport or self._data_channel()
            self._hb_channel = self._heartbeat_channel()
        self._sender = self._make_sender()
        self._hb_enabled = (faults is not None and faults.liveness_enabled
                            and mode == "free")
        self._delivery = DeliveryTracker(
            quarantine_after=(faults.quarantine_after if faults else 8))
        self._dlock = threading.Lock()
        self._fault_accum: Dict[str, int] = {}
        self._inboxes: Dict[int, "_queue.Queue"] = {}
        self._ack_waiters: Dict[int, AckWaiter] = {}
        self._threads: Dict[int, threading.Thread] = {}
        self._hb_threads: Dict[int, threading.Thread] = {}
        self._hb_stops: Dict[int, threading.Event] = {}
        self._last_beat: Dict[int, float] = {}
        self._miss_counted: Dict[int, int] = {}
        self._liveness_dead: set = set()
        self._quarantine_acted: set = set()
        self._results: Dict[int, RoundResult] = {}      # task_id -> result
        self._computing = 0
        self._comp_lock = threading.Lock()
        self._local = threading.local()                 # a model per thread
        self._shut = False
        self.stats: Dict[str, Any] = {
            "mode": mode, "arrivals": 0, "rounds": 0,
            "server_busy_seconds": 0.0, "wall_seconds": 0.0,
            "queue_depth_samples": [], "overlap_samples": [],
            "compute_seconds_total": 0.0,
        }
        # one card per worker, round robin, when there are several (worker
        # processes resolve the engine's device themselves)
        self._pin: List[torch.device] = []
        if (self.device.type == "cuda" and torch.cuda.device_count() > 1
                and kind != "socket"):
            self._pin = [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]

    # ------------------------------------------------------------- channels
    def _virtual_now(self) -> float:
        """The free-running virtual clock (partition windows live on it)."""
        if self._free_t0 is None:
            return 0.0
        scale = self.pace_scale if self.pace_scale > 0 else 1.0
        return (time.monotonic() - self._free_t0) / scale

    def _wrap(self, inner: Transport, stream: int) -> Transport:
        return FaultyTransport(inner, self.faults, stream=stream,
                               clock=self._virtual_now)

    def _data_channel(self) -> Transport:
        if self.transport_kind == "socket":
            # the pool's transport stays unwrapped: the worker processes
            # inject faults on their side of the wire (same streams, same
            # dice), so wrapping it too would inject twice
            self._pool = WorkerProcessPool(
                self.cfg, device=self.device, capacity=self._capacity,
                faults=self.faults, mode=self.mode,
                pace_scale=self.pace_scale, hb_sink=self._hb_channel,
                obs=self.tracer.enabled or self.telemetry is not None)
            self._pool.on_obs = self._on_obs
            return self._pool.transport
        inner = InProcTransport(self._capacity)
        return self._wrap(inner, stream=0) if self.faults else inner

    def _heartbeat_channel(self) -> Transport:
        # a side channel: beacons never queue behind pseudo-gradient
        # backpressure, and partitions silence them like any other frame
        inner = InProcTransport(max(64 * max(len(self.workers), 1), 256))
        if self.transport_kind == "socket":
            return inner                 # children wrap their own beacons
        return self._wrap(inner, stream=1) if self.faults else inner

    def _make_sender(self) -> ReliableSender:
        return ReliableSender(
            self.transport, spec=self.faults, tracer=self.tracer,
            default_timeout=self._RELIABLE_ACK_TIMEOUT,
            on_retry=lambda env, attempt: self._bump("retries"))

    # ------------------------------------------------------- worker threads
    def _start_worker_thread(self, wid: int):
        inbox: "_queue.Queue[Optional[RoundTask]]" = _queue.Queue()
        waiter = AckWaiter()
        self._inboxes[wid] = inbox
        self._ack_waiters[wid] = waiter
        self._delivery.reset_stream(wid)     # a fresh thread, a fresh stream
        self._last_beat[wid] = time.monotonic()
        self._miss_counted[wid] = 0
        t = threading.Thread(target=self._worker_loop,
                             args=(wid, inbox, waiter),
                             name=f"heloco-worker-{wid}", daemon=True)
        self._threads[wid] = t
        t.start()
        if self._hb_enabled:
            stop = threading.Event()
            self._hb_stops[wid] = stop
            ht = threading.Thread(target=self._heartbeat_loop,
                                  args=(wid, stop),
                                  name=f"heloco-hb-{wid}", daemon=True)
            self._hb_threads[wid] = ht
            ht.start()

    def _worker_loop(self, wid: int, inbox, waiter: AckWaiter):
        seq = 0                          # per-stream monotonic frame counter
        while True:
            task = inbox.get()
            if task is None:
                return
            t0 = time.monotonic()
            with self._comp_lock:
                self._computing += 1
            try:
                on_card = (task.device is not None
                           and torch.device(task.device).type == "cuda")
                with (torch.cuda.device(task.device) if on_card
                      else contextlib.nullcontext()):
                    out: Any = self._execute(task)
            except Exception as e:                      # noqa: BLE001
                out = RoundError(task.wid, task.generation, task.round_seq,
                                 repr(e))
            finally:
                # the throttle below is emulated device time, not compute:
                # it stays out of the overlap evidence
                with self._comp_lock:
                    self._computing -= 1
                    self.stats["rounds"] += 1
            # pace throttle: a device at `pace` s/step takes at least
            # h * pace * pace_scale wall seconds a round
            if task.sleep_per_step > 0 and not isinstance(out, RoundError):
                rest = (task.h_steps * task.sleep_per_step
                        - (time.monotonic() - t0))
                if rest > 0:
                    time.sleep(rest)
            seq += 1
            if isinstance(out, RoundError):
                env = Envelope(wid=wid, generation=task.generation, seq=seq,
                               kind=KIND_ERROR, payload=out)
            else:
                env = Envelope(wid=wid, generation=task.generation, seq=seq,
                               kind=KIND_RESULT, payload=out,
                               crc=payload_crc(out))
            if not self._sender.send(env, waiter):
                return                              # channel torn down

    def _heartbeat_loop(self, wid: int, stop: threading.Event):
        """Liveness side channel: one beacon an interval until the worker
        is torn down. Beacons ride the same fault injector as data frames,
        so a partition silences them, which is how the server detects
        it."""
        interval = self.faults.heartbeat_interval
        seq = 0
        while not stop.wait(interval):
            seq += 1
            w = self.workers.get(wid)
            gen = w.generation if w is not None else 0
            try:
                self._hb_channel.send(
                    Envelope(wid=wid, generation=gen, seq=seq,
                             kind=KIND_HEARTBEAT, payload=None,
                             sent_time=time.monotonic()),
                    timeout=0.01)
            except TransportTimeout:
                continue                         # channel full: drop beacon
            except TransportClosed:
                return

    # --------------------------------------------------------- engine hooks
    def _use_virtual_clock(self) -> bool:
        return self.mode == "deterministic"

    def _sleep_per_step(self, w: Worker) -> float:
        return w.pace * self.pace_scale if self.mode == "free" else 0.0

    def _make_task(self, w: Worker) -> RoundTask:
        task = super()._make_task(w)
        if self._pin:
            task.device = self._pin[w.wid % len(self._pin)]
        return task

    def _thread_model(self):
        model = getattr(self._local, "model", None)
        if model is None:
            model = self._local.model = build_model(self.cfg.model)
        return model

    def _execute(self, task: RoundTask) -> RoundResult:
        """The round on the calling thread's own model object, on the
        task's card (inputs moved there and results back when it is not
        the engine's)."""
        dev = task.device
        moved = dev is not None and torch.device(dev) != self.device
        if moved:
            task = dataclasses.replace(
                task, params=_to(task.params, dev), opt=_to(task.opt, dev),
                ef=_to(task.ef, dev))
        layout = (self.server.layout
                  if self.cfg.outer.compression == "int8" else None)
        res = execute_round(task, model=self._thread_model(), cfg=self.cfg,
                            specs=self.specs, layout=layout,
                            tracer=self.tracer)
        if moved:
            res = dataclasses.replace(
                res, delta=_to(res.delta, self.device),
                opt=_to(res.opt, self.device), ef=_to(res.ef, self.device))
        return res

    def _submit(self, task: RoundTask):
        self._ensure_open()
        if self._pool is not None:
            inc = self._pool.ensure(task.wid)
            if inc is not None:
                self._fresh_process(task.wid)
            self._pool.clock = (self._free_t0, self.pace_scale)
            self._last_task[task.wid] = (self._pool.incarnation(task.wid),
                                         task)
            self._pool.submit(task.wid, task)
            return
        th = self._threads.get(task.wid)
        if th is None or not th.is_alive():
            self._start_worker_thread(task.wid)
        self._inboxes[task.wid].put(task)

    def _fresh_process(self, wid: int):
        """A (re)started worker process begins a fresh delivery stream and
        a fresh beat."""
        self._delivery.reset_stream(wid)
        self._last_beat[wid] = time.monotonic()
        self._miss_counted[wid] = 0

    def _start_processes(self):
        """Start the live workers' processes together (each takes seconds
        to import torch) before the first dispatch waits on them."""
        if self._pool is None:
            return
        wids = [w.wid for w in self.workers.values() if w.alive]
        for wid in self._pool.ensure_many(wids):
            self._fresh_process(wid)

    def _recv_result(self, timeout: Optional[float] = None) -> RoundResult:
        """One accepted result. Duplicate, corrupt and quarantined frames
        are consumed (and acked or rejected by the delivery protocol)
        without being returned. With an explicit ``timeout`` the
        ``TransportTimeout`` propagates (a polling caller keeps its event
        clock ticking); without one it is a hard liveness failure."""
        budget = RESULT_TIMEOUT if timeout is None else timeout
        deadline = time.monotonic() + budget
        while True:
            rest = deadline - time.monotonic()
            try:
                if rest <= 0:
                    raise TransportTimeout(f"recv idle > {budget}s")
                msg = self.transport.recv(timeout=rest)
            except TransportTimeout:
                if timeout is not None:
                    raise
                pool = self._pool
                raise RuntimeError(
                    f"no arrival within {RESULT_TIMEOUT}s: a worker "
                    f"thread or process is dead, wedged or quarantined "
                    f"(threads alive: "
                    f"{[w for w, t in self._threads.items() if t.is_alive()]}"
                    f", processes alive: "
                    f"{[w for w in self.workers if pool and pool.alive(w)]}"
                    f", quarantined: {sorted(self._delivery.quarantined)})")
            if isinstance(msg, WorkerFatal):
                raise RuntimeError(f"worker {msg.wid}'s process could not "
                                   f"start: {msg.error}")
            if isinstance(msg, WorkerExit):
                self._handle_worker_exit(msg)
                continue
            if isinstance(msg, Envelope):
                payload = self._process_envelope(msg)
                if payload is None:
                    continue                     # dup / reject / heartbeat
                msg = payload
            self.stats["queue_depth_samples"].append(self.transport.depth())
            if isinstance(msg, RoundError):
                raise RuntimeError(f"worker {msg.wid} round {msg.round_seq} "
                                   f"failed: {msg.error}")
            if self._pool is not None:
                # checked on its host bytes; committed from the device
                msg = device_result(msg, self.device)
            self.stats["compute_seconds_total"] += msg.compute_seconds
            return msg

    # -------------------------------------------------- process supervision
    def _handle_worker_exit(self, ev: WorkerExit):
        """A worker process died outside a graceful stop. If the round the
        engine waits on went to exactly that incarnation, respawn the
        process and resubmit the same task snapshot (same task id), a
        deterministic recompute of the round; anything else (a stale
        incarnation, a crashed or departed worker) the generation machinery
        covers. A round whose process dies ``MAX_RESPAWNS_PER_ROUND`` times
        fails the run."""
        self._proc_counters["proc_exits"] += 1
        if self._pool is None or self._shut:
            return
        entry = self._last_task.get(ev.wid)
        w = self.workers.get(ev.wid)
        if (entry is not None and w is not None and w.alive
                and entry[0] == ev.incarnation
                and w.pending_task_id is not None
                and entry[1].task_id == w.pending_task_id):
            tid = entry[1].task_id
            self._respawns[tid] = self._respawns.get(tid, 0) + 1
            if self._respawns[tid] > MAX_RESPAWNS_PER_ROUND:
                raise RuntimeError(
                    f"worker {ev.wid}'s process died "
                    f"{self._respawns[tid]} times on one round")
            self._proc_counters["proc_restarts"] += 1
            self._telemetry_fault("proc_restart", wid=ev.wid)
            self._submit(entry[1])

    # --------------------------------------------------- delivery protocol
    def _process_envelope(self, env: Envelope) -> Optional[Any]:
        """The idempotent-commit gate: CRC verification, (wid, generation,
        seq) dedup, quarantine policy, ack routing. Returns the payload
        only for a first, checksum-clean delivery."""
        if env.kind == KIND_HEARTBEAT:
            self._note_heartbeat(env)            # stray beacon: harmless
            return None
        verdict = self._delivery.process(env)
        if verdict.ack:
            self._send_ack(env, quarantined=env.wid
                           in self._delivery.quarantined)
        if verdict.quarantine:
            self._on_quarantine(env)
        elif verdict.status == "reject":
            self._telemetry_fault("checksum_reject", env)
        elif verdict.status == "dup":
            self._telemetry_fault("dedup", env)
        if verdict.status != "accept":
            return None
        return env.payload

    def _send_ack(self, env: Envelope, quarantined: bool = False):
        spec = self.faults
        if (spec is not None and not quarantined
                and spec.drops_ack(env.wid, env.seq, env.attempt)):
            self._bump("acks_dropped")           # lost receipt: redelivery
            return
        if self._pool is not None:
            self._pool.send_ack(env.wid,
                                Ack(wid=env.wid, generation=env.generation,
                                    seq=env.seq, quarantined=quarantined))
            return
        waiter = self._ack_waiters.get(env.wid)
        if waiter is not None:
            waiter.put(Ack(wid=env.wid, generation=env.generation,
                           seq=env.seq, quarantined=quarantined))

    def _on_quarantine(self, env: Envelope):
        """K consecutive corrupt frames: stop accepting this worker. Free
        mode degrades gracefully (the worker leaves the rotation through
        the crash machinery, with no restart); deterministic mode records
        it, and the event loop raises a liveness error if it starves for
        that worker's round."""
        if env.wid in self._quarantine_acted:
            return
        self._quarantine_acted.add(env.wid)
        self._telemetry_fault("quarantine", env)
        w = self.workers.get(env.wid)
        if w is not None and w.alive and self.mode == "free":
            self._crash_worker(w)

    def _bump(self, key: str, n: int = 1):
        with self._dlock:
            self._delivery.counters[key] += n

    def _telemetry_fault(self, event: str, env: Optional[Envelope] = None,
                         wid: Optional[int] = None, detail=None):
        if self.telemetry is None:
            return
        self.telemetry.record_fault(
            event=event,
            wid=env.wid if env is not None else (-1 if wid is None else wid),
            seq=env.seq if env is not None else -1,
            generation=env.generation if env is not None else -1,
            detail=detail)

    # ------------------------------------------------------------- liveness
    def _note_heartbeat(self, env: Envelope):
        wid = env.wid
        # silence is measured between send instants, not drain instants:
        # beacons queue on the side channel and the server may drain late
        beat_t = env.sent_time or time.monotonic()
        w = self.workers.get(wid)
        if (self._hb_enabled and w is not None and w.alive
                and wid not in self._liveness_dead):
            last = self._last_beat.get(wid)
            interval = self.faults.heartbeat_interval
            if last is not None and beat_t > last:
                missed = int((beat_t - last) / interval)
                if missed >= self.faults.liveness_misses:
                    # silent past the death threshold and only now back:
                    # the death is declared late (the generation bump drops
                    # what it computed meanwhile), and this very beacon
                    # revives it below
                    counted = self._miss_counted.get(wid, 0)
                    if missed > counted:
                        self._bump("heartbeat_misses", missed - counted)
                    self._liveness_dead.add(wid)
                    self._bump("liveness_deaths")
                    self._telemetry_fault("liveness_dead", wid=wid)
                    self._crash_worker(w)
        self._last_beat[wid] = max(beat_t, self._last_beat.get(wid, 0.0))
        self._miss_counted[wid] = 0
        if (wid in self._liveness_dead and w is not None and not w.alive
                and wid not in self._delivery.quarantined):
            # the silent worker is back: it rejoins through the generation
            # machinery (its lost round can never commit)
            self._liveness_dead.discard(wid)
            w.alive = True
            self._bump("liveness_revivals")
            self._telemetry_fault("liveness_revive", wid=wid)
            self._dispatch(w)

    def _drain_heartbeats(self):
        if not self._hb_enabled:
            return
        while True:
            try:
                env = self._hb_channel.recv(timeout=0.0)
            except (TransportTimeout, TransportClosed):
                return
            if isinstance(env, Envelope) and env.kind == KIND_HEARTBEAT:
                self._note_heartbeat(env)

    def _check_liveness(self):
        """Declare dead a worker whose beacons stopped for
        ``liveness_misses`` whole intervals; the crash and rejoin machinery
        does the rest (a returning beacon revives it)."""
        if not self._hb_enabled:
            return
        interval = self.faults.heartbeat_interval
        now = time.monotonic()
        for wid, w in list(self.workers.items()):
            if not w.alive or wid in self._liveness_dead:
                continue
            last = self._last_beat.get(wid)
            if last is None:
                continue
            missed = int((now - last) / interval)
            counted = self._miss_counted.get(wid, 0)
            if missed > counted:
                self._bump("heartbeat_misses", missed - counted)
                self._miss_counted[wid] = missed
            if missed >= self.faults.liveness_misses:
                self._liveness_dead.add(wid)
                self._bump("liveness_deaths")
                self._telemetry_fault("liveness_dead", wid=wid)
                self._crash_worker(w)

    # ----------------------------------------------------------- commit path
    def _is_current(self, res: RoundResult) -> bool:
        """A result counts only if it is the round its worker waits on;
        task ids are engine-unique, so a departed incarnation of a reused
        wid or a crashed generation is never mistaken for it."""
        w = self.workers.get(res.wid)
        return w is not None and res.task_id == w.pending_task_id

    def _obtain(self, w: Worker) -> RoundResult:
        """Block until this worker's round has landed; other workers'
        results are parked, stale ones dropped."""
        want = w.pending_task_id
        while want not in self._results:
            res = self._recv_result()
            if self._is_current(res):
                self._results[res.task_id] = res
        return self._results.pop(want)

    def _ready(self):
        """Wait for the server's outer step on the device, so busy time is
        the step's and not its dispatch's. Every thread shares the default
        stream, so the wait also covers the workers' round kernels queued
        ahead of the commit: on one card the busy time, and
        ``server_occupancy`` with it, is an upper bound of the step's."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _commit(self, w: Worker, res: RoundResult):
        with self._comp_lock:
            overlap = self._computing
        t0 = time.monotonic()
        rec = super()._commit(w, res)
        self._ready()
        self.stats["server_busy_seconds"] += time.monotonic() - t0
        self.stats["overlap_samples"].append(overlap)
        self.stats["arrivals"] += 1
        return rec

    def _commit_batch(self, pairs, reason: str = "batch-full"):
        with self._comp_lock:
            overlap = self._computing
        t0 = time.monotonic()
        recs = super()._commit_batch(pairs, reason=reason)
        self._ready()
        self.stats["server_busy_seconds"] += time.monotonic() - t0
        self.stats["overlap_samples"].append(overlap)
        self.stats["arrivals"] += len(pairs)
        return recs

    def _drop_round(self, w: Worker):
        """A crash, leave or restore loses the round in flight: its parked
        result goes now, and a result still to land is stale."""
        if w.pending_task_id is not None:
            self._results.pop(w.pending_task_id, None)

    def _on_worker_removed(self, w: Worker):
        if self._pool is not None:
            self._pool.kill(w.wid)
        self._last_task.pop(w.wid, None)
        inbox = self._inboxes.pop(w.wid, None)
        if inbox is not None:
            inbox.put(None)                             # poison pill
        waiter = self._ack_waiters.pop(w.wid, None)
        if waiter is not None:
            waiter.close()                              # unblock a resend
        stop = self._hb_stops.pop(w.wid, None)
        if stop is not None:
            stop.set()
        self._hb_threads.pop(w.wid, None)
        self._threads.pop(w.wid, None)

    # ------------------------------------------------------------ lifecycle
    def _ensure_open(self):
        if self._shut:
            if not self._own_transport:
                raise RuntimeError("transport closed; inject a fresh one")
            self._fold_fault_counters()
            if self.transport_kind == "socket":
                self._hb_channel = self._heartbeat_channel()
                self.transport = self._data_channel()     # a fresh pool
            else:
                self.transport = self._data_channel()
                self._hb_channel = self._heartbeat_channel()
            self._sender = self._make_sender()
            self._shut = False

    def _fold_fault_counters(self):
        """Carry injected-fault counts across channel rebuilds."""
        for name, tr in (("data", self.transport),
                         ("heartbeat", self._hb_channel)):
            if isinstance(tr, FaultyTransport):
                acc = self._channel_counters.setdefault(name, {})
                for k, v in tr.counters.items():
                    self._fault_accum[k] = self._fault_accum.get(k, 0) + v
                    acc[k] = acc.get(k, 0) + v

    def _harvest_child_counters(self):
        """Fold what the worker processes reported at their graceful stop
        into the run's totals: injected faults join the fault tallies (so
        ``delivery_stats`` reads as on the in-process backend), resends
        join the delivery counters, rounds the runtime's; kernel launches
        are kept apart (``stats_summary()["child_launches"]``)."""
        if self._pool is None:
            return
        pool = self._pool
        for channel, counters in pool.child_counters.items():
            acc = self._channel_counters.setdefault(channel, {})
            for k, v in counters.items():
                acc[k] = acc.get(k, 0) + v
                if channel == "protocol":
                    if k in DELIVERY_COUNTERS:
                        self._bump(k, v)
                else:
                    self._fault_accum[k] = self._fault_accum.get(k, 0) + v
        for k, v in pool.child_launches.items():
            self._child_launches[k] = self._child_launches.get(k, 0) + v
        self.stats["rounds"] += pool.child_rounds
        pool.child_counters.clear()
        pool.child_launches.clear()
        pool.child_rounds = 0

    # ------------------------------------------ cross-process observability
    def _on_obs(self, payload: Dict) -> None:
        """One child's obs frame: its span batch merged into the tracer as
        a process row of its pid, and a cumulative "transport" record. Runs
        on a pool reader thread, so the shared state is taken under
        ``_obs_lock``; a malformed frame is dropped and never raises. Only
        observes: touches no engine state and no tensor."""
        try:
            wid = int(payload["wid"])
            pid = int(payload["pid"])
        except (KeyError, TypeError, ValueError):
            return
        metrics = payload.get("metrics") or {}
        final = bool(payload.get("final"))
        offset = float(payload.get("offset", 0.0))
        with self._obs_lock:
            self._child_wire[(wid, pid)] = dict(metrics, final=final,
                                                clock_offset_s=offset)
            spans = payload.get("spans")
            if self.tracer.enabled and spans is not None:
                self.tracer.ingest_remote(
                    pid=pid,
                    epoch_offset=float(payload.get("epoch_offset", 0.0)),
                    events=spans.get("events", []),
                    names=spans.get("names", {}),
                    process_name=f"heloco-worker-{wid} (pid {pid})")
            if self.telemetry is not None:
                self.telemetry.record_transport(
                    wid=wid, pid=pid,
                    frames_sent=int(metrics.get("frames_sent", 0)),
                    frames_recv=int(metrics.get("frames_recv", 0)),
                    bytes_sent=int(metrics.get("bytes_sent", 0)),
                    bytes_recv=int(metrics.get("bytes_recv", 0)),
                    ser_s=float(metrics.get("ser_s", 0.0)),
                    deser_s=float(metrics.get("deser_s", 0.0)),
                    crc_rejects=int(metrics.get("crc_rejects", 0)),
                    retries=int(metrics.get("retries", 0)),
                    credit_wait_s=float(metrics.get("credit_wait_s", 0.0)),
                    rounds=int(metrics.get("rounds", 0)),
                    compute_s=float(metrics.get("compute_s", 0.0)),
                    clock_offset_s=offset, final=final)

    def child_obs_report(self) -> Dict[str, Any]:
        """What the worker processes reported: obs frames by wid, the wids
        whose final report arrived, and the latest cumulative wire counters
        summed over every (wid, pid) incarnation. Empty off the socket
        transport."""
        if self._pool is None:
            return {"reports": {}, "final": [], "wire": {}}
        with self._obs_lock:
            wire: Dict[str, float] = {}
            for snap in self._child_wire.values():
                for k, v in snap.items():
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        wire[k] = wire.get(k, 0) + v
        return {"reports": dict(self._pool.obs_reports),
                "final": sorted(self._pool.obs_final),
                "wire": wire}

    def assert_child_reports(self) -> None:
        """Raise if a worker process the run dispatched to never shipped an
        obs frame (over processes with tracing or telemetry on): a silent
        child means the collection path is broken, not that the run was
        quiet."""
        if self._pool is None or not self._pool.obs:
            return
        silent = sorted(w for w in self._last_task
                        if w not in self._pool.obs_reports)
        if silent:
            raise RuntimeError(
                f"cross-process observability enabled but worker(s) "
                f"{silent} never reported in over the obs control "
                f"channel (reports: {dict(self._pool.obs_reports)}): "
                f"child-side collection is broken or the processes died "
                f"before their first report")

    def shutdown(self):
        """Tear the worker threads or processes down. Idempotent; ``run``
        or ``restore`` after it rebuilds the channel and the workers."""
        self._shut = True
        if self._pool is not None:
            self._pool.close()           # stop, stats harvest, join
            self._harvest_child_counters()
        else:
            self.transport.close()
        self._hb_channel.close()
        for stop in self._hb_stops.values():
            stop.set()
        for inbox in self._inboxes.values():
            inbox.put(None)
        for waiter in self._ack_waiters.values():
            waiter.close()
        for t in list(self._threads.values()) + list(self._hb_threads.values()):
            t.join(timeout=5.0)
        self._inboxes.clear()
        self._ack_waiters.clear()
        self._threads.clear()
        self._hb_threads.clear()
        self._hb_stops.clear()
        self._results.clear()

    # ------------------------------------------- runtime health snapshots
    def _runtime_snapshot(self) -> Dict:
        """Live counters for a telemetry "runtime" record: what
        ``stats_summary()`` reports at the end, mid-run, with the liveness
        states and the delivery and fault counters."""
        snap = super()._runtime_snapshot()
        wall = (time.monotonic() - self._run_t0
                if self._run_t0 is not None else 0.0)
        arrivals = self.stats["arrivals"]
        snap.update(
            arrivals=arrivals,
            arrivals_per_sec=arrivals / wall if wall > 0 else 0.0,
            server_occupancy=(self.stats["server_busy_seconds"] / wall
                              if wall > 0 else 0.0),
            compute_parallelism=(self.stats["compute_seconds_total"] / wall
                                 if wall > 0 else 0.0),
            queue_depth=self.transport.depth(),
            liveness={
                "dead": len(self._liveness_dead),
                "quarantined": len(self._delivery.quarantined),
                "threads_alive": sum(1 for t in self._threads.values()
                                     if t.is_alive()),
            },
            delivery={k: float(v)
                      for k, v in self.delivery_stats().items() if v})
        return snap

    # ------------------------------------------------------------------ run
    def run(self, eval_every: int = 0,
            eval_fn: Optional[Callable[[Dict, int, float], Dict]] = None,
            ckpt_every: int = 0, ckpt_dir: str = "",
            budget=None) -> History:
        t0 = time.monotonic()
        self._run_t0 = t0
        try:
            self._ensure_open()
            self._start_processes()
            if self.mode == "free" and not self.server.method.sync:
                hist = self._run_free(eval_every, eval_fn, ckpt_every,
                                      ckpt_dir, budget)
            else:
                hist = super().run(eval_every, eval_fn, ckpt_every, ckpt_dir,
                                   budget)
        finally:
            self.stats["wall_seconds"] += time.monotonic() - t0
            self.shutdown()
        return hist

    def _finalize(self, eval_fn) -> History:
        hist = super()._finalize(eval_fn)
        if self.telemetry is not None:
            d = self.delivery_stats()
            if any(d.values()):
                self._telemetry_fault(
                    "summary", detail={k: float(v) for k, v in d.items()})
        return hist

    # ------------------------------------------------------- free-run loop
    def _run_free(self, eval_every, eval_fn, ckpt_every, ckpt_dir,
                  budget=None) -> History:
        """True arrival order on the wall clock. ``self.time`` is in virtual
        seconds (wall / pace_scale; raw wall seconds when pace_scale is 0),
        so histories compare with the simulator's, and failure, membership
        and restart times live on that clock, as does a clock ``Budget``.
        Every loop turn drains the heartbeat channel and sweeps for silent
        workers."""
        self._ensure_telemetry_meta()
        target = self.cfg.outer_steps
        self._free_t0 = t0 = time.monotonic()
        scale = self.pace_scale if self.pace_scale > 0 else 1.0
        fail_idx = el_idx = 0
        restarts: List = []
        for w in self.workers.values():
            if w.alive and not w.in_flight:
                self._dispatch(w)

        def vnow() -> float:
            return (time.monotonic() - t0) / scale

        def process_events(vt: float):
            nonlocal fail_idx, el_idx
            while (fail_idx < len(self.failures)
                   and self.failures[fail_idx].time <= vt):
                ev = self.failures[fail_idx]
                fail_idx += 1
                w = self.workers.get(ev.wid)
                if w is None:
                    continue
                self._crash_worker(w)
                restarts.append((ev.time + ev.restart_delay, ev.wid))
                restarts.sort()
            while (el_idx < len(self.elastic)
                   and self.elastic[el_idx].time <= vt):
                self._handle_elastic(self.elastic[el_idx])
                el_idx += 1
            while restarts and restarts[0][0] <= vt:
                _, wid = restarts.pop(0)
                w = self.workers.get(wid)
                if w is not None and not w.alive:
                    w.alive = True
                    self._dispatch(w)

        def progress_possible() -> bool:
            """Someone will still produce an arrival: a live worker, a
            pending restart, an unfired event, or a liveness-dead worker
            whose beacon may return."""
            return (any(w.alive for w in self.workers.values())
                    or bool(restarts)
                    or bool(self._liveness_dead)
                    or fail_idx < len(self.failures)
                    or el_idx < len(self.elastic))

        while self.server.t < target and not self._stop:
            process_events(vnow())
            self._drain_heartbeats()
            self._check_liveness()
            if not progress_possible():
                break                   # every worker gone: a starved run
            if budget is not None and budget.over_time(vnow()):
                break                   # clock horizon: stop committing
            try:
                msg = self._recv_result(timeout=0.05)
            except TransportTimeout:
                continue                # keep the event clock ticking
            if not self._is_current(msg) or not self.workers[msg.wid].alive:
                continue                # stale: crashed or departed worker
            w = self.workers[msg.wid]
            self.time = vnow()
            if budget is not None and budget.over_time(self.time):
                break                   # arrived past the horizon: dropped
            # with commit_batch > 1, drain what else has landed (without
            # blocking) into one fused flush, capped as in the virtual-clock
            # loop so a batch never overshoots an eval, ckpt or close
            limits = [(self.server.commit_batch, "batch-full"),
                      (target - self.server.t, "close")]
            if eval_every:
                limits.append(
                    (eval_every - self.server.t % eval_every, "eval"))
            if ckpt_every:
                limits.append(
                    (ckpt_every - self.server.t % ckpt_every, "ckpt"))
            cap, flush_reason = min(limits, key=lambda kv: kv[0])
            batch = [(w, msg)]
            while len(batch) < cap:
                try:
                    extra = self._recv_result(timeout=0.001)
                except TransportTimeout:
                    break               # queue drained: commit what we have
                if (not self._is_current(extra)
                        or not self.workers[extra.wid].alive):
                    continue
                batch.append((self.workers[extra.wid], extra))
            if len(batch) == 1:
                self._commit(w, msg)
            else:
                self._commit_batch(batch, reason=flush_reason)
            self._post_commit(eval_every, eval_fn, ckpt_every, ckpt_dir)
            if budget is not None and budget.over_tokens(self.history.tokens):
                break
            if self.server.t < target:
                process_events(vnow())
                for bw, _ in batch:
                    if bw.alive:
                        self._dispatch(bw)
        self.time = vnow()
        return self._finalize(eval_fn)

    # -------------------------------------------------------- sync barrier
    def _execute_sync(self, tasks: List[RoundTask]) -> List[RoundResult]:
        """A synchronous round with the workers' inner rounds in parallel
        threads; the barrier is the transport's collect."""
        for task in tasks:
            self._submit(task)
        want = {t.task_id: i for i, t in enumerate(tasks)}
        got: Dict[int, RoundResult] = {}
        while len(got) < len(tasks):
            res = self._recv_result()
            idx = want.get(res.task_id)
            if idx is not None:
                got[idx] = res
        return [got[i] for i in range(len(tasks))]

    # ----------------------------------------------------------- reporting
    def delivery_stats(self) -> Dict[str, int]:
        """Delivery-health counters: protocol events (resends, dedups,
        checksum rejects, quarantines, heartbeat misses, liveness
        transitions) and the injected-fault tallies of the faulty
        channels."""
        with self._dlock:
            out = {k: self._delivery.counters[k] for k in DELIVERY_COUNTERS}
        for k, v in self._fault_accum.items():
            out[k] = out.get(k, 0) + v
        for tr in (self.transport, self._hb_channel):
            if isinstance(tr, FaultyTransport):
                for k, v in tr.counters.items():
                    out[k] = out.get(k, 0) + v
        for k, v in self._proc_counters.items():
            if v:
                out[k] = out.get(k, 0) + v
        return out

    def delivery_channels(self) -> Dict[str, Dict[str, int]]:
        """The injected-fault counters by channel, "data" and "heartbeat"
        (on the socket transport what the worker processes tallied on
        their side of the wire, and their resends under "protocol")."""
        out = {k: dict(v) for k, v in self._channel_counters.items()}
        for name, tr in (("data", self.transport),
                         ("heartbeat", self._hb_channel)):
            if isinstance(tr, FaultyTransport):
                acc = out.setdefault(name, {})
                for k, v in tr.counters.items():
                    acc[k] = acc.get(k, 0) + v
        return out

    def stats_summary(self) -> Dict[str, Any]:
        """The run's wall-clock health. ``server_busy_seconds`` (and
        ``server_occupancy``) include the workers' device work queued on
        the shared stream ahead of a commit (see ``_ready``);
        ``compute_seconds_total`` (and ``compute_parallelism``) is host
        seconds inside rounds, waits for the GIL included."""
        q = self.stats["queue_depth_samples"]
        ov = self.stats["overlap_samples"]
        wall = max(self.stats["wall_seconds"], 1e-9)
        return {
            "mode": self.mode,
            "arrivals": self.stats["arrivals"],
            "rounds": self.stats["rounds"],
            "wall_seconds": self.stats["wall_seconds"],
            "arrivals_per_sec": self.stats["arrivals"] / wall,
            "server_busy_seconds": self.stats["server_busy_seconds"],
            "server_occupancy": self.stats["server_busy_seconds"] / wall,
            "compute_seconds_total": self.stats["compute_seconds_total"],
            # workers' seconds inside rounds over the wall; threads waiting
            # for the GIL count, so > 1 is not concurrency by itself
            "compute_parallelism": self.stats["compute_seconds_total"] / wall,
            "queue_depth_mean": (sum(q) / len(q)) if q else 0.0,
            "queue_depth_max": max(q) if q else 0,
            # workers mid-round at the moment the server applied an update
            "overlap_mean": (sum(ov) / len(ov)) if ov else 0.0,
            "overlap_max": max(ov) if ov else 0,
            "overlap_commits": sum(1 for x in ov if x >= 1),
            "delivery": self.delivery_stats(),
            "delivery_channels": self.delivery_channels(),
            "transport": self.transport_kind,
            "proc_exits": self._proc_counters["proc_exits"],
            "proc_restarts": self._proc_counters["proc_restarts"],
            # the worker processes' kernel launches (graceful stops only)
            "child_launches": dict(self._child_launches),
            # what the worker processes reported (socket + obs only)
            "child_obs": self.child_obs_report(),
            "flush": dict(getattr(self.server, "flush_totals", {})),
        }
