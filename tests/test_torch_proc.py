"""The port's worker processes on the socket transport
(``async_engine/proc.py``) against the reference's wire, on the CPU.

  * frames written by the port's ``_send_frame`` and by the reference's
    hold the same bytes for the same objects, each side's ``_recv_frame``
    reads the other's, and a flipped payload byte or an over-cap length
    raises ``WireError``;
  * a standalone ``SocketTransport`` keeps ``InProcTransport``'s contract
    over its loopback (FIFO, a credit window that blocks with an exact
    timeout, ``close`` waking a blocked ``recv``) and ``FaultyTransport``
    wraps it;
  * the rendezvous assigns a hand-seeded nonce once (with the device and
    the parent's torch settings) and rejects it reused, and an unknown one;
    a worker that beats joins a heartbeat connection of its own;
  * ``host_task``/``device_task`` and ``host_result``/``device_result``
    round-trip a full round bit for bit through pickle, fp32 and int8, and
    the result's ``payload_crc`` equals the reference's for bridged bits;
  * one run over 4 spawned processes: ``socket_hetero`` with the golden's
    arrivals, tokens and comm_bytes, its final parameters bit-equal to the
    port's sim twin from the same bits.

The ``proc`` lane (``-m proc``, the reference's marker: each spawns worker
processes) ports tests/test_proc.py: a child dead before the rendezvous
fails ``ensure``, ``close`` leaves no orphan, a SIGKILL of worker 0 after 3
arrivals recovers with the golden's arrivals and the twin's bits,
``chaos_lossy`` over the socket commits ``wallclock_hetero``'s bits with
its fault counters harvested from the children, a child asked for CUDA
without one fails the run (no fallback to the CPU), and the launcher's and
``scenarios.run``'s socket flags.
"""
import dataclasses
import os
import pickle
import signal
import socket
import struct
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.async_engine import proc as jproc
from repro.async_engine import transport as jtransport
from repro.core import packing as jpacking
from repro_torch.async_engine import proc
from repro_torch.async_engine import runtime as runtime_lib
from repro_torch.async_engine.engine import make_engine, make_eval_fn
from repro_torch.async_engine.faults import FaultSpec, FaultyTransport
from repro_torch.async_engine.proc import (
    RendezvousRejected, SocketClient, SocketTransport, WireError,
    WorkerFatal, WorkerProcessPool, device_result, device_task, host_result,
    host_task,
)
from repro_torch.async_engine.transport import (
    Envelope, KIND_RESULT, TransportClosed, TransportTimeout, payload_crc,
)
from repro_torch.core.packing import Packed
from repro_torch.scenarios import registry, run, trace
from test_torch_methods import one_intra_op_thread  # noqa: F401
from test_torch_transport import FakeResult, _nested
from test_torch_wallclock import _init, _twin

# a hung rendezvous or result fails its own test inside this many seconds
DEADLINE = 60.0

FRAMES = {
    "arrays_and_ints": ("task", (np.arange(12, dtype=np.float32)
                                 .reshape(3, 4), 7,
                                 np.array([-128, 0, 127], np.int8),
                                 np.int64(5), 2 ** 40)),
    "nested": ("ctrl", "stats", {"protocol": {"retries": 3},
                                 "w": [np.ones((2, 2)), None, 1.5]}),
    "credit": ("credit", 1),
    "stop": ("stop",),
}


def _raw_frame(send_frame, obj) -> bytes:
    """The bytes ``send_frame`` puts on a socket for ``obj``."""
    a, b = socket.socketpair()
    try:
        send_frame(a, threading.Lock(), obj)
        hdr = b.recv(8, socket.MSG_WAITALL)
        (length, _crc) = struct.unpack("!II", hdr)
        return hdr + b.recv(length, socket.MSG_WAITALL)
    finally:
        a.close()
        b.close()


def _decode(recv_frame, raw: bytes):
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        return recv_frame(b)
    finally:
        a.close()
        b.close()


def _same_tree(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_are_the_references_byte_for_byte(name):
    obj = FRAMES[name]
    mine = _raw_frame(proc._send_frame, obj)
    ref = _raw_frame(jproc._send_frame, obj)
    assert mine == ref
    _same_tree(_decode(proc._recv_frame, ref), obj)
    _same_tree(_decode(jproc._recv_frame, mine), obj)


def test_a_flipped_byte_or_an_oversized_length_raises_wire_error():
    raw = bytearray(_raw_frame(proc._send_frame, FRAMES["arrays_and_ints"]))
    raw[20] ^= 0x40
    with pytest.raises(WireError, match="CRC"):
        _decode(proc._recv_frame, bytes(raw))
    over = struct.pack("!II", proc._MAX_FRAME + 1, 0)
    with pytest.raises(WireError, match="exceeds cap"):
        _decode(proc._recv_frame, over)


# ---------------------------------------------------------------------------
# SocketTransport: InProcTransport's contract over sockets
# ---------------------------------------------------------------------------

@pytest.fixture
def sock_tr():
    tr = SocketTransport(capacity=2)
    yield tr
    tr.close()


def test_socket_transport_is_fifo(sock_tr):
    for i in range(5):
        sock_tr.send(("m", i))
        assert sock_tr.recv(timeout=5.0) == ("m", i)
    sock_tr.send(1)
    sock_tr.send(2)
    assert [sock_tr.recv(timeout=5.0), sock_tr.recv(timeout=5.0)] == [1, 2]


def test_credit_window_blocks_with_an_exact_timeout(sock_tr):
    sock_tr.send("a")
    sock_tr.send("b")
    t0 = time.monotonic()
    with pytest.raises(TransportTimeout):
        sock_tr.send("c", timeout=0.3)
    assert abs(time.monotonic() - t0 - 0.3) < 0.1
    assert sock_tr.recv(timeout=5.0) == "a"      # returns one credit
    sock_tr.send("c", timeout=5.0)
    assert [sock_tr.recv(timeout=5.0), sock_tr.recv(timeout=5.0)] == \
        ["b", "c"]
    with pytest.raises(TransportTimeout):
        sock_tr.recv(timeout=0.05)


def test_close_wakes_a_blocked_recv(sock_tr):
    out = {}

    def blocked():
        try:
            sock_tr.recv()
        except TransportClosed as e:
            out["e"] = e

    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.1)
    sock_tr.close()
    t.join(timeout=5.0)
    assert not t.is_alive() and "e" in out
    with pytest.raises(TransportClosed):
        sock_tr.send("x")


def test_faulty_transport_wraps_the_socket_transport(sock_tr):
    tr = FaultyTransport(sock_tr, FaultSpec(dup_p=1.0, seed=3))
    env = Envelope(wid=1, generation=0, seq=1, kind=KIND_RESULT,
                   payload=FakeResult({"w": np.arange(3, dtype=np.float32)}),
                   crc=5)
    tr.send(env)
    got = [tr.recv(timeout=5.0), tr.recv(timeout=5.0)]
    assert [(g.wid, g.seq, g.crc) for g in got] == [(1, 1, 5)] * 2
    np.testing.assert_array_equal(got[0].payload.delta["w"],
                                  np.arange(3, dtype=np.float32))
    assert tr.counters["injected_dups"] == 1


# ---------------------------------------------------------------------------
# The rendezvous
# ---------------------------------------------------------------------------

def test_rendezvous_assigns_once_and_rejects_reused_and_unknown_nonces():
    cfg = registry.get_scenario("socket_hetero").run_config()
    pool = WorkerProcessPool(cfg, device="cpu", capacity=4)
    client = None
    try:
        pool._pending["w0-i1-seeded"] = (0, 1)
        client = SocketClient.connect(pool.transport.address,
                                      {"nonce": "w0-i1-seeded"}, timeout=10)
        a = client.assign
        assert (a["wid"], a["credit"], a["device"]) == (0, 4, "cpu")
        assert a["cfg"] == cfg and a["mode"] == "deterministic"
        assert a["torch"] == proc.torch_settings()
        assert a["torch"]["num_threads"] == torch.get_num_threads() == 1
        deadline = time.monotonic() + 5.0
        while not pool.alive(0) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pool.alive(0) and not pool._pending
        for nonce in ("w0-i1-seeded", "never-issued"):
            with pytest.raises(RendezvousRejected):
                SocketClient.connect(pool.transport.address,
                                     {"nonce": nonce}, timeout=10)
        assert pool.alive(0)                     # the impostors changed nothing
        assert pool.ensure(0) is None            # live: no spawn
        assert not pool._procs
    finally:
        if client is not None:
            client.close()
        pool.close()


@pytest.mark.parametrize("puts, end, want, skipped", [
    (["t1"], None, "t1", 0),
    (["t1", "t2", "t3"], None, "t3", 2),
    (["t1", "t2"], "stop", "stop", 2),
    ([], "eof", "eof", 0),
])
def test_child_task_slot_keeps_only_the_newest_task(puts, end, want,
                                                     skipped):
    """The child's intake holds one task: an overtaken one is dropped on
    arrival and counted, and a stop or disconnect wins over a waiting
    task (counted too), as the loop's skip of overtaken tasks did."""
    slot = proc._TaskSlot()
    for t in puts:
        slot.put(t)
    if end is not None:
        slot.end(end)
    assert slot.get() == want
    assert slot.skipped == skipped


def test_child_task_slot_get_waits_for_a_put():
    slot = proc._TaskSlot()
    got = []
    th = threading.Thread(target=lambda: got.append(slot.get()))
    th.start()
    time.sleep(0.05)
    assert not got
    slot.put("t1")
    th.join(timeout=5.0)
    assert got == ["t1"] and slot.skipped == 0


def test_heartbeats_join_on_a_connection_of_their_own():
    """In free mode with liveness on, the assign frame carries a one-time
    nonce for a second connection, whose beacons reach the heartbeat sink
    and whose loss is no worker exit; in deterministic mode there is
    none."""
    from repro_torch.async_engine.transport import InProcTransport
    cfg = registry.get_scenario("socket_hetero").run_config()
    quiet = WorkerProcessPool(cfg, device="cpu")
    sink = InProcTransport(8)
    pool = WorkerProcessPool(cfg, device="cpu", mode="free", hb_sink=sink,
                             faults=FaultSpec(heartbeat_interval=0.05))
    clients = []
    try:
        for p in (quiet, pool):
            p._pending["seeded"] = (2, 1)
            clients.append(SocketClient.connect(
                p.transport.address, {"nonce": "seeded"}, timeout=10))
        assert clients[0].assign["hb_nonce"] is None
        hb_nonce = clients[1].assign["hb_nonce"]
        assert hb_nonce is not None
        hb = SocketClient.connect(pool.transport.address,
                                  {"nonce": hb_nonce, "channel": "hb"},
                                  timeout=10)
        clients.append(hb)
        assert hb.assign == {"wid": 2, "credit": 0}
        with pytest.raises(RendezvousRejected):
            SocketClient.connect(pool.transport.address,
                                 {"nonce": hb_nonce, "channel": "hb"},
                                 timeout=10)
        beat = Envelope(wid=2, generation=0, seq=1, kind="heartbeat",
                        payload=None, sent_time=1.5)
        hb.send_hb(beat)
        assert sink.recv(timeout=5.0) == beat
        hb.close()
        time.sleep(0.2)
        assert pool.alive(2) and pool.proc_exits == 0
        with pytest.raises(TransportTimeout):
            pool.transport.recv(timeout=0.05)    # no WorkerExit surfaced
    finally:
        for c in clients:
            c.close()
        quiet.close()
        pool.close()


# ---------------------------------------------------------------------------
# Host form of payloads
# ---------------------------------------------------------------------------

def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _tensors(x[k])
    elif isinstance(x, tuple):
        for v in x:
            yield from _tensors(v)


def _bytes(t):
    t = t.detach().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            ).numpy().tobytes()


def _bit_equal(got, want):
    g, w = list(_tensors(got)), list(_tensors(want))
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _bytes(a) == _bytes(b)


@pytest.mark.parametrize("name, overrides", [
    ("wallclock_hetero", {}), ("int8_dylu", {"engine": "wallclock"})])
def test_round_trips_through_the_wire_bit_for_bit(name, overrides):
    eng = registry.get_scenario(name).overridden(**overrides).build(
        device="cpu", init_params=_init())
    try:
        task = eng._make_task(eng.workers[0])
        res = eng._execute(task)
        # a task that carries the moments and error feedback of a round
        task = dataclasses.replace(task, opt=res.opt, ef=res.ef)
    finally:
        eng.shutdown()
    wire = pickle.loads(pickle.dumps(host_task(task), protocol=5))
    assert wire.device is None
    assert all(isinstance(v, np.ndarray) for v in wire.params.values())
    back = device_task(wire, "cpu")
    _bit_equal((back.params, back.opt, back.ef),
               (task.params, task.opt, task.ef))
    assert back.opt.count == task.opt.count
    assert dataclasses.replace(back, params=None, opt=None, ef=None,
                               device=None) == \
        dataclasses.replace(task, params=None, opt=None, ef=None,
                            device=None)
    hres = pickle.loads(pickle.dumps(host_result(res), protocol=5))
    assert payload_crc(hres) == payload_crc(res)
    if isinstance(hres.delta, Packed):
        assert overrides and name == "int8_dylu"
        ref = FakeResult(jpacking.Packed(jnp.asarray(hres.delta.buf)))
    else:
        ref = FakeResult(_nested({k: jnp.asarray(v)
                                  for k, v in hres.delta.items()}))
    assert payload_crc(hres) == jtransport.payload_crc(ref)
    _bit_equal((device_result(hres, "cpu").delta,
                device_result(hres, "cpu").opt),
               (res.delta, res.opt))


def test_bf16_leaves_cross_as_their_bit_patterns():
    x = {"a": torch.randn(5, 3).to(torch.bfloat16),
         "b": torch.arange(4, dtype=torch.float32)}
    wire = pickle.loads(pickle.dumps(proc.host_tree(x)))
    assert wire["a"].bits.dtype == np.int16
    back = proc.device_tree(wire, "cpu")
    _bit_equal(back, x)
    assert payload_crc(wire) == payload_crc(x)


# ---------------------------------------------------------------------------
# Worker processes
# ---------------------------------------------------------------------------

@pytest.fixture
def short_deadlines(monkeypatch):
    monkeypatch.setattr(runtime_lib, "RESULT_TIMEOUT", DEADLINE)
    monkeypatch.setattr(WorkerProcessPool, "RENDEZVOUS_TIMEOUT", DEADLINE)


def _run(eng, scn):
    try:
        return eng.run(eval_every=scn.eval_cadence,
                       eval_fn=make_eval_fn(eng, batch=scn.eval_batch))
    finally:
        eng.shutdown()


def test_socket_hetero_over_processes_is_golden_and_sim_bit_equal(
        short_deadlines):
    scn = registry.get_scenario("socket_hetero")
    eng = scn.build(device="cpu", init_params=_init())
    assert eng.transport_kind == "socket" and not eng._pool._procs
    hist = _run(eng, scn)
    got = {"arrivals": run.arrival_rows(hist), "evals": hist.evals,
           "tokens": hist.tokens, "comm_bytes": hist.comm_bytes,
           "final_time": hist.final_time}
    fails = []
    trace._cmp_counts(fails, got, run.load_golden("socket_hetero"))
    assert fails == []
    twin = _twin(scn).build(device="cpu", init_params=_init())
    twin.run()
    assert trace.param_digest(eng.server.state.params) == \
        trace.param_digest(twin.server.state.params)
    s = eng.stats_summary()
    assert s["transport"] == "socket"
    assert s["rounds"] >= s["arrivals"] == 10
    assert (s["proc_exits"], s["proc_restarts"]) == (0, 0)
    assert not any(p.is_alive() for p in eng._pool._procs.values())


# ---------------------------------------------------------------------------
# The proc lane
# ---------------------------------------------------------------------------

class _StillbornProc:
    """A spawn-context Process that dies before it connects."""
    exitcode = 7
    pid = -1

    def start(self):
        pass

    def is_alive(self):
        return False

    def terminate(self):
        pass

    def join(self, timeout=None):
        pass


class _StillbornCtx:
    def Process(self, *args, **kw):
        return _StillbornProc()


@pytest.mark.proc
def test_worker_death_before_rendezvous_fails_ensure():
    pool = WorkerProcessPool(registry.get_scenario("socket_hetero")
                             .run_config(), device="cpu", capacity=4)
    pool._ctx = _StillbornCtx()
    try:
        with pytest.raises(RuntimeError, match="died before the rendezvous"):
            pool.ensure(0)
        assert not pool._pending and not pool.alive(0)
    finally:
        pool.close()


@pytest.mark.proc
def test_close_leaves_no_orphan_processes(short_deadlines):
    pool = WorkerProcessPool(registry.get_scenario("socket_hetero")
                             .run_config(), device="cpu", capacity=4)
    assert pool.ensure_many([0, 1]) == {0: 1, 1: 1}
    procs = [pool._procs[w] for w in (0, 1)]
    assert all(p.is_alive() for p in procs)
    family, target = pool.transport.address
    pool.close()
    for p in procs:
        assert not p.is_alive(), f"orphan worker pid {p.pid}"
    if family == "unix":
        assert not os.path.exists(target)


@pytest.mark.proc
def test_sigkill_mid_run_recovers_golden_arrivals_and_sim_bits(
        short_deadlines):
    scn = registry.get_scenario("socket_hetero")
    eng = make_engine(scn, device="cpu", init_params=_init())
    killed = {}

    def killer():
        deadline = time.monotonic() + DEADLINE
        while time.monotonic() < deadline:
            pool = eng._pool
            if len(eng.history.arrivals) >= 3:
                p = pool._procs.get(0)
                if p is not None and p.is_alive():
                    os.kill(p.pid, signal.SIGKILL)
                    killed["at"] = len(eng.history.arrivals)
                    return
            time.sleep(0.005)

    t = threading.Thread(target=killer, daemon=True)
    t.start()
    hist = _run(eng, scn)
    t.join(timeout=5.0)
    assert killed, "the killer never saw a live worker-0 process"
    s = eng.stats_summary()
    assert s["proc_restarts"] >= 1 and s["proc_exits"] >= 1
    assert run.arrival_rows(hist) == run.load_golden(scn.name)["arrivals"]
    twin = _twin(scn).build(device="cpu", init_params=_init())
    twin.run()
    assert trace.param_digest(eng.server.state.params) == \
        trace.param_digest(twin.server.state.params)


@pytest.mark.proc
def test_chaos_lossy_over_processes_commits_wallclock_heteros_bits(
        short_deadlines):
    scn = registry.get_scenario("chaos_lossy").overridden(transport="socket")
    eng = scn.build(device="cpu", init_params=_init())
    hist = _run(eng, scn)
    assert run.arrival_rows(hist) == \
        run.load_golden("wallclock_hetero")["arrivals"]
    twin = _twin(registry.get_scenario("wallclock_hetero")).build(
        device="cpu", init_params=_init())
    twin.run()
    assert trace.param_digest(eng.server.state.params) == \
        trace.param_digest(twin.server.state.params)
    ch = eng.delivery_channels()
    assert ch["data"]["injected_drops"] > 0
    assert ch["data"]["injected_reorders"] > 0
    assert ch["protocol"]["retries"] > 0
    d = eng.delivery_stats()
    assert d["injected_drops"] == ch["data"]["injected_drops"]
    assert d["retries"] >= ch["protocol"]["retries"]


@pytest.mark.proc
def test_a_child_asked_for_cuda_without_one_fails_the_run(short_deadlines):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    pool = WorkerProcessPool(registry.get_scenario("socket_hetero")
                             .run_config(), device="cuda", capacity=4)
    try:
        pool.ensure(0)
        msg = pool.transport.recv(timeout=DEADLINE)
        assert isinstance(msg, WorkerFatal) and msg.wid == 0
        assert "is_available() is False" in msg.error
    finally:
        pool.close()
    eng = registry.get_scenario("socket_hetero").build(device="cpu")
    eng._pool.device = "cuda"                    # the children's device
    with pytest.raises(RuntimeError, match="could not start"):
        eng.run()


@pytest.mark.proc
def test_launcher_and_verify_cli_run_over_processes(short_deadlines,
                                                    capsys, tmp_path):
    import json
    from repro_torch.launch import train
    stats = tmp_path / "s.json"
    hist = train.main(("--smoke --engine wallclock --transport socket "
                       "--workers 4 --paces 1,2,6,15 --outer 10 --inner 2 "
                       "--batch 2 --seq 16 --device cpu "
                       f"--stats-json {stats}").split())
    assert run.arrival_rows(hist) == \
        run.load_golden("wallclock_hetero")["arrivals"]
    assert json.loads(stats.read_text())["transport"] == "socket"
    assert run.main(["verify", "wallclock_hetero", "dcasgd", "--transport",
                     "socket", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PASS wallclock_hetero [transport=socket]" in out
    assert "1 sim checks skipped" in out
    assert run.main(["list", "--transport-filter", "socket"]) == 0
    listed = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert listed == ["socket_hetero"]
