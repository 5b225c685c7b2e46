"""The port's delivery protocol against the reference's, on identical inputs.

Pure Python and numpy (no training run): the fault dice over a grid of
``(wid, seq, attempt)``, the frames a scripted envelope stream yields
through ``FaultyTransport(InProcTransport)`` (keys, attempts, flipped CRCs,
counters), ``DeliveryTracker`` verdicts and counters on those frames,
``payload_crc`` of bridged pseudo-gradients (fp32 dicts, a bf16 leaf, a
packed int8 buffer), ``ReliableSender``'s resends against a scripted ack
waiter, and ``param_digest``/``param_fingerprint`` of bridged parameters,
each equal to the reference's. Then the reference's own transport and
protocol cases (tests/test_runtime.py's transport section,
tests/test_faults.py's) on the port's classes.
"""
import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.async_engine import faults as jfaults
from repro.async_engine import transport as jtransport
from repro.core import packing as jpacking
from repro.scenarios import trace as jtrace
from repro_torch.async_engine import faults, transport
from repro_torch.async_engine.faults import (
    DELIVERY_COUNTERS, DeliveryTracker, FaultSpec, FaultyTransport,
    PartitionSpec,
)
from repro_torch.async_engine.transport import (
    Ack, AckWaiter, Envelope, InProcTransport, KIND_HEARTBEAT, KIND_RESULT,
    TransportClosed, TransportTimeout, payload_crc,
)
from repro_torch.core.packing import Packed
from repro_torch.scenarios import trace

SPEC = dict(drop_p=0.2, dup_p=0.15, reorder_p=0.25, delay_p=0.1,
            delay_s=0.0, corrupt_p=0.2, ack_drop_p=0.1, corrupt_wids=(0, 2),
            seed=7)
GRID = [(w, s, a) for w in range(4) for s in range(60) for a in range(3)]
DECISIONS = ("drops", "duplicates", "reorders", "delays", "corrupts",
             "drops_ack", "retry_jitter")


@dataclasses.dataclass
class FakeResult:
    """Duck-types the ``.delta`` that payload_crc checksums."""
    delta: object


def _nested(flat):
    """``{"a/b": x}`` -> ``{"a": {"b": x}}`` (the reference's pytree)."""
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _delta(seed=0):
    rng = np.random.default_rng(seed)
    return {"blocks_list/layer_00/attn/wq": rng.normal(size=(8, 2, 4)),
            "blocks_list/layer_00/norm1/bias": rng.normal(size=8),
            "embed/tok": rng.normal(size=(16, 8)),
            "final_norm/scale": rng.normal(size=8)}


def _env(pkg, seq, *, wid=0, gen=0, attempt=0, kind=KIND_RESULT):
    payload = FakeResult({"w": np.arange(4, dtype=np.float32) + seq})
    return pkg.Envelope(wid=wid, generation=gen, seq=seq, kind=kind,
                        payload=payload, crc=pkg.payload_crc(payload),
                        attempt=attempt)


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decision", DECISIONS)
def test_fault_dice_equal_the_references(decision):
    mine = getattr(FaultSpec(**SPEC), decision)
    ref = getattr(jfaults.FaultSpec(**SPEC), decision)
    got = [mine(*k) for k in GRID]
    assert got == [ref(*k) for k in GRID]
    assert len(set(got)) > 1                     # the grid rolls both ways


def test_partition_windows_equal_the_references():
    parts = (dict(start=1.0, end=2.0, wids=(1, 3)),
             dict(start=0.5, end=4.0, wids=()))
    mine = FaultSpec(partitions=tuple(PartitionSpec(**p) for p in parts),
                     heartbeat_interval=0.05)
    ref = jfaults.FaultSpec(partitions=tuple(jfaults.PartitionSpec(**p)
                                             for p in parts),
                            heartbeat_interval=0.05)
    keys = [(w, t) for w in range(5) for t in np.arange(0.0, 5.0, 0.25)]
    assert [mine.in_partition(w, t) for w, t in keys] == \
        [ref.in_partition(w, t) for w, t in keys]
    assert [p.covers(w, t) for p in mine.partitions for w, t in keys] == \
        [p.covers(w, t) for p in ref.partitions for w, t in keys]
    assert mine.liveness_enabled and ref.liveness_enabled
    assert mine.to_dict() == ref.to_dict()


def _script(pkg, stream):
    """A scripted stream through the package's FaultyTransport: three
    workers' frames, a resend of each, heartbeats on stream 1; returns the
    frames received in order, after the close flush, and the counters."""
    inner = pkg.InProcTransport(capacity=4096)
    spec_cls = jfaults.FaultSpec if pkg is jtransport else FaultSpec
    faulty = (jfaults.FaultyTransport if pkg is jtransport
              else FaultyTransport)
    tr = faulty(inner, spec_cls(**SPEC), stream=stream)
    kind = KIND_HEARTBEAT if stream else KIND_RESULT
    for seq in range(1, 31):
        for wid in range(3):
            for attempt in range(2):
                tr.send(_env(pkg, seq, wid=wid, attempt=attempt, kind=kind))
    tr.send("not-an-envelope")
    tr.close()
    frames = []
    while True:
        try:
            msg = inner.recv(timeout=0)
        except (TransportClosed, jtransport.TransportClosed,
                TransportTimeout, jtransport.TransportTimeout):
            break
        frames.append(msg if isinstance(msg, str) else
                      (msg.wid, msg.generation, msg.seq, msg.kind, msg.crc,
                       msg.attempt))
    return frames, dict(tr.counters)


@pytest.mark.parametrize("stream", [0, 1])
def test_faulty_transport_frames_equal_the_references(stream):
    got, counters = _script(transport, stream)
    want, jcounters = _script(jtransport, stream)
    assert got == want
    assert counters == jcounters
    assert all(counters[k] > 0 for k in ("injected_drops", "injected_dups",
                                          "injected_reorders"))
    assert (counters["injected_corruptions"] > 0) == (stream == 0)


def test_delivery_tracker_verdicts_equal_the_references():
    """The frames of the scripted stream, corrupt ones included, then a
    worker corrupted past the quarantine threshold."""
    def run(pkg, tracker):
        inner = pkg.InProcTransport(capacity=4096)
        spec_cls = jfaults.FaultSpec if pkg is jtransport else FaultSpec
        faulty = (jfaults.FaultyTransport if pkg is jtransport
                  else FaultyTransport)
        tr = faulty(inner, spec_cls(**SPEC))
        for seq in range(1, 31):
            for wid in range(3):
                for attempt in range(2):
                    tr.send(_env(pkg, seq, wid=wid, attempt=attempt))
        for seq in range(31, 36):                # corrupt: quarantined
            tr.send(dataclasses.replace(_env(pkg, seq, wid=1), crc=12345))
        tr.close()
        out = []
        while True:
            try:
                env = inner.recv(timeout=0)
            except (TransportClosed, jtransport.TransportClosed):
                break
            v = tracker.process(env)
            out.append((env.wid, env.seq, v.status, v.ack, v.quarantine))
        tracker.reset_stream(0)
        out.append(tracker.process(_env(pkg, 1)).status)
        return out, dict(tracker.counters), sorted(tracker.quarantined)

    got = run(transport, DeliveryTracker(quarantine_after=3))
    want = run(jtransport, jfaults.DeliveryTracker(quarantine_after=3))
    assert got == want
    statuses = {v[2] for v in got[0][:-1]}
    assert statuses == {"accept", "dup", "reject"} and 1 in got[2]
    assert tuple(got[1]) == DELIVERY_COUNTERS == jfaults.DELIVERY_COUNTERS


def test_payload_crc_of_bridged_deltas_equals_the_references():
    flat = {k: v.astype(np.float32) for k, v in _delta().items()}
    nested = _nested({k: jnp.asarray(v) for k, v in flat.items()})
    want = jtransport.payload_crc(FakeResult(nested))
    assert payload_crc(FakeResult({k: torch.from_numpy(v)
                                   for k, v in flat.items()})) == want
    assert payload_crc({k: torch.from_numpy(v) for k, v in flat.items()}) \
        == want == payload_crc(flat)
    # a bf16 leaf hashes its 16-bit pattern, as the reference's does
    half = {k: torch.from_numpy(v).to(torch.bfloat16)
            for k, v in flat.items()}
    jhalf = _nested({k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
                     for k, v in half.items()})
    assert payload_crc(half) == jtransport.payload_crc(jhalf)
    # the packed int8 round-trip's delta is one (R, 128) buffer
    buf = np.random.default_rng(1).normal(size=(16, 128)).astype(np.float32)
    assert payload_crc(FakeResult(Packed(torch.from_numpy(buf)))) == \
        jtransport.payload_crc(FakeResult(jpacking.Packed(jnp.asarray(buf))))
    assert payload_crc(flat) != payload_crc(
        {**flat, "embed/tok": flat["embed/tok"] + 1})


class ScriptedWaiter:
    """An ack mailbox that answers the ``answer_at``-th wait (0-based), and
    records every timeout it is given."""

    def __init__(self, answer_at, closed_at=None):
        self.answer_at, self.closed_at = answer_at, closed_at
        self.timeouts = []
        self.closed = False

    def wait_for(self, env, timeout):
        self.timeouts.append(timeout)
        n = len(self.timeouts) - 1
        if n == self.closed_at:
            self.closed = True
            return None
        if n == self.answer_at:
            return (env.wid, env.generation, env.seq)
        return None


@pytest.mark.parametrize("answer_at, closed_at, with_spec",
                         [(0, None, True), (4, None, True), (3, None, False),
                          (9, 2, True)])
def test_reliable_sender_resends_as_the_references(answer_at, closed_at,
                                                   with_spec):
    spec = dict(ack_timeout=0.25, max_backoff=2.0, seed=5)

    def run(pkg):
        tr = pkg.InProcTransport(capacity=64)
        retries = []
        spec_obj = ((jfaults.FaultSpec if pkg is jtransport else FaultSpec)
                    (**spec) if with_spec else None)
        sender = pkg.ReliableSender(tr, spec=spec_obj, default_timeout=5.0,
                                    on_retry=lambda e, a: retries.append(a))
        waiter = ScriptedWaiter(answer_at, closed_at)
        ok = sender.send(_env(pkg, 3, wid=2), waiter)
        sent = []
        while tr.depth():
            env = tr.recv(timeout=0)
            sent.append((env.wid, env.seq, env.attempt, env.crc))
        return ok, waiter.timeouts, retries, sent

    got, want = run(transport), run(jtransport)
    assert got == want
    assert got[0] == (closed_at is None)
    assert len(got[3]) == min(answer_at, 9 if closed_at is None
                              else closed_at) + 1


def test_param_digest_and_fingerprint_of_bridged_params_equal_the_references():
    flat = {k: v.astype(np.float32) for k, v in _delta(3).items()}
    nested = _nested({k: jnp.asarray(v) for k, v in flat.items()})
    port = {k: torch.from_numpy(v) for k, v in flat.items()}
    assert trace.param_digest(port) == jtrace.param_digest(nested)
    assert trace.param_fingerprint(port) == jtrace.param_fingerprint(nested)
    assert list(trace.param_fingerprint(port)) == [
        jax.tree_util.keystr(p) for p, _ in sorted(
            jax.tree_util.tree_flatten_with_path(nested)[0],
            key=lambda kv: jax.tree_util.keystr(kv[0]))]
    # tamper with a copy: jnp.asarray may alias the numpy buffer on the CPU
    port["final_norm/scale"] = port["final_norm/scale"].clone()
    port["final_norm/scale"][0] += 1.0
    assert trace.param_digest(port) != jtrace.param_digest(nested)


# ---------------------------------------------------------------------------
# The reference's transport cases on the port's InProcTransport
# ---------------------------------------------------------------------------

def test_transport_backpressure_blocks_and_loses_nothing():
    tr = InProcTransport(capacity=2)
    n, high_water = 25, []

    def producer():
        for i in range(n):
            tr.send(i)
            high_water.append(tr.depth())

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.2)                      # let the producer hit the wall
    assert tr.depth() == 2 and t.is_alive()
    got = [tr.recv(timeout=5.0) for _ in range(n)]
    t.join(timeout=5.0)
    assert got == list(range(n)) and max(high_water) <= 2


def test_transport_close_wakes_blocked_sender_and_receiver():
    tr = InProcTransport(capacity=1)
    tr.send(0)
    errs = []

    def blocked_send():
        try:
            tr.send(1)
        except TransportClosed as e:
            errs.append(e)

    def blocked_recv(other):
        try:
            other.recv(timeout=10.0)
        except TransportClosed as e:
            errs.append(e)

    empty = InProcTransport(capacity=1)
    threads = [threading.Thread(target=blocked_send, daemon=True),
               threading.Thread(target=blocked_recv, args=(empty,),
                                daemon=True)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    tr.close()
    empty.close()
    for t in threads:
        t.join(timeout=5.0)
    assert len(errs) == 2
    assert tr.recv(timeout=1.0) == 0     # close still drains queued msgs
    with pytest.raises(TransportClosed):
        tr.recv(timeout=1.0)
    with pytest.raises(TransportClosed):
        empty.send(1)


@pytest.mark.parametrize("op", ["send", "recv"])
def test_transport_timeout_deadline_is_exact(op):
    tr = InProcTransport(capacity=1)
    if op == "send":
        tr.send(0)
    t0 = time.monotonic()
    with pytest.raises(TransportTimeout):
        tr.send(1, timeout=0.2) if op == "send" else tr.recv(timeout=0.2)
    assert 0.18 <= time.monotonic() - t0 < 0.6
    assert tr.depth() == (1 if op == "send" else 0)


# ---------------------------------------------------------------------------
# The reference's protocol cases on the port's classes
# ---------------------------------------------------------------------------

def test_fault_dice_deterministic_rate_and_fresh_per_attempt():
    a = FaultSpec(drop_p=0.3, seed=1)
    da = [a.drops(*k) for k in GRID]
    assert da == [FaultSpec(drop_p=0.3, seed=1).drops(*k) for k in GRID]
    assert 0.25 < sum(da) / len(da) < 0.35
    assert any(a.drops(w, s, 0) != a.drops(w, s, 1)
               for w in range(4) for s in range(50))
    assert da != [FaultSpec(drop_p=0.3, seed=2).drops(*k) for k in GRID]
    js = [a.retry_jitter(*k) for k in GRID]
    assert all(0.0 <= j < 0.25 for j in js) and len(set(js)) > 50


def test_partition_spec_covers_and_needs_a_clock():
    p = PartitionSpec(start=1.0, end=2.0, wids=(1, 3))
    assert p.covers(1, 1.5) and p.covers(3, 1.0)
    assert not p.covers(2, 1.5) and not p.covers(1, 2.0)
    assert PartitionSpec(start=0.0, end=1.0).covers(7, 0.5)
    spec = FaultSpec(partitions=(PartitionSpec(0.0, 1.0),))
    with pytest.raises(ValueError):
        FaultyTransport(InProcTransport(4), spec)
    t = [0.5]
    tr = FaultyTransport(InProcTransport(4), spec, clock=lambda: t[0])
    tr.send(_env(transport, 1))
    assert tr.counters["partition_drops"] == 1
    t[0] = 2.0                                    # the window is over
    tr.send(_env(transport, 1, attempt=1))
    assert tr.recv(timeout=0.5).seq == 1


def test_faulty_transport_reorder_swaps_and_close_flushes():
    inner = InProcTransport(capacity=16)
    tr = FaultyTransport(inner, FaultSpec(reorder_p=1.0, seed=0))
    tr.send(_env(transport, 1))                   # shelved
    assert inner.depth() == 0
    tr.send(_env(transport, 2))                   # releases the shelf after
    assert [tr.recv(timeout=0.5).seq for _ in range(2)] == [2, 1]
    tr.send(_env(transport, 3))                   # shelved again
    tr.close()                                    # flush: the frame lands
    assert tr.counters["injected_reorders"] == 2
    assert inner.recv(timeout=0.5).seq == 3


def test_faulty_transport_corrupts_a_copy_not_the_senders_frame():
    tr = FaultyTransport(InProcTransport(16),
                         FaultSpec(corrupt_p=1.0, seed=0))
    env = _env(transport, 1)
    tr.send(env)
    wire = tr.recv(timeout=0.5)
    assert wire.crc != env.crc and env.crc == payload_crc(env.payload)
    v = DeliveryTracker().process(wire)
    assert v.status == "reject" and not v.ack     # no ack: the sender resends
    tr.send(_env(transport, 2, kind=KIND_HEARTBEAT))
    hb = tr.recv(timeout=0.5)                     # beacons are never corrupted
    assert hb.kind == KIND_HEARTBEAT and hb.crc == payload_crc(hb.payload)


def test_tracker_dedup_quarantine_and_streak_reset():
    tr = DeliveryTracker(quarantine_after=3)
    assert tr.process(_env(transport, 2)).status == "accept"
    assert tr.process(_env(transport, 1)).status == "dup"   # late copy
    assert tr.process(_env(transport, 3, gen=1)).status == "accept"
    assert tr.process(_env(transport, 3, gen=0)).status == "dup"
    bad = lambda seq: dataclasses.replace(_env(transport, seq, wid=4),
                                          crc=1)
    assert tr.process(bad(1)).status == "reject"
    assert tr.process(_env(transport, 1, wid=4)).status == "accept"
    assert [tr.process(bad(s)).quarantine for s in (2, 3, 4)] == \
        [False, False, True]
    v = tr.process(_env(transport, 5, wid=4))
    assert (v.status, v.ack, v.quarantine) == ("reject", True, True)
    assert tr.quarantined == {4} and tr.counters["quarantines"] == 1
    assert tr.counters["checksum_rejects"] == 4


def test_ack_waiter_matches_discards_and_closes():
    w = AckWaiter()
    env = _env(transport, 5)
    w.put(Ack(wid=0, generation=0, seq=4))        # stale: discarded
    w.put(Ack(wid=0, generation=0, seq=5))
    assert w.wait_for(env, timeout=0.5).seq == 5
    assert w.wait_for(env, timeout=0.05) is None and not w.closed
    w.close()
    assert w.wait_for(env, timeout=0.05) is None and w.closed


def test_scenario_faults_materialize_and_round_trip():
    from repro_torch.scenarios.spec import Scenario
    scn = Scenario(name="t", engine="wallclock",
                   faults=FaultSpec(drop_p=0.2, seed=7))
    assert Scenario.from_dict(json.loads(json.dumps(scn.to_dict()))) == scn
    m = scn.materialize()
    assert m.engine_kw == {"mode": "deterministic", "pace_scale": 0.0,
                           "faults": scn.faults}
    assert Scenario(name="t").materialize().engine_kw == {}
    assert faults.FaultSpec is FaultSpec
