"""The port's decentralized topologies (ROADMAP A14) against the reference's.

  * the splitmix64 dice (``faults._splitmix64``, ``_unit``) equal the
    reference's bit for bit over a grid of seeds and keys;
  * ``PeerMixer`` (ring and gossip, with a stale drop and a replica born
    mid-run) after every arrival: every replica's params and momentum and
    the replica-mean ``state`` within 1e-6 of the reference's (the local
    step's multiply-adds may round once in XLA, twice here), the same
    peers, records equal; the ``state`` setter resets every replica;
  * ``gossip_ring`` and ``gossip_random`` against a live reference run from
    the same bits under tests/test_torch_methods.py's ``check_live`` (their
    goldens are held in tests/test_torch_scenarios.py), and the launcher's
    ``--topology`` flag rebuilding ``gossip_ring``'s golden.
"""
import numpy as np
import pytest
import torch

from repro.async_engine import faults as jfaults
from repro.async_engine.topology import PeerMixer as JaxPeerMixer
from repro.configs.base import OuterOptConfig as JaxOuterOptConfig
from repro_torch import bridge
from repro_torch.async_engine import faults, topology
from repro_torch.async_engine.topology import PeerMixer
from repro_torch.configs.base import OuterOptConfig
from repro_torch.core.heloco import OuterState
from repro_torch.launch import train
from repro_torch.scenarios import run
from test_torch_methods import _live, check_live, one_intra_op_thread  # noqa: F401
from test_torch_server import _flat, _tree

TOL = dict(rtol=0, atol=1e-6)
# (s_i, wid) per arrival: wid 3 first arrives at t = 4 (a replica born from
# the mean); with drop_stale_after=3 the arrival at t = 7 (staleness 4) drops
SCHEDULE = [(0, 0), (0, 1), (1, 0), (0, 2), (2, 3), (3, 1), (5, 0), (3, 2),
            (7, 3), (8, 1)]


def test_dice_equal_the_reference_bit_for_bit():
    keys = [0, 1, 2, 101, 7, 2**32 + 5, 2**63, 2**64 - 1, -1, -12345]
    for x in keys:
        assert faults._splitmix64(x & faults._MASK) == \
            jfaults._splitmix64(x & jfaults._MASK)
    for seed in (0, 1, 3, 2**40 + 17, -7):
        for a in keys[:6]:
            for b in keys:
                assert faults._unit(seed, a, b) == jfaults._unit(seed, a, b)
                assert faults._unit(seed, topology._S_PEER, a, b) == \
                    jfaults._unit(seed, 101, a, b)
    assert faults._unit(0) == jfaults._unit(0) == 0.0
    assert topology.TOPOLOGIES == ("hub", "ring", "gossip")


def _close_tree(got, want_tree):
    want = _flat(want_tree)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, err_msg=k, **TOL)


@pytest.mark.parametrize("kind", ["ring", "gossip"])
def test_peer_mixer_matches_reference_after_every_arrival(kind):
    rng = np.random.default_rng(4)
    init = _tree(rng)
    cfg = dict(method="nesterov", drop_stale_after=3)
    ref = JaxPeerMixer(init, JaxOuterOptConfig(**cfg), 4, kind=kind, seed=3)
    ours = PeerMixer(bridge.to_torch(_flat(init), "cpu"),
                     OuterOptConfig(**cfg), 4, kind=kind, seed=3)
    for wid in range(3):                   # the engine's first dispatches
        _close_tree(ours.worker_init(wid), ref.worker_init(wid))
    for s_i, wid in SCHEDULE:
        if wid not in ours._p:             # a replica born from the mean
            _close_tree(ours.worker_init(wid), ref.worker_init(wid))
        assert ours._pick_peer(wid) == ref._pick_peer(wid)
        delta = _tree(rng, 0.05)
        want = ref.on_arrival(delta, s_i, wid, sim_time=1.0, lang="de")
        got = ours.on_arrival(bridge.to_torch(_flat(delta), "cpu"), s_i, wid,
                              sim_time=1.0, lang="de")
        assert got.__dict__ == want.__dict__
        assert sorted(ours._p) == sorted(ref._p) and ours.t == ref.t
        for w in ours._p:
            _close_tree(ours._p[w], ref._p[w])
            _close_tree(ours._m[w], ref._m[w])
        _close_tree(ours.state.params, ref.state.params)
        _close_tree(ours.state.momentum, ref.state.momentum)
        assert ours.state.step == int(ref.state.step)
    assert [r.dropped for r in ours.records] == \
        [False] * 7 + [True] + [False] * 2
    # the setter resets every replica to the given state
    st = ours.state
    ours.state = OuterState(st.params, st.momentum, 3)
    assert ours.t == 3
    for w in ours._p:
        assert all(torch.equal(ours._p[w][k], st.params[k]) for k in st.params)
    with pytest.raises(RuntimeError, match="barrier"):
        ours.on_sync_round([])


def test_peer_mixer_commit_buffer_is_sequential():
    init = bridge.to_torch(_flat(_tree(np.random.default_rng(8))), "cpu")
    a = PeerMixer(init, OuterOptConfig(method="nesterov"), 3, kind="gossip")
    b = PeerMixer(init, OuterOptConfig(method="nesterov"), 3, kind="gossip")
    rng = np.random.default_rng(9)
    deltas = [bridge.to_torch(_flat(_tree(rng, 0.05)), "cpu")
              for _ in range(3)]
    for j, d in enumerate(deltas):
        assert a.buffer_arrival(d, 0, j) is None
    assert a.pending == 3
    recs = a.flush("close")
    assert [r.__dict__ for r in recs] == \
        [b.on_arrival(d, 0, j).__dict__ for j, d in enumerate(deltas)]
    for w in b._p:
        assert all(torch.equal(a._p[w][k], b._p[w][k]) for k in b._p[w])


@pytest.mark.parametrize("name", ["gossip_ring", "gossip_random"])
def test_live_gossip_from_the_same_bits(name):
    jeng, jhist, eng, hist = _live(name)
    assert isinstance(eng.server, PeerMixer)
    assert run.arrival_rows(hist) == run.load_golden(name)["arrivals"]
    check_live(jeng, jhist, eng, hist)


def test_launcher_topology_flag_reproduces_the_golden():
    hist = train.main(["--smoke", "--workers", "4", "--paces", "1,2,6,15",
                       "--outer", "12", "--inner", "2", "--batch", "2",
                       "--seq", "16", "--method", "nesterov", "--topology",
                       "ring", "--device", "cpu"])
    golden = run.load_golden("gossip_ring")
    assert run.arrival_rows(hist) == golden["arrivals"]
    assert (hist.tokens, hist.final_time) == (golden["tokens"],
                                              golden["final_time"])
