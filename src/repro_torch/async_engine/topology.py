"""Decentralized exchange topologies: NoLoCo-style ring / gossip mixing.

Port of ``repro/async_engine/topology.py``. The hub ``Synchronizer`` applies
every pseudo-gradient to one shared outer state. NoLoCo (arXiv 2506.10911)
removes the hub: each worker keeps its own replica, applies its own outer
step locally, and then averages parameters and outer momentum with one
sampled peer. ``PeerMixer`` does that exchange behind the ``Synchronizer``
surface the engine uses (``worker_init`` / ``on_arrival`` / ``state`` /
``t`` / ``set_n_workers`` and the commit buffer).

Peer sampling is a pure function of ``(seed, outer_step, wid)`` over the
sorted replica set (the splitmix64 dice of ``faults.py``), so a run is
exactly replayable:

  ring    each arrival averages with the next live wid in sorted cyclic
          order (a directed ring);
  gossip  each arrival averages with a uniformly hashed random peer.

Per-replica outer update (the ``nesterov`` outer method's flavour), in
fp32 on the engine's device:

  m_i <- mu * m_i + Delta_i
  p_i <- p_i - eta * (Delta_i + mu * m_i)
  (p_i, m_i), (p_j, m_j) <- pairwise mean (x + y) * 0.5 with the peer j

The ``state`` view (evals) is the mean over replicas in sorted wid order,
``sum(xs) / n``, made on demand and cached between arrivals; its setter
resets every replica to the given state. A stale-dropped arrival
(``drop_stale_after``) skips both the local step and the mix. The
reference computes all of this outside any kernel, so no kernel launches
here either.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.async_engine.faults import _unit
from repro_torch.async_engine.server import ArrivalRecord
from repro_torch.configs.base import OuterOptConfig
from repro_torch.core import methods as outer_methods
from repro_torch.core import packing
from repro_torch.core.heloco import OuterState

Params = Dict[str, torch.Tensor]

TOPOLOGIES = ("hub", "ring", "gossip")

_S_PEER = 101                        # splitmix64 stream salt for peer dice


def _mean(reps: List[Params]) -> Params:
    """The replicas' mean, leaf by leaf: summed in order, then one IEEE
    division by the count."""
    n = float(len(reps))
    return {k: packing.true_div(sum(r[k] for r in reps), n) for k in reps[0]}


def _zeros(params: Mapping[str, torch.Tensor]) -> Params:
    return {k: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for k, x in params.items()}


class PeerMixer:
    """Hub-less synchronizer: per-worker replicas and pairwise peer
    averaging, with the ``Synchronizer`` surface the engine uses."""

    #: the engine reads these to pick its commit path
    packed = False
    layout = None
    telemetry = False

    def __init__(self, init_params: Mapping[str, torch.Tensor],
                 cfg: OuterOptConfig, n_workers: int, *,
                 kind: str = "gossip", seed: int = 0):
        if kind not in ("ring", "gossip"):
            raise ValueError(f"topology {kind!r}")
        self.cfg = cfg
        self.kind = kind
        self.seed = seed
        self.method = outer_methods.resolve(cfg.method)
        if self.method.sync:
            raise ValueError("decentralized topologies have no barrier; "
                             "use an async method")
        self.n_workers = n_workers
        self.records: List[ArrivalRecord] = []
        self._committed: Dict[Any, ArrivalRecord] = {}
        self._pending_buf: List[tuple] = []
        self._init_params = dict(init_params)
        self._p: Dict[int, Params] = {}          # wid -> replica params
        self._m: Dict[int, Params] = {}          # wid -> replica momentum
        self._t = 0
        self._mean_cache: Optional[OuterState] = None
        # the step's scalars in fp32, as the reference's jitted fp32 math
        self._lr = float(np.float32(cfg.outer_lr))
        self._mu = float(np.float32(cfg.momentum))

    def _local(self, p: Params, m: Params, delta: Params):
        """One Nesterov step on a replica: new (p, m) dicts."""
        m2 = {k: self._mu * mm + delta[k].float() for k, mm in m.items()}
        p2 = {k: pp - self._lr * (delta[k].float() + self._mu * m2[k])
              for k, pp in p.items()}
        return p2, m2

    @staticmethod
    def _mix(a: Params, b: Params) -> Params:
        return {k: (x + b[k]) * 0.5 for k, x in a.items()}

    # -- replica management ---------------------------------------------------
    def _ensure_replica(self, wid: int):
        if wid not in self._p:
            # a replica born mid-run (elastic join) starts from the current
            # global mean, as a worker of the hub would
            self._p[wid] = (self._mean_params() if self._p
                            else self._init_params)
            self._m[wid] = _zeros(self._p[wid])
            self._mean_cache = None

    def worker_init(self, wid: Optional[int] = None) -> Params:
        if wid is None:
            return self.state.params
        self._ensure_replica(wid)
        return self._p[wid]

    # -- peer sampling (deterministic in (seed, t, wid)) -----------------------
    def _pick_peer(self, wid: int) -> Optional[int]:
        others = sorted(w for w in self._p if w != wid)
        if not others:
            return None
        if self.kind == "ring":
            nxt = [w for w in others if w > wid]
            return nxt[0] if nxt else others[0]
        idx = int(_unit(self.seed, _S_PEER, self._t, wid) * len(others))
        return others[min(idx, len(others) - 1)]

    # -- state view (mean over replicas) ---------------------------------------
    def _mean_params(self) -> Params:
        return _mean([self._p[w] for w in sorted(self._p)])

    @property
    def state(self) -> OuterState:
        if self._mean_cache is None:
            if not self._p:
                params = self._init_params
                mom = _zeros(params)
            else:
                params = self._mean_params()
                mom = _mean([self._m[w] for w in sorted(self._m)])
            self._mean_cache = OuterState(params=params, momentum=mom,
                                          step=self._t, aux=None)
        return self._mean_cache

    @state.setter
    def state(self, value: OuterState):
        # restore semantics: every replica resets to the given state
        self._init_params = dict(value.params)
        for wid in self._p:
            self._p[wid] = dict(value.params)
            self._m[wid] = dict(value.momentum)
        self._t = int(value.step)
        self._mean_cache = None

    @property
    def t(self) -> int:
        return self._t

    # -- arrival processing -----------------------------------------------------
    def on_arrival(self, delta: Mapping[str, torch.Tensor], s_i: int,
                   worker_id: int, sim_time: float = 0.0, lang: str = "",
                   commit_key=None) -> ArrivalRecord:
        if commit_key is not None:
            prior = self._committed.get(commit_key)
            if prior is not None:
                return prior
        self._ensure_replica(worker_id)
        tau = self._t - s_i
        dropped = (self.cfg.drop_stale_after is not None
                   and tau > self.cfg.drop_stale_after)
        if not dropped:
            if isinstance(delta, packing.Packed):
                raise TypeError("a replica takes a dict of leaves, not a "
                                "packed buffer")
            p2, m2 = self._local(self._p[worker_id], self._m[worker_id],
                                 delta)
            peer = self._pick_peer(worker_id)
            if peer is not None:
                p2 = self._mix(p2, self._p[peer])
                m2 = self._mix(m2, self._m[peer])
                self._p[peer], self._m[peer] = p2, m2
            self._p[worker_id], self._m[worker_id] = p2, m2
        self._t += 1
        self._mean_cache = None
        rec = ArrivalRecord(outer_step=self._t, worker_id=worker_id,
                            staleness=tau, rho=1.0, sim_time=sim_time,
                            lang=lang, dropped=dropped)
        self.records.append(rec)
        if commit_key is not None:
            self._committed[commit_key] = rec
        return rec

    # -- batched arrival surface -------------------------------------------------
    # Peer mixing is order-dependent (each commit rewrites two replicas), so
    # there is no fused multi-apply: the commit buffer keeps the exact
    # sequential semantics, and the engine's batched loop stays
    # topology-agnostic.
    @property
    def pending(self) -> int:
        return len(self._pending_buf)

    def buffer_arrival(self, delta, s_i: int, worker_id: int,
                       sim_time: float = 0.0, lang: str = "",
                       commit_key=None) -> Optional[List[ArrivalRecord]]:
        self._pending_buf.append((delta, s_i, worker_id, sim_time, lang,
                                  commit_key))
        return None

    def flush(self, reason: str = "batch-full") -> List[ArrivalRecord]:
        """Commit the buffered arrivals in order (``reason`` is the engine's
        label of the flush; nothing here reads it)."""
        pending, self._pending_buf = self._pending_buf, []
        return [self.on_arrival(*args) for args in pending]

    def on_sync_round(self, deltas, sim_time: float = 0.0):
        raise RuntimeError("decentralized topologies have no sync barrier")

    def set_n_workers(self, n: int):
        self.n_workers = n
