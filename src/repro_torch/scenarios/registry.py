"""Named scenario registry: the enumerable form of the paper's claim grid.

A copy, as data, of the reference's ``repro/scenarios/registry.py``: the
same 25 scenarios, field for field (a test holds the two equal, and each
equal to its committed golden's ``scenario`` dict). Each has a committed
golden trace under ``results/golden/<name>.json``; ``python -m
repro_torch.scenarios verify NAME`` holds a port run to it. The port
builds every one of them: the simulator's, on the hub or a ring or gossip
topology, and the wall-clock runtime's, threaded or over worker processes.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.async_engine.faults import FaultSpec, PartitionSpec
from repro_torch.scenarios.spec import ElasticSpec, FailureSpec, Scenario

_REGISTRY: Dict[str, Scenario] = {}


def register(scn: Scenario) -> Scenario:
    if scn.name in _REGISTRY:
        raise ValueError(f"duplicate scenario name: {scn.name!r}")
    _REGISTRY[scn.name] = scn
    return scn


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{', '.join(names())}") from None


def names() -> List[str]:
    return list(_REGISTRY)


def all_scenarios() -> List[Scenario]:
    return list(_REGISTRY.values())


# ---------------------------------------------------------------------------
# The registered grid. Tiny smoke-model budgets: each scenario is a full
# training run that must stay cheap enough to verify on every CI push.
# ---------------------------------------------------------------------------

register(Scenario(
    name="paper_hetero_severe",
    description="Severe device heterogeneity: the paper's (1, 2, 6, 15) "
                "pace profile, non-IID fixed shards, async HeLoCo.",
    n_workers=4, worker_paces=(1.0, 2.0, 6.0, 15.0),
    outer_steps=12, inner_steps=2))

register(Scenario(
    name="noniid_dirichlet",
    description="Dirichlet(0.3) per-worker language mixtures instead of "
                "one-shard-per-worker: the soft non-IID axis.",
    n_workers=5, worker_paces=(1.0, 1.0, 2.0, 6.0, 6.0),
    mixture_alpha=0.3, outer_steps=12, inner_steps=2, seed=1))

register(Scenario(
    name="crash_rejoin",
    description="Fault tolerance: worker 0 crashes mid-round at t=5 "
                "(in-flight round lost) and rejoins at t=15.",
    n_workers=3, worker_paces=(1.0, 2.0, 6.0),
    outer_steps=12, inner_steps=2,
    failures=(FailureSpec(time=5.0, wid=0, restart_delay=10.0),)))

register(Scenario(
    name="elastic_membership",
    description="Elastic membership: worker 7 joins at t=4, worker 2 "
                "leaves at t=20 (its in-flight round is discarded).",
    n_workers=3, worker_paces=(1.0, 2.0, 6.0),
    outer_steps=12, inner_steps=2,
    elastic=(ElasticSpec(time=4.0, action="join", wid=7, pace=1.0, lang=1),
             ElasticSpec(time=20.0, action="leave", wid=2))))

register(Scenario(
    name="int8_dylu",
    description="Communication efficiency: int8 pseudo-gradient "
                "compression with error feedback + Dynamic Local Updates.",
    n_workers=3, worker_paces=(1.0, 2.0, 6.0),
    outer_steps=8, inner_steps=4, dylu=True, compression="int8"))

register(Scenario(
    name="drop_stale",
    description="Staleness regime (App. A.6): arrivals with tau > 2 "
                "dropped (momentum-decay-only step), delay weighting on.",
    n_workers=4, worker_paces=(1.0, 1.0, 6.0, 15.0),
    outer_steps=12, inner_steps=2,
    drop_stale_after=2, delay_weighting=True))

register(Scenario(
    name="flexible_shards",
    description="Flexible shard assignment: each round trains the "
                "least-served language (App. A.6).",
    n_workers=4, worker_paces=(1.0, 1.0, 2.0, 6.0),
    outer_steps=12, inner_steps=2, shard_assignment="flexible"))

register(Scenario(
    name="delayed_nesterov",
    description="Delayed-Nesterov baseline (Liu et al. 2024): buffered "
                "pseudo-gradients, momentum refresh every N arrivals.",
    n_workers=4, worker_paces=(1.0, 2.0, 6.0, 15.0),
    outer_steps=12, inner_steps=2, method="delayed_nesterov"))

register(Scenario(
    name="dcasgd",
    description="DC-ASGD-style delay compensation: stale pseudo-gradients "
                "Taylor-corrected along the momentum, scaled by tau.",
    n_workers=4, worker_paces=(1.0, 1.0, 6.0, 15.0),
    outer_steps=12, inner_steps=2, method="dcasgd"))

register(Scenario(
    name="fedbuff",
    description="FedBuff-style buffered aggregation baseline: the server "
                "averages every K=4 arrivals into one outer step.",
    n_workers=4, worker_paces=(1.0, 2.0, 6.0, 15.0),
    outer_steps=12, inner_steps=2, method="fedbuff"))

register(Scenario(
    name="poly_stale",
    description="Polynomial staleness weighting baseline: pseudo-"
                "gradients damped by (1+tau)^-alpha before the outer "
                "step.",
    n_workers=4, worker_paces=(1.0, 1.0, 6.0, 15.0),
    outer_steps=12, inner_steps=2, method="poly_stale"))

register(Scenario(
    name="sync_baseline",
    description="Synchronous DiLoCo/Nesterov barrier baseline: the "
                "slowest worker gates every round.",
    n_workers=3, worker_paces=(1.0, 2.0, 6.0),
    outer_steps=4, inner_steps=2, method="sync_nesterov"))

register(Scenario(
    name="wallclock_hetero",
    description="Deterministic wall-clock runtime (threaded workers, "
                "FIFO-forced commits): trace-identical to the simulator.",
    engine="wallclock", mode="deterministic",
    n_workers=4, worker_paces=(1.0, 2.0, 6.0, 15.0),
    outer_steps=10, inner_steps=2))

register(Scenario(
    name="delayed_nesterov_wallclock",
    description="Delayed-Nesterov on the deterministic wall-clock "
                "runtime: the buffered schedule commits trace-identically "
                "to the simulator.",
    engine="wallclock", mode="deterministic", method="delayed_nesterov",
    n_workers=4, worker_paces=(1.0, 2.0, 6.0, 15.0),
    outer_steps=10, inner_steps=2))

register(Scenario(
    name="fedbuff_wallclock",
    description="FedBuff buffered aggregation on the deterministic "
                "wall-clock runtime: the K-arrival boundary schedule "
                "commits trace-identically to the simulator.",
    engine="wallclock", mode="deterministic", method="fedbuff",
    n_workers=4, worker_paces=(1.0, 2.0, 6.0, 15.0),
    outer_steps=10, inner_steps=2))

register(Scenario(
    name="dcasgd_wallclock",
    description="DC-ASGD delay compensation on the deterministic "
                "wall-clock runtime (threaded workers, FIFO-forced "
                "commits).",
    engine="wallclock", mode="deterministic", method="dcasgd",
    n_workers=4, worker_paces=(1.0, 1.0, 6.0, 15.0),
    outer_steps=10, inner_steps=2))

register(Scenario(
    name="wallclock_free",
    description="Free-running wall-clock runtime: true arrival order "
                "with pace-scaled throttling; tolerance-banded golden.",
    engine="wallclock", mode="free", pace_scale=0.02,
    n_workers=4, worker_paces=(1.0, 1.0, 2.0, 6.0),
    outer_steps=10, inner_steps=1))

# -- chaos: unreliable delivery (docs/faults.md) ----------------------------
# chaos_lossy / chaos_corrupt share wallclock_hetero's exact run config:
# with at-least-once retries and idempotent commit, a deterministic-mode
# run under drop/dup/reorder (or corruption) commits the IDENTICAL history
# — their golden param digests must equal wallclock_hetero's.

register(Scenario(
    name="chaos_lossy",
    description="wallclock_hetero under a lossy channel: 20% drop, 10% "
                "duplicate, 20% reorder, delays and lost acks — the "
                "delivery layer makes the committed history (and the "
                "final param digest) identical to the fault-free twin.",
    engine="wallclock", mode="deterministic",
    n_workers=4, worker_paces=(1.0, 2.0, 6.0, 15.0),
    outer_steps=10, inner_steps=2,
    faults=FaultSpec(drop_p=0.2, dup_p=0.1, reorder_p=0.2,
                     delay_p=0.1, delay_s=0.01, ack_drop_p=0.05, seed=7)))

register(Scenario(
    name="chaos_corrupt",
    description="wallclock_hetero under payload corruption: 25% of frames "
                "arrive checksum-broken and are rejected (never folded "
                "into outer state); retries redeliver clean copies, so "
                "the digest still matches the fault-free twin.",
    engine="wallclock", mode="deterministic",
    n_workers=4, worker_paces=(1.0, 2.0, 6.0, 15.0),
    outer_steps=10, inner_steps=2,
    faults=FaultSpec(corrupt_p=0.25, ack_drop_p=0.1, seed=11)))

# -- topology: decentralized NoLoCo-style mixing (docs/topologies.md) -------

register(Scenario(
    name="gossip_ring",
    description="Decentralized ring topology: each arrival applies a "
                "local Nesterov step on the worker's own replica and "
                "averages with the next worker in the ring — no hub, "
                "O(1) communication per round.",
    n_workers=4, worker_paces=(1.0, 2.0, 6.0, 15.0),
    outer_steps=12, inner_steps=2, method="nesterov", topology="ring"))

register(Scenario(
    name="gossip_random",
    description="Decentralized gossip topology: peer sampled by a "
                "deterministic hash of (seed, outer_step, wid) — the "
                "NoLoCo-style random pairwise average, exactly "
                "replayable across engines and process boundaries.",
    n_workers=4, worker_paces=(1.0, 2.0, 6.0, 15.0),
    outer_steps=12, inner_steps=2, method="nesterov", topology="gossip"))

# -- transport: the multi-process socket backend ----------------------------

register(Scenario(
    name="socket_hetero",
    description="wallclock_hetero over the multi-process socket backend: "
                "real worker processes, socket rendezvous, length-"
                "prefixed Envelope frames — trace-identical to the "
                "threaded twin (and the simulator).",
    engine="wallclock", mode="deterministic", transport="socket",
    n_workers=4, worker_paces=(1.0, 2.0, 6.0, 15.0),
    outer_steps=10, inner_steps=2))

# -- scale: batched-arrival fast path (docs/scale.md) -----------------------
# Small-N golden cells for the O(10k)-worker machinery: the bench grid
# (benchmarks/bench_scale.py) exercises N in {64, 1k, 10k}; these keep the
# coalesced-commit semantics pinned under CI-sized budgets.

register(Scenario(
    name="hogwild_rampup",
    description="Hogwild-style batch ramp-up (arXiv 2010.14763): per-round "
                "mini-batch grows linearly 2->8 across the run while the "
                "server coalesces up to 4 same-tick arrivals per fused "
                "commit (commit_batch=4).",
    n_workers=8, worker_paces=(1.0, 1.0, 2.0, 6.0),
    outer_steps=12, inner_steps=2,
    commit_batch=4, batch_rampup=8))

register(Scenario(
    name="trace_paced",
    description="Worker speeds and churn replayed from a committed trace "
                "file (results/traces/straggler_n8.json): pace schedule, "
                "one crash/rejoin and one elastic join, committed through "
                "the batched fast path (commit_batch=4).",
    n_workers=8, outer_steps=12, inner_steps=2,
    commit_batch=4, pace_trace="straggler_n8.json"))

register(Scenario(
    name="chaos_partition",
    description="Free-running runtime with a network partition: worker 3 "
                "is black-holed from t=2 on the virtual clock, heartbeats "
                "stop, the liveness monitor routes it through the crash "
                "machinery, and the survivors finish the run "
                "(tolerance-banded golden).",
    engine="wallclock", mode="free", pace_scale=0.02,
    n_workers=4, worker_paces=(1.0, 1.0, 2.0, 6.0),
    outer_steps=10, inner_steps=1,
    faults=FaultSpec(drop_p=0.05, seed=13,
                     partitions=(PartitionSpec(start=2.0, end=1e9,
                                               wids=(3,)),),
                     heartbeat_interval=0.05, liveness_misses=3)))
