"""Training launcher of the port, on the card unless ``--device cpu`` is
given.

Two ways to describe a run, as in ``repro/launch/train.py``:

  - ``--scenario NAME``: a registered ``repro_torch.scenarios`` spec
    (``--list-scenarios`` enumerates them); ``--full-width`` runs it at
    tinygpt-15m's own width with batch 4 x 128;
  - ad-hoc flags, compiled into an anonymous ``Scenario`` first, so both
    paths build the run the same way; ``--arch`` takes any dense, MoE,
    hybrid or ssm config (the sampler yields tokens, so no audio or vision
    one).

    PYTHONPATH=src python -m repro_torch.launch.train --scenario dcasgd \\
        --full-width
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinygpt-15m \\
        --workers 4 --paces 1,2,6,15 --outer 12 --inner 2 --batch 4 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --workers 3 \\
        --paces 1,2,6 --outer 8 --inner 4 --dylu --compression int8 \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --scenario fedbuff \\
        --commit-batch 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch xlstm-125m --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --scenario paper_hetero_severe --telemetry t.jsonl \\
        --stats-json s.json --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --workers 4 \\
        --paces 1,2,6,15 --outer 12 --inner 2 --batch 2 --seq 16 \\
        --method nesterov --topology gossip --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --scenario paper_hetero_severe --ckpt-dir ckpts --ckpt-every 6 \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --scenario paper_hetero_severe --ckpt-dir ckpts --resume --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --engine \\
        wallclock --workers 3 --paces 1,2,6 --outer 10 --inner 3 --batch 2 \\
        --seq 16 [--free --pace-scale 0.02] [--chaos] [--transport socket] \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --scenario \\
        wallclock_hetero --engine wallclock --transport socket --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --scenario paper_hetero_severe --trace t.json --telemetry t.jsonl \\
        --device cpu

``--telemetry PATH`` streams the run's records live to a JSONL file (the
reference's schema; a "runtime" record every ``--telemetry-every`` commits,
1 by default), ``--trace PATH`` writes the run's spans as Chrome
trace-event JSON (over worker processes the children's rows merged in;
``python -m repro_torch.obs trace --validate PATH`` checks it), and
``--stats-json PATH`` writes the run's summary. Over processes with any of
the three, a worker that never shipped an obs frame fails the run.
``--ckpt-dir DIR`` writes ``DIR/step_<t>.npz`` every ``--ckpt-every``
commits (the reference's format); with ``--resume`` the run starts from the
latest checkpoint there, if there is one. ``--engine wallclock`` runs the
threaded runtime (deterministic commit order, or ``--free`` with
``--pace-scale``; ``--chaos`` injects the lossy-channel preset;
``--transport socket`` runs each worker in a process of its own) and prints
its ``stats_summary()``, which ``--stats-json`` then writes.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

from repro_torch.async_engine.engine import make_eval_fn
from repro_torch.async_engine.faults import FaultSpec
from repro_torch.checkpoint import ckpt
from repro_torch.core import methods as outer_methods
from repro_torch.device import resolve_device
from repro_torch.obs.spans import SpanTracer
from repro_torch.scenarios import registry
from repro_torch.scenarios.spec import Scenario
from repro_torch.telemetry import TelemetryRecorder

# --full-width: the scenario at the model's own width, with the batch the
# card's smoke run uses (chip_smoke.py)
FULL_WIDTH = dict(smoke=False, batch_size=4, seq_len=128)


def chaos_faults(seed: int) -> FaultSpec:
    """The --chaos preset: chaos_lossy's lossy channel keyed off the run's
    seed."""
    return FaultSpec(drop_p=0.2, dup_p=0.1, reorder_p=0.2,
                     delay_p=0.1, delay_s=0.01, ack_drop_p=0.05,
                     seed=seed + 97)


def scenario_from_args(args) -> Scenario:
    """Compile the launcher's flag dialect into a Scenario; ``--outer-lr``
    is clamped by the method's ``outer_lr_cap``."""
    outer_lr = args.outer_lr
    cap = outer_methods.get(args.method).outer_lr_cap
    if outer_lr is not None and cap is not None:
        outer_lr = min(outer_lr, cap)
    return Scenario(
        name="cli",
        arch=args.arch, smoke=args.smoke,
        engine=args.engine,
        mode="free" if args.free else "deterministic",
        transport=args.transport,
        pace_scale=args.pace_scale,
        n_workers=args.workers,
        worker_paces=tuple(float(p) for p in args.paces.split(",")),
        inner_steps=args.inner, outer_steps=args.outer,
        batch_size=args.batch, seq_len=args.seq,
        non_iid=not args.iid, mixture_alpha=args.mixture_alpha,
        shard_assignment=args.shard_assignment, dylu=args.dylu,
        topology=args.topology,
        method=args.method, outer_lr=outer_lr, momentum=args.momentum,
        compression=args.compression,
        drop_stale_after=args.drop_stale_after,
        commit_batch=args.commit_batch,
        inner_lr=args.inner_lr, seed=args.seed,
        faults=chaos_faults(args.seed) if args.chaos else None)


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="",
                    help="run a registered scenario by name (overrides the "
                         "ad-hoc config flags)")
    ap.add_argument("--list-scenarios", action="store_true")
    ap.add_argument("--full-width", action="store_true",
                    help="with --scenario: the model's own width, batch "
                         "4 x 128")
    ap.add_argument("--arch", default="tinygpt-15m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--method", default="heloco",
                    choices=outer_methods.cli_names())
    ap.add_argument("--workers", type=int, default=5)
    ap.add_argument("--paces", default="1,1,1,1,1")
    ap.add_argument("--outer", type=int, default=50)
    ap.add_argument("--inner", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--mixture-alpha", type=float, default=None,
                    help="per-worker Dirichlet(alpha) language mixtures "
                         "instead of one shard per worker")
    ap.add_argument("--dylu", action="store_true",
                    help="Dynamic Local Updates: H scaled by the fastest "
                         "pace over the worker's")
    ap.add_argument("--outer-lr", type=float, default=None,
                    help="default: the method's paper value (Table 3)")
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--inner-lr", type=float, default=3e-3)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"],
                    help="pseudo-gradient compression, with error feedback")
    ap.add_argument("--drop-stale-after", type=int, default=None)
    ap.add_argument("--shard-assignment", default="fixed",
                    choices=["fixed", "flexible"])
    ap.add_argument("--commit-batch", type=int, default=1,
                    help="server commit-buffer size: >1 commits up to K "
                         "same-tick arrivals in one fused flush (also "
                         "overrides a --scenario's own)")
    ap.add_argument("--topology", default="hub",
                    choices=["hub", "ring", "gossip"],
                    help="exchange topology: hub-and-spoke server, or "
                         "decentralized NoLoCo-style ring/gossip peer "
                         "averaging (async methods only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="",
                    help="write a checkpoint of the outer state here")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="commits between checkpoints (with --ckpt-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="start from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--telemetry", default="", metavar="PATH",
                    help="stream per-arrival update-quality telemetry "
                         "(JSONL, the reference's schema) to this path, "
                         "written live (one flushed line per record)")
    ap.add_argument("--telemetry-every", type=int, default=None,
                    metavar="N",
                    help="a runtime-health telemetry record every N "
                         "commits (default 1 when --telemetry is set, "
                         "else the scenario's telemetry_every)")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="record the run's spans and write them as Chrome "
                         "trace-event JSON (Perfetto-loadable) to this path")
    ap.add_argument("--stats-json", default="", metavar="PATH",
                    help="write the run's summary (arrivals, tokens, "
                         "comm_bytes, mean staleness) as JSON at exit")
    ap.add_argument("--eval-every", type=int, default=None,
                    help="default: 10, or the scenario's golden-trace "
                         "cadence with --scenario")
    ap.add_argument("--engine", default="sim", choices=["sim", "wallclock"])
    ap.add_argument("--free", action="store_true",
                    help="wallclock engine: free-running arrival order "
                         "instead of the simulator's schedule")
    ap.add_argument("--pace-scale", type=float, default=0.0,
                    help="wallclock + free: wall seconds per virtual second "
                         "of worker pace (0: no throttling)")
    ap.add_argument("--transport", default="inproc",
                    choices=["inproc", "socket"],
                    help="wallclock engine backend: worker threads over the "
                         "in-process queue, or worker processes over the "
                         "socket transport")
    ap.add_argument("--chaos", action="store_true",
                    help="wallclock engine: inject chaos_lossy's lossy "
                         "channel (20%% drop, 10%% dup, 20%% reorder, "
                         "delays, lost acks), seeded by --seed + 97")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.chaos and args.engine != "wallclock":
        ap.error("--chaos needs --engine wallclock (the simulator has no "
                 "transport to inject faults into)")
    if args.transport == "socket" and args.engine != "wallclock":
        ap.error("--transport socket needs --engine wallclock (the "
                 "simulator has no worker processes)")
    return args


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if args.list_scenarios:
        for s in registry.all_scenarios():
            print(f"{s.name:28s} engine={s.engine}/{s.mode}  {s.description}")
        return None
    device = resolve_device(args.device)
    if args.scenario:
        scn = registry.get_scenario(args.scenario)
        if args.full_width:
            scn = scn.overridden(**FULL_WIDTH)
        if args.transport != "inproc" and scn.engine == "wallclock":
            scn = scn.overridden(transport=args.transport)
        if args.commit_batch > 1:
            scn = scn.overridden(commit_batch=args.commit_batch)
        print(f"scenario {scn.name}: {scn.description}")
    else:
        scn = scenario_from_args(args)
    eval_every = (args.eval_every if args.eval_every is not None
                  else (scn.eval_cadence if args.scenario else 10))
    recorder = (TelemetryRecorder(sink=args.telemetry) if args.telemetry
                else None)
    tracer = SpanTracer() if args.trace else None
    # runtime-health cadence: the flag, else on whenever telemetry is
    # streamed, else the scenario's own telemetry_every
    runtime_every = (args.telemetry_every
                     if args.telemetry_every is not None
                     else (1 if args.telemetry else None))
    eng = scn.build(device=device, telemetry=recorder, tracer=tracer,
                    runtime_record_every=runtime_every)
    if args.resume and args.ckpt_dir:
        latest = ckpt.latest(args.ckpt_dir)
        if latest:
            eng.restore(latest)
            print(f"resumed from {latest} (outer step {eng.server.t})")
    eval_fn = make_eval_fn(eng, batch=scn.eval_batch)
    t0 = time.perf_counter()
    hist = eng.run(eval_every=eval_every, eval_fn=eval_fn,
                   ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
                   ckpt_dir=args.ckpt_dir)
    wall = time.perf_counter() - t0
    for e in hist.evals:
        print(f"step {e['step']:5d}  t={e['time']:8.0f}s  "
              f"loss={e['mean']:.4f}")
    taus = [a["staleness"] for a in hist.arrivals] or [0]
    print(f"done: device={device} method={scn.method} "
          f"arrivals={len(hist.arrivals)} tokens={hist.tokens} "
          f"mean_staleness={sum(taus) / len(taus):.2f} "
          f"comm={hist.comm_bytes / 1e6:.1f}MB wall={wall:.2f}s")
    # over worker processes with any observability output asked for, a
    # child that never shipped an obs frame fails the run
    if ((args.trace or args.stats_json or args.telemetry)
            and hasattr(eng, "assert_child_reports")):
        eng.assert_child_reports()
    summary = None
    if hasattr(eng, "stats_summary"):
        summary = eng.stats_summary()
        print(f"runtime[{summary['mode']}]: "
              f"{summary['arrivals_per_sec']:.2f} arrivals/s "
              f"occupancy={summary['server_occupancy']:.2f} "
              f"parallelism={summary['compute_parallelism']:.2f} "
              f"overlap_max={summary['overlap_max']}")
        hot = {k: v for k, v in summary["delivery"].items() if v}
        if hot:
            print(f"delivery: {hot}")
    if args.stats_json:
        os.makedirs(os.path.dirname(args.stats_json) or ".", exist_ok=True)
        with open(args.stats_json, "w") as f:
            json.dump(summary or {
                "arrivals": len(hist.arrivals), "tokens": hist.tokens,
                "comm_bytes": hist.comm_bytes,
                "mean_staleness": sum(taus) / len(taus)},
                f, indent=2, sort_keys=True, default=str)
        print(f"stats -> {args.stats_json}")
    if recorder is not None:
        recorder.close()       # the stream is on disk already, live-flushed
        t = recorder.summary()
        print(f"telemetry -> {args.telemetry}: {t['arrivals']} arrivals "
              f"mean_cos={t['mean_cos_align']:.3f} "
              f"mean_corrected_frac={t['mean_corrected_frac']:.3f}")
    if tracer is not None:
        path = tracer.write(args.trace)
        print(f"trace -> {path}: {len(tracer)} events (load in "
              f"https://ui.perfetto.dev or chrome://tracing)")
    return hist


if __name__ == "__main__":
    main()
