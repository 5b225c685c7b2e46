"""Training launcher of the port, on the card unless ``--device cpu`` is
given.

Two ways to describe a run, as in ``repro/launch/train.py``:

  - ``--scenario NAME``: a registered ``repro_torch.scenarios`` spec
    (``--list-scenarios`` enumerates them); ``--full-width`` runs it at
    tinygpt-15m's own width with batch 4 x 128;
  - ad-hoc flags, compiled into an anonymous ``Scenario`` first, so both
    paths build the run the same way.

    PYTHONPATH=src python -m repro_torch.launch.train --scenario dcasgd \\
        --full-width
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinygpt-15m \\
        --workers 4 --paces 1,2,6,15 --outer 12 --inner 2 --batch 4 --seq 128
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from repro_torch.async_engine.engine import make_eval_fn
from repro_torch.core import methods as outer_methods
from repro_torch.device import resolve_device
from repro_torch.scenarios import registry
from repro_torch.scenarios.spec import Scenario

# --full-width: the scenario at the model's own width, with the batch the
# card's smoke run uses (chip_smoke.py)
FULL_WIDTH = dict(smoke=False, batch_size=4, seq_len=128)


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
        n_workers=args.workers,
        worker_paces=tuple(float(p) for p in args.paces.split(",")),
        inner_steps=args.inner, outer_steps=args.outer,
        batch_size=args.batch, seq_len=args.seq,
        shard_assignment=args.shard_assignment,
        method=args.method, outer_lr=outer_lr, momentum=args.momentum,
        drop_stale_after=args.drop_stale_after,
        inner_lr=args.inner_lr, seed=args.seed)


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
    ap.add_argument("--outer-lr", type=float, default=None,
                    help="default: the method's paper value (Table 3)")
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--inner-lr", type=float, default=3e-3)
    ap.add_argument("--drop-stale-after", type=int, default=None)
    ap.add_argument("--shard-assignment", default="fixed",
                    choices=["fixed", "flexible"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=None,
                    help="default: 10, or the scenario's golden-trace "
                         "cadence with --scenario")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


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
        print(f"scenario {scn.name}: {scn.description}")
    else:
        scn = scenario_from_args(args)
    eval_every = (args.eval_every if args.eval_every is not None
                  else (scn.eval_cadence if args.scenario else 10))
    eng = scn.build(device=device)
    eval_fn = make_eval_fn(eng, batch=scn.eval_batch)
    t0 = time.perf_counter()
    hist = eng.run(eval_every=eval_every, eval_fn=eval_fn)
    wall = time.perf_counter() - t0
    for e in hist.evals:
        print(f"step {e['step']:5d}  t={e['time']:8.0f}s  "
              f"loss={e['mean']:.4f}")
    taus = [a["staleness"] for a in hist.arrivals] or [0]
    print(f"done: device={device} method={scn.method} "
          f"arrivals={len(hist.arrivals)} tokens={hist.tokens} "
          f"mean_staleness={sum(taus) / len(taus):.2f} "
          f"comm={hist.comm_bytes / 1e6:.1f}MB wall={wall:.2f}s")
    return hist


if __name__ == "__main__":
    main()
