"""Training launcher of the port: the asynchronous HeLoCo run on the
virtual-clock engine, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinygpt-15m \
        --workers 4 --paces 1,2,6,15 --outer 12 --inner 2 --batch 4 --seq 128

Mirrors the sim-engine flags of ``repro/launch/train.py``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from repro_torch.async_engine.engine import make_engine, make_eval_fn
from repro_torch.configs import get_config
from repro_torch.configs.base import InnerOptConfig, OuterOptConfig, RunConfig
from repro_torch.core import methods as outer_methods
from repro_torch.device import resolve_device


def run_config_from_args(args) -> RunConfig:
    """The flags compiled into a RunConfig, with the reference scenario
    layer's derived defaults (Table-3 outer preset; warm-up of 5% of the
    inner steps, at least 2)."""
    model = get_config(args.arch + ("-smoke" if args.smoke else ""))
    preset = outer_methods.get(args.method)
    total = args.outer * args.inner
    return RunConfig(
        model=model,
        inner=InnerOptConfig(lr=args.inner_lr,
                             warmup_steps=max(total // 20, 2),
                             total_steps=total),
        outer=OuterOptConfig(method=preset.name,
                             outer_lr=preset.outer_lr,
                             momentum=preset.momentum,
                             weight_factor=preset.weight_factor,
                             lookahead_init=preset.lookahead_init),
        n_workers=args.workers,
        inner_steps=args.inner,
        outer_steps=args.outer,
        batch_size=args.batch,
        seq_len=args.seq,
        seed=args.seed,
        worker_paces=tuple(float(p) for p in args.paces.split(",")),
    )


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
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
    ap.add_argument("--inner-lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    eng = make_engine(run_config_from_args(args), device=device)
    eval_fn = make_eval_fn(eng, batch=8)
    t0 = time.perf_counter()
    hist = eng.run(eval_every=args.eval_every, eval_fn=eval_fn)
    wall = time.perf_counter() - t0
    for e in hist.evals:
        print(f"step {e['step']:5d}  t={e['time']:8.0f}s  "
              f"loss={e['mean']:.4f}")
    taus = [a["staleness"] for a in hist.arrivals] or [0]
    print(f"done: device={device} arrivals={len(hist.arrivals)} "
          f"tokens={hist.tokens} "
          f"mean_staleness={sum(taus) / len(taus):.2f} "
          f"comm={hist.comm_bytes / 1e6:.1f}MB wall={wall:.2f}s")
    return hist


if __name__ == "__main__":
    main()
