"""Fault tolerance on the PyTorch port: a worker crashes mid-round (its
in-flight work lost) and rejoins later; another worker joins elastically;
the server checkpoints every few outer steps, and training restarts from
the latest checkpoint. On the card unless ``--device cpu``.

    PYTHONPATH=src python examples/elastic_failover_torch.py [--device cpu]
    PYTHONPATH=src python3 examples/elastic_failover_torch.py   # the card

``--outer``, ``--inner`` and ``--more`` (outer steps after the restart)
shorten the run; the defaults are the reference example's.
"""
import argparse
import os
import tempfile

from repro_torch.async_engine.engine import (ElasticEvent, FailureEvent,
                                             make_eval_fn)
from repro_torch.async_engine.simulator import AsyncSimulator
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import (InnerOptConfig, OuterOptConfig,
                                      RunConfig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--outer", type=int, default=24)
    ap.add_argument("--inner", type=int, default=6)
    ap.add_argument("--more", type=int, default=6)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: a new temporary "
                         "one)")
    args = ap.parse_args(argv)
    rc = RunConfig(
        model=reduced(get_config("tinygpt-15m")),
        inner=InnerOptConfig(lr=3e-3, warmup_steps=4, total_steps=400),
        outer=OuterOptConfig(method="heloco"),
        n_workers=4, inner_steps=args.inner, outer_steps=args.outer,
        batch_size=4, seq_len=64,
        worker_paces=(1.0, 2.0, 4.0, 8.0), non_iid=True)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="heloco_ckpt_")
    failures = [FailureEvent(time=20.0, wid=1, restart_delay=30.0)]
    elastic = [ElasticEvent(time=40.0, action="join", wid=9, pace=1.5,
                            lang=2)]

    sim = AsyncSimulator(rc, device=args.device, failures=failures,
                         elastic=elastic)
    hist = sim.run(eval_every=6, eval_fn=make_eval_fn(sim, batch=8),
                   ckpt_every=6, ckpt_dir=ckpt_dir)

    print("events observed:")
    w1 = [a for a in hist.arrivals if a["worker_id"] == 1]
    w9 = [a for a in hist.arrivals if a["worker_id"] == 9]
    print(f"  worker 1 crash at t=20, rejoin at t=50: {len(w1)} arrivals "
          f"(latest at t={max(a['sim_time'] for a in w1):.0f})")
    print(f"  worker 9 joined at t=40: {len(w9)} arrivals")
    print(f"  final loss: {hist.evals[-1]['mean']:.4f}")

    latest = ckpt.latest(ckpt_dir)
    print(f"\nrestarting from checkpoint {os.path.basename(latest)} ...")
    sim2 = AsyncSimulator(rc, device=args.device)
    sim2.restore(latest)
    restored = sim2.server.t
    print(f"  restored outer step {restored}, sim time {sim2.time:.0f}s")
    sim2.cfg = RunConfig(**{**rc.__dict__,
                            "outer_steps": restored + args.more})
    hist2 = sim2.run(eval_every=3, eval_fn=make_eval_fn(sim2, batch=8))
    print(f"  continued to step {sim2.server.t}; "
          f"loss {hist2.evals[-1]['mean']:.4f}")
    return hist, latest, restored, hist2


if __name__ == "__main__":
    main()
