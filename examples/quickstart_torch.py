"""Quickstart on the PyTorch port: asynchronous HeLoCo training with 5
heterogeneous workers on non-IID synthetic multilingual data (the paper's
Fig. 2 setting, tiny), on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
    PYTHONPATH=src python3 examples/quickstart_torch.py   # the card

``--outer`` and ``--inner`` shorten the run (defaults: the reference
example's 30 outer steps of 8 local steps).
"""
import argparse

from repro_torch.async_engine.engine import make_eval_fn
from repro_torch.async_engine.simulator import AsyncSimulator
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import (InnerOptConfig, OuterOptConfig,
                                      RunConfig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--outer", type=int, default=30)
    ap.add_argument("--inner", type=int, default=8)
    ap.add_argument("--eval-every", type=int, default=6)
    args = ap.parse_args(argv)
    run = RunConfig(
        model=reduced(get_config("tinygpt-15m")),
        inner=InnerOptConfig(lr=3e-3, warmup_steps=5, total_steps=400),
        outer=OuterOptConfig(method="heloco"),      # paper defaults (Table 3)
        n_workers=5,
        inner_steps=args.inner,                     # H local steps per round
        outer_steps=args.outer,
        batch_size=4,
        seq_len=64,
        worker_paces=(0.74, 1.5, 3.0, 6.0, 7.5),    # heterogeneous (sec/step)
        non_iid=True,
    )
    sim = AsyncSimulator(run, device=args.device)
    hist = sim.run(eval_every=args.eval_every,
                   eval_fn=make_eval_fn(sim, batch=8))

    print(f"\narrivals={len(hist.arrivals)} tokens={hist.tokens} "
          f"sim_time={hist.final_time:.0f}s device={sim.device}")
    print("step  time(s)  mean-loss  per-language")
    for e in hist.evals:
        langs = " ".join(f"{k}:{v:.2f}" for k, v in e["per_lang"].items())
        print(f"{e['step']:4d}  {e['time']:7.0f}  {e['mean']:9.4f}  {langs}")
    taus = [a["staleness"] for a in hist.arrivals]
    print(f"staleness: mean={sum(taus)/len(taus):.2f} max={max(taus)}")
    return hist


if __name__ == "__main__":
    main()
