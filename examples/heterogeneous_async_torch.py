"""End-to-end run on the PyTorch port: train the tiny default config,
comparing HeLoCo to the paper's baselines under a chosen pace
configuration, on the card unless ``--device cpu``. Demonstrates DyLU,
compression, stale-drop and Dirichlet language mixtures. Runs are
``repro_torch.scenarios`` specs; ``--scenario NAME`` replays a registered
one. Results are cached under ``results/torch_experiments``
(``repro_torch.sweeps.cache``).

    PYTHONPATH=src python examples/heterogeneous_async_torch.py \\
        --paces 1,1,6,6,6 --methods async-heloco,async-mla --outer 30 \\
        --engine wallclock --device cpu
    PYTHONPATH=src python examples/heterogeneous_async_torch.py \\
        --scenario paper_hetero_severe --device cpu
    PYTHONPATH=src python3 examples/heterogeneous_async_torch.py   # the card
"""
import argparse

from repro_torch.scenarios import registry
from repro_torch.scenarios.adhoc import METHODS, scenario_for
from repro_torch.sweeps.cache import run_cached_scenario


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="",
                    help="replay a registered scenario instead of the "
                         "ad-hoc flags below")
    ap.add_argument("--paces", default="0.74,1.5,3,6,7.5")
    ap.add_argument("--methods", default="async-heloco,async-mla,"
                                         "async-nesterov,sync-nesterov")
    ap.add_argument("--outer", type=int, default=30)
    ap.add_argument("--inner", type=int, default=8)
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--mixture-alpha", type=float, default=None)
    ap.add_argument("--dylu", action="store_true")
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--drop-stale-after", type=int, default=None)
    ap.add_argument("--engine", default="sim", choices=["sim", "wallclock"],
                    help="wallclock = threaded concurrent runtime "
                         "(deterministic mode: same results, real overlap)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.scenario:
        scn = registry.get_scenario(args.scenario)
        print(f"scenario {scn.name}: {scn.description}")
        hist = scn.build(device=args.device).run()
        taus = [a["staleness"] for a in hist.arrivals] or [0]
        print(f"arrivals={len(hist.arrivals)} tokens={hist.tokens} "
              f"mean_staleness={sum(taus) / len(taus):.2f} "
              f"sim_time={hist.final_time:.0f}s")
        return {scn.name: hist}

    paces = tuple(float(p) for p in args.paces.split(","))
    print(f"paces={paces} non_iid={not args.iid} dylu={args.dylu} "
          f"compression={args.compression} engine={args.engine} "
          f"device={args.device}")
    print("method,final_loss,mean_staleness,sim_time_s,comm_MB")
    out = {}
    for method in args.methods.split(","):
        if method not in METHODS:
            raise SystemExit(f"unknown method {method!r}; known: "
                             f"{', '.join(METHODS)}")
        scn = scenario_for(paces, method=method, non_iid=not args.iid,
                           outer_steps=args.outer, inner_steps=args.inner,
                           dylu=args.dylu, compression=args.compression,
                           drop_stale_after=args.drop_stale_after,
                           mixture_alpha=args.mixture_alpha,
                           engine=args.engine)
        r = run_cached_scenario(f"example_{method}", scn, device=args.device)
        tau = sum(r["staleness"]) / max(len(r["staleness"]), 1)
        print(f"{method},{r['final_loss']:.4f},{tau:.2f},"
              f"{r['final_time']:.0f},{r['comm_bytes'] / 1e6:.1f}")
        out[method] = r
    return out


if __name__ == "__main__":
    main()
