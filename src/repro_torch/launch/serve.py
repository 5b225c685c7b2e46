"""Serving launcher of the port: prefill a batch of prompts, then greedy
decode over the KV cache, on the card unless ``--device cpu`` is given.

The port's counterpart of ``examples/serve_demo.py``. Prefill runs each
layer's attention through the flash-attention kernel (one launch a layer
on the card); decode is plain PyTorch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinygpt-15m \\
        --batch 4 --prompt-len 128 --gen 24
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

One untimed warm-up at the timed shapes (CUDA and cuBLAS set-up, kernel
loading, the caches' allocations) comes first; then ``--repeats`` timed
runs, reported as medians beside each run's time. Parameters come from the model's init (``--seed``), or from a
``.npz`` of ``{key path: array}`` (``--params``; the reference's
parameters flattened to numpy, carried over by ``bridge.to_torch``).
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import Model


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill(model: Model, params: Mapping[str, torch.Tensor],
            prompts: torch.Tensor, gen: int):
    """Prefill ``prompts`` (B, S) into caches of length S + gen. Returns
    (logits of the last position, caches, seconds to a synchronised end)."""
    _sync(prompts.device)
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, prompts, prompts.shape[1] + gen)
    _sync(prompts.device)
    return logits, caches, time.perf_counter() - t0


def decode(model: Model, params: Mapping[str, torch.Tensor],
           logits: torch.Tensor, caches, pos: int, gen: int):
    """``gen`` greedy tokens: the first from ``logits``, each next one from
    a decode step of the previous at ``pos``, ``pos + 1``, ... Returns
    (tokens (B, gen), seconds of the decode steps to a synchronised end)."""
    tok = torch.argmax(logits, -1)
    out = [tok]
    _sync(tok.device)
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = model.decode(params, tok, caches, pos + i)
        tok = torch.argmax(logits, -1)
        out.append(tok)
    _sync(tok.device)
    return torch.stack(out, 1), time.perf_counter() - t0


def generate(model: Model, params: Mapping[str, torch.Tensor],
             prompts: torch.Tensor, gen: int) -> Dict[str, object]:
    """``prefill`` then ``decode``: the tokens (B, gen), the prefill's
    logits, and the prefill and decode seconds."""
    logits, caches, t_prefill = prefill(model, params, prompts, gen)
    tokens, t_decode = decode(model, params, logits, caches,
                              prompts.shape[1], gen)
    return {"tokens": tokens, "prefill_logits": logits,
            "prefill_s": t_prefill, "decode_s": t_decode}


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinygpt-15m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed runs after the warm-up; medians reported")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--params", default="",
                    help=".npz of {key path: array} to serve instead of a "
                         "fresh init")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    model = Model(cfg)
    if args.params:
        with np.load(args.params) as f:
            params = bridge.to_torch(dict(f), device)
    else:
        params = model.init(torch.Generator().manual_seed(args.seed), device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(
                                args.seed + 1)).to(device)
    generate(model, params, prompts, args.gen)            # untimed warm-up
    runs = [generate(model, params, prompts, args.gen)
            for _ in range(max(args.repeats, 1))]
    res = runs[-1]
    n_dec = max(args.gen - 1, 1)
    t_prefill = statistics.median(r["prefill_s"] for r in runs)
    t_decode = statistics.median(r["decode_s"] for r in runs)
    print(f"arch={cfg.name} device={device} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} repeats={len(runs)}")
    print(f"prefill: {t_prefill * 1e3:.2f} ms median "
          f"({args.batch * args.prompt_len / t_prefill:.0f} tok/s); runs: "
          + ", ".join(f"{r['prefill_s'] * 1e3:.2f}" for r in runs))
    print(f"decode: {t_decode * 1e3:.2f} ms median total, "
          f"{t_decode / n_dec * 1e3:.3f} ms/token, "
          f"{args.batch * (args.gen - 1) / max(t_decode, 1e-9):.0f} tok/s; "
          "runs (ms/token): "
          + ", ".join(f"{r['decode_s'] / n_dec * 1e3:.3f}" for r in runs))
    print("tokens:")
    for row in res["tokens"].tolist():
        print("  ", row)
    return res


if __name__ == "__main__":
    main()
