"""Serving launcher of the port: prefill a batch of prompts, then greedy
decode over the KV cache, on the card unless ``--device cpu`` is given.

The port's counterpart of ``examples/serve_demo.py``, for every model
family (``--arch`` of any config). Prefill runs each attention layer
through the flash-attention kernel (one launch a layer on the card; for
zamba2, one at each of its shared block's sites); the recurrent blocks
(Mamba2, mLSTM, sLSTM) and decode are plain PyTorch. A vision model
prefills its patch embeddings (normal draws from ``--seed``) before the
prompt and decodes from ``prompt_len + n_prefix_tokens``; an audio encoder
prefills frame features (normal draws) and has no decode step.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinygpt-15m \\
        --batch 4 --prompt-len 128 --gen 24
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --smoke --device cpu

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
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import Model


Batch = Union[torch.Tensor, Mapping[str, torch.Tensor]]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seq_len(batch: Batch) -> int:
    """The prefill's sequence: the prompt's tokens, after the patch
    prefix for vision, or the audio frames."""
    if isinstance(batch, torch.Tensor):
        return batch.shape[1]
    if "features" in batch:
        return batch["features"].shape[1]
    return batch["tokens"].shape[1] + (batch["patches"].shape[1]
                                       if "patches" in batch else 0)


def make_inputs(cfg, batch: int, prompt_len: int, seed: int,
                device) -> Dict[str, torch.Tensor]:
    """The prompts from ``seed``: tokens (B, S) uniform over the vocabulary
    (generator seed + 1); for vision also patch embeddings (B, prefix, d),
    for audio frame features (B, S, d) instead of tokens, both normal
    draws (seed + 2), as ``examples/serve_demo.py`` makes them."""
    out = {}
    if cfg.frontend.kind != "audio":
        out["tokens"] = torch.randint(
            0, cfg.vocab_size, (batch, prompt_len),
            generator=torch.Generator().manual_seed(seed + 1))
    gen = torch.Generator().manual_seed(seed + 2)
    if cfg.frontend.kind == "audio":
        out["features"] = torch.randn((batch, prompt_len, cfg.d_model),
                                      generator=gen)
    elif cfg.frontend.kind == "vision":
        out["patches"] = torch.randn(
            (batch, cfg.frontend.n_prefix_tokens, cfg.d_model), generator=gen)
    return {k: v.to(device) for k, v in out.items()}


def prefill(model: Model, params: Mapping[str, torch.Tensor], batch: Batch,
            gen: int):
    """Prefill ``batch`` (prompt tokens (B, S), or ``make_inputs``' dict)
    into caches of length ``seq_len(batch) + gen``. Returns (logits of the
    last position, caches, seconds to a synchronised end)."""
    device = (batch if isinstance(batch, torch.Tensor)
              else next(iter(batch.values()))).device
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch, seq_len(batch) + gen)
    _sync(device)
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


def generate(model: Model, params: Mapping[str, torch.Tensor], batch: Batch,
             gen: int) -> Dict[str, object]:
    """``prefill`` then ``decode`` from position ``seq_len(batch)``: the
    tokens (B, gen), the prefill's logits, and the prefill and decode
    seconds. An encoder-only model stops after the prefill (its tokens and
    decode seconds None)."""
    logits, caches, t_prefill = prefill(model, params, batch, gen)
    tokens = t_decode = None
    if not model.cfg.encoder_only:
        tokens, t_decode = decode(model, params, logits, caches,
                                  seq_len(batch), gen)
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
    prompts = make_inputs(cfg, args.batch, args.prompt_len, args.seed,
                          device)
    generate(model, params, prompts, args.gen)            # untimed warm-up
    runs = [generate(model, params, prompts, args.gen)
            for _ in range(max(args.repeats, 1))]
    res = runs[-1]
    n_dec = max(args.gen - 1, 1)
    t_prefill = statistics.median(r["prefill_s"] for r in runs)
    print(f"arch={cfg.name} device={device} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} repeats={len(runs)}")
    n_tok = args.batch * seq_len(prompts)
    print(f"prefill: {t_prefill * 1e3:.2f} ms median "
          f"({n_tok / t_prefill:.0f} tok/s); runs: "
          + ", ".join(f"{r['prefill_s'] * 1e3:.2f}" for r in runs))
    if cfg.encoder_only:
        print("decode: none (encoder-only: no decode step)")
        return res
    t_decode = statistics.median(r["decode_s"] for r in runs)
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
