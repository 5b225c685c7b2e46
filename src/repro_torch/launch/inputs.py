"""Abstract inputs for the dry-run: ``meta`` tensors in place of every model
input and state (shape and dtype, no storage), as ``jax.eval_shape``
allocates nothing.

Port of ``repro/launch/inputs.py``. Token and label batches are int32, as
the reference's; the steps widen them to int64 where PyTorch indexes with
them."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import build_model

META = torch.device("meta")


def _s(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs_struct(cfg: ModelConfig, batch: int, seq: int,
                       with_labels: bool = True) -> Dict[str, torch.Tensor]:
    """Abstract train/prefill batch for one DiLoCo worker (pod)."""
    emb = getattr(torch, cfg.compute_dtype)
    out: Dict[str, torch.Tensor] = {}
    if cfg.frontend.kind == "audio":
        out["features"] = _s((batch, seq, cfg.d_model), emb)
        if with_labels:
            out["labels"] = _s((batch, seq), torch.int32)
        return out
    if cfg.frontend.kind == "vision":
        npfx = cfg.frontend.n_prefix_tokens
        out["patches"] = _s((batch, npfx, cfg.d_model), emb)
        out["tokens"] = _s((batch, seq - npfx), torch.int32)
        if with_labels:
            out["labels"] = _s((batch, seq - npfx), torch.int32)
        return out
    out["tokens"] = _s((batch, seq), torch.int32)
    if with_labels:
        out["labels"] = _s((batch, seq), torch.int32)
    return out


def abstract_params(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    return build_model(cfg).param_specs()


def abstract_caches(cfg: ModelConfig, batch: int, cache_len: int) -> Any:
    return build_model(cfg).init_caches(batch, cache_len, META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """All abstract inputs of an (arch x shape) dry-run cell."""
    if shape.kind == "train":
        return {"batch": batch_specs_struct(cfg, shape.global_batch,
                                            shape.seq_len)}
    if shape.kind == "prefill":
        return {"batch": batch_specs_struct(cfg, shape.global_batch,
                                            shape.seq_len, with_labels=False)}
    # decode: one new token against a cache of seq_len
    return {"token": _s((shape.global_batch,), torch.int32),
            "pos": _s((), torch.int32),
            "caches": abstract_caches(cfg, shape.global_batch, shape.seq_len)}
