"""The dense transformer of the HeLoCo training slice and of serving.

Port of the dense family of ``repro/models/transformer.py:Model`` with an
unrolled ``blocks_list`` stack. The module tree mirrors the reference's
parameter tree, so ``named_parameters()`` with ``.`` turned into ``/`` gives
the reference's key paths. The module's own parameters live on the ``meta``
device; ``init`` draws values, and ``loss``, ``prefill`` and ``decode`` run
on a given parameter dict, so workers share one module.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import leaf_order
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (MLP, Embed, LayerNorm, cross_entropy,
                                      dtype_of)

Params = Dict[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]          # one layer's {"k", "v"}
Caches = Dict[str, Cache]                # by layer, "layer_XX"


class AttnBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.norm1 = LayerNorm(cfg, cfg.d_model)
        self.attn = attn_lib.Attention(cfg)
        self.norm2 = LayerNorm(cfg, cfg.d_model)
        self.mlp = MLP(cfg, cfg.d_model, cfg.d_ff)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        q, k, v = attn_lib.qkv_project(self.attn, h, self.cfg, positions)
        ctx = attn_lib.attend(q, k, v, causal=self.cfg.causal)
        x = x + attn_lib.attn_output(self.attn, ctx)
        return x + self.mlp(self.norm2(x))

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                cache_len: int) -> Tuple[torch.Tensor, Cache]:
        """The forward of ``prefill_attn_block``: attention through the
        flash kernel, and the KV cache (length ``cache_len``, x's dtype)
        with the prompt's k and v written at 0."""
        h = self.norm1(x)
        q, k, v = attn_lib.qkv_project(self.attn, h, self.cfg, positions)
        ctx = attn_lib.prefill_attend(q, k, v, causal=self.cfg.causal)
        cache = attn_lib.init_kv_cache(self.cfg, x.shape[0], cache_len,
                                       x.dtype, x.device)
        attn_lib.cache_write(cache, k, v, 0)
        x = x + attn_lib.attn_output(self.attn, ctx)
        return x + self.mlp(self.norm2(x)), cache

    def decode(self, x: torch.Tensor, cache: Cache, pos: int
               ) -> Tuple[torch.Tensor, Cache]:
        """``decode_attn_block``: one token against the cache."""
        h = self.norm1(x)
        a, cache = attn_lib.decode_attend(self.attn, h, cache, pos, self.cfg)
        x = x + a
        return x + self.mlp(self.norm2(x)), cache


class _Call(nn.Module):
    """Runs one method of ``model`` as its forward, so that
    ``functional_call`` can bind a parameter dict to it."""

    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args):
        return getattr(self.model, self.method)(*args)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if (cfg.family, cfg.norm, cfg.mlp_act, cfg.tied_embeddings) != \
                ("dense", "layernorm", "gelu", True):
            raise NotImplementedError(
                f"{cfg.name}: the port runs the dense layernorm/gelu/tied "
                "family only")
        self.cfg = cfg
        self.embed = Embed(cfg)
        self.final_norm = LayerNorm(cfg, cfg.d_model)
        self.blocks_list = nn.ModuleDict(
            {f"layer_{i:02d}": AttnBlock(cfg) for i in range(cfg.n_layers)})

    def forward(self, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for block in self.blocks_list.values():
            x = block(x, positions)
        logits = self.embed.logits(self.final_norm(x))
        return cross_entropy(logits, torch.clamp_min(labels, 0), labels >= 0)

    # ---------------- parameters ----------------

    def param_specs(self) -> Dict[str, torch.Tensor]:
        """The model's leaves in leaf order, as ``meta`` tensors (shape and
        dtype, no storage)."""
        named = {n.replace(".", "/"): p for n, p in self.named_parameters()}
        return {k: named[k] for k in leaf_order(named)}

    def _init_scale(self, path: str) -> float:
        cfg = self.cfg
        return {"tok": 0.02,
                "wq": cfg.d_model ** -0.5, "wk": cfg.d_model ** -0.5,
                "wv": cfg.d_model ** -0.5,
                "wo": (cfg.n_heads * cfg.head_dim) ** -0.5,
                "w_in": cfg.d_model ** -0.5,
                "w_down": cfg.d_ff ** -0.5}[path.rsplit("/", 1)[-1]]

    def init(self, generator: torch.Generator, device) -> Params:
        """Fresh parameters: normal * scale (0.02 for the embedding, fan-in
        ** -0.5 for projections), ones/zeros for norm scale/bias. Drawn
        from ``generator`` (a CPU generator, so the draw does not depend
        on the device) in leaf order."""
        dtype = getattr(torch, self.cfg.param_dtype)
        out = {}
        for path, spec in self.param_specs().items():
            leaf = path.rsplit("/", 1)[-1]
            if leaf == "scale":
                x = torch.ones(spec.shape)
            elif leaf == "bias":
                x = torch.zeros(spec.shape)
            else:
                x = torch.randn(spec.shape, generator=generator) \
                    * self._init_scale(path)
            out[path] = x.to(device=device, dtype=dtype)
        return out

    # ---------------- train forward ----------------

    def loss(self, params: Mapping[str, torch.Tensor],
             batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token loss of ``batch`` (``tokens``, ``labels``) under
        ``params`` (the reference returns it with an empty aux dict)."""
        values = {k.replace("/", "."): v for k, v in params.items()}
        return functional_call(self, values,
                               (batch["tokens"], batch["labels"]),
                               strict=True)

    # ---------------- serving ----------------

    def _serve(self, method: str, params: Mapping[str, torch.Tensor], *args):
        values = {"model." + k.replace("/", "."): v for k, v in params.items()}
        return functional_call(_Call(self, method), values, args, strict=True)

    def _prefill(self, tokens: torch.Tensor, cache_len: int):
        x = self.embed(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        caches = {}
        for key, block in self.blocks_list.items():
            x, caches[key] = block.prefill(x, positions, cache_len)
        x = self.final_norm(x[:, -1:])
        return self.embed.logits(x)[:, 0], caches

    def _decode(self, token: torch.Tensor, caches: Caches, pos: int):
        x = self.embed(token[:, None])
        new = {}
        for key, block in self.blocks_list.items():
            x, new[key] = block.decode(x, caches[key], pos)
        return self.embed.logits(self.final_norm(x))[:, 0], new

    def prefill(self, params: Mapping[str, torch.Tensor], tokens: torch.Tensor,
                cache_len: Optional[int] = None) -> Tuple[torch.Tensor, Caches]:
        """tokens: (B, S) int. Returns (the last position's logits (B, V) in
        the compute dtype, the caches ``{"layer_XX": {"k", "v"}}`` of length
        ``cache_len`` (default S) in the compute dtype). Each layer's
        attention is one launch of the flash-attention kernel on the card."""
        return self._serve("_prefill", params, tokens,
                           cache_len or tokens.shape[1])

    def init_caches(self, batch: int, cache_len: int, device) -> Caches:
        """Zero caches of every layer, in the compute dtype."""
        return {key: attn_lib.init_kv_cache(self.cfg, batch, cache_len,
                                            dtype_of(self.cfg), device)
                for key in self.blocks_list}

    def decode(self, params: Mapping[str, torch.Tensor], token: torch.Tensor,
               caches: Caches, pos: int) -> Tuple[torch.Tensor, Caches]:
        """One decode step. token: (B,) int; pos: the position it is written
        at (the same for every row). The caches are written in place and
        returned; logits (B, V) in the compute dtype. Plain PyTorch: no
        kernel launches."""
        return self._serve("_decode", params, token, caches, int(pos))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
