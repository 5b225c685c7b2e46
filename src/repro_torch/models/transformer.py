"""The dense transformer of the HeLoCo training slice.

Port of the dense family of ``repro/models/transformer.py:Model`` with an
unrolled ``blocks_list`` stack. The module tree mirrors the reference's
parameter tree, so ``named_parameters()`` with ``.`` turned into ``/`` gives
the reference's key paths. The module's own parameters live on the ``meta``
device; ``init`` draws values and ``loss`` runs the forward on a given
parameter dict, so workers share one module.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import leaf_order
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import MLP, Embed, LayerNorm, cross_entropy

Params = Dict[str, torch.Tensor]


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


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
