"""Model assembly: the attention families of the reference's ``Model``.

Port of ``repro/models/transformer.py`` for the families that run through
``apply_attn_block``: ``dense``, ``moe``, ``audio`` (an encoder over frame
features) and ``vlm`` (patch embeddings prepended to the text). The
recurrent families ``hybrid`` and ``ssm`` are ROADMAP A17b.

Parameters are a flat dict of tensors keyed by the reference's ``/``-joined
key paths. With ``cfg.scan_layers`` the layers are stacked: every block
leaf has a leading ``n_layers`` axis under ``blocks/`` (``blocks/attn/wq``,
``blocks/moe/router``, ``blocks/moe/shared/w_gate``, ...), as the
reference's ``jax.vmap``-ed init gives them; otherwise each layer has its
own ``blocks_list/layer_XX/`` leaves. The model object holds only the
config, so workers share one; ``init`` draws values, and ``loss``,
``prefill`` and ``decode`` run on a given parameter dict.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import leaf_order
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (Params, Shapes, apply_mlp, apply_norm,
                                      cross_entropy, dtype_of, embed_shapes,
                                      embed_tokens, lm_logits, mlp_shapes,
                                      norm_shapes)

Cache = Dict[str, torch.Tensor]          # {"k", "v"}: (B, T, KV, D), or
Caches = Dict[str, object]               # stacked (L, B, T, KV, D); or by
                                         # layer, {"layer_XX": Cache}
ATTN_FAMILIES = ("dense", "moe", "audio", "vlm")
BIAS_LEAVES = ("bias", "bq", "bk", "bv", "b_gate", "b_up", "b_in", "b_down")


def _prefixed(prefix: str, shapes: Shapes) -> Shapes:
    return {f"{prefix}/{k}": v for k, v in shapes.items()}


def attn_block_shapes(cfg: ModelConfig) -> Shapes:
    """``init_attn_block``'s leaves: norm1, attn, norm2 (not with a
    parallel block), and the MLP or the MoE."""
    out = {**_prefixed("norm1", norm_shapes(cfg, cfg.d_model)),
           **_prefixed("attn", attn_lib.attention_shapes(cfg))}
    if not cfg.parallel_block:
        out.update(_prefixed("norm2", norm_shapes(cfg, cfg.d_model)))
    if cfg.block_kind == "moe":
        out.update(_prefixed("moe", moe_lib.moe_shapes(cfg)))
    else:
        out.update(_prefixed("mlp", mlp_shapes(cfg, cfg.d_model, cfg.d_ff)))
    return out


def _split(p: Mapping[str, torch.Tensor]) -> Dict[str, Params]:
    """One layer's leaves by their first path part: ``{"attn": {"wq": ..},
    "moe": {"router": .., "shared/w_gate": ..}, ...}``."""
    out: Dict[str, Params] = {}
    for k, v in p.items():
        head, rest = k.split("/", 1)
        out.setdefault(head, {})[rest] = v
    return out


def _ffn(p: Dict[str, Params], h: torch.Tensor, cfg: ModelConfig
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if cfg.block_kind == "moe":
        return moe_lib.apply_moe(p["moe"], h, cfg)
    return apply_mlp(p["mlp"], h, cfg), None


def _mix(p: Dict[str, Params], x: torch.Tensor, h: torch.Tensor,
         a: torch.Tensor, cfg: ModelConfig
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's residual stream after attention ``a`` of ``h =
    norm1(x)``: x + a + ffn(h) for a parallel block, else x + a then the
    FFN of norm2 of that."""
    if cfg.parallel_block:
        mo, aux = _ffn(p, h, cfg)
        return x + a + mo, aux
    x = x + a
    mo, aux = _ffn(p, apply_norm(p["norm2"], x, cfg), cfg)
    return x + mo, aux


def apply_attn_block(p: Dict[str, Params], x: torch.Tensor, cfg: ModelConfig,
                     positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Training forward without cache. Returns (x', aux: the MoE's
    load-balance loss, None without one)."""
    h = apply_norm(p["norm1"], x, cfg)
    q, k, v = attn_lib.qkv_project(p["attn"], h, cfg, positions)
    ctx = attn_lib.attend(q, k, v, causal=cfg.causal)
    return _mix(p, x, h, attn_lib.attn_output(p["attn"], ctx), cfg)


def prefill_attn_block(p: Dict[str, Params], x: torch.Tensor,
                       cfg: ModelConfig, positions: torch.Tensor,
                       cache: Cache) -> torch.Tensor:
    """``prefill_attn_block``: attention through the flash kernel, the
    prompt's k and v written into ``cache`` at 0."""
    h = apply_norm(p["norm1"], x, cfg)
    q, k, v = attn_lib.qkv_project(p["attn"], h, cfg, positions)
    ctx = attn_lib.prefill_attend(q, k, v, causal=cfg.causal)
    attn_lib.cache_write(cache, k, v, 0)
    return _mix(p, x, h, attn_lib.attn_output(p["attn"], ctx), cfg)[0]


def decode_attn_block(p: Dict[str, Params], x: torch.Tensor, cfg: ModelConfig,
                      cache: Cache, pos: int) -> torch.Tensor:
    """``decode_attn_block``: one token against the cache (written in
    place)."""
    h = apply_norm(p["norm1"], x, cfg)
    a, _ = attn_lib.decode_attend(p["attn"], h, cache, pos, cfg)
    return _mix(p, x, h, a, cfg)[0]


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ATTN_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the port does not run the {cfg.family!r} "
                "family yet (ROADMAP A17b: zamba2's Mamba2 stack and xLSTM)")
        self.cfg = cfg
        shapes = {**_prefixed("embed", embed_shapes(cfg)),
                  **_prefixed("final_norm", norm_shapes(cfg, cfg.d_model))}
        block = attn_block_shapes(cfg)
        if cfg.scan_layers:
            shapes.update({f"blocks/{k}": ((cfg.n_layers,) + s, dt)
                           for k, (s, dt) in block.items()})
        else:
            for i in range(cfg.n_layers):
                shapes.update(_prefixed(f"blocks_list/layer_{i:02d}", block))
        self._shapes = {k: shapes[k] for k in leaf_order(shapes)}

    # ---------------- parameters ----------------

    def param_specs(self) -> Dict[str, torch.Tensor]:
        """The model's leaves in leaf order, as ``meta`` tensors (shape and
        dtype, no storage)."""
        return {k: torch.empty(s, dtype=getattr(torch, dt), device="meta")
                for k, (s, dt) in self._shapes.items()}

    def _init_scale(self, path: str) -> float:
        """The reference's init scale of a drawn leaf, keyed on its whole
        path: ``w_down`` is d_ff ** -0.5 in the MLP, expert_d_ff ** -0.5 in
        the MoE's experts and its shared expert."""
        cfg = self.cfg
        parts = path.split("/")
        leaf = parts[-1]
        if parts[0] == "embed":
            return 0.02 if leaf == "tok" else cfg.d_model ** -0.5
        if leaf == "router":
            return 0.02
        if leaf == "wo":
            return (cfg.n_heads * cfg.head_dim) ** -0.5
        if leaf == "w_down":
            ff = cfg.moe.expert_d_ff if "moe" in parts else cfg.d_ff
            return ff ** -0.5
        return cfg.d_model ** -0.5      # wq, wk, wv, w_in, w_gate, w_up

    def init(self, generator: torch.Generator, device) -> Params:
        """Fresh parameters: normal * scale (0.02 for the embedding and the
        router, fan-in ** -0.5 for projections), ones for norm scales,
        zeros for biases. Drawn leaf by leaf in leaf order on the
        generator's device (so a CPU generator's draw does not depend on
        ``device``), then moved to ``device``."""
        out = {}
        for path, (shape, dt) in self._shapes.items():
            leaf = path.rsplit("/", 1)[-1]
            dtype = getattr(torch, dt)
            if leaf == "scale":
                x = torch.ones(shape, dtype=dtype, device=device)
            elif leaf in BIAS_LEAVES:
                x = torch.zeros(shape, dtype=dtype, device=device)
            else:
                x = torch.randn(shape, generator=generator,
                                device=generator.device)
                x = x.mul_(self._init_scale(path)).to(device=device,
                                                      dtype=dtype)
            out[path] = x
        return out

    def _layers(self, params: Mapping[str, torch.Tensor]
                ) -> Iterator[Dict[str, Params]]:
        """Each layer's leaves, split by block part, in layer order."""
        cfg = self.cfg
        if cfg.scan_layers:
            stacked = {k[len("blocks/"):]: v for k, v in params.items()
                       if k.startswith("blocks/")}
            for i in range(cfg.n_layers):
                yield _split({k: v[i] for k, v in stacked.items()})
        else:
            for i in range(cfg.n_layers):
                pre = f"blocks_list/layer_{i:02d}/"
                yield _split({k[len(pre):]: v for k, v in params.items()
                              if k.startswith(pre)})

    @staticmethod
    def _part(params: Mapping[str, torch.Tensor], name: str) -> Params:
        pre = name + "/"
        return {k[len(pre):]: v for k, v in params.items()
                if k.startswith(pre)}

    # ---------------- embedding front ----------------

    def _embed(self, params: Mapping[str, torch.Tensor],
               batch: Mapping[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (x (B, S, d), positions (S,)): frame features (audio),
        patch embeddings before the tokens' (vision), or the tokens'."""
        cfg = self.cfg
        if cfg.frontend.kind == "audio":
            x = batch["features"].to(dtype_of(cfg))
        else:
            x = embed_tokens(self._part(params, "embed"), batch["tokens"],
                             cfg)
            if cfg.frontend.kind == "vision":
                x = torch.cat([batch["patches"].to(dtype_of(cfg)), x], dim=1)
        return x, torch.arange(x.shape[1], device=x.device)

    # ---------------- train forward ----------------

    def loss(self, params: Mapping[str, torch.Tensor],
             batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token loss of ``batch`` (``tokens`` or ``features``,
        ``patches`` for vision, ``labels``, optional ``loss_mask``) under
        ``params``; an MoE adds 0.01 times its load-balance loss averaged
        over layers (the reference returns the aux beside the loss)."""
        cfg = self.cfg
        x, positions = self._embed(params, batch)
        aux_sum = None
        for p in self._layers(params):
            x, aux = apply_attn_block(p, x, cfg, positions)
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
        x = apply_norm(self._part(params, "final_norm"), x, cfg)
        if cfg.frontend.kind == "vision":
            x = x[:, cfg.frontend.n_prefix_tokens:]
        logits = lm_logits(self._part(params, "embed"), x, cfg)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = labels >= 0
        loss = cross_entropy(logits, torch.clamp_min(labels, 0), mask)
        if cfg.is_moe:
            loss = loss + 0.01 * (aux_sum / max(cfg.n_layers, 1))
        return loss

    # ---------------- serving ----------------

    def init_caches(self, batch: int, cache_len: int, device) -> Caches:
        """Zero caches of every layer, in the compute dtype: stacked
        ``{"k", "v"}`` of (L, B, T, KV, D) with ``scan_layers``, else
        ``{"layer_XX": {"k", "v"}}``."""
        cfg = self.cfg
        if cfg.scan_layers:
            shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads,
                     cfg.head_dim)
            return {kv: torch.zeros(shape, dtype=dtype_of(cfg), device=device)
                    for kv in ("k", "v")}
        return {f"layer_{i:02d}": attn_lib.init_kv_cache(
            cfg, batch, cache_len, dtype_of(cfg), device)
            for i in range(cfg.n_layers)}

    def _layer_caches(self, caches: Caches) -> Iterator[Cache]:
        """Each layer's cache, a view into the stacked tensors."""
        if self.cfg.scan_layers:
            for i in range(self.cfg.n_layers):
                yield {"k": caches["k"][i], "v": caches["v"][i]}
        else:
            for i in range(self.cfg.n_layers):
                yield caches[f"layer_{i:02d}"]

    @torch.no_grad()
    def prefill(self, params: Mapping[str, torch.Tensor],
                batch: Union[torch.Tensor, Mapping[str, torch.Tensor]],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Caches]:
        """``batch``: the prompts' tokens (B, S), or a dict with ``tokens``
        (and ``patches`` for vision) or ``features`` (audio). Returns (the
        last position's logits (B, V) in the compute dtype, the caches of
        length ``cache_len`` (default the sequence, prefix included) in
        the compute dtype). Each layer's attention is one launch of the
        flash-attention kernel on the card."""
        cfg = self.cfg
        if isinstance(batch, torch.Tensor):
            batch = {"tokens": batch}
        x, positions = self._embed(params, batch)
        caches = self.init_caches(x.shape[0], cache_len or x.shape[1],
                                  x.device)
        for p, cache in zip(self._layers(params), self._layer_caches(caches)):
            x = prefill_attn_block(p, x, cfg, positions, cache)
        x = apply_norm(self._part(params, "final_norm"), x[:, -1:], cfg)
        return lm_logits(self._part(params, "embed"), x, cfg)[:, 0], caches

    @torch.no_grad()
    def decode(self, params: Mapping[str, torch.Tensor], token: torch.Tensor,
               caches: Caches, pos: int) -> Tuple[torch.Tensor, Caches]:
        """One decode step. token: (B,) int; pos: the position it is written
        at (the same for every row). The caches are written in place and
        returned; logits (B, V) in the compute dtype. Plain PyTorch: no
        kernel launches. An encoder-only model has no decode step."""
        cfg = self.cfg
        if cfg.encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        x = embed_tokens(self._part(params, "embed"), token[:, None], cfg)
        for p, cache in zip(self._layers(params), self._layer_caches(caches)):
            x = decode_attn_block(p, x, cfg, cache, int(pos))
        x = apply_norm(self._part(params, "final_norm"), x, cfg)
        return lm_logits(self._part(params, "embed"), x, cfg)[:, 0], caches


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
