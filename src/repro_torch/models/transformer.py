"""Model assembly: every model family of the reference's ``Model``.

Port of ``repro/models/transformer.py``:

  dense / moe / audio / vlm : a stack of attention(+MLP|MoE) blocks
                              (``audio``: an encoder over frame features;
                              ``vlm``: patch embeddings before the text);
  hybrid (zamba2)           : super blocks of ``shared_attn_every`` Mamba2
                              layers, each followed by one shared
                              attention + MLP block (one weight set used
                              at every site; its gradient sums the uses);
  ssm (xlstm)               : a mixed stack of mLSTM and sLSTM blocks.

Parameters are a flat dict of tensors keyed by the reference's ``/``-joined
key paths. With ``cfg.scan_layers`` the attention layers are stacked: every
block leaf has a leading ``n_layers`` axis under ``blocks/``
(``blocks/attn/wq``, ``blocks/moe/router``, ...), as the reference's
``jax.vmap``-ed init gives them; otherwise each layer has its own
``blocks_list/layer_XX/`` leaves, as every ssm layer has. A hybrid model's
``super/norm/*`` and ``super/mamba/*`` leaves carry two leading axes
(n_super, shared_attn_every), and ``shared/`` holds the shared block. The
model object holds only the config, so workers share one; ``init`` draws
values, and ``loss``, ``prefill`` and ``decode`` run on a given parameter
dict.

Training keeps the reference's memory plan: attention in query chunks of
``q_chunk`` (``attention.flash_attention``), and under ``cfg.remat`` its
rematerialisation (``torch.utils.checkpoint``): stacked ``blocks/`` layers
in groups of ``max(remat_group, 1)``, ``blocks_list`` layers one by one,
each hybrid super block and each xLSTM block as one checkpoint. A
checkpoint keeps only its input and recomputes its forward in the
backward; it changes no value.

Placed (DTensor) parameters and batches run the same code as DTensor
programs: ``layers.constrain_acts`` pins the residual stream where the
reference pins it (after the embedding, after each attention layer inside
its remat group, after each Mamba2 unit and the shared block inside a
super block, after each xLSTM block), and the modules' ``local_map``
sites run what has no DTensor sharding strategy on each rank's shard.
"""
from __future__ import annotations

from typing import (Callable, Dict, Iterator, Mapping, Optional, Tuple,
                    Union)

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import leaf_order
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (Params, Shapes, apply_mlp, apply_norm,
                                      constrain_acts, cross_entropy, dtype_of,
                                      embed_shapes, embed_tokens, lm_logits,
                                      mlp_shapes, norm_shapes, placed)

Cache = Dict[str, torch.Tensor]          # {"k", "v"}: (B, T, KV, D), or
Caches = object                          # stacked (L, B, T, KV, D); or by
                                         # layer, {"layer_XX": Cache}; see
                                         # init_caches for the recurrent
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
                     positions: torch.Tensor, q_chunk: int = 128
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Training forward without cache, attention in query chunks of
    ``q_chunk``. Returns (x', aux: the MoE's load-balance loss, None
    without one)."""
    h = apply_norm(p["norm1"], x, cfg)
    q, k, v = attn_lib.qkv_project(p["attn"], h, cfg, positions)
    ctx = attn_lib.attend(q, k, v, causal=cfg.causal, q_chunk=q_chunk)
    return _mix(p, x, h, attn_lib.attn_output(p["attn"], ctx, cfg), cfg)


def prefill_attn_block(p: Dict[str, Params], x: torch.Tensor,
                       cfg: ModelConfig, positions: torch.Tensor,
                       cache: Cache) -> torch.Tensor:
    """``prefill_attn_block``: attention through the flash kernel, the
    prompt's k and v written into ``cache`` at 0."""
    h = apply_norm(p["norm1"], x, cfg)
    q, k, v = attn_lib.qkv_project(p["attn"], h, cfg, positions)
    ctx = attn_lib.prefill_attend(q, k, v, causal=cfg.causal)
    attn_lib.cache_write(cache, k, v, 0)
    return _mix(p, x, h, attn_lib.attn_output(p["attn"], ctx, cfg), cfg)[0]


def decode_attn_block(p: Dict[str, Params], x: torch.Tensor, cfg: ModelConfig,
                      cache: Cache, pos: int) -> torch.Tensor:
    """``decode_attn_block``: one token against the cache (written in
    place)."""
    h = apply_norm(p["norm1"], x, cfg)
    a, _ = attn_lib.decode_attend(p["attn"], h, cache, pos, cfg)
    return _mix(p, x, h, a, cfg)[0]


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        shapes = {**_prefixed("embed", embed_shapes(cfg)),
                  **_prefixed("final_norm", norm_shapes(cfg, cfg.d_model))}
        norm = _prefixed("norm", norm_shapes(cfg, cfg.d_model))
        if cfg.family == "hybrid":
            unit = {**norm, **_prefixed("mamba", m2.mamba2_shapes(cfg))}
            lead = (self.n_super, cfg.shared_attn_every)
            shapes.update({f"super/{k}": (lead + s, dt)
                           for k, (s, dt) in unit.items()})
            shapes.update(_prefixed("shared", attn_block_shapes(cfg)))
        elif cfg.family == "ssm":
            for i, kind in enumerate(self.xlstm_kinds):
                mixer = (xl.slstm_shapes if kind == "slstm"
                         else xl.mlstm_shapes)(cfg)
                shapes.update(_prefixed(f"blocks_list/layer_{i:02d}",
                                        {**norm, **_prefixed(kind, mixer)}))
        elif cfg.scan_layers:
            shapes.update({f"blocks/{k}": ((cfg.n_layers,) + s, dt)
                           for k, (s, dt) in attn_block_shapes(cfg).items()})
        else:
            for i in range(cfg.n_layers):
                shapes.update(_prefixed(f"blocks_list/layer_{i:02d}",
                                        attn_block_shapes(cfg)))
        self._shapes = {k: shapes[k] for k in leaf_order(shapes)}

    @property
    def n_super(self) -> int:
        """A hybrid model's super blocks: n_layers // shared_attn_every."""
        return self.cfg.n_layers // self.cfg.shared_attn_every

    @property
    def xlstm_kinds(self) -> Tuple[str, ...]:
        """An ssm model's block kind by layer: ``slstm`` at
        ``xlstm.slstm_at``, else ``mlstm``."""
        return tuple("slstm" if i in self.cfg.xlstm.slstm_at else "mlstm"
                     for i in range(self.cfg.n_layers))

    @property
    def _stacked(self) -> bool:
        return self.cfg.scan_layers and self.cfg.family in ATTN_FAMILIES

    # ---------------- parameters ----------------

    def param_specs(self) -> Dict[str, torch.Tensor]:
        """The model's leaves in leaf order, as ``meta`` tensors (shape and
        dtype, no storage)."""
        return {k: torch.empty(s, dtype=getattr(torch, dt), device="meta")
                for k, (s, dt) in self._shapes.items()}

    def _init_scale(self, path: str) -> float:
        """The reference's init scale of a drawn leaf, keyed on its whole
        path: ``w_down`` is d_ff ** -0.5 in the MLP, expert_d_ff ** -0.5 in
        the MoE's experts and its shared expert; the recurrent blocks'
        leaves take their module's scales."""
        cfg = self.cfg
        parts = path.split("/")
        leaf = parts[-1]
        if "mamba" in parts:
            return m2.init_scale(leaf, cfg)
        for kind in ("mlstm", "slstm"):
            if kind in parts:
                return xl.init_scale(
                    kind, "/".join(parts[parts.index(kind) + 1:]), cfg)
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

    @staticmethod
    def _fixed_value(path: str, shape, device) -> Optional[torch.Tensor]:
        """A leaf the reference's init sets rather than draws, in fp32:
        norm scales' ones, biases' zeros, and the recurrent blocks' own
        (Mamba2's A and D, the xLSTM gates' biases); None for a drawn
        leaf."""
        parts = path.split("/")
        leaf = parts[-1]
        if "mamba" in parts:
            return m2.fixed_value(leaf, shape, device)
        if "mlstm" in parts or "slstm" in parts:
            return xl.fixed_value(leaf, shape, device)
        if leaf == "scale":
            return torch.ones(shape, device=device)
        if leaf in BIAS_LEAVES:
            return torch.zeros(shape, device=device)
        return None

    def init(self, generator: torch.Generator, device) -> Params:
        """Fresh parameters: normal * scale (0.02 for the embedding and the
        router, fan-in ** -0.5 for projections, the recurrent blocks'
        own), ones for norm scales, zeros for biases, the reference's fixed
        values elsewhere (``_fixed_value``). Drawn leaf by leaf in leaf
        order on the generator's device (so a CPU generator's draw does not
        depend on ``device``), then moved to ``device``."""
        out = {}
        for path, (shape, dt) in self._shapes.items():
            dtype = getattr(torch, dt)
            x = self._fixed_value(path, shape, device)
            if x is None:
                x = torch.randn(shape, generator=generator,
                                device=generator.device)
                x = x.mul_(self._init_scale(path))
            out[path] = x.to(device=device, dtype=dtype)
        return out

    def _layers(self, params: Mapping[str, torch.Tensor]
                ) -> Iterator[Dict[str, Params]]:
        """Each layer's leaves, split by block part, in layer order."""
        cfg = self.cfg
        if self._stacked:
            stacked = self._part(params, "blocks")
            for i in range(cfg.n_layers):
                yield _split({k: v[i] for k, v in stacked.items()})
        else:
            for i in range(cfg.n_layers):
                yield _split(self._part(params, f"blocks_list/layer_{i:02d}"))

    def _units(self, params: Mapping[str, torch.Tensor]
               ) -> Iterator[Tuple[int, int, Dict[str, Params]]]:
        """A hybrid model's Mamba2 units: (super block i, unit j, its
        ``norm`` and ``mamba`` leaves), in order."""
        sup = self._part(params, "super")
        for i in range(self.n_super):
            for j in range(self.cfg.shared_attn_every):
                yield i, j, _split({k: v[i, j] for k, v in sup.items()})

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
        return (constrain_acts(x, cfg),
                torch.arange(x.shape[1], device=x.device))

    # ---------------- train forward ----------------

    def _recurrent(self, p: Dict[str, Params], x: torch.Tensor, kind: str,
                   state=None, return_state: bool = False):
        """A pre-norm residual recurrent block (``mamba``, ``mlstm`` or
        ``slstm``): (x + mixer(norm(x)), the mixer's state or None)."""
        apply = {"mamba": m2.apply_mamba2, "mlstm": xl.apply_mlstm_block,
                 "slstm": xl.apply_slstm_block}[kind]
        y, st = apply(p[kind], apply_norm(p["norm"], x, self.cfg), self.cfg,
                      state=state, return_state=return_state)
        return x + y, st

    def _trunk(self, params: Mapping[str, torch.Tensor], x: torch.Tensor,
               positions: torch.Tensor, q_chunk: int = 128
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The training forward between the embedding and the final norm:
        (x, the MoE's load-balance loss summed over layers, or None), each
        checkpoint of the reference's plan one ``_remat`` call."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            shared = _split(self._part(params, "shared"))
            units = list(self._units(params))
            per = cfg.shared_attn_every

            def super_block(xc, i):
                for _, _, up in units[i * per:(i + 1) * per]:
                    xc = constrain_acts(self._recurrent(up, xc, "mamba")[0],
                                        cfg)
                return constrain_acts(apply_attn_block(
                    shared, xc, cfg, positions, q_chunk)[0], cfg)
            for i in range(self.n_super):
                x = self._remat(super_block, x, i)
            return x, None
        if cfg.family == "ssm":
            for p, kind in zip(self._layers(params), self.xlstm_kinds):
                x = constrain_acts(self._remat(
                    lambda xc, p=p, kind=kind: self._recurrent(p, xc, kind)[0],
                    x), cfg)
            return x, None
        layers = list(self._layers(params))
        k = max(cfg.remat_group, 1) if self._stacked else 1
        if len(layers) % k:
            raise ValueError(f"{cfg.n_layers} layers are not whole remat "
                             f"groups of {k}")

        def group(xc, aux_sum, i):
            """k consecutive layers from layer i * k; the aux carried
            through, summed layer by layer as without groups."""
            for p in layers[i * k:(i + 1) * k]:
                xc, aux = apply_attn_block(p, xc, cfg, positions, q_chunk)
                xc = constrain_acts(xc, cfg)
                if aux is not None:
                    aux_sum = aux if aux_sum is None else aux_sum + aux
            return xc, aux_sum
        aux_sum = None
        for i in range(len(layers) // k):
            x, aux_sum = self._remat(group, x, aux_sum, i)
        return x, aux_sum

    def _remat(self, fn: Callable, *args):
        """``fn(*args)``, checkpointed under ``cfg.remat``: autograd keeps
        only the inputs and runs ``fn`` again in the backward. The forward
        draws no random numbers, so no RNG state is kept."""
        if not self.cfg.remat:
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)

    def loss(self, params: Mapping[str, torch.Tensor],
             batch: Mapping[str, torch.Tensor], *,
             q_chunk: int = 128) -> torch.Tensor:
        """Mean next-token loss of ``batch`` (``tokens`` or ``features``,
        ``patches`` for vision, ``labels``, optional ``loss_mask``) under
        ``params``, attention in query chunks of ``q_chunk``; an MoE adds
        0.01 times its load-balance loss averaged over layers (the
        reference returns the aux beside the loss)."""
        cfg = self.cfg
        x, positions = self._embed(params, batch)
        x, aux_sum = self._trunk(params, x, positions, q_chunk)
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
        """Zero caches of every layer, in the reference's tree and dtypes:
        - attention families: the compute dtype's stacked ``{"k", "v"}``
          of (L, B, T, KV, D) with ``scan_layers``, else
          ``{"layer_XX": {"k", "v"}}``;
        - hybrid: (``{"conv": (n_super, per, B, K-1, C) bf16, "ssm":
          (n_super, per, B, H, P, N) fp32}``, the shared block's
          ``{"k", "v"}`` at each site, (n_super, B, T, KV, D));
        - ssm: ``{"layer_XX": {"mlstm": (C, n, m) | "slstm": (c, n, m,
          h), "conv": bf16}}``."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            lead = (self.n_super, cfg.shared_attn_every)
            st = m2.init_mamba2_state(cfg, batch, device)
            sts = {k: v.new_zeros(lead + v.shape) for k, v in st.items()}
            kv = attn_lib.init_kv_cache(cfg, batch, cache_len, dtype_of(cfg),
                                        device)
            return sts, {k: v.new_zeros((self.n_super,) + v.shape)
                         for k, v in kv.items()}
        if cfg.family == "ssm":
            return {f"layer_{i:02d}": (
                xl.init_slstm_state if kind == "slstm"
                else xl.init_mlstm_state)(cfg, batch, device)
                for i, kind in enumerate(self.xlstm_kinds)}
        if self._stacked:
            shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads,
                     cfg.head_dim)
            return {kv: torch.zeros(shape, dtype=dtype_of(cfg), device=device)
                    for kv in ("k", "v")}
        return {f"layer_{i:02d}": attn_lib.init_kv_cache(
            cfg, batch, cache_len, dtype_of(cfg), device)
            for i in range(cfg.n_layers)}

    def _zero_caches(self, x: torch.Tensor, cache_len: int) -> Caches:
        """``init_caches``' zeros for the prompt's activations ``x`` (B, S,
        d); an ssm model's prefill returns each layer's state, so it takes
        none. For a placed ``x``, DTensors on its mesh: a hybrid model's
        Mamba2 states with their batch dim (2) over ``x``'s batch axes,
        each rank making only its shard; the attention caches replicated,
        the same zeros on every rank, until the step places them by
        ``cache_specs``."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return {}
        if not placed(x):
            return self.init_caches(x.shape[0], cache_len, x.device)
        from torch.distributed.tensor import zeros
        from repro_torch.dist.sharding import (batch_axes_of,
                                               placements_by_axis,
                                               replicated, tree_map)
        dm = x.device_mesh
        shapes = self.init_caches(x.shape[0], cache_len, "meta")

        def whole(_, t):
            return replicated(torch.zeros(t.shape, dtype=t.dtype,
                                          device=x.device), dm)
        if cfg.family != "hybrid":
            return tree_map(whole, shapes)
        sts, kvs = shapes
        rows = placements_by_axis(dm, {a: 2 for a in batch_axes_of(x)})
        return ({k: zeros(v.shape, dtype=v.dtype, device_mesh=dm,
                          placements=rows) for k, v in sts.items()},
                tree_map(whole, kvs))

    def _layer_caches(self, caches: Caches) -> Iterator[Cache]:
        """Each attention layer's cache, a view into the stacked tensors."""
        if self._stacked:
            for i in range(self.cfg.n_layers):
                yield {"k": caches["k"][i], "v": caches["v"][i]}
        else:
            for i in range(self.cfg.n_layers):
                yield caches[f"layer_{i:02d}"]

    def _hybrid_serve(self, params: Mapping[str, torch.Tensor],
                      x: torch.Tensor, caches: Caches, positions, pos):
        """Prefill (``pos`` None: each unit's end-of-sequence state and the
        shared block's k and v at every site written into ``caches``) or
        one decode step at ``pos`` from the states in ``caches``, written
        back in place: the conv window into its bf16 tensor, as the
        reference rounds it. Placed states are written the same way: a
        unit's slot of a DTensor is a view of each rank's batch shard."""
        cfg = self.cfg
        sts, kvs = caches
        shared = _split(self._part(params, "shared"))
        for i, j, up in self._units(params):
            state = None if pos is None else {k: v[i, j]
                                              for k, v in sts.items()}
            x, st = self._recurrent(up, x, "mamba", state=state,
                                    return_state=True)
            for k, v in st.items():
                sts[k][i, j].copy_(v)
            if j == cfg.shared_attn_every - 1:
                kv = {k: v[i] for k, v in kvs.items()}
                x = (prefill_attn_block(shared, x, cfg, positions, kv)
                     if pos is None else
                     decode_attn_block(shared, x, cfg, kv, pos))
        return x

    @torch.no_grad()
    def prefill(self, params: Mapping[str, torch.Tensor],
                batch: Union[torch.Tensor, Mapping[str, torch.Tensor]],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Caches]:
        """``batch``: the prompts' tokens (B, S), or a dict with ``tokens``
        (and ``patches`` for vision) or ``features`` (audio). Returns (the
        last position's logits (B, V) in the compute dtype, the caches:
        ``init_caches``' of length ``cache_len`` (default the sequence,
        prefix included), filled). Each attention layer, and a hybrid
        model's shared block at each site, is one launch of the
        flash-attention kernel on the card; the recurrent blocks are plain
        PyTorch. A placed prompt (DTensors) gives placed caches: the
        recurrent states on its batch shard, the attention caches
        replicated (``_zero_caches``)."""
        cfg = self.cfg
        if isinstance(batch, torch.Tensor):
            batch = {"tokens": batch}
        x, positions = self._embed(params, batch)
        caches = self._zero_caches(x, cache_len or x.shape[1])
        if cfg.family == "hybrid":
            x = self._hybrid_serve(params, x, caches, positions, None)
        elif cfg.family == "ssm":
            for i, (p, kind) in enumerate(zip(self._layers(params),
                                              self.xlstm_kinds)):
                x, caches[f"layer_{i:02d}"] = self._recurrent(
                    p, x, kind, return_state=True)
        else:
            for p, cache in zip(self._layers(params),
                                self._layer_caches(caches)):
                x = prefill_attn_block(p, x, cfg, positions, cache)
        x = apply_norm(self._part(params, "final_norm"), x[:, -1:], cfg)
        return lm_logits(self._part(params, "embed"), x, cfg)[:, 0], caches

    @torch.no_grad()
    def decode(self, params: Mapping[str, torch.Tensor], token: torch.Tensor,
               caches: Caches, pos: int) -> Tuple[torch.Tensor, Caches]:
        """One decode step. token: (B,) int; pos: the position it is written
        at (the same for every row). Returns (logits (B, V) in the compute
        dtype, the caches): the attention caches and a hybrid model's
        states are written in place; an ssm model's come back as new
        tensors, the conv windows in the compute dtype, as the reference's
        (placed states stay on their batch shard).
        Plain PyTorch: no kernel launches. An encoder-only model has no
        decode step."""
        cfg = self.cfg
        if cfg.encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        x = embed_tokens(self._part(params, "embed"), token[:, None], cfg)
        if cfg.family == "hybrid":
            x = self._hybrid_serve(params, x, caches, None, int(pos))
        elif cfg.family == "ssm":
            new = {}
            for (key, st), p, kind in zip(caches.items(),
                                          self._layers(params),
                                          self.xlstm_kinds):
                x, new[key] = self._recurrent(p, x, kind, state=st)
            caches = new
        else:
            for p, cache in zip(self._layers(params),
                                self._layer_caches(caches)):
                x = decode_attn_block(p, x, cfg, cache, int(pos))
        x = apply_norm(self._part(params, "final_norm"), x, cfg)
        return lm_logits(self._part(params, "embed"), x, cfg)[:, 0], caches


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
