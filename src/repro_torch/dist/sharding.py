"""Sharding rules for the production meshes.

Port of ``repro/dist/sharding.py``, as pure functions of a leaf's name, its
shape and the mesh's axis sizes. A spec is a tuple with one entry per dim:
an axis name, a tuple of axis names, or None (replicated): the content of
the reference's ``PartitionSpec``.

  spec_for            one parameter leaf -> spec (name + shape heuristics;
                      every rule degrades to replication when a dim is not
                      divisible by the mesh axis size)
  param_specs         a parameter dict -> specs by path
  batch_specs         input batches (leading batch dim over the data axes)
  cache_specs         KV caches (batch- or sequence-sharded decode)
  stacked_axes_tree   leading layer-axis count per leaf (scanned stacks)
  shard_shape         a leaf's per-device shape under its spec (checks that
                      every placement divides)
  shardings_of        specs -> DTensor placements on a mesh
  place               a tensor (whole, or a DTensor) to its placements on
                      a mesh of ranks: the reference's
                      ``with_sharding_constraint``
  place_tree          a tree of tensors at a tree of specs
  place_caches        decode caches at ``cache_specs``' placements
  gather              a DTensor back to the whole tensor (tests, checks)
  from_shard          this rank's shard of a leaf as a DTensor
  on_shards           a function of local tensors run under ``local_map``
                      on each rank's shards (the sites with no DTensor
                      sharding strategy; see ``models/``)
  on_batch_shard      the same on the batch shard, weights gathered
  mesh_context        make a mesh the ambient one (``current_mesh``), as
                      the reference's ``jax.set_mesh``

The layout strategy is FSDP over ``data`` + tensor parallelism over
``model``: weights shard their d_model (or expert-input) dimension over the
data axis and their heads / experts / head_dim dimension over the model
axis; norms and biases are tiny and stay replicated. The ``pod`` axis never
appears here: it is the DiLoCo worker boundary and carries only the outer
exchange (``repro_torch.dist.steps.make_outer_exchange``).

Trees are the port's: a flat dict keyed by the reference's ``/``-joined
paths (parameters), or nested dicts, tuples and lists of tensors (caches),
whose paths join the keys and indices the same way.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import (Any, Callable, Dict, Iterator, Mapping, Optional,
                    Sequence, Tuple, Union)

import torch

AxisName = Union[str, Tuple[str, ...]]


class Spec(tuple):
    """One leaf's placement: a tuple with one entry per dim (an axis name,
    a tuple of names, or None). A tuple subclass only so that tree walks
    take it for a leaf, as the reference's ``is_leaf=PartitionSpec``."""

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _divisible(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def tree_map(fn: Callable, tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over nested dicts, tuples and lists of leaves
    (tensors, ``Spec``s, anything else), keeping the structure; a path
    joins keys and indices with ``/``."""
    def sub(key):
        return f"{path}/{key}" if path else str(key)
    if isinstance(tree, Spec):
        return fn(path, tree)
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, sub(i)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree: Any) -> Dict[str, Any]:
    """Every leaf of ``tree`` by path, in the tree's order."""
    out: Dict[str, Any] = {}
    tree_map(lambda p, x: out.__setitem__(p, x), tree)
    return out


def n_layer_axes(name: str) -> int:
    """Leading scanned-layer axes of a leaf (1 for stacked block params).
    Only a top-level ``blocks/`` counts: the reference's rule, so a hybrid
    model's ``super/`` leaves and the unstacked ``blocks_list/`` ones give
    0, as they do there."""
    return 1 if name.split("/", 1)[0] == "blocks" else 0


def stacked_axes_tree(params: Mapping[str, Any]) -> Dict[str, int]:
    """Path -> how many leading axes of that leaf are scanned layer axes:
    the granularity contract of ``core.heloco.block_correct``."""
    return {k: n_layer_axes(k) for k in params}


def _axis_product(axis: AxisName, axis_sizes: Mapping[str, int]) -> int:
    names = (axis,) if isinstance(axis, str) else axis
    return math.prod(axis_sizes.get(a, 1) for a in names)


def spec_for(name: str, shape: Sequence[int], *,
             data_axis: AxisName = "data", model_axis: str = "model",
             axis_sizes: Mapping[str, int], attn_style: str = "tp") -> Spec:
    """Spec of one parameter leaf. Rules (first match wins, every
    assignment requires divisibility):
      - norms / biases / rank<=1 payloads: fully replicated
      - embeddings: vocab axis over model, d_model over data
      - MoE expert stacks: expert axis over model, expert-input over data
      - attention projections: heads over model, falling back to head_dim
        when the head count does not divide the model axis (qwen2's 28
        heads on a 16-way axis); d_model over data
      - everything else: last axis over model, first remaining over data
    attn_style="dp" drops the tensor-parallel (model) assignment and keeps
    only the FSDP data-axis sharding."""
    shape = tuple(int(s) for s in shape)
    rank = len(shape)
    dsz = _axis_product(data_axis, axis_sizes)
    msz = axis_sizes.get(model_axis, 1)
    parts = name.split("/")
    leaf = parts[-1]
    spec: list = [None] * rank
    n_layer = n_layer_axes(name)

    # tiny / vector-like leaves stay replicated
    if ("norm" in name or leaf in ("scale", "bias")
            or leaf in ("bq", "bk", "bv", "bo", "b_up", "b_gate", "b_down")
            or rank - n_layer <= 1):
        return Spec(spec)

    # model (tensor-parallel) axis
    model_idx: Optional[int] = None
    if attn_style != "dp":
        if "embed" in parts[0]:
            candidates = [max(range(rank), key=lambda i: shape[i])]  # vocab
        elif "moe" in parts:
            candidates = [n_layer]                   # expert axis
        elif "attn" in parts and rank - n_layer >= 2:
            candidates = [rank - 2, rank - 1]        # heads, then head_dim
        else:
            candidates = [rank - 1]
        for i in candidates:
            if i >= n_layer and _divisible(shape[i], msz):
                model_idx = i
                spec[i] = model_axis
                break

    # data (FSDP) axis
    for i in range(n_layer, rank):
        if i != model_idx and _divisible(shape[i], dsz):
            spec[i] = data_axis
            break
    return Spec(spec)


def param_specs(params: Mapping[str, Any], *, axis_sizes: Mapping[str, int],
                data_axis: AxisName = "data", model_axis: str = "model",
                attn_style: str = "tp") -> Dict[str, Spec]:
    """Spec of every leaf of a parameter dict (tensors, meta tensors or
    anything with a ``shape``)."""
    return {k: spec_for(k, x.shape, data_axis=data_axis,
                        model_axis=model_axis, axis_sizes=axis_sizes,
                        attn_style=attn_style)
            for k, x in params.items()}


def batch_specs(batch: Any, *, batch_axes: Tuple[str, ...] = ("data",)
                ) -> Any:
    """Leading (batch) dim over ``batch_axes``; everything else
    replicated."""
    axes = tuple(batch_axes)
    entry = axes if len(axes) > 1 else axes[0]
    return tree_map(
        lambda _, x: Spec((entry,) + (None,) * (len(x.shape) - 1)), batch)


def cache_specs(caches: Any, *, batch_sharded: bool,
                axis_sizes: Mapping[str, int], data_axis: AxisName = "data",
                model_axis: str = "model") -> Any:
    """KV-cache specs for decode, layout (L, B, S, kv_heads, hd):
    batch_sharded=True puts the batch over the data axis (throughput
    decode), False the sequence (context-parallel long decode). kv heads
    shard over the model axis only when they divide it; GQA's few kv heads
    fall back to head_dim. A leaf of another rank raises ValueError, as the
    reference's unpacking does (the recurrent families' states, and the
    (B, S, KV, D) caches of a model whose layers are not stacked)."""
    msz = axis_sizes.get(model_axis, 1)
    dsz = _axis_product(data_axis, axis_sizes)

    def one(_, x):
        L, B, S, KV, HD = x.shape
        spec: list = [None] * 5
        if _divisible(KV, msz):
            spec[3] = model_axis
        elif _divisible(HD, msz):
            spec[4] = model_axis
        if batch_sharded:
            if B % dsz == 0:
                spec[1] = data_axis
        elif S % dsz == 0:
            spec[2] = data_axis
        return Spec(spec)

    return tree_map(one, caches)


def shard_shape(shape: Sequence[int], spec: Spec,
                axis_sizes: Mapping[str, int], name: str = ""
                ) -> Tuple[int, ...]:
    """Per-device shape of a leaf under ``spec``; raises ValueError when a
    placement does not divide its dim (or the spec's rank is not the
    leaf's)."""
    shape = tuple(int(s) for s in shape)
    if len(spec) != len(shape):
        raise ValueError(f"{name}: spec {spec} for a rank-{len(shape)} leaf")
    out = []
    for dim, entry in zip(shape, spec):
        parts = 1 if entry is None else _axis_product(entry, axis_sizes)
        if dim % parts:
            raise ValueError(f"{name}: dim {dim} is not divisible by "
                             f"{entry} ({parts} devices), spec {spec}")
        out.append(dim // parts)
    return tuple(out)


def replicated(x: torch.Tensor, device_mesh) -> Any:
    """A whole tensor, the same on every rank, as a replicated DTensor on
    ``device_mesh`` (each rank's local tensor is ``x``: no copy, no
    collective)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, device_mesh, placements_by_axis(device_mesh),
                              run_check=False)


def from_shard(local: torch.Tensor, spec: Spec, mesh) -> Any:
    """This rank's even shard of a leaf under ``spec`` as a DTensor on
    ``mesh`` (no collective: every rank passes its own shard)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh.device_mesh, placements(spec, mesh),
                              run_check=False)


def placements(spec: Spec, mesh) -> tuple:
    """One spec -> DTensor placements on ``mesh`` (``launch.mesh.Mesh``):
    one for each mesh axis, ``Shard(d)`` on the axes dim d names (a tuple
    entry shards one dim over several axes, major first), ``Replicate()``
    on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.axis_names]
    for dim, entry in enumerate(spec):
        for axis in (() if entry is None else
                     (entry,) if isinstance(entry, str) else entry):
            if axis not in mesh.axis_names:
                raise ValueError(f"spec {spec} names axis {axis!r}; the mesh "
                                 f"has {mesh.axis_names}")
            out[mesh.axis_names.index(axis)] = Shard(dim)
    return tuple(out)


def shardings_of(specs: Any, mesh) -> Any:
    """A tree of specs -> the same tree of ``placements`` on ``mesh``."""
    return tree_map(lambda _, s: placements(s, mesh), specs)


def place(x: torch.Tensor, spec: Spec, mesh, name: str = "", *,
          even: bool = True) -> torch.Tensor:
    """``x`` at its placements on ``mesh``: the port's
    ``with_sharding_constraint``. A whole tensor (the same on every rank)
    goes through ``distribute_tensor``, a DTensor through ``redistribute``;
    either way the placements are ``placements(spec, mesh)``, and the
    result is a DTensor. A whole tensor must be the same on every rank:
    each rank cuts its own shard from it, with no collective (on a mesh of
    one rank the shard is ``x`` itself, not a copy). On an abstract mesh
    (no ``DeviceMesh``) ``x`` comes back as it is. ``even`` (parameters,
    batches, caches) requires every placement to divide its dim
    (``shard_shape``); without it (the activation pins) a dim that does
    not divide is sharded unevenly, where the reference pads an
    intermediate."""
    if even:
        shard_shape(x.shape, spec, mesh.axis_sizes, name)
    if mesh.device_mesh is None:
        return x
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = placements(spec, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh.device_mesh, pl)
    if mesh.size == 1:
        # the one shard is the whole tensor: no copy
        return from_shard(x, spec, mesh)
    # every rank holds the whole tensor: each keeps its own shard, with no
    # collective
    return distribute_tensor(x, mesh.device_mesh, pl, src_data_rank=None)


def place_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every leaf of ``tree`` at its spec in ``specs`` (the same paths)."""
    flat = tree_leaves(specs)
    return tree_map(lambda path, x: place(x, flat[path], mesh, path), tree)


def place_caches(caches: Any, mesh, *, batch_sharded: bool,
                 data_axis: AxisName = "data") -> Any:
    """Decode caches at ``cache_specs``' placements on ``mesh``, as the
    reference's caller places them before decode: the stacked (L, B, S,
    KV, D) leaves by the rule itself, a model's unstacked (B, S, KV, D)
    ones as one layer of it. The recurrent families' states have no layout
    there and raise, as the rule does: their decode takes the caches as
    the placed prefill returned them, the states on the batch shard."""
    kw = dict(batch_sharded=batch_sharded, axis_sizes=mesh.axis_sizes,
              data_axis=data_axis)

    def one(path, x):
        if x.dim() == 4:
            layer = torch.empty((1,) + tuple(x.shape), device="meta")
            spec = Spec(cache_specs({"x": layer}, **kw)["x"][1:])
        else:
            spec = cache_specs({"x": x}, **kw)["x"]
        return place(x, spec, mesh, path)
    return tree_map(one, caches)


def is_placed(x: Any) -> bool:
    """Whether ``x`` is a DTensor (a placed step's tensor)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def gather(x: Any) -> Any:
    """A DTensor's whole tensor on every rank (a collective); anything else
    as it is."""
    return x.full_tensor() if is_placed(x) else x


def gather_tree(tree: Any) -> Any:
    return tree_map(lambda _, x: gather(x), tree)


def mesh_axes(x) -> Dict[str, Any]:
    """A DTensor's placement on each axis of its mesh, by axis name."""
    return dict(zip(x.device_mesh.mesh_dim_names, x.placements))


def batch_axes_of(x) -> Tuple[str, ...]:
    """The mesh axes over which a DTensor's leading (batch) dim is
    sharded."""
    from torch.distributed.tensor import Shard
    return tuple(a for a, p in mesh_axes(x).items() if p == Shard(0))


def placements_by_axis(device_mesh, shard: Optional[Mapping[str, int]] = None,
                       partial: Sequence[str] = ()) -> tuple:
    """Placements on ``device_mesh``: ``Shard(dim)`` on the axes ``shard``
    maps, ``Partial()`` (a sum) on ``partial``, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    shard = shard or {}
    return tuple(Shard(shard[a]) if a in shard else
                 Partial() if a in partial else Replicate()
                 for a in device_mesh.mesh_dim_names)


def on_shards(fn: Callable, args: Sequence[Any], in_placements: Sequence,
              out_placements, *, device_mesh,
              in_grad_placements: Optional[Sequence] = None):
    """``fn(*local tensors)`` under ``local_map``: each DTensor argument is
    first redistributed to its entry of ``in_placements`` (None for an
    argument that is not a tensor), ``fn`` runs on this rank's local
    tensors, and its outputs come back as DTensors at ``out_placements``
    (one entry per output, a tuple of one for a single output).
    ``in_grad_placements`` names where an argument's gradient lies when it
    is not the argument's own placement (a ``Partial`` sum over an axis on
    which each rank used a part of a replicated input)."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=(None if in_grad_placements is None
                                         else tuple(in_grad_placements)),
                     device_mesh=device_mesh,
                     redistribute_inputs=True)(*args)


def on_batch_shard(fn: Callable, x, weights: Mapping[str, Any], *,
                   keep_batch: bool = True, sums: int = 0):
    """``fn(x_local, weights)`` on this rank's batch shard of a placed
    ``x`` (its batch axes kept, every other axis gathered) with the
    ``weights`` gathered whole (``Replicate``: the collectives GSPMD might
    place elsewhere). Returns ``fn``'s output at ``x``'s batch placement;
    with ``sums`` > 0, ``fn`` returns ``(out, s_1, .., s_sums)`` and each
    s_i comes back as a ``Partial`` sum over the batch axes. The weights'
    gradients are such sums too. ``keep_batch=False`` gathers the batch as
    well (a function whose rows do not part at the shard boundary)."""
    dm = x.device_mesh
    axes = batch_axes_of(x) if keep_batch else ()
    x_pl = placements_by_axis(dm, {a: 0 for a in axes})
    summed = placements_by_axis(dm, partial=axes)
    whole = placements_by_axis(dm)
    names = list(weights)

    def local(xl, *ws):
        return fn(xl, dict(zip(names, ws)))

    n = len(names)
    return on_shards(local, (x, *weights.values()), (x_pl,) + (whole,) * n,
                     (x_pl,) + (summed,) * sums,
                     device_mesh=dm,
                     in_grad_placements=(x_pl,) + (summed,) * n)


def batch_shards(x) -> int:
    """How many shards a placed ``x``'s batch is cut into."""
    dm = x.device_mesh
    return math.prod(dm.size(dm.mesh_dim_names.index(a))
                     for a in batch_axes_of(x))


_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("mesh",
                                                          default=None)


@contextlib.contextmanager
def mesh_context(mesh) -> Iterator[Any]:
    """Make ``mesh`` the ambient mesh (``current_mesh``) inside the block:
    the steps' placement constraints resolve against it."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def current_mesh():
    return _AMBIENT.get()
