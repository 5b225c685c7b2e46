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
  place               a tensor through its placements on a local mesh
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


def place(x: torch.Tensor, spec: Spec, mesh, name: str = "") -> torch.Tensor:
    """``x`` (this device's shard) through its placements on ``mesh``: the
    port's ``with_sharding_constraint``. The spec must divide ``x``'s dims
    on the mesh's axis sizes; on a local mesh (a ``DeviceMesh`` behind it)
    the tensor goes through ``DTensor.from_local`` with its placements and
    comes back as the local tensor, which on a mesh of size 1 is ``x``
    itself."""
    shard_shape(x.shape, spec, mesh.axis_sizes, name)
    if mesh.device_mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, mesh.device_mesh, placements(spec, mesh),
                              run_check=False).to_local()


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
