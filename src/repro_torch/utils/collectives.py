"""Collective statistics of the port's placed programs.

Port of ``repro/utils/hlo.py``. The reference parses the collectives out of
XLA's compiled (SPMD-partitioned) HLO text; the port compiles no program,
so ``CollectiveRecorder`` records each collective as the program runs it
(on a world of real ranks, or as rank 0 of a fake world on meta tensors:
``launch.mesh.abstract_world``), and the functions below apply the
reference's per-kind wire estimates to those records. Bytes are per
device, as the HLO's post-partitioning shapes are. With b the result bytes
and g the group's size (``hlo.py:70-78``):

  all-reduce          2 b (g-1)/g   (ring: reduce-scatter + all-gather)
  all-gather          b (g-1)/g     (each rank receives the other shards)
  reduce-scatter      b (g-1)       (sends ~operand = result x g)
  all-to-all          b
  collective-permute  b
  broadcast           b             (torch only: what each receiving rank
                                     takes in)

HLO has no broadcast: XLA expresses the same transfer as an all-reduce
over the group, whose wire at g = 2 is also b, so the two packages' wire
bytes of a broadcast over two ranks agree. The port issues no
collective-permute; the key stays, at zero, as in the reference's dict.

Result bytes: the all-reduce's and the broadcast's tensor, the
all-gather's gathered output, the reduce-scatter's scattered output, the
all-to-all's output; a coalesced collective is one record of all its
tensors, as XLA's combined collective is one instruction with a tuple
result.

``hbm_traffic_estimate`` (``hlo.py:97``) reads XLA's post-fusion program
for the reference's probes, not for the dry-run, and has no counterpart
here.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")

# op name (without the overload) -> kind, for the eager ``c10d`` ops that
# ``torch.distributed``'s functions run and the ``_c10d_functional`` ones
# that DTensor issues
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "broadcast_": "broadcast",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
}
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
# DTensor's own all-to-all of a Shard(i) -> Shard(j) redistribution (on a
# CUDA mesh; on a CPU mesh DTensor runs an all-gather and a chunk instead);
# its namespace's other ops move no data
_DTENSOR = {"shard_dim_alltoall": "all-to-all"}
# ops of the other two namespaces that move no data between ranks
_PASS = {"wait_tensor", "_wrap_tensor_autograd"}
_TABLES = {"c10d": _C10D, "_c10d_functional": _FUNCTIONAL,
           "_dtensor": _DTENSOR}


class Collective(NamedTuple):
    """One collective as run: its kind (``KINDS``), the torch op, the
    global ranks of its group and the result bytes on this rank."""
    kind: str
    op: str
    ranks: Tuple[int, ...]
    result_bytes: int


def _tensors(x: Any) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_ranks(func, args, kwargs) -> Tuple[int, ...]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    if func.namespace == "c10d":
        group = next(a for a in list(args) + list(kwargs.values())
                     if isinstance(a, torch.ScriptObject))
        group = dist.ProcessGroup.unbox(group)
    else:
        names = [a.name for a in func._schema.arguments]
        i = names.index("group_name")
        group = kwargs["group_name"] if i >= len(args) else args[i]
        if isinstance(group, str):
            group = _resolve_process_group(group)
    return tuple(dist.get_process_group_ranks(group))


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective run inside the block, once each, in the
    order run, as ``Collective`` records (``self.records``).

    It sees the collectives at the dispatcher: the eager ``c10d`` ops
    (``torch.distributed.all_reduce`` and the rest reach the dispatcher as
    ``c10d.allreduce_`` and the like), the functional ones that DTensor's
    redistributions issue, and DTensor's ``shard_dim_alltoall``. An
    operation on DTensors is handed back to DTensor (``NotImplemented``) so
    that the collectives its sharding propagation inserts come back here
    on the local tensors.
    ``wait_tensor`` is skipped, as ``hlo.py`` skips an async collective's
    ``-done``. Any other op of those namespaces (reduce, gather, scatter,
    point-to-point, a barrier) raises, so that none goes uncounted.

    Bytes are this rank's. Under an uneven ``Shard`` the ranks' shards
    differ; a fake world records as rank 0, which holds the larger
    ``torch.chunk`` piece: the padded shard that XLA's per-device shapes
    show."""

    def __init__(self):
        super().__init__()
        self.records: List[Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ns = getattr(func, "namespace", None)
        table = _TABLES.get(ns)
        if table is None:
            return out
        name = func._schema.name.split("::")[-1]
        if name in _PASS or (table is _DTENSOR and name not in table):
            return out
        kind = table.get(name)
        if kind is None:
            raise NotImplementedError(f"{func}: a collective with no kind "
                                      "in the recorder's table")
        result = args[0] if table is _C10D else out
        self.records.append(Collective(kind, f"{ns}.{name}",
                                       _group_ranks(func, args, kwargs),
                                       _nbytes(result)))
        return out


def _wire(kind: str, b: float, g: int) -> float:
    if kind == "all-reduce":
        return 2 * b * (g - 1) / max(g, 1)
    if kind == "all-gather":
        return b * (g - 1) / max(g, 1)
    if kind == "reduce-scatter":
        return b * (g - 1)
    return b


def collective_stats(records: Iterable[Collective]
                     ) -> Dict[str, Dict[str, float]]:
    """Per collective kind (the reference's five and ``broadcast``):
    count, result_bytes and wire_bytes, per device."""
    out: Dict[str, Dict[str, float]] = {
        k: {"count": 0, "result_bytes": 0, "wire_bytes": 0} for k in KINDS}
    for r in records:
        b, g = r.result_bytes, len(r.ranks)
        out[r.kind]["count"] += 1
        out[r.kind]["result_bytes"] += b
        out[r.kind]["wire_bytes"] += _wire(r.kind, b, g)
    return out


def total_wire_bytes(stats: Dict[str, Dict[str, float]]) -> float:
    return sum(v["wire_bytes"] for v in stats.values())


def group_size_histogram(records: Iterable[Collective]) -> Dict[int, int]:
    """Collective count per group size. A DiLoCo-correct multi-pod inner
    step must show no groups of size 2 (pod pairs) or >= 32 (merged pod x
    data/model axes)."""
    hist: Dict[int, int] = {}
    for r in records:
        hist[len(r.ranks)] = hist.get(len(r.ranks), 0) + 1
    return hist


def has_axis_collectives(records: Iterable[Collective],
                         axis_group_size: int) -> bool:
    """Heuristic: any collective whose group size equals
    ``axis_group_size``."""
    return any(len(r.ranks) == axis_group_size for r in records)


__all__ = ["KINDS", "Collective", "CollectiveRecorder", "collective_stats",
           "total_wire_bytes", "group_size_histogram",
           "has_axis_collectives"]
