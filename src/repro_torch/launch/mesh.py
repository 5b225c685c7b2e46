"""Meshes: the production meshes as abstract axis names and sizes, and the
meshes of real ranks that the steps run on.

Port of ``repro/launch/mesh.py``:

  make_production_mesh   single pod (data=16, model=16) = 256 devices;
                         multi-pod (pod=2, data=16, model=16) = 512, the
                         ``pod`` axis the DiLoCo worker boundary
  make_test_mesh         the small variants (2, 4) and (2, 2, 2)
  process_mesh           a mesh of the world that exists: a ``DeviceMesh``
                         of the given shape over the initialised process
                         group (``torchrun``'s, or a test's spawned ranks),
                         one card a rank, or CPU ranks with
                         ``device="cpu"``
  local_mesh             the multi-pod axis names, every size 1, on one
                         device (the card unless ``device="cpu"``)
  abstract_world         an abstract mesh's ``DeviceMesh`` over a fake
                         world of its size, as rank 0, in one process with
                         no device (the dry-run's collective count)
  mesh_context           make a mesh the ambient one (``current_mesh``;
                         both from ``dist.sharding``, where the steps read
                         it)

The production and test meshes hold no devices: the sharding rules and
the dry-run read their axis sizes. ``process_mesh`` refuses a world whose
size is not the mesh's, and a CUDA mesh of more ranks than the host has
cards (NCCL refuses two ranks on one card); it never carries on on the
CPU. A local mesh is backed by a
``torch.distributed`` ``DeviceMesh`` over a process group of one process
built on an in-process ``HashStore``: the group is global state, so
``local_mesh`` is a context manager that creates it on entry (when no group
exists yet) and destroys it on exit. Importing this module touches no
device and no process group.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Tuple

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import current_mesh, mesh_context  # noqa: F401


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device_mesh: Any = None      # a local mesh's DeviceMesh; None: abstract

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def sub(self, names: Tuple[str, ...]) -> "Mesh":
        """The mesh over ``names`` that holds this rank (a ``DeviceMesh``
        slice: its groups hold only ranks that share the other axes'
        coordinates)."""
        sizes = self.axis_sizes
        dm = None if self.device_mesh is None else self.device_mesh[names]
        return Mesh(tuple(names), tuple(sizes[n] for n in names), dm)

    def coordinate(self, name: str) -> int:
        """This rank's coordinate on axis ``name``."""
        return self.device_mesh.get_local_rank(name)


def _axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    return Mesh(_axes(multi_pod), (2, 16, 16) if multi_pod else (16, 16))


def make_test_mesh(*, multi_pod: bool = False) -> Mesh:
    """Small-device-count variant (8 devices)."""
    return Mesh(_axes(multi_pod), (2, 2, 2) if multi_pod else (2, 4))


@contextlib.contextmanager
def process_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
                 device="cuda") -> Iterator[Mesh]:
    """A mesh of ``shape`` over the process group that is already
    initialised (``torchrun``'s environment, or ranks a test spawned):
    rank r at row-major position r. Raises when the world is not
    ``prod(shape)`` ranks, and, for ``device="cuda"``, when the world has
    more ranks than the host has cards; each rank takes the card of its
    local rank. The group is the caller's and stays as it is."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = tuple(int(n) for n in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} for axes {names}")
    if not dist.is_initialized():
        raise RuntimeError("process_mesh needs an initialised process group "
                           "(torchrun, or init_process_group per rank)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a world of {world} ranks cannot hold a mesh "
                         f"{dict(zip(names, shape))} of {math.prod(shape)}")
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if world > cards:
            raise RuntimeError(f"a CUDA mesh of {world} ranks needs {world} "
                               f"cards; this host has {cards}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    yield Mesh(names, shape, init_device_mesh(dev.type, shape,
                                              mesh_dim_names=names))


@contextlib.contextmanager
def local_mesh(device="cuda") -> Iterator[Mesh]:
    """A mesh of one device with the multi-pod axis names, every size 1:
    a ``DeviceMesh`` on a world of one process. Creates the process group
    (gloo, on a ``HashStore``: no socket to another process) when there is
    none and destroys it on exit; an existing group is used and left as it
    is."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    names = _axes(True)
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        if dist.get_world_size() != 1:
            raise RuntimeError("local_mesh needs a world of one process, "
                               f"not {dist.get_world_size()}")
        dm = init_device_mesh(dev.type, (1,) * len(names),
                              mesh_dim_names=names)
        yield Mesh(names, (1,) * len(names), dm)
    finally:
        if own:
            dist.destroy_process_group()


@contextlib.contextmanager
def abstract_world(mesh: Mesh) -> Iterator[Mesh]:
    """``mesh`` (a production or test mesh) with a CPU ``DeviceMesh`` over
    a world of ``mesh.size`` ranks that exists only in this process, as
    rank 0: a ``"fake"`` process group on ``FakeStore``, whose collectives
    move nothing, so that a placed step runs its program (on meta tensors)
    and its collectives can be recorded. The group is created on entry and
    destroyed on exit; an existing group is refused, as ``local_mesh``
    guards its own. ``fake_pg`` is a private module of PyTorch's testing
    package (it registers the ``"fake"`` backend), imported here only."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("abstract_world needs no process group, but one "
                           f"of {dist.get_world_size()} ranks exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield Mesh(mesh.axis_names, mesh.shape, init_device_mesh(
            "cpu", mesh.shape, mesh_dim_names=mesh.axis_names))
    finally:
        dist.destroy_process_group()
