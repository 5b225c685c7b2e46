"""Meshes: the production meshes as abstract axis names and sizes, and a
one-card mesh to run the steps on.

Port of ``repro/launch/mesh.py``:

  make_production_mesh   single pod (data=16, model=16) = 256 devices;
                         multi-pod (pod=2, data=16, model=16) = 512, the
                         ``pod`` axis the DiLoCo worker boundary
  make_test_mesh         the small variants (2, 4) and (2, 2, 2)
  local_mesh             the multi-pod axis names, every size 1, on one
                         device (the card unless ``device="cpu"``)
  mesh_context           make a mesh the ambient one (``current_mesh``;
                         both from ``dist.sharding``, where the steps read
                         it)

The production and test meshes hold no devices: the sharding rules and
the dry-run read their axis sizes. A local mesh is backed by a
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


def _axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    return Mesh(_axes(multi_pod), (2, 16, 16) if multi_pod else (16, 16))


def make_test_mesh(*, multi_pod: bool = False) -> Mesh:
    """Small-device-count variant (8 devices)."""
    return Mesh(_axes(multi_pod), (2, 2, 2) if multi_pod else (2, 4))


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
