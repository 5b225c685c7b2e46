"""Flat packed view of a parameter dict for the arrival fast path.

Port of ``repro/core/packing.py``. Parameters are a flat dict keyed by
``/``-joined key paths (``"blocks_list/layer_00/attn/wq"``); the ordered
list of those paths takes the place of the reference's treedef.

Memory format (identical to the reference, element for element):

  * Leaves are laid out back to back in ``jax.tree.flatten`` order, i.e.
    nested dict keys sorted at every level (``leaf_order``).
  * A leaf with ``n`` stacked leading layer axes is split into
    ``prod(shape[:n])`` blocks, one per layer.
  * Each block is zero-padded to whole 128-lane rows and starts on a row
    boundary; ``row_block[r]`` is the block owning row ``r``. Zero padding
    is invariant under every packed sweep, so it is never re-zeroed.
  * Trailing filler rows (``padded_rows`` alignment) belong to block 0 and
    stay zero.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterable, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.tiling import LANES, padded_rows

Params = Dict[str, torch.Tensor]


class Packed(NamedTuple):
    """A value that already lives in packed (R, 128) form.

    ``pack`` passes it through, so a producer that ends with a packed
    buffer (the packed int8 round-trip) hands it straight to the packed
    arrival path without an unpack -> re-pack detour."""
    buf: torch.Tensor


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c with an IEEE division on every device: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal instead."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def leaf_order(paths: Iterable[str]) -> Tuple[str, ...]:
    """``jax.tree.flatten`` order of a nested dict given by its key paths."""
    return tuple(sorted(paths, key=lambda p: tuple(p.split("/"))))


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Static placement of one leaf inside the packed buffer."""
    path: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    n_stack: int               # number of blocks (prod of stacked layer axes)
    block_elems: int           # elements per block
    rows_per_block: int        # 128-lane rows per block (zero-padded)
    start_row: int
    start_block: int


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Static map between a parameter dict and its packed (R, 128) view."""
    leaves: Tuple[LeafSpec, ...]
    data_rows: int             # rows backed by leaf data
    n_rows: int                # R: data_rows aligned by ``padded_rows``
    n_blocks: int
    total_elems: int           # real (unpadded) elements

    @property
    def paths(self) -> Tuple[str, ...]:
        return tuple(leaf.path for leaf in self.leaves)

    @functools.cached_property
    def row_block(self) -> np.ndarray:
        """(R,) int32: block id of each row (filler rows -> block 0)."""
        ids = np.zeros(self.n_rows, np.int32)
        for leaf in self.leaves:
            r0 = leaf.start_row
            for s in range(leaf.n_stack):
                ids[r0 + s * leaf.rows_per_block:
                    r0 + (s + 1) * leaf.rows_per_block] = leaf.start_block + s
        return ids

    @functools.cached_property
    def block_sizes(self) -> np.ndarray:
        """(B,) int64: real element count of each block."""
        sizes = np.zeros(self.n_blocks, np.int64)
        for leaf in self.leaves:
            sizes[leaf.start_block:leaf.start_block + leaf.n_stack] = \
                leaf.block_elems
        return sizes

    @functools.cached_property
    def block_row_ranges(self) -> tuple:
        """((start_row, end_row), ...) per block, in block-id order. Blocks
        are contiguous and in increasing row order, which is what lets the
        per-block reduction be one segment sum over row counts."""
        ranges = [None] * self.n_blocks
        for leaf in self.leaves:
            for s in range(leaf.n_stack):
                r0 = leaf.start_row + s * leaf.rows_per_block
                ranges[leaf.start_block + s] = (r0, r0 + leaf.rows_per_block)
        return tuple(ranges)

    @functools.cached_property
    def _on_device(self) -> dict:
        return {}

    def device_tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Tables on ``device``, made once per device so an arrival issues
        no host-to-device copy: ``row_block`` (R,) int32, and the segment
        lengths of the per-block sum over three stacked (R,) planes, each
        plane being its B blocks' row counts plus one segment of filler
        rows, (3 * (B + 1),) int64."""
        key = str(torch.device(device))
        tabs = self._on_device.get(key)
        if tabs is None:
            tabs = (torch.from_numpy(self.row_block).to(device),
                    self.segment_lengths(device, 3))
            self._on_device[key] = tabs
        return tabs

    def segment_lengths(self, device, planes: int) -> torch.Tensor:
        """Segment lengths of the per-block sum over ``planes`` stacked (R,)
        planes, each its B blocks' row counts plus one segment of filler
        rows: (planes * (B + 1),) int64 on ``device``, made once."""
        key = (str(torch.device(device)), planes)
        seg = self._on_device.get(key)
        if seg is None:
            rows = [e - s for s, e in self.block_row_ranges]
            plane = np.array(rows + [self.n_rows - self.data_rows], np.int64)
            seg = torch.from_numpy(np.tile(plane, planes)).to(device)
            self._on_device[key] = seg
        return seg


def build_layout(params: Mapping[str, object],
                 stacked_axes: Optional[Mapping[str, int]] = None
                 ) -> BlockLayout:
    """Static layout for a dict of tensors or arrays (anything with
    ``.shape`` and ``.dtype``). ``stacked_axes`` maps a path to its number of
    leading layer axes; each layer then becomes its own block."""
    if not params:
        raise ValueError("cannot build a BlockLayout for an empty dict")
    stacked_axes = stacked_axes or {}
    unknown = set(stacked_axes) - set(params)
    if unknown:
        raise ValueError(f"stacked_axes names unknown leaves {sorted(unknown)}")
    specs = []
    row = block = elems = 0
    for path in leaf_order(params):
        x = params[path]
        shape = tuple(int(s) for s in x.shape)
        nax = int(stacked_axes.get(path, 0))
        if nax > len(shape):
            raise ValueError(f"stacked_axes {nax} exceeds rank of {shape}")
        n_stack = int(np.prod(shape[:nax], dtype=np.int64)) if nax else 1
        block_elems = int(np.prod(shape[nax:], dtype=np.int64))
        rpb = max(1, -(-block_elems // LANES))
        dtype = x.dtype if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.zeros(0, x.dtype)).dtype
        specs.append(LeafSpec(path=path, shape=shape, dtype=dtype,
                              n_stack=n_stack, block_elems=block_elems,
                              rows_per_block=rpb, start_row=row,
                              start_block=block))
        row += n_stack * rpb
        block += n_stack
        elems += n_stack * block_elems
    return BlockLayout(leaves=tuple(specs), data_rows=row,
                       n_rows=padded_rows(row * LANES), n_blocks=block,
                       total_elems=elems)


def _block_view(layout: BlockLayout, buf: torch.Tensor, leaf: LeafSpec):
    rows = leaf.n_stack * leaf.rows_per_block
    x = buf[leaf.start_row:leaf.start_row + rows]
    return x.reshape(leaf.n_stack, leaf.rows_per_block * LANES)[
        :, :leaf.block_elems]


def pack(layout: BlockLayout,
         params: Union[Packed, Mapping[str, torch.Tensor]],
         dtype: torch.dtype = torch.float32,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flatten ``params`` into a new packed (R, 128) buffer on their device,
    or into ``out`` (an (R, 128) buffer, e.g. one slice of a delta stack).
    A :class:`Packed` value is already that buffer: it passes through (cast
    to ``dtype``, no copy when it has it), or is copied into ``out``."""
    if isinstance(params, Packed):
        if params.buf.shape != (layout.n_rows, LANES):
            raise ValueError(f"packed buffer {tuple(params.buf.shape)} does "
                             f"not match the layout's ({layout.n_rows}, "
                             f"{LANES})")
        if out is not None:
            return out.copy_(params.buf)
        return params.buf.to(dtype)
    if len(params) != len(layout.leaves):
        raise ValueError("params do not match layout")
    if out is None:
        device = next(iter(params.values())).device
        buf = torch.zeros((layout.n_rows, LANES), dtype=dtype, device=device)
    else:
        buf = out.zero_()
    for leaf in layout.leaves:
        x = params[leaf.path]
        if tuple(x.shape) != leaf.shape:
            raise ValueError(f"{leaf.path}: shape {tuple(x.shape)} != "
                             f"{leaf.shape}")
        _block_view(layout, buf, leaf).copy_(
            x.reshape(leaf.n_stack, leaf.block_elems))
    return buf


def unpack(layout: BlockLayout, buf: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> Params:
    """Rebuild the parameter dict from a packed buffer.

    dtype: override the per-leaf output dtype (e.g. fp32 for momentum);
    default restores each leaf's original dtype. Leaves are new contiguous
    tensors, never views of ``buf``.
    """
    return {leaf.path: _block_view(layout, buf, leaf)
            .reshape(leaf.shape).to(dtype or leaf.dtype, copy=True)
            .contiguous()
            for leaf in layout.leaves}


def zeros(layout: BlockLayout, device, dtype=torch.float32) -> torch.Tensor:
    """A packed buffer of zeros (e.g. fresh momentum)."""
    return torch.zeros((layout.n_rows, LANES), dtype=dtype, device=device)
