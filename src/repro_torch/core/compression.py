"""Pseudo-gradient compression with error feedback, applied on the worker
before its pseudo-gradient is shipped to the synchronizer.

Port of ``repro/core/compression.py``. Two int8 paths:

  * per leaf (``compress``/``decompress``): one scale per tensor;
  * packed (``packed_int8_roundtrip`` and the ``layout=`` argument of
    ``roundtrip_with_error_feedback``): the pseudo-gradient is flattened
    through the server's ``BlockLayout`` and quantized per block with three
    kernel launches (absmax, quantize, dequantize) whatever the number of
    tensors; the error-feedback buffer lives packed too.

Top-k keeps the k largest |values| of each tensor. The per-leaf paths have
no kernel and are plain tensor math.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from repro_torch.core import packing
from repro_torch.kernels import packed as pk

Params = Dict[str, torch.Tensor]


class Compressed(NamedTuple):
    payload: Dict    # path -> int8 values, or path -> (values, indices)
    scale: Dict      # path -> per-tensor fp32 scale (int8), or shape (top-k)
    kind: str


def _int8_one(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = packing.true_div(torch.clamp_min(xf.abs().max(), 1e-12), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _topk_one(x: torch.Tensor, ratio: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest |values|, ties to the lower index (``lax.top_k``'s
    order, which a stable descending sort gives)."""
    flat = x.float().reshape(-1)
    k = max(1, int(flat.numel() * ratio))
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return flat[idx], idx.to(torch.int32)


def compress(delta: Mapping[str, torch.Tensor], kind: str,
             topk_ratio: float = 0.1) -> Compressed:
    if kind == "int8":
        qs = {k: _int8_one(v) for k, v in delta.items()}
        return Compressed({k: q for k, (q, _) in qs.items()},
                          {k: s for k, (_, s) in qs.items()}, "int8")
    if kind == "topk":
        return Compressed({k: _topk_one(v, topk_ratio)
                           for k, v in delta.items()},
                          {k: tuple(v.shape) for k, v in delta.items()},
                          "topk")
    raise ValueError(kind)


def decompress(c: Compressed, like: Mapping[str, torch.Tensor]) -> Params:
    if c.kind == "int8":
        return {k: q.to(torch.float32) * c.scale[k]
                for k, q in c.payload.items()}
    if c.kind == "topk":
        out = {}
        for k, (vals, idx) in c.payload.items():
            ref = like[k]
            flat = torch.zeros(ref.numel(), dtype=torch.float32,
                               device=ref.device)
            flat[idx.long()] = vals
            out[k] = flat.reshape(ref.shape)
        return out
    raise ValueError(c.kind)


def compressed_bytes(c: Compressed) -> int:
    """Wire bytes: int8 values plus one fp32 scale per tensor, or top-k's
    fp32 values and int32 indices."""
    if c.kind == "int8":
        return (sum(q.numel() for q in c.payload.values())
                + 4 * len(c.scale))
    return sum(t.numel() * t.element_size()
               for pair in c.payload.values() for t in pair)


def block_scales(buf: torch.Tensor, layout) -> torch.Tensor:
    """(B,) fp32 int8 scales of a packed buffer, max(|block|, 1e-12) / 127:
    one absmax sweep, then a max over each block's contiguous rows."""
    _, seg = layout.device_tables(buf.device)
    rowabs = pk.packed_rowabs(buf)[:, 0]
    # one segment per block, then the filler rows (zeros), as in the
    # first plane of the row-stats segment table; a max is exact in any order
    blockabs = torch.segment_reduce(rowabs, "max",
                                    lengths=seg[:layout.n_blocks + 1])
    return packing.true_div(
        torch.clamp_min(blockabs[:layout.n_blocks], 1e-12), 127.0)


def packed_int8_roundtrip(buf: torch.Tensor, layout
                          ) -> Tuple[torch.Tensor, int]:
    """Per-block int8 fake quantization of a packed (R, 128) buffer.

    The block scales (one absmax sweep), then one quantize and one
    dequantize sweep: three kernel launches whatever the number of blocks.
    The int8 tensor between the two is the wire payload. Returns (decoded
    buffer, wire bytes), the bytes counting the real elements as int8 plus
    one fp32 scale per block."""
    row_block, _ = layout.device_tables(buf.device)
    scale = block_scales(buf, layout)
    q = pk.packed_quant(buf, scale, row_block)
    decoded = pk.packed_dequant(q, scale, row_block)
    return decoded, int(layout.total_elems) + 4 * layout.n_blocks


def roundtrip_with_error_feedback(delta: Mapping[str, torch.Tensor],
                                  ef, kind: str, topk_ratio: float = 0.1,
                                  layout=None):
    """Worker side: compress (delta + ef); returns (decoded, new ef, bytes).

    ``decoded`` is what the synchronizer receives; the new ef keeps what
    compression lost. With ``kind="int8"`` and a ``layout`` the round-trip
    runs on the packed buffer: ``ef`` is then a packed (R, 128) buffer
    (``None`` before the first round) and ``decoded`` a ``packing.Packed``
    the packed arrival path takes as it is."""
    if kind == "int8" and layout is not None:
        dbuf = packing.pack(layout, delta)
        target = dbuf if ef is None else dbuf + ef
        decoded_buf, nbytes = packed_int8_roundtrip(target, layout)
        return packing.Packed(decoded_buf), target - decoded_buf, nbytes
    if kind == "none":
        # no error to feed back: None, where the reference keeps zeros
        return delta, None, sum(x.numel() * 4 for x in delta.values())
    if ef is None:
        ef = {k: torch.zeros_like(x, dtype=torch.float32)
              for k, x in delta.items()}
    target = {k: d.float() + ef[k] for k, d in delta.items()}
    comp = compress(target, kind, topk_ratio)
    decoded = decompress(comp, target)
    new_ef = {k: target[k] - decoded[k] for k in target}
    return decoded, new_ef, compressed_bytes(comp)
