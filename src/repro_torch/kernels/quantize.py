"""Per-tensor int8 quantization kernels (one fp32 scale per tensor).

Port of ``repro/kernels/quantize.py``. Three sweeps:

  absmax         one read of x -> max|x| (NaN propagates), (1,) fp32
  quantize_2d    scale = max(absmax, 1e-12) / 127 on the device, then one
                 read of x -> q = clip(rint(x / scale), -127, 127) int8
  dequantize_2d  one read of q -> q * scale, fp32

A tensor is read as its n contiguous fp32 elements with a guarded tail, not
padded to the reference's (R, 128) TPU tiling; q has x's shape. The names
are the reference's.

Each sweep is bound by bytes: 5 a element, 64.3 MB and 0.0192 ms at 3.35
TB/s for the tied embedding of tinygpt-15m (n = 12,865,792).
``tiling.plan`` sizes the launch: a body of 16-element units, 16 bytes of
int8 and 64 of fp32 a lane, walked grid-stride by at most one resident
wave (the CTAs an SM holds, read once from the CUDA occupancy query, times
the SMs) in whole waves; the elements after it, or all of an unaligned
tensor, one by one. On an NVIDIA H100 80GB HBM3 at a 700 W power limit,
timed as in a stream of calls that read their inputs from memory, that
walk runs quantize_2d in 0.0251 ms (76 % of the bound) and dequantize_2d
in 0.0280 (68 %), and the pair in 0.0447 against
``torch.fake_quantize_per_tensor_affine``'s 0.052; the design and its
alternatives are in ``csrc/quantize.cu``.

Each wrapper launches the CUDA kernel of ``csrc/quantize.cu`` for a CUDA
tensor and raises if it cannot; it runs the plain PyTorch version beside it
(``*_ref``) only for a tensor on the CPU. Each wrapper counts its launches
in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.packing import true_div
from repro_torch.kernels import _build
from repro_torch.kernels.tiling import aligned, plan

_ptr = ctypes.c_void_p
_n = ctypes.c_longlong
_int = ctypes.c_int
_SIGNATURES = {
    "absmax_f32": [_ptr] * 3 + [_n, _int, _int, _int, _ptr],
    "quantize_ctas_per_sm": [_ptr, _ptr],
    "quantize_f32": [_ptr] * 4 + [_n, _n, _int, _int, _ptr],
    "dequantize_f32": [_ptr] * 3 + [_n, _n, _int, _int, _ptr],
}
# absmax: the least elements one CTA of the first pass reads (256 threads,
# 16 each), and CTAs that fill the card (8 per SM)
_MIN_CHUNK = 4096
_CTAS_PER_SM = 8
SCALE_FLOOR = 1e-12
QMAX = 127


@functools.cache
def _lib():
    return _build.bind("quantize", _SIGNATURES)


@functools.cache
def _waves(index: int) -> Tuple[int, int]:
    """CTAs of one resident wave of the quantize and the dequantize sweep on
    CUDA device ``index``: the CTAs one SM holds of each, times the SMs."""
    sms = _build.sm_count(index)
    return tuple(c * sms for c in _build.ctas_per_sm(
        _lib().quantize_ctas_per_sm, index, 2))


def _check(x: torch.Tensor, dtype: torch.dtype, name: str):
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")


def _check_scalar(s: torch.Tensor, device, name: str):
    if s.numel() != 1 or s.dtype != torch.float32 or s.device != device:
        raise ValueError(f"{name} must be one float32 value on {device}")


# ---------------------------------------------------------------------------
# absmax
# ---------------------------------------------------------------------------

def absmax_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: max|x| as a (1,) fp32 tensor; NaN propagates."""
    return x.abs().amax().reshape(1)


def absmax(x: torch.Tensor) -> torch.Tensor:
    """x: fp32, any shape. One read; returns max|x|, (1,) fp32 (NaN if x
    holds one), as two passes in one call when the tensor is split over
    several CTAs."""
    _check(x, torch.float32, "absmax")
    if x.device.type == "cpu":
        return absmax_ref(x)
    _build.check_cuda(x)
    n = x.numel()
    sms = _build.sm_count(x.device.index)
    chunks = max(1, min(-(-n // _MIN_CHUNK), _CTAS_PER_SM * sms))
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    part = (torch.empty(chunks, dtype=torch.float32, device=x.device)
            if chunks > 1 else out)
    _build.launch("absmax", _lib().absmax_f32, x.device, x.data_ptr(),
                  part.data_ptr(), out.data_ptr(), n, chunks,
                  aligned((x, 16)))
    _build.count_launch(absmax)
    return out


absmax.launches = 0


# ---------------------------------------------------------------------------
# quantize_2d
# ---------------------------------------------------------------------------

def quantize_2d_ref(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (q int8 of x's shape, scale (1,) fp32). The scale is
    max(amax, 1e-12) / 127 (NaN stays); true divisions, round half to even,
    clip to +-127; a NaN quotient gives 0, as the reference's conversion to
    int8 does."""
    amax = absmax_ref(x) if amax is None else amax
    scale = true_div(torch.clamp_min(amax, SCALE_FLOOR), float(QMAX))
    q = torch.clamp(torch.round(x / scale.reshape(())), -QMAX, QMAX)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8), scale


def quantize_2d(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: fp32, any shape. Returns (q int8 of x's shape, scale (1,) fp32).

    The scale is ``max(amax, 1e-12) / 127``, computed by the kernel from
    ``amax`` on the device: by default ``absmax(x)`` (its own launch), as
    the reference's ``quantize_2d`` does. A given (1,) fp32 ``amax``: the
    placed int8 exchange passes a shard's absmax reduced over the leaf's
    other shards (``dist.steps.int8_roundtrip_leaf``), and the tests pass a
    smaller value to force the clip or time the sweep without the absmax."""
    _check(x, torch.float32, "quantize_2d")
    if amax is None:
        amax = absmax(x)
    _check_scalar(amax, x.device, "amax")
    if x.device.type == "cpu":
        return quantize_2d_ref(x, amax)
    _build.check_cuda(x, amax)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(1, dtype=torch.float32, device=x.device)
    n = x.numel()
    grid, units = plan(n, aligned((x, 16), (q, 16)),
                       _waves(x.device.index)[0])
    _build.launch("quantize_2d", _lib().quantize_f32, x.device, x.data_ptr(),
                  amax.data_ptr(), q.data_ptr(), scale.data_ptr(), n, units,
                  grid)
    _build.count_launch(quantize_2d)
    return q, scale


quantize_2d.launches = 0


# ---------------------------------------------------------------------------
# dequantize_2d
# ---------------------------------------------------------------------------

def dequantize_2d_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: q * scale in fp32."""
    return q.to(torch.float32) * scale.reshape(())


def dequantize_2d(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q: int8, any shape; scale: (1,) fp32 on the same device, read there.
    Returns q * scale, fp32 of q's shape."""
    _check(q, torch.int8, "dequantize_2d")
    _check_scalar(scale, q.device, "scale")
    if q.device.type == "cpu":
        return dequantize_2d_ref(q, scale)
    _build.check_cuda(q, scale)
    x = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    n = q.numel()
    grid, units = plan(n, aligned((q, 16), (x, 16)),
                       _waves(q.device.index)[1])
    _build.launch("dequantize_2d", _lib().dequantize_f32, q.device,
                  q.data_ptr(), scale.data_ptr(), x.data_ptr(), n, units,
                  grid)
    _build.count_launch(dequantize_2d)
    return x


dequantize_2d.launches = 0



def near_half_quotients(scale: float, device=None, random: int = 0,
                        seed: int = 1) -> torch.Tensor:
    """fp32 inputs whose quotients x / scale lie next to every half-integer
    from -127.5 to 127.5: one ulp either side of it and (1 + j * 2^-23)
    times it for j in -8..8; then ``random`` normal quotients of spread 60
    (seeded by ``seed``). These are the quotients on which the quantize
    body's x * (1 / scale) and the IEEE division may round apart (csrc/
    quantize.cu:rint_quotient), which random data almost never reaches;
    the tests and ``chip_smoke.py`` hold quantize_2d to its plain version
    on them."""
    half = (torch.arange(-128, 128, device=device) + 0.5) * scale
    gen = torch.Generator(device=half.device).manual_seed(seed)
    return torch.cat(
        [torch.nextafter(half, half + i) for i in (-1, 1)]
        + [half * (1 + j * 2.0 ** -23) for j in range(-8, 9)]
        + [torch.randn(random, generator=gen, device=half.device) * 60
           * scale])


KERNEL_WRAPPERS = (absmax, quantize_2d, dequantize_2d)
