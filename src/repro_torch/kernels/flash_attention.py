"""Attention forward of prefill (flash attention, online softmax).

Port of ``repro/kernels/flash_attention.py``: q (BH, Sq, D), k and v
(BH, Skv, D) -> softmax(q k^T * D^-0.5) v, (BH, Sq, D) in q's dtype, with
the causal mask ``kv_idx <= q_idx`` on absolute indices (no offset when
Sq != Skv, the reference's rule). ``q_chunk`` and ``kv_chunk`` keep the
reference's signature and divisibility check; the CUDA kernel
(``csrc/flash_attention.cu``) tiles by its own sizes and masks the ragged
edge itself.

The wrapper launches the kernel for CUDA tensors (bf16 on the tensor cores,
fp32 on fp32 FMA; D in {32, 64, 128}) and raises on anything else; it runs
the plain PyTorch version (``flash_attention_fwd_ref``, a masked fp32
softmax) only for tensors on the CPU. It counts its launches in
``flash_attention_fwd.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_ptr = ctypes.c_void_p
_int = ctypes.c_int
_ARGS = [_ptr] * 4 + [_int] * 5 + [ctypes.c_float, _int, _ptr]
_SIGNATURES = {"flash_fwd_bf16": _ARGS, "flash_fwd_f32": _ARGS}
_ENTRY = {torch.bfloat16: "flash_fwd_bf16", torch.float32: "flash_fwd_f32"}


@functools.cache
def _lib():
    return _build.bind("flash_attention", _SIGNATURES)


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool = True) -> torch.Tensor:
    """Plain version: fp32 scores of the inputs, the masked entries at -1e30,
    an fp32 softmax and an fp32 product with v, cast to q's dtype."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
        * float(np.float32(q.shape[-1] ** -0.5))
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(ki > qi, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    bh, _, d = q.shape
    if k.dim() != 3 or k.shape[0] != bh or k.shape[2] != d or \
            v.shape != k.shape:
        raise ValueError(f"expected q (BH, Sq, D) and k, v (BH, Skv, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v on different devices")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_chunk: int = 128,
                        kv_chunk: int = 128) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BH, Skv, D). GQA callers broadcast kv heads
    and flatten (batch, heads) into BH. Returns (BH, Sq, D) in q's dtype."""
    if q.dim() != 3:
        raise ValueError(f"expected q (BH, Sq, D), got {tuple(q.shape)}")
    _check(q, k, v)
    bh, sq, d = q.shape
    skv = k.shape[1]
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    assert sq % q_chunk == 0 and skv % kv_chunk == 0, (sq, q_chunk, skv,
                                                        kv_chunk)
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal)
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention_fwd: bf16 or fp32, got {q.dtype}")
    if d not in HEAD_DIMS or bh > 65535:
        raise ValueError(f"flash_attention_fwd: D in {HEAD_DIMS} and "
                         f"BH <= 65535, got D {d}, BH {bh}")
    _build.check_cuda(q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: 16-byte aligned tensors")
    o = torch.empty_like(q)
    _build.launch("flash_attention_fwd", getattr(_lib(), _ENTRY[q.dtype]),
                  q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), bh, sq, skv, d, int(causal),
                  float(np.float32(d ** -0.5)))
    flash_attention_fwd.launches += 1
    return o


flash_attention_fwd.launches = 0

KERNEL_WRAPPERS = (flash_attention_fwd,)
