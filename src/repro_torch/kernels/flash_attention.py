"""Attention forward of prefill (flash attention, online softmax).

Port of ``repro/kernels/flash_attention.py``: q (BH, Sq, D), k and v
(BH, Skv, D) -> softmax(q k^T * D^-0.5) v, (BH, Sq, D) in q's dtype, with
the causal mask ``kv_idx <= q_idx`` on absolute indices (no offset when
Sq != Skv, the reference's rule). ``q_chunk`` and ``kv_chunk`` keep the
reference's signature and divisibility check; the CUDA kernel
(``csrc/flash_attention.cu``) tiles by its own sizes and masks the ragged
edge itself.

The wrapper launches the kernel for CUDA tensors and raises on anything
else. One design serves every head dim in ``SERVED_DIMS`` (a multiple of 16
up to 256: 16 for the smoke configs, 80 for hubert and zamba2, 256 for
paligemma, ...): a TMA ring of K and V tiles, bf16 through wgmma and fp32 as
3xTF32 on the tensor cores, built at the padded widths ``PADDED_WIDTHS``;
``SERVED_DIMS[d]`` is the width D runs at (TMA zero-fills the columns past
D). It runs the plain PyTorch version (``flash_attention_fwd_ref``, a
masked fp32 softmax) only for tensors on the CPU. It counts its launches in
``flash_attention_fwd.launches``. ``flash_attention_fwd_tiled`` repeats the
kernel's walk over tiles in plain PyTorch, for the tests.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
PADDED_WIDTHS = (32, 64, 128, 192, 256)   # the widths the kernel is built at
# served head dim -> the least padded width that holds it
SERVED_DIMS = {d: min(w for w in PADDED_WIDTHS if w >= d)
               for d in range(16, 257, 16)}
TILE = 64   # q rows per warpgroup, kv rows per tile (but see kv_tile)
LOG2E = 1.4426950408889634
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


def kv_tile(d: int, dtype: torch.dtype) -> int:
    """Rows of a kv tile in the CUDA kernel's walk at head dim ``d``: 32 in
    fp32 at a padded width past 128 (where two stages of 64-row K and V
    tiles would not fit in shared memory beside Q), else TILE."""
    return 32 if dtype == torch.float32 and SERVED_DIMS[d] > 128 else TILE


def flash_attention_fwd_tiled(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              split: bool = True,
                              kv_rows: int = TILE) -> torch.Tensor:
    """The CUDA kernel's walk in fp32: q tiles of TILE rows, each with its
    kv tiles of ``kv_rows`` rows (those wholly above a causal tile's last
    row skipped) and a running (m, l, acc) from (-1e30, 0, 0) rescaled at
    every tile in the log2 domain; then acc / max(l, 1e-30) in q's dtype.
    With ``split`` (the two warpgroups of a CTA on one q tile) the kv tiles
    go alternately to two states and the second is merged into the first;
    without, one state walks them all (a warpgroup that owns its q tile, as
    bf16 at padded widths from 128 takes past one wave). ``kv_rows`` is
    ``kv_tile(d, dtype)`` for the kernel's own walk. Only the tests call
    it."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    scale2 = float(np.float32(np.float32(d ** -0.5) * np.float32(LOG2E)))
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty_like(q)
    n_kv = -(-skv // kv_rows)
    for q0 in range(0, sq, TILE):
        rows = torch.arange(q0, min(q0 + TILE, sq), device=q.device)
        n_tiles = min(n_kv, (q0 + TILE - 1) // kv_rows + 1) if causal \
            else n_kv
        states = []
        for first in ((0, 1) if split else (0,)):
            m = torch.full((bh, len(rows)), NEG_INF, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((bh, len(rows), d), device=q.device)
            for t in range(first, n_tiles, 2 if split else 1):
                kv = slice(t * kv_rows, min((t + 1) * kv_rows, skv))
                s = torch.einsum("bqd,bkd->bqk", qf[:, q0:q0 + len(rows)],
                                 kf[:, kv]) * scale2
                if causal:
                    # masked at -inf: p is 0 even in a row the tile masks
                    # whole, where the max stays at its finite start
                    cols = torch.arange(kv.start, kv.stop, device=q.device)
                    s = s.masked_fill(cols[None, :] > rows[:, None],
                                      -float("inf"))
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = alpha * l + p.sum(-1)
                acc = alpha[..., None] * acc + torch.einsum(
                    "bqk,bkd->bqd", p, vf[:, kv])
                m = m_new
            states.append((m, l, acc))
        m, l, acc = states[0]
        if split:
            m1, l1, a1 = states[1]
            m_new = torch.maximum(m, m1)
            f0, f1 = torch.exp2(m - m_new), torch.exp2(m1 - m_new)
            l, acc = l * f0 + l1 * f1, acc * f0[..., None] + a1 * f1[..., None]
        out[:, q0:q0 + len(rows)] = (acc / l.clamp_min(1e-30)[..., None]).to(
            q.dtype)
    return out


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
    if d not in SERVED_DIMS or bh > 65535:
        raise ValueError(f"flash_attention_fwd: D a multiple of 16 up to "
                         f"256 and BH <= 65535, got D {d}, BH {bh}")
    _build.check_cuda(q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: 16-byte aligned tensors")
    o = torch.empty_like(q)
    _build.launch("flash_attention_fwd", getattr(_lib(), _ENTRY[q.dtype]),
                  q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), bh, sq, skv, d, int(causal),
                  float(np.float32(d ** -0.5)))
    _build.count_launch(flash_attention_fwd)
    return o


flash_attention_fwd.launches = 0

KERNEL_WRAPPERS = (flash_attention_fwd,)
