"""Kernels over the packed (R, 128) arrival buffer.

Port of the ``repro/kernels/packed.py`` sweeps an arrival runs:

  packed_row_stats      one read of (delta, momentum) -> per-row partial
                        (dot, uu, vv); ``packed_stats`` reduces them per
                        block with one deterministic segment sum.
  packed_correct_outer  one fused read of (p, m, delta) writing (p', m'):
                        Alg. 2 correction with per-block (cu, cv) and the
                        Eqs. 17-19 Nesterov outer update, optionally with
                        the per-row telemetry moments in the same launch.
  packed_correct_outer_quad
                        the same sweep with DC-ASGD's per-block quadratic
                        term cq*delta^2*m in the correction.
  packed_correct_outer_acc
                        the sweep of the accumulator schedule (delayed
                        Nesterov, FedBuff): reads (p, m, b, delta), writes
                        (p', m', b') under eight schedule scalars.
  packed_rowabs         per-row max|x| -> (R, 1), the absmax sweep of the
                        packed int8 round-trip (``core/compression.py``).
  packed_quant          clip(rint(x / s), -127, 127) to int8, s the scale
                        of the row's block.
  packed_dequant        q * s back to fp32.
  packed_multi_correct_outer, packed_multi_correct_outer_quad,
  packed_multi_correct_outer_acc
                        K chained applications of the three fused sweeps
                        in one launch, for the K arrivals of one flush of
                        the server's commit buffer: p and m (and b) are
                        read and written once, each delta of the (K, R, 128)
                        stack read once.
  packed_multi_gram     one read of (m, delta stack) -> per-row pairwise
                        products of the basis [m, delta_1..delta_K];
                        ``multi_gram_blocks`` reduces them to per-block
                        (K+1, K+1) Gram matrices, HeLoCo's statistics for a
                        K-flush.

Each wrapper launches the CUDA kernel of ``csrc/packed.cu`` for a CUDA
tensor and raises if it cannot; it runs the plain PyTorch version beside it
(``*_ref``) only for a tensor on the CPU. Each wrapper counts its kernel
launches in ``<wrapper>.launches`` (``kernels.launch_counts`` reads them). ``branch_scalars`` is O(#blocks) tensor
math and has no kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import HeLoCoConfig
from repro_torch.kernels import _build
from repro_torch.kernels._build import launch as _launch
from repro_torch.kernels.tiling import LANES

N_MOMENTS = 4

_ptr = ctypes.c_void_p
_SIGNATURES = {
    "packed_row_stats_f32": [_ptr, _ptr, _ptr, ctypes.c_longlong,
                             ctypes.c_int, _ptr],
    "packed_correct_outer_f32": [_ptr] * 9 + [ctypes.c_longlong] +
                                [ctypes.c_float] * 3 + [ctypes.c_int, _ptr],
    "packed_correct_outer_quad_f32": [_ptr] * 10 + [ctypes.c_longlong] +
                                     [ctypes.c_float] * 3 +
                                     [ctypes.c_int, _ptr],
    "packed_correct_outer_acc_f32": [_ptr] * 11 + [ctypes.c_longlong] +
                                    [ctypes.c_float] * 8 +
                                    [ctypes.c_int, _ptr],
    "packed_rowabs_f32": [_ptr, _ptr, ctypes.c_longlong, ctypes.c_int, _ptr],
    "packed_quant_f32": [_ptr] * 4 + [ctypes.c_longlong, ctypes.c_int, _ptr],
    "packed_dequant_f32": [_ptr] * 4 + [ctypes.c_longlong, ctypes.c_int, _ptr],
    "packed_multi_correct_outer_f32": [_ptr] * 11 + [ctypes.c_longlong] +
                                      [ctypes.c_int] * 3 + [_ptr],
    "packed_multi_correct_outer_acc_f32": [_ptr] * 12 + [ctypes.c_longlong] +
                                          [ctypes.c_int] * 3 + [_ptr],
    "packed_multi_gram_f32": [_ptr] * 3 + [ctypes.c_longlong] +
                             [ctypes.c_int] * 2 + [_ptr],
}

# The largest K of one multi-Gram launch (its template instantiations).
MAX_GRAM_K = 8


@functools.cache
def _lib():
    return _build.bind("packed", _SIGNATURES)


def _f32(x) -> float:
    """A scalar rounded to fp32, as the reference's (1, 3) scalar table holds it."""
    return float(np.float32(x))


def _check_buffers(*bufs: torch.Tensor):
    r = bufs[0].shape[0]
    for b in bufs:
        if b.dim() != 2 or b.shape != (r, LANES):
            raise ValueError(f"expected ({r}, {LANES}) buffers, got "
                             f"{tuple(b.shape)}")
        if b.dtype != torch.float32:
            raise TypeError(f"expected float32 buffers, got {b.dtype}")
        if b.device != bufs[0].device:
            raise ValueError("buffers on different devices")
    return bufs[0].device


def _check_cuda(*tensors: torch.Tensor):
    _build.check_cuda(*tensors)
    for t in tensors:
        # (R, 128) buffers are read 16 bytes at a time, the rest by element
        align = 16 if t.shape[-1:] == (LANES,) else t.element_size()
        if t.data_ptr() % align:
            raise ValueError(f"CUDA kernel needs {align}-byte aligned "
                             "buffers")


# ---------------------------------------------------------------------------
# Sweep 1: per-row correction statistics
# ---------------------------------------------------------------------------

def packed_row_stats_ref(u2d: torch.Tensor, v2d: torch.Tensor) -> torch.Tensor:
    """Plain version: (R, 128) x 2 -> (R, 3) rows of (u.v, u.u, v.v)."""
    return torch.stack([(u2d * v2d).sum(1), (u2d * u2d).sum(1),
                        (v2d * v2d).sum(1)], dim=1)


def packed_row_stats(u2d: torch.Tensor, v2d: torch.Tensor) -> torch.Tensor:
    """u2d, v2d: (R, 128) fp32. One read of each; returns (R, 3) partials.
    On the card they are stored planar, so the result is the transposed
    view of a contiguous (3, R) tensor."""
    device = _check_buffers(u2d, v2d)
    if device.type == "cpu":
        return packed_row_stats_ref(u2d, v2d)
    _check_cuda(u2d, v2d)
    r = u2d.shape[0]
    out = torch.empty((3, r), dtype=torch.float32, device=device)
    _launch("packed_row_stats", _lib().packed_row_stats_f32, device,
            u2d.data_ptr(), v2d.data_ptr(), out.data_ptr(), r)
    _build.count_launch(packed_row_stats)
    return out.t()


packed_row_stats.launches = 0


def packed_stats(u2d: torch.Tensor, v2d: torch.Tensor, layout) -> torch.Tensor:
    """Per-block (dot, uu, vv), (B, 3): one O(d) sweep plus one segment sum.

    The three planes of row partials are summed as one flat vector whose
    segments are each plane's blocks (contiguous row ranges) followed by
    its filler rows: a 1-D segment sum, which PyTorch runs as one
    segmented reduction with a block per segment. It adds in a fixed order
    (no atomics), so it gives the same bits on every run.
    """
    parts = packed_row_stats(u2d, v2d)
    _, seg_rows = layout.device_tables(parts.device)
    sums = torch.segment_reduce(parts.t().reshape(-1), "sum",
                                lengths=seg_rows)
    return sums.reshape(3, -1)[:, :layout.n_blocks].t()


# ---------------------------------------------------------------------------
# Branch scalars, vectorised over blocks (paper Alg. 2 / Eqs. 7-16)
# ---------------------------------------------------------------------------

def branch_scalars(stats: torch.Tensor, h: HeLoCoConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3) per-block (dot, uu, vv) -> per-block (cu, cv), each (B,).

    The corrected pseudo-gradient of every block is ``cu*u + cv*v``: keep
    (c >= c_ok or a degenerate norm), damp the anti-momentum component
    (c < 0), or rotate toward the momentum (0 <= c < c_ok)."""
    dot, uu, vv = stats[:, 0], stats[:, 1], stats[:, 2]
    nu = torch.sqrt(uu)
    nv = torch.sqrt(vv)
    c = dot / torch.clamp_min(nu * nv, h.eps * h.eps)
    conf = nu / (nu + h.kappa * nv + h.eps)

    beta = torch.clamp_max(h.k_s * (-c) * conf, h.beta_max)
    anti_cv = -beta * c * nu / torch.clamp_min(nv, h.eps)

    lam = torch.clamp_max(h.k_d * (1.0 - c) * conf, 1.0)
    nt = torch.sqrt((1 - lam) ** 2 + lam ** 2 + 2 * lam * (1 - lam) * c)
    wscale = nu / torch.clamp_min(nt, h.eps)
    weak_cu = wscale * (1 - lam) / torch.clamp_min(nu, h.eps)
    weak_cv = wscale * lam / torch.clamp_min(nv, h.eps)

    keep = (c >= h.c_ok) | (nu < h.eps) | (nv < h.eps)
    antib = c < 0.0
    one = torch.ones_like(c)
    cu = torch.where(keep, one, torch.where(antib, one, weak_cu))
    cv = torch.where(keep, torch.zeros_like(c),
                     torch.where(antib, anti_cv, weak_cv))
    return cu, cv


# ---------------------------------------------------------------------------
# Sweep 2: fused correct + Nesterov outer update
# ---------------------------------------------------------------------------

def _rows(vec: torch.Tensor, row_block: torch.Tensor) -> torch.Tensor:
    """(B,) per-block scalars -> (R, 1) per-row scalars."""
    return vec[row_block.long()][:, None]


def _moments(d2d, m2d, corr):
    """Per-row ``[d.m, d.d, m.m, |corr - d|^2]``, (R, 4)."""
    e = corr - d2d
    return torch.stack([(d2d * m2d).sum(1), (d2d * d2d).sum(1),
                        (m2d * m2d).sum(1), (e * e).sum(1)], dim=1)


def _check_coeffs(r: int, device, row_block, *vecs):
    if row_block.shape != (r,) or row_block.dtype != torch.int32:
        raise ValueError("row_block must be (R,) int32")
    if any(v.dtype != torch.float32 or v.dim() != 1 or v.shape != vecs[0].shape
           for v in vecs):
        raise ValueError("per-block coefficients must be matching (B,) "
                         "float32 vectors")
    if any(t.device != device for t in (*vecs, row_block)):
        raise ValueError("coefficients/row_block must be on the buffers' device")


def _cpu_result(res, out):
    """Copy a plain-version result into the named ``out`` buffers."""
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return (*out, *res[len(out):])


def _outputs(out, like, n: int):
    return out if out is not None else tuple(torch.empty_like(like)
                                             for _ in range(n))


def packed_correct_outer_ref(p2d, m2d, d2d, cu, cv, row_block, eta, mu, rho,
                             with_stats: bool = False):
    """Plain version of ``packed_correct_outer`` (same arguments, no ``out``).
    Every scalar is rounded to fp32 first and each product and sum rounds
    on its own, the arithmetic the kernel performs."""
    eta, mu, rho = _f32(eta), _f32(mu), _f32(rho)
    one_minus_mu = float(np.float32(1.0) - np.float32(mu))
    corr = _rows(cu, row_block) * d2d + _rows(cv, row_block) * m2d
    g = corr * rho
    m_new = mu * m2d + one_minus_mu * g
    p_new = p2d - eta * (g + mu * m_new)
    if not with_stats:
        return p_new, m_new
    return p_new, m_new, _moments(d2d, m2d, corr)


def packed_correct_outer(p2d: torch.Tensor, m2d: torch.Tensor,
                         d2d: torch.Tensor, cu: torch.Tensor,
                         cv: torch.Tensor, row_block: torch.Tensor,
                         eta: float, mu: float, rho: float, *,
                         with_stats: bool = False,
                         out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One fused sweep: g = (cu*delta + cv*m)*rho per element, then Eqs. 17-19.

    p2d/m2d/d2d: (R, 128) fp32; cu/cv: (B,) fp32 per-block branch scalars;
    row_block: (R,) int32 block of each row. Returns (p', m'), plus the
    (R, 4) per-row moments ``[d.m, d.d, m.m, |cu*d+cv*m - d|^2]`` when
    ``with_stats`` (same launch, same p'/m' bits). ``out=(p_out, m_out)``
    names the output buffers; they may be ``p2d``/``m2d`` themselves for an
    in-place update.
    """
    device = _check_buffers(p2d, m2d, d2d)
    r = p2d.shape[0]
    _check_coeffs(r, device, row_block, cu, cv)
    if device.type == "cpu":
        return _cpu_result(packed_correct_outer_ref(
            p2d, m2d, d2d, cu, cv, row_block, eta, mu, rho,
            with_stats=with_stats), out)
    p_out, m_out = _outputs(out, p2d, 2)
    _check_buffers(p2d, p_out, m_out)
    stats = (torch.empty((r, N_MOMENTS), dtype=torch.float32, device=device)
             if with_stats else None)
    _check_cuda(p2d, m2d, d2d, cu, cv, row_block, p_out, m_out)
    _launch("packed_correct_outer", _lib().packed_correct_outer_f32, device,
            p2d.data_ptr(), m2d.data_ptr(), d2d.data_ptr(), cu.data_ptr(),
            cv.data_ptr(), row_block.data_ptr(), p_out.data_ptr(),
            m_out.data_ptr(), None if stats is None else stats.data_ptr(),
            r, _f32(eta), _f32(mu), _f32(rho))
    _build.count_launch(packed_correct_outer)
    return (p_out, m_out) if stats is None else (p_out, m_out, stats)


packed_correct_outer.launches = 0


# ---------------------------------------------------------------------------
# Sweep 2 variants of the method layer: DC-ASGD's quadratic term, and the
# accumulator schedule of the buffered methods
# ---------------------------------------------------------------------------

def packed_correct_outer_quad_ref(p2d, m2d, d2d, cu, cv, cq, row_block, eta,
                                  mu, rho, with_stats: bool = False):
    """Plain version of ``packed_correct_outer_quad``. The correction sums
    left to right as the reference writes it: ``(cu*d + cv*m) +
    ((cq*d)*d)*m``."""
    eta, mu, rho = _f32(eta), _f32(mu), _f32(rho)
    one_minus_mu = float(np.float32(1.0) - np.float32(mu))
    corr = (_rows(cu, row_block) * d2d + _rows(cv, row_block) * m2d
            + _rows(cq, row_block) * d2d * d2d * m2d)
    g = corr * rho
    m_new = mu * m2d + one_minus_mu * g
    p_new = p2d - eta * (g + mu * m_new)
    if not with_stats:
        return p_new, m_new
    return p_new, m_new, _moments(d2d, m2d, corr)


def packed_correct_outer_quad(p2d: torch.Tensor, m2d: torch.Tensor,
                              d2d: torch.Tensor, cu: torch.Tensor,
                              cv: torch.Tensor, cq: torch.Tensor,
                              row_block: torch.Tensor, eta: float, mu: float,
                              rho: float, *, with_stats: bool = False,
                              out: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]] = None):
    """``packed_correct_outer`` with a per-block quadratic compensation term:
    g = (cu*delta + cv*m + cq*delta^2*m)*rho, then Eqs. 17-19. Arguments,
    outputs and aliasing as ``packed_correct_outer``; cq is (B,) fp32."""
    device = _check_buffers(p2d, m2d, d2d)
    r = p2d.shape[0]
    _check_coeffs(r, device, row_block, cu, cv, cq)
    if device.type == "cpu":
        return _cpu_result(packed_correct_outer_quad_ref(
            p2d, m2d, d2d, cu, cv, cq, row_block, eta, mu, rho,
            with_stats=with_stats), out)
    p_out, m_out = _outputs(out, p2d, 2)
    _check_buffers(p2d, p_out, m_out)
    stats = (torch.empty((r, N_MOMENTS), dtype=torch.float32, device=device)
             if with_stats else None)
    _check_cuda(p2d, m2d, d2d, cu, cv, cq, row_block, p_out, m_out)
    _launch("packed_correct_outer_quad", _lib().packed_correct_outer_quad_f32,
            device, p2d.data_ptr(), m2d.data_ptr(), d2d.data_ptr(),
            cu.data_ptr(), cv.data_ptr(), cq.data_ptr(), row_block.data_ptr(),
            p_out.data_ptr(), m_out.data_ptr(),
            None if stats is None else stats.data_ptr(),
            r, _f32(eta), _f32(mu), _f32(rho))
    _build.count_launch(packed_correct_outer_quad)
    return (p_out, m_out) if stats is None else (p_out, m_out, stats)


packed_correct_outer_quad.launches = 0


def packed_correct_outer_acc_ref(p2d, m2d, b2d, d2d, cu, cv, row_block, eta,
                                 rho, am, bm, ab, cg, cm, ca=0.0,
                                 with_stats: bool = False):
    """Plain version of ``packed_correct_outer_acc``: every scalar rounded
    to fp32 first, each product and sum rounding on its own, and the
    parameter step summed as ``(cg*g + ca*acc) + cm*m'``."""
    eta, rho, am, bm, ab, cg, cm, ca = (_f32(x) for x in
                                        (eta, rho, am, bm, ab, cg, cm, ca))
    corr = _rows(cu, row_block) * d2d + _rows(cv, row_block) * m2d
    g = corr * rho
    acc = b2d + g
    m_new = am * m2d + bm * acc
    p_new = p2d - eta * (cg * g + ca * acc + cm * m_new)
    b_new = ab * acc
    if not with_stats:
        return p_new, m_new, b_new
    return p_new, m_new, b_new, _moments(d2d, m2d, corr)


def packed_correct_outer_acc(p2d: torch.Tensor, m2d: torch.Tensor,
                             b2d: torch.Tensor, d2d: torch.Tensor,
                             cu: torch.Tensor, cv: torch.Tensor,
                             row_block: torch.Tensor, eta: float, rho: float,
                             am: float, bm: float, ab: float, cg: float,
                             cm: float, ca: float = 0.0, *,
                             with_stats: bool = False,
                             out: Optional[Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]] = None):
    """One fused sweep of the generalized schedule with a gradient
    accumulator b (delayed Nesterov / FedBuff):

      g = (cu*delta + cv*m)*rho;  acc = b + g
      m' = am*m + bm*acc;  b' = ab*acc
      p' = p - eta*(cg*g + ca*acc + cm*m')

    Returns (p', m', b'), plus the (R, 4) per-row moments of the unweighted
    correction when ``with_stats`` (same launch, same bits).
    ``out=(p_out, m_out, b_out)`` may name ``p2d``/``m2d``/``b2d``
    themselves for an in-place update."""
    device = _check_buffers(p2d, m2d, b2d, d2d)
    r = p2d.shape[0]
    _check_coeffs(r, device, row_block, cu, cv)
    if device.type == "cpu":
        return _cpu_result(packed_correct_outer_acc_ref(
            p2d, m2d, b2d, d2d, cu, cv, row_block, eta, rho, am, bm, ab, cg,
            cm, ca, with_stats=with_stats), out)
    p_out, m_out, b_out = _outputs(out, p2d, 3)
    _check_buffers(p2d, p_out, m_out, b_out)
    stats = (torch.empty((r, N_MOMENTS), dtype=torch.float32, device=device)
             if with_stats else None)
    _check_cuda(p2d, m2d, b2d, d2d, cu, cv, row_block, p_out, m_out, b_out)
    _launch("packed_correct_outer_acc", _lib().packed_correct_outer_acc_f32,
            device, p2d.data_ptr(), m2d.data_ptr(), b2d.data_ptr(),
            d2d.data_ptr(), cu.data_ptr(), cv.data_ptr(),
            row_block.data_ptr(), p_out.data_ptr(), m_out.data_ptr(),
            b_out.data_ptr(), None if stats is None else stats.data_ptr(),
            r, *(_f32(x) for x in (eta, rho, am, bm, ab, cg, cm, ca)))
    _build.count_launch(packed_correct_outer_acc)
    res = (p_out, m_out, b_out)
    return res if stats is None else (*res, stats)


packed_correct_outer_acc.launches = 0

# ---------------------------------------------------------------------------
# Per-block int8 quantization of a packed buffer (the compression sweeps)
# ---------------------------------------------------------------------------

def packed_rowabs_ref(x2d: torch.Tensor) -> torch.Tensor:
    """Plain version: (R, 128) -> (R, 1) per-row max|x|; NaN propagates."""
    return x2d.abs().amax(dim=1, keepdim=True)


def packed_rowabs(x2d: torch.Tensor) -> torch.Tensor:
    """x2d: (R, 128) fp32. One read; returns the (R, 1) per-row max|x|, NaN
    where the row holds one (as ``jnp.max``)."""
    device = _check_buffers(x2d)
    if device.type == "cpu":
        return packed_rowabs_ref(x2d)
    _check_cuda(x2d)
    r = x2d.shape[0]
    out = torch.empty((r, 1), dtype=torch.float32, device=device)
    _launch("packed_rowabs", _lib().packed_rowabs_f32, device,
            x2d.data_ptr(), out.data_ptr(), r)
    _build.count_launch(packed_rowabs)
    return out


packed_rowabs.launches = 0


def packed_quant_ref(x2d, scale, row_block) -> torch.Tensor:
    """Plain version of ``packed_quant``: true division, round half to even,
    clip to +-127."""
    q = torch.round(x2d / _rows(scale, row_block))
    return torch.clamp(q, -127, 127).to(torch.int8)


def packed_quant(x2d: torch.Tensor, scale: torch.Tensor,
                 row_block: torch.Tensor) -> torch.Tensor:
    """q = clip(rint(x / s), -127, 127) as int8, per element.

    x2d: (R, 128) fp32; scale: (B,) fp32 per-block scales (> 0); row_block:
    (R,) int32 block of each row. The reference takes the same scales as
    an (R, 1) table ``scale[row_block]``; the kernel looks them up."""
    device = _check_buffers(x2d)
    r = x2d.shape[0]
    _check_coeffs(r, device, row_block, scale)
    if device.type == "cpu":
        return packed_quant_ref(x2d, scale, row_block)
    _check_cuda(x2d, scale, row_block)
    q = torch.empty((r, LANES), dtype=torch.int8, device=device)
    _launch("packed_quant", _lib().packed_quant_f32, device, x2d.data_ptr(),
            scale.data_ptr(), row_block.data_ptr(), q.data_ptr(), r)
    _build.count_launch(packed_quant)
    return q


packed_quant.launches = 0


def packed_dequant_ref(q2d, scale, row_block) -> torch.Tensor:
    """Plain version of ``packed_dequant``."""
    return q2d.to(torch.float32) * _rows(scale, row_block)


def packed_dequant(q2d: torch.Tensor, scale: torch.Tensor,
                   row_block: torch.Tensor) -> torch.Tensor:
    """x = q * s in fp32; q2d: (R, 128) int8, scale and row_block as in
    ``packed_quant``."""
    if q2d.dim() != 2 or q2d.shape[1] != LANES or q2d.dtype != torch.int8:
        raise ValueError(f"expected an (R, {LANES}) int8 buffer, got "
                         f"{tuple(q2d.shape)} {q2d.dtype}")
    device = q2d.device
    r = q2d.shape[0]
    _check_coeffs(r, device, row_block, scale)
    if device.type == "cpu":
        return packed_dequant_ref(q2d, scale, row_block)
    _check_cuda(q2d, scale, row_block)
    x = torch.empty((r, LANES), dtype=torch.float32, device=device)
    _launch("packed_dequant", _lib().packed_dequant_f32, device,
            q2d.data_ptr(), scale.data_ptr(), row_block.data_ptr(),
            x.data_ptr(), r)
    _build.count_launch(packed_dequant)
    return x


packed_dequant.launches = 0


# ---------------------------------------------------------------------------
# The K-stacked sweeps of a flush of the commit buffer
# ---------------------------------------------------------------------------

def _hp_table(k: int, *cols) -> np.ndarray:
    """Per-delta scalar table: each column is a scalar or K values, rounded
    to fp32 -> (K, #cols)."""
    return np.ascontiguousarray(np.stack(
        [np.broadcast_to(np.asarray(c, np.float32), (k,)) for c in cols],
        axis=1))


def _multi_hp(k: int, device, *cols) -> torch.Tensor:
    """``_hp_table`` on ``device``: one host-to-device copy."""
    return torch.from_numpy(_hp_table(k, *cols)).to(device)


def _check_stack(d3d: torch.Tensor, r: int, device) -> int:
    if (d3d.dim() != 3 or d3d.shape[1:] != (r, LANES)
            or d3d.dtype != torch.float32 or d3d.device != device):
        raise ValueError(f"expected a (K, {r}, {LANES}) float32 delta stack "
                         f"on {device}, got {tuple(d3d.shape)} {d3d.dtype} "
                         f"on {d3d.device}")
    return d3d.shape[0]


def _check_multi_coeffs(k: int, r: int, device, row_block, *mats):
    if row_block.shape != (r,) or row_block.dtype != torch.int32:
        raise ValueError("row_block must be (R,) int32")
    if any(c.dim() != 2 or c.shape != mats[0].shape or c.shape[0] != k
           or c.dtype != torch.float32 for c in mats):
        raise ValueError(f"per-block coefficients must be matching (K={k}, "
                         "B) float32 tables")
    if any(t.device != device for t in (*mats, row_block)):
        raise ValueError("coefficients/row_block must be on the buffers' "
                         "device")


def _multi_ref(single, k, state, d3d, coeffs, hp, with_stats):
    """K sequential calls of a single-arrival plain version, application j
    with row j of the coefficient tables and of the scalar table; the
    moments of slice j are taken against the state as of application j."""
    stats = []
    for j in range(k):
        res = single(*state, d3d[j], *(c[j] for c in coeffs),
                     *(float(x) for x in hp[j]), with_stats=with_stats)
        state = res[:len(state)]
        if with_stats:
            stats.append(res[-1])
    return (*state, torch.stack(stats)) if with_stats else tuple(state)


def packed_multi_correct_outer_ref(p2d, m2d, d3d, cu, cv, row_block, eta, mu,
                                   rho, with_stats: bool = False):
    """Plain version of ``packed_multi_correct_outer``: K sequential
    ``packed_correct_outer_ref`` applications."""
    k = d3d.shape[0]
    hp = _hp_table(k, eta, mu, rho)

    def single(p, m, d, a, b, eta, mu, rho, with_stats):
        return packed_correct_outer_ref(p, m, d, a, b, row_block, eta, mu, rho,
                                        with_stats=with_stats)
    return _multi_ref(single, k, (p2d, m2d), d3d, (cu, cv), hp, with_stats)


def packed_multi_correct_outer_quad_ref(p2d, m2d, d3d, cu, cv, cq, row_block,
                                        eta, mu, rho,
                                        with_stats: bool = False):
    """Plain version of ``packed_multi_correct_outer_quad``: K sequential
    ``packed_correct_outer_quad_ref`` applications."""
    k = d3d.shape[0]
    hp = _hp_table(k, eta, mu, rho)

    def single(p, m, d, a, b, q, eta, mu, rho, with_stats):
        return packed_correct_outer_quad_ref(p, m, d, a, b, q, row_block, eta,
                                             mu, rho, with_stats=with_stats)
    return _multi_ref(single, k, (p2d, m2d), d3d, (cu, cv, cq), hp,
                      with_stats)


def packed_multi_correct_outer_acc_ref(p2d, m2d, b2d, d3d, cu, cv, row_block,
                                       eta, rho, am, bm, ab, cg, cm, ca=0.0,
                                       with_stats: bool = False):
    """Plain version of ``packed_multi_correct_outer_acc``: K sequential
    ``packed_correct_outer_acc_ref`` applications, each under its own row
    of the schedule table."""
    k = d3d.shape[0]
    hp = _hp_table(k, eta, rho, am, bm, ab, cg, cm, ca)

    def single(p, m, b, d, x, y, *scalars, with_stats):
        return packed_correct_outer_acc_ref(p, m, b, d, x, y, row_block,
                                            *scalars, with_stats=with_stats)
    return _multi_ref(single, k, (p2d, m2d, b2d), d3d, (cu, cv), hp,
                      with_stats)


def _launch_multi(name, fn, state, d3d, coeffs, row_block, hp, out,
                  with_stats, *extra):
    """Shared launch of the three multi sweeps: ``state`` is (p, m) or
    (p, m, b), ``coeffs`` the (K, B) tables, ``extra`` the pointers the
    C entry point takes between the coefficients and the map."""
    device = state[0].device
    k, r = d3d.shape[0], state[0].shape[0]
    outs = _outputs(out, state[0], len(state))
    _check_buffers(state[0], *outs)
    stats = (torch.empty((k, r, N_MOMENTS), dtype=torch.float32,
                         device=device) if with_stats else None)
    _check_cuda(*state, d3d, *coeffs, row_block, hp, *outs)
    _launch(name, fn, device, *(t.data_ptr() for t in (*state, d3d, *coeffs)),
            *extra, row_block.data_ptr(), hp.data_ptr(),
            *(t.data_ptr() for t in outs),
            None if stats is None else stats.data_ptr(), r, k,
            coeffs[0].shape[1])
    return outs if stats is None else (*outs, stats)


def packed_multi_correct_outer(p2d: torch.Tensor, m2d: torch.Tensor,
                               d3d: torch.Tensor, cu: torch.Tensor,
                               cv: torch.Tensor, row_block: torch.Tensor,
                               eta, mu, rho, *, with_stats: bool = False,
                               out: Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]] = None):
    """K fused correct+outer applications in one launch.

    d3d: (K, R, 128) delta stack in commit order; cu/cv: (K, B) per-delta
    per-block branch scalars; eta/mu/rho: a scalar or K values each.
    Application j is ``packed_correct_outer`` with row j of everything and
    the momentum as left by application j - 1. Returns (p', m') after all
    K, plus the (K, R, 4) per-row moments when ``with_stats`` (slice j
    against m as of application j; same launch, same bits). ``out`` as in
    ``packed_correct_outer``."""
    device = _check_buffers(p2d, m2d)
    r = p2d.shape[0]
    k = _check_stack(d3d, r, device)
    _check_multi_coeffs(k, r, device, row_block, cu, cv)
    if device.type == "cpu":
        return _cpu_result(packed_multi_correct_outer_ref(
            p2d, m2d, d3d, cu, cv, row_block, eta, mu, rho,
            with_stats=with_stats), out)
    hp = _multi_hp(k, device, eta, mu, rho)
    res = _launch_multi("packed_multi_correct_outer",
                        _lib().packed_multi_correct_outer_f32, (p2d, m2d), d3d,
                        (cu, cv), row_block, hp, out, with_stats, None)
    _build.count_launch(packed_multi_correct_outer)
    return res


packed_multi_correct_outer.launches = 0


def packed_multi_correct_outer_quad(p2d: torch.Tensor, m2d: torch.Tensor,
                                    d3d: torch.Tensor, cu: torch.Tensor,
                                    cv: torch.Tensor, cq: torch.Tensor,
                                    row_block: torch.Tensor, eta, mu, rho, *,
                                    with_stats: bool = False,
                                    out: Optional[Tuple[torch.Tensor,
                                                        torch.Tensor]] = None):
    """``packed_multi_correct_outer`` with DC-ASGD's quadratic term: cq is
    a (K, B) table, application j is ``packed_correct_outer_quad``."""
    device = _check_buffers(p2d, m2d)
    r = p2d.shape[0]
    k = _check_stack(d3d, r, device)
    _check_multi_coeffs(k, r, device, row_block, cu, cv, cq)
    if device.type == "cpu":
        return _cpu_result(packed_multi_correct_outer_quad_ref(
            p2d, m2d, d3d, cu, cv, cq, row_block, eta, mu, rho,
            with_stats=with_stats), out)
    _check_cuda(cq)
    hp = _multi_hp(k, device, eta, mu, rho)
    res = _launch_multi("packed_multi_correct_outer_quad",
                        _lib().packed_multi_correct_outer_f32, (p2d, m2d), d3d,
                        (cu, cv), row_block, hp, out, with_stats, cq.data_ptr())
    _build.count_launch(packed_multi_correct_outer_quad)
    return res


packed_multi_correct_outer_quad.launches = 0


def packed_multi_correct_outer_acc(p2d: torch.Tensor, m2d: torch.Tensor,
                                   b2d: torch.Tensor, d3d: torch.Tensor,
                                   cu: torch.Tensor, cv: torch.Tensor,
                                   row_block: torch.Tensor, eta, rho, am, bm,
                                   ab, cg, cm, ca=0.0, *,
                                   with_stats: bool = False,
                                   out: Optional[Tuple[torch.Tensor,
                                                       torch.Tensor,
                                                       torch.Tensor]] = None):
    """K accumulator-schedule applications in one launch: every schedule
    scalar may be K values (a boundary arrival inside the batch toggles its
    own row). Application j is ``packed_correct_outer_acc``. Returns (p',
    m', b'), plus (K, R, 4) moments when ``with_stats``."""
    device = _check_buffers(p2d, m2d, b2d)
    r = p2d.shape[0]
    k = _check_stack(d3d, r, device)
    _check_multi_coeffs(k, r, device, row_block, cu, cv)
    if device.type == "cpu":
        return _cpu_result(packed_multi_correct_outer_acc_ref(
            p2d, m2d, b2d, d3d, cu, cv, row_block, eta, rho, am, bm, ab, cg,
            cm, ca, with_stats=with_stats), out)
    hp = _multi_hp(k, device, eta, rho, am, bm, ab, cg, cm, ca)
    res = _launch_multi("packed_multi_correct_outer_acc",
                        _lib().packed_multi_correct_outer_acc_f32,
                        (p2d, m2d, b2d), d3d, (cu, cv), row_block, hp, out,
                        with_stats)
    _build.count_launch(packed_multi_correct_outer_acc)
    return res


packed_multi_correct_outer_acc.launches = 0


def gram_pairs(k: int):
    """The (a <= b) column order of the basis [m, d_1..d_K]'s pairs."""
    t = k + 1
    return [(a, b) for a in range(t) for b in range(a, t)]


def packed_multi_gram_ref(m2d: torch.Tensor,
                          d3d: torch.Tensor) -> torch.Tensor:
    """Plain version: (R, 128) + (K, R, 128) -> (R, P) per-row products of
    the basis pairs in ``gram_pairs`` order, P = (K+1)(K+2)/2."""
    vecs = [m2d, *d3d]
    return torch.stack([(vecs[a] * vecs[b]).sum(1)
                        for a, b in gram_pairs(d3d.shape[0])], dim=1)


def packed_multi_gram(m2d: torch.Tensor, d3d: torch.Tensor) -> torch.Tensor:
    """m2d: (R, 128) fp32, d3d: (K, R, 128) fp32, K <= ``MAX_GRAM_K``. One
    read of each; returns the (R, P) per-row partials. On the card they are
    stored planar, so the result is the transposed view of a contiguous
    (P, R) tensor."""
    device = _check_buffers(m2d)
    r = m2d.shape[0]
    k = _check_stack(d3d, r, device)
    if device.type == "cpu":
        return packed_multi_gram_ref(m2d, d3d)
    if not 1 <= k <= MAX_GRAM_K:
        raise ValueError(f"packed_multi_gram takes 1..{MAX_GRAM_K} deltas, "
                         f"got {k}")
    _check_cuda(m2d, d3d)
    out = torch.empty((len(gram_pairs(k)), r), dtype=torch.float32,
                      device=device)
    _launch("packed_multi_gram", _lib().packed_multi_gram_f32, device,
            m2d.data_ptr(), d3d.data_ptr(), out.data_ptr(), r, k)
    _build.count_launch(packed_multi_gram)
    return out.t()


packed_multi_gram.launches = 0


@functools.cache
def _gram_index(k: int, device: str) -> torch.Tensor:
    """(K+1, K+1) column of each (a, b) pair, symmetric, on ``device``."""
    t = k + 1
    idx = np.zeros((t, t), np.int64)
    for c, (a, b) in enumerate(gram_pairs(k)):
        idx[a, b] = idx[b, a] = c
    return torch.from_numpy(idx).to(device)


def multi_gram_blocks(m2d: torch.Tensor, d3d: torch.Tensor,
                      layout) -> torch.Tensor:
    """Per-block Gram matrices of the basis [m, d_1..d_K], (B, K+1, K+1):
    one O(d) sweep plus one segment sum over its planes, as
    ``packed_stats`` reduces the row stats. Every inner product a sequential
    flush would measure between a delta and the evolving momentum is a
    linear functional of these."""
    parts = packed_multi_gram(m2d, d3d)
    k = d3d.shape[0]
    seg = layout.segment_lengths(parts.device, parts.shape[1])
    sums = torch.segment_reduce(parts.t().reshape(-1), "sum", lengths=seg)
    blocks = sums.reshape(parts.shape[1], -1)[:, :layout.n_blocks].t()
    return blocks[:, _gram_index(k, str(parts.device))]


KERNEL_WRAPPERS = (packed_row_stats, packed_correct_outer,
                   packed_correct_outer_quad, packed_correct_outer_acc,
                   packed_rowabs, packed_quant, packed_dequant,
                   packed_multi_correct_outer, packed_multi_correct_outer_quad,
                   packed_multi_correct_outer_acc, packed_multi_gram)
