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

Each wrapper launches the CUDA kernel of ``csrc/packed.cu`` for a CUDA
tensor and raises if it cannot; it runs the plain PyTorch version beside it
(``*_ref``) only for a tensor on the CPU. Each wrapper counts its kernel
launches in ``<wrapper>.launches``. ``branch_scalars`` is O(#blocks) tensor
math and has no kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import HeLoCoConfig
from repro_torch.kernels import _build
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
}


@functools.cache
def _lib():
    lib = _build.load("packed")
    for fn, args in _SIGNATURES.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    """SM count of CUDA device ``index``, read once: it sizes each grid."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"CUDA kernel given a {t.device} tensor")
        if not t.is_contiguous():
            raise ValueError("CUDA kernel needs contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("CUDA kernel needs 16-byte aligned buffers")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _launch(name: str, fn, device, *args):
    """Call the C launcher ``fn`` on ``device``'s current stream; raise if
    the launch failed."""
    with torch.cuda.device(device):
        err = fn(*args, _sm_count(device.index),
                 torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, name)


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
    packed_row_stats.launches += 1
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
    packed_correct_outer.launches += 1
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
    packed_correct_outer_quad.launches += 1
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
    packed_correct_outer_acc.launches += 1
    res = (p_out, m_out, b_out)
    return res if stats is None else (*res, stats)


packed_correct_outer_acc.launches = 0

KERNEL_WRAPPERS = (packed_row_stats, packed_correct_outer,
                   packed_correct_outer_quad, packed_correct_outer_acc)


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
