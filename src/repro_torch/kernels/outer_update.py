"""The per-leaf fused Nesterov outer update (paper Eqs. 17-19).

Port of ``repro/kernels/outer_update.py``. Per arrival the outer step
updates momentum and parameters:

    m' = mu*m + (1-mu)*rho*g
    p' = p - eta*(rho*g + mu*m')

``outer_update_2d`` reads (p, m, g) once and writes (p', m') once, in the
reference kernel's order of operations. It takes tensors of any one shape,
read as their n contiguous elements (not padded to the reference's (R, 128)
TPU tiling); the name is the reference's.

The wrapper launches the CUDA kernel of ``csrc/leaf.cu`` for a CUDA tensor
and raises if it cannot; it runs the plain PyTorch version beside it
(``outer_update_2d_ref``) only for a tensor on the CPU, and counts its
launches in ``outer_update_2d.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build

_ptr = ctypes.c_void_p
_SIGNATURES = {
    "outer_update_f32": [_ptr] * 5 + [ctypes.c_longlong] +
                        [ctypes.c_float] * 3 + [ctypes.c_int, _ptr],
}


@functools.cache
def _lib():
    return _build.bind("leaf", _SIGNATURES)


def _scalars(eta, mu, rho):
    """eta, mu, rho rounded to fp32, as the reference's (1, 3) table holds
    them, and 1 - mu computed in fp32 as its kernel does."""
    f = np.float32
    return (float(f(eta)), float(f(mu)), float(f(rho)),
            float(f(1.0) - f(mu)))


def outer_update_2d_ref(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                        eta: float, mu: float, rho: float):
    """Plain version: the kernel's arithmetic, each product and sum
    rounding on its own. Returns (p', m')."""
    eta, mu, rho, one_minus_mu = _scalars(eta, mu, rho)
    g = g * rho
    m_new = mu * m + one_minus_mu * g
    return p - eta * (g + mu * m_new), m_new


def outer_update_2d(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                    eta: float, mu: float, rho: float):
    """p, m, g: fp32 tensors of one shape on one device. One read of each,
    one write of each output; returns new tensors (p', m')."""
    for x in (p, m, g):
        if x.shape != p.shape or x.dtype != torch.float32:
            raise ValueError("p, m, g must be float32 tensors of one shape")
        if x.device != p.device:
            raise ValueError("p, m, g on different devices")
    if p.device.type == "cpu":
        return outer_update_2d_ref(p, m, g, eta, mu, rho)
    _build.check_cuda(p, m, g)
    eta, mu, rho, _ = _scalars(eta, mu, rho)
    p_new, m_new = torch.empty_like(p), torch.empty_like(m)
    _build.launch("outer_update_2d", _lib().outer_update_f32, p.device,
                  p.data_ptr(), m.data_ptr(), g.data_ptr(), p_new.data_ptr(),
                  m_new.data_ptr(), p.numel(), eta, mu, rho)
    outer_update_2d.launches += 1
    return p_new, m_new


outer_update_2d.launches = 0

KERNEL_WRAPPERS = (outer_update_2d,)
