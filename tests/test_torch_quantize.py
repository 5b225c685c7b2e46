"""The port's per-tensor int8 entry points against the reference's.

``kernels/ops.py:quantize_block``/``dequantize_block`` and
``kernels/ref.py:ref_quantize``/``ref_dequantize`` against the reference's
(its Pallas kernels in interpret mode on the CPU, as tests/test_kernels.py
runs them), on the same numpy inputs: tests/test_kernels.py's SHAPES in
fp32 and bf16, exact .5 ties, an all-zero tensor and a NaN element.

On the CPU each kernel wrapper runs its plain version; the CUDA kernels are
held to those bit for bit on the card (tests/test_torch_cuda.py).

Tolerance: none. The port's q is the reference's q2d with its zero padding
cut (the port keeps the n elements flat), equal element for element; the
scale and n are equal, and so are the dequantized values (one IEEE division
and a round half to even per element, one product back).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quantize as qk
from repro_torch.kernels import tiling
from test_kernels import SHAPES


def _pair(x, bf16):
    """The same fp32 numpy values as a JAX array and a torch tensor, both
    rounded to bf16 (to nearest even on both sides) when asked."""
    j, t = jnp.asarray(x), torch.from_numpy(np.array(x, np.float32))
    return (j.astype(jnp.bfloat16), t.to(torch.bfloat16)) if bf16 else (j, t)


def _check(x, bf16=False):
    """quantize_block / dequantize_block and the ref_* pair against the
    reference's on ``x``; returns the port's (q, scale)."""
    jx, tx = _pair(x, bf16)
    jq, js, jn = jops.quantize_block(jx, interpret=True)
    q, s, n = ops.quantize_block(tx)
    assert q.dtype == torch.int8 and q.shape == (x.size,)
    assert s.dtype == torch.float32 and s.shape == ()
    assert n.dtype == torch.int32 and n.tolist() == np.asarray(jn).tolist()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).reshape(-1)[:x.size])
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    shape = x.shape
    want = np.asarray(jops.dequantize_block(jq, js, shape, interpret=True))
    got = ops.dequantize_block(q, s, shape)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the reference's padded payload dequantizes to the same tensor too
    padded = torch.from_numpy(np.array(jq))
    np.testing.assert_array_equal(ops.dequantize_block(padded, s, shape).numpy(),
                                  want)
    assert ops.dequantize_block(q, s, shape, torch.bfloat16).dtype == \
        torch.bfloat16
    rq, rs = ref.ref_quantize(tx)
    jrq, jrs = jref.ref_quantize(jx)
    np.testing.assert_array_equal(rq.numpy(), np.asarray(jrq))
    np.testing.assert_array_equal(rs.numpy(), np.asarray(jrs))
    np.testing.assert_array_equal(ref.ref_dequantize(rq, rs).numpy(),
                                  np.asarray(jref.ref_dequantize(jrq, jrs)))
    return q, s


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_block_matches_reference(shape, bf16):
    rng = np.random.default_rng(int(np.prod(shape)))
    _check(5.0 * rng.standard_normal(shape).astype(np.float32), bf16)


def test_quantize_rounds_half_to_even():
    # max|x| = 63.5 gives scale 0.5 exactly, so x / scale = k + 0.5
    x = ((np.arange(-64, 64, dtype=np.float32) + 0.5) * 0.5)
    x[0] = 63.5
    q, s = _check(x)
    assert s.item() == 0.5
    assert q[1:5].tolist() == [-62, -62, -60, -60]


def test_quantize_all_zero_tensor_takes_the_scale_floor():
    q, s = _check(np.zeros((3, 50), np.float32))
    assert s.item() == np.float32(np.float32(1e-12) / np.float32(127))
    assert not q.any()


def test_quantize_nan_element():
    x = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    x[17] = np.nan
    q, s = _check(x)
    assert np.isnan(s.item()) and not q.any()


def test_quantize_given_absmax_clips_and_wrappers_count_nothing_on_cpu():
    x = torch.linspace(-4.0, 4.0, 101)
    before = (qk.absmax.launches, qk.quantize_2d.launches,
              qk.dequantize_2d.launches)
    q, s = qk.quantize_2d(x, amax=torch.tensor([1.0]))
    assert s.item() == np.float32(1.0) / np.float32(127)
    assert q.min().item() == -127 and q.max().item() == 127
    assert (q.abs() == 127).sum().item() > 2
    torch.testing.assert_close(qk.dequantize_2d(q, s),
                               qk.dequantize_2d_ref(q, s), rtol=0, atol=0)
    assert (qk.absmax.launches, qk.quantize_2d.launches,
            qk.dequantize_2d.launches) == before
    with pytest.raises(TypeError):
        qk.absmax(x.double())
    with pytest.raises(ValueError):
        qk.dequantize_2d(q, torch.ones(2))


# the wave of an H100 SXM at 6 and 8 resident CTAs of 256 threads on 132
# SMs, and one smaller
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 4_099, 1_000_003,
                               12_865_792])
def test_int8_sweep_plan_covers_every_element_once(n, offset):
    """``tiling.plan``'s (grid, units), walked as csrc/quantize.cu's
    sweeps walk them: in trip t CTA b's body units [(t * grid + b) * 256,
    ... + 256), 16 elements each, then the elements from 16 * units on over
    every thread of the grid, a stride of grid * 256. Every element once;
    the grid at most one wave, its trips as many as a full wave's and none
    short by a CTA's units. With x offset by 1-3 elements (not 16-byte
    aligned) there is no body."""
    x = torch.empty(n + 3)[offset:offset + n]
    q = torch.empty(n, dtype=torch.int8)
    aligned = tiling.aligned((x, 16), (q, 16))
    assert aligned == (offset == 0) or n == 0    # an empty view: no data
    for wave in (1056, 792, 264):
        grid, units = tiling.plan(n, aligned, wave)
        assert units == (n // tiling.UNIT if aligned else 0)
        work, lanes = -(-n // tiling.UNIT), grid * tiling.THREADS
        trips = max(1, -(-work // lanes))
        assert 1 <= grid <= wave
        assert trips == max(1, -(-work // (tiling.THREADS * wave)))
        assert trips * lanes - work < trips * tiling.THREADS or work == 0
        seen = []
        for t in range(-(-units // lanes)):
            ub = t * lanes + np.arange(lanes)
            ub = ub[ub < units]
            seen.append((tiling.UNIT * ub[:, None] + np.arange(tiling.UNIT)).ravel())
        start = tiling.UNIT * units
        assert n - start < tiling.UNIT or not aligned
        for trip in range(-(-(n - start) // lanes)):
            i = start + trip * lanes + np.arange(lanes)
            seen.append(i[i < n])
        cover = np.bincount(np.concatenate(seen + [np.zeros(0, int)]),
                            minlength=n)
        assert len(cover) == n and (cover == 1).all()


def _rint_quotient(x, s):
    """csrc/quantize.cu:rint_quotient in numpy float32: q0 = x * r with r =
    1 / s rounded, rint(q0), and the IEEE quotient's rint where q0 lies
    within |q0| * 2^-21 of a half-integer. Returns (result, where the
    division decided)."""
    f = np.float32
    q0 = x * (f(1) / s)
    k = np.rint(q0)
    near = np.abs(np.abs(q0 - k) - f(0.5)) <= np.abs(q0) * f(2.0 ** -21)
    return np.where(near, np.rint(x / s), k), near


@pytest.mark.parametrize("seed", range(4))
def test_rint_quotient_rule_equals_the_ieee_division(seed):
    """The quantize body's rounding rule, in numpy float32 as the kernel
    computes it (one rounding an operation, no fused multiply-add), gives
    rint(x / s) of the IEEE quotient for every quotient next to each
    half-integer up to 127.5 and for random ones, at the scales of the
    card tests, the scale floor 1e-12 / 127 and 40 scales from 1e-14 to
    1e30. The data reaches the rule's hard cases: x * r alone rounds apart
    from the division on some of them, and the division decides there."""
    rng = np.random.default_rng(seed)
    scales = np.concatenate([[0.37, 1.0 / 3.0, 0.0123, 7.77e-9, 0.5,
                              1e-12 / 127],
                             10.0 ** rng.uniform(-14, 30, 40)])
    apart = decided = 0
    for s in scales.astype(np.float32):
        x = qk.near_half_quotients(float(s), "cpu", random=1 << 12,
                                   seed=seed).numpy()
        x = np.concatenate([x, (rng.uniform(-3e5, 3e5, 1 << 12)
                                * s).astype(np.float32)])
        assert x.dtype == np.float32 and np.isfinite(x).all()
        want = np.rint(x / s)
        got, near = _rint_quotient(x, s)
        np.testing.assert_array_equal(got, want, err_msg=f"scale {s}")
        apart += int((np.rint(x * (np.float32(1) / s)) != want).sum())
        decided += int(near.sum())
    assert 0 < apart <= decided
