"""The port's packed kernels against the reference's Pallas kernels (run in
interpret mode on the CPU, as the reference's own tests run them), on a
multi-block layout whose blocks take every Alg. 2 branch: keep, anti-aligned,
weak-aligned, and degenerate (zero delta or zero momentum).

Tolerances, all fp32:
  * per-row sums of 128 products (row stats, moments): the two packages add
    in different orders, so each entry within 1e-5 of its own scale:
    sqrt(uu*vv) for a dot product (Cauchy-Schwarz bounds it and its
    rounding; 128 adds round by at most 128 * 2^-24 < 1e-5 of it) and the
    value itself for a sum of squares;
  * per-block sums: the same bound, block by block;
  * elementwise math from identical inputs (branch scalars, the fused
    update): rtol 1e-6 / atol 1e-6, i.e. a few ulp of the O(1) operands, for
    XLA's instruction choices (fused multiply-adds) against PyTorch's one
    rounding per op; p - eta*(...) can cancel, so the bound is absolute.
The kernels themselves are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import HeLoCoConfig as JaxHeLoCoConfig
from repro.core import packing as jpacking
from repro.kernels import packed as jpk
from repro_torch import bridge
from repro_torch.configs.base import HeLoCoConfig
from repro_torch.core import packing
from repro_torch.kernels import _build
from repro_torch.kernels import packed as pk

H = HeLoCoConfig()
JH = JaxHeLoCoConfig()
MODES = ("keep", "anti", "weak", "zero_u", "zero_v")
# "emb" spans more than 256 rows, so R is padded and the layout has filler
SHAPES = {"emb": (330, 130), "head": (17,), "layers/b": (3, 5),
          "layers/w": (3, 4, 5), "norm": (129,), "wide": (3, 700)}
STACKED = {"layers/b": 1, "layers/w": 1, "wide": 1}


def _block_pair(rng, n, mode):
    u = rng.standard_normal(n).astype(np.float32)
    noise = rng.standard_normal(n).astype(np.float32)
    if mode == "keep":
        v = 0.5 * u + 0.1 * noise
    elif mode == "anti":
        v = -0.8 * u + 0.3 * noise
    elif mode == "weak":          # cos(u, v) ~ 0.1: the rotation branch
        w = noise - (noise @ u) / (u @ u) * u
        v = 0.1 * np.linalg.norm(w) / np.linalg.norm(u) * u + w
    elif mode == "zero_u":
        u, v = np.zeros_like(u), noise
    else:
        v = np.zeros_like(u)
    return u, v.astype(np.float32)


def _case(seed=0):
    """(layout, u dict, v dict) with the block modes cycling over MODES."""
    rng = np.random.default_rng(seed)
    u, v, i = {}, {}, 0
    for path, shape in SHAPES.items():
        n_stack = shape[0] if path in STACKED else 1
        us, vs = [], []
        for _ in range(n_stack):
            a, b = _block_pair(rng, int(np.prod(shape)) // n_stack,
                               MODES[i % len(MODES)])
            us.append(a)
            vs.append(b)
            i += 1
        u[path] = np.concatenate(us).reshape(shape)
        v[path] = np.concatenate(vs).reshape(shape)
    layout = packing.build_layout(u, STACKED)
    return layout, u, v


def _bufs(layout, *dicts):
    return [packing.pack(layout, bridge.to_torch(d, "cpu")) for d in dicts]


def _close_sums(got, want):
    """Rows of (dot, uu, vv[, more sums of squares]), each entry within 1e-5
    of its own scale: sqrt(uu * vv) for the dot, itself for the others."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want)
    scale[:, 0] = np.sqrt(want[:, 1] * want[:, 2])
    err = np.abs(got - want)
    bad = np.argwhere(err > 1e-5 * scale)
    assert not len(bad), (f"{len(bad)} sums off, first at {tuple(bad[0])}: "
                          f"got {got[tuple(bad[0])]} want {want[tuple(bad[0])]}")


def _close_elementwise(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_case_covers_every_branch():
    layout, u, v = _case()
    ub, vb = _bufs(layout, u, v)
    stats = pk.packed_stats(ub, vb, layout).numpy()
    nu, nv = np.sqrt(stats[:, 1]), np.sqrt(stats[:, 2])
    c = stats[:, 0] / np.maximum(nu * nv, 1e-16)
    live = (nu > 0) & (nv > 0)
    assert layout.n_blocks >= 12 and (~live).sum() >= 2
    assert layout.n_rows > layout.data_rows          # filler rows exist
    assert (c[live] >= H.c_ok).any() and (c[live] < 0).any()
    assert ((c[live] >= 0) & (c[live] < H.c_ok)).any()


def test_row_stats_match_reference():
    layout, u, v = _case()
    ub, vb = _bufs(layout, u, v)
    want = jpk.packed_row_stats(jnp.asarray(ub.numpy()),
                                jnp.asarray(vb.numpy()), interpret=True)
    _close_sums(pk.packed_row_stats(ub, vb), want)


def test_block_stats_match_reference_slice_sums():
    layout, u, v = _case(1)
    ub, vb = _bufs(layout, u, v)
    ref_layout = jpacking.build_layout(
        {k: np.zeros(s, np.float32) for k, s in SHAPES.items()},
        {k: STACKED.get(k, 0) for k in SHAPES})
    want = jpk.packed_stats(jnp.asarray(ub.numpy()), jnp.asarray(vb.numpy()),
                            jnp.asarray(ref_layout.row_block),
                            ref_layout.n_blocks, interpret=True,
                            ranges=ref_layout.block_row_ranges)
    _close_sums(pk.packed_stats(ub, vb, layout), want)


def test_branch_scalars_match_reference():
    layout, u, v = _case(2)
    ub, vb = _bufs(layout, u, v)
    stats = pk.packed_stats(ub, vb, layout)
    cu, cv = pk.branch_scalars(stats, H)
    jcu, jcv = jpk.branch_scalars(jnp.asarray(stats.numpy()), JH)
    _close_elementwise(cu, jcu)
    _close_elementwise(cv, jcv)


@pytest.mark.parametrize("with_stats", [False, True])
def test_correct_outer_matches_reference(with_stats):
    layout, u, v = _case(3)
    rng = np.random.default_rng(4)
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    db, mb, pb = _bufs(layout, u, v, p)
    cu, cv = pk.branch_scalars(pk.packed_stats(db, mb, layout), H)
    row_block, _ = layout.device_tables("cpu")
    got = pk.packed_correct_outer(pb, mb, db, cu, cv, row_block, 0.7, 0.9, 0.5,
                                  with_stats=with_stats)
    rb = np.asarray(layout.row_block)
    want = jpk.packed_correct_outer(
        jnp.asarray(pb.numpy()), jnp.asarray(mb.numpy()),
        jnp.asarray(db.numpy()), jnp.asarray(cu.numpy()[rb][:, None]),
        jnp.asarray(cv.numpy()[rb][:, None]), 0.7, 0.9, 0.5, interpret=True,
        with_stats=with_stats)
    assert len(got) == len(want) == (3 if with_stats else 2)
    _close_elementwise(got[0], want[0])
    _close_elementwise(got[1], want[1])
    if with_stats:
        _close_sums(got[2], want[2])


def test_correct_outer_stats_variant_and_in_place_keep_the_bits():
    layout, u, v = _case(5)
    db, mb, pb = _bufs(layout, u, v, v)
    cu, cv = pk.branch_scalars(pk.packed_stats(db, mb, layout), H)
    rb, _ = layout.device_tables("cpu")
    p1, m1 = pk.packed_correct_outer(pb, mb, db, cu, cv, rb, 0.7, 0.9, 0.5)
    p2, m2, s = pk.packed_correct_outer(pb, mb, db, cu, cv, rb, 0.7, 0.9, 0.5,
                                        with_stats=True)
    assert s.shape == (layout.n_rows, pk.N_MOMENTS)
    assert torch.equal(p1, p2) and torch.equal(m1, m2)
    p3, m3 = pk.packed_correct_outer(pb, mb, db, cu, cv, rb, 0.7, 0.9, 0.5,
                                     out=(pb, mb))
    assert p3 is pb and m3 is mb
    assert torch.equal(pb, p1) and torch.equal(mb, m1)


def test_cpu_path_builds_nothing(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build or load a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    before = dict(pk.launch_counts())
    layout, u, v = _case()
    ub, vb = _bufs(layout, u, v)
    cu, cv = pk.branch_scalars(pk.packed_stats(ub, vb, layout), H)
    pk.packed_correct_outer(ub, vb, ub, cu, cv, layout.device_tables("cpu")[0],
                            0.7, 0.9, 1.0, with_stats=True)
    assert pk.launch_counts() == before
    assert not _build._LIBS and "triton" not in sys.modules


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(4, 128)
    with pytest.raises(ValueError):
        pk.packed_row_stats(x, torch.zeros(4, 64))
    with pytest.raises(TypeError):
        pk.packed_row_stats(x, x.double())
    with pytest.raises(ValueError):
        pk.packed_correct_outer(x, x, x, torch.ones(1), torch.zeros(1),
                                torch.zeros(4, dtype=torch.int64), 0.7, 0.9, 1.0)
