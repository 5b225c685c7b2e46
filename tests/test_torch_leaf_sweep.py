"""The launch plan of the per-leaf elementwise sweeps, walked on the CPU.

``csrc/leaf.cu``'s correct_apply and outer_update kernels walk a leaf of L
blocks of n elements as one flat range of L * n: a body of 16-element units
(lane l of a warp takes the float4 l, l + 32, l + 64 and l + 96 of the
warp's 512 elements; a CTA for every 256 units, or a smaller grid walking
them grid-stride), then the elements after it one by one. correct_apply
takes the scalars of the block that holds each float4, and each element's
own where the float4 straddles two blocks. No compiler runs here, so this
walk is modelled in numpy from ``tiling.plan``'s (grid, units) as the
wrappers compute them, and every element of (L, n) is shown to be covered
exactly once, with its own block's scalars. The card tests
(tests/test_torch_cuda.py) hold the kernels themselves to their plain
versions on the same shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import outer_update as ok
from repro_torch.kernels import tiling

WARPS = tiling.THREADS // 32


def _walk(total, n, stacked, grid, units):
    """(element, block whose scalars it takes) for every element the kernel
    writes, in the kernel's order of trips, CTAs, warps, float4 and lanes;
    the body's float4 ``f`` is elements 4 f .. 4 f + 3."""
    trips = -(-units // (grid * tiling.THREADS)) if units else 0
    t, b, w = np.meshgrid(np.arange(trips), np.arange(grid), np.arange(WARPS),
                          indexing="ij")
    ub = ((t * grid + b) * tiling.THREADS + 32 * w).ravel()
    ub = ub[ub < units]
    f = (4 * ub[:, None, None] + np.arange(32)[None, None, :]
         + 32 * np.arange(4)[None, :, None]).ravel()
    f = f[f < 4 * units]
    e = 4 * f
    elems = (e[:, None] + np.arange(4)).ravel()
    if stacked:
        first = e // n
        straddles = e + 3 >= (first + 1) * n
        own = (e[:, None] + np.arange(4)) // n
        blocks = np.where(straddles[:, None], own, first[:, None]).ravel()
    else:
        blocks = np.zeros_like(elems)
    # then thread i of the grid takes the elements 16 * units + i, + grid *
    # 256, ...
    lanes = grid * tiling.THREADS
    start = tiling.UNIT * units
    tail = (start + np.arange(lanes)[None, :] + lanes
            * np.arange(-(-(total - start) // lanes))[:, None]).ravel()
    tail = tail[tail < total]
    return (np.concatenate([elems, tail]),
            np.concatenate([blocks, tail // n if stacked else 0 * tail]))


# (L, n, offset of the views in elements): one block, stacked blocks whose
# boundaries fall inside a float4 (n % 4 != 0) or on one, blocks shorter
# than a float4 or a unit, tiny leaves around one unit, the embedding's
# length cut to a quarter, each aligned and 1-3 elements off
CASES = [(1, 0, 0), (1, 1, 0), (1, 7, 0), (1, 15, 0), (1, 16, 0), (1, 17, 0),
         (1, 17, 1), (1, 1025, 2), (1, 1_000_003, 0), (1, 3_216_448, 3),
         (4, 4097, 0), (4, 4097, 1), (3, 128_003, 0), (3, 128_003, 3),
         (4, 4096, 0), (5, 3, 0), (16, 1, 0), (6, 18, 0), (7, 65_537, 2),
         (2, 2, 1)]


@pytest.mark.parametrize("blocks,n,offset", CASES)
def test_leaf_sweep_plan_covers_every_element_once(blocks, n, offset):
    """correct_apply's walk over (L, n) views offset by ``offset``
    elements: every element once, each with its own block's (cu, cv);
    outer_update's walk over the same L * n elements: every element once.
    The wrappers launch a CTA for every 256 units (one trip); the kernels
    walk a smaller grid grid-stride, as the int8 sweeps do."""
    total = blocks * n
    u, v = (torch.empty(total + 3)[offset:offset + total].view(blocks, n)
            for _ in range(2))
    out = torch.empty_like(u)
    aligned = tiling.aligned((u, 16), (v, 16), (out, 16))
    assert aligned == (offset == 0) or total == 0
    # the wrappers' plan (no wave: one trip), and a grid of at most 3 CTAs,
    # which the kernels' grid-stride loop walks in many trips
    for wave in (None, 3):
        grid, units = tiling.plan(total, aligned, wave)
        assert 1 <= grid <= (wave or grid)
        if wave is None:
            assert grid == max(1, -(-total // (tiling.UNIT * tiling.THREADS)))
        assert units == (total // tiling.UNIT if aligned else 0)
        elems, used = _walk(total, n, blocks > 1, grid, units)
        cover = np.bincount(elems, minlength=total)
        assert len(cover) == total and (cover == 1).all()
        own = np.empty(total, dtype=np.int64)
        own[elems] = used
        np.testing.assert_array_equal(own, np.arange(total) // max(n, 1))
        p, m, g = (torch.empty(total + 3)[offset:offset + total]
                   for _ in range(3))
        outs = (torch.empty_like(p), torch.empty_like(p))
        grid, units = tiling.plan(total, tiling.aligned(
            *((t, 16) for t in (p, m, g, *outs))), wave)
        cover = np.bincount(_walk(total, total, False, grid, units)[0],
                            minlength=total)
        assert len(cover) == total and (cover == 1).all()


@pytest.mark.parametrize("shape", [(7,), (4, 4097), (3, 5, 17)])
def test_outer_update_in_place_equals_new_outputs(shape):
    """``out=(p, m)`` writes the step into p and m and returns them, the
    same bits as new outputs; the plain version runs on the CPU."""
    rng = np.random.default_rng(len(shape))
    p, m, g = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               for _ in range(3))
    want = ok.outer_update_2d(p, m, g, 0.7, 0.9, 0.447)
    got = ok.outer_update_2d(p, m, g, 0.7, 0.9, 0.447, out=(p, m))
    assert got[0] is p and got[1] is m
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        ok.outer_update_2d(p, m, g, 0.7, 0.9, 0.447,
                           out=(p, torch.empty(1)))
