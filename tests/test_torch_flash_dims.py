"""flash_attention_fwd at head dims outside {32, 64, 128} (a multiple of 16
up to 256: 16 for every smoke config, 80 for hubert-xlarge and zamba2, 256
for paligemma-3b) against the reference's Pallas kernel in interpret mode
on the CPU, on the same numpy inputs: the plain version
(``flash_attention_fwd``'s CPU path) and ``flash_attention_fwd_tiled`` with
the CUDA kernel's walk at those dims (one 64-row q tile split between two
warpgroups on alternate kv tiles, merged in a fixed order; 64-row kv tiles,
32-row ones in fp32 past padded width 128; the tiles above a causal tile's
last row skipped). The kernel itself is held to the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: the reference's own (tests/test_kernels.py:125-160), 2e-5 in
fp32 and 2e-2 in bf16: the same function summed in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jax_flash
from repro_torch.kernels import flash_attention as fa

TOL = {False: dict(rtol=2e-5, atol=2e-5), True: dict(rtol=2e-2, atol=2e-2)}
DIMS = (16, 80, 256)


def _inputs(bh, sq, skv, d, bf16, seed):
    rng = np.random.default_rng(seed)
    out = []
    for s in (sq, skv, skv):
        x = rng.standard_normal((bh, s, d)).astype(np.float32)
        j, t = jnp.asarray(x), torch.from_numpy(x)
        out.append((j.astype(jnp.bfloat16), t.to(torch.bfloat16)) if bf16
                   else (j, t))
    return out


def _want(q, k, v, causal, q_chunk):
    return np.asarray(jax_flash(q, k, v, causal=causal, q_chunk=q_chunk,
                                kv_chunk=k.shape[1], interpret=True),
                      np.float32)


def test_served_dims_and_their_padded_widths():
    """Every multiple of 16 up to 256 runs on the least padded width that
    holds it, and that width leaves no 64-column box of a bf16 tile wholly
    past D (a box TMA would fill with zeros only)."""
    assert fa.PADDED_WIDTHS == (32, 64, 128, 192, 256)
    assert fa.SERVED_DIMS == {16: 32, 32: 32, 48: 64, 64: 64, 80: 128,
                              96: 128, 112: 128, 128: 128, 144: 192,
                              160: 192, 176: 192, 192: 192, 208: 256,
                              224: 256, 240: 256, 256: 256}
    for d, w in fa.SERVED_DIMS.items():
        assert w - d < min(w, 64)
    assert [fa.kv_tile(d, torch.float32) for d in DIMS] == [64, 64, 32]
    assert [fa.kv_tile(d, torch.bfloat16) for d in DIMS] == [64, 64, 64]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("shape", [(2, 128, 128), (2, 64, 192)],
                         ids=["square", "rectangular"])
def test_plain_version_matches_pallas_interpreter(shape, d, causal, bf16):
    bh, sq, skv = shape
    (jq, tq), (jk, tk), (jv, tv) = _inputs(bh, sq, skv, d, bf16, seed=d)
    got = fa.flash_attention_fwd(tq, tk, tv, causal=causal, q_chunk=32,
                                 kv_chunk=skv)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               _want(jq, jk, jv, causal, 32), **TOL[bf16])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("shape", [(2, 200, 200), (2, 64, 200),
                                   (2, 200, 64)],
                         ids=["ragged", "sq_lt_skv", "sq_gt_skv"])
def test_mma_route_walk_matches_pallas_interpreter(shape, d, causal):
    """The kernel's walks at the dims the retired mma route served: the fp32
    kernel's, split between two warpgroups on its kv tiles (32 rows at D
    256), and the bf16 kernel's, split or whole (a warpgroup that owns its
    q tile, as past one wave at padded widths from 128); ragged edges on
    both axes (200 = 3 tiles + 8 rows), and Sq != Skv both ways under the
    absolute causal rule."""
    bh, sq, skv = shape
    (jq, tq), (jk, tk), (jv, tv) = _inputs(bh, sq, skv, d, False, seed=sq)
    want = _want(jq, jk, jv, causal, sq)
    for dtype, split in ((torch.float32, True), (torch.bfloat16, True),
                         (torch.bfloat16, False)):
        got = fa.flash_attention_fwd_tiled(tq, tk, tv, causal, split=split,
                                           kv_rows=fa.kv_tile(d, dtype))
        np.testing.assert_allclose(got.numpy(), want, **TOL[False])


def test_the_card_refuses_head_dims_no_route_serves():
    """Not a multiple of 16, or past 256: refused before any launch, for a
    tensor off the CPU (``meta`` here; on the CPU the plain version takes
    any D)."""
    for d in (24, 272):
        q = torch.empty((2, 64, d), device="meta")
        with pytest.raises(ValueError, match="multiple of 16"):
            fa.flash_attention_fwd(q, q, q)
