"""flash_attention_fwd at the head dims of the second CUDA route (a multiple
of 16 up to 256 outside {32, 64, 128}: 16 for every smoke config, 80 for
hubert-xlarge, 256 for paligemma-3b) against the reference's Pallas kernel
in interpret mode on the CPU, on the same numpy inputs: the plain version
(``flash_attention_fwd``'s CPU path) and ``flash_attention_fwd_tiled``
without the split, the walk of that route's CTA (one 64-row q tile, its kv
tiles of 64 rows in order with one online-softmax state, those above a
causal tile's last row skipped). The route itself is held to the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).

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


def test_the_routes_split_the_head_dims():
    assert fa.MMA_DIMS == (16, 48, 80, 96, 112, 144, 160, 176, 192, 208, 224,
                           240, 256)
    assert not set(fa.MMA_DIMS) & set(fa.HEAD_DIMS)
    assert set(DIMS) <= set(fa.MMA_DIMS)


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
    """Ragged edges on both axes (200 = 3 tiles + 8 rows), and Sq != Skv
    both ways under the absolute causal rule."""
    bh, sq, skv = shape
    (jq, tq), (jk, tk), (jv, tv) = _inputs(bh, sq, skv, d, False, seed=sq)
    got = fa.flash_attention_fwd_tiled(tq, tk, tv, causal, split=False)
    np.testing.assert_allclose(got.numpy(), _want(jq, jk, jv, causal, sq),
                               **TOL[False])


def test_the_card_refuses_head_dims_no_route_serves():
    """Not a multiple of 16, or past 256: refused before any launch, for a
    tensor off the CPU (``meta`` here; on the CPU the plain version takes
    any D)."""
    for d in (24, 272):
        q = torch.empty((2, 64, d), device="meta")
        with pytest.raises(ValueError, match="multiple of 16"):
            fa.flash_attention_fwd(q, q, q)
