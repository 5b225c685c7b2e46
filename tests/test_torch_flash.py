"""The port's attention forward of prefill against the reference's.

``kernels/flash_attention.py:flash_attention_fwd`` (on the CPU its plain
version, a masked fp32 softmax) against the reference's Pallas kernel in
interpret mode on the CPU, as tests/test_kernels.py runs it, on the same
numpy inputs; and the port's prefill attention (``models/attention.py:
prefill_attend``: heads grouped into (B*H, S, D), kv heads broadcast for
GQA) against the reference's ``attend``.

The CUDA kernel is held to the plain version on the card
(tests/test_torch_cuda.py); its walk over tiles (two partial states on
alternate kv tiles, merged in a fixed order) is modelled in plain PyTorch
by ``flash_attention_fwd_tiled`` and held here to the Pallas interpreter.

Tolerances: the reference's own (tests/test_kernels.py:125-160), 2e-5 in
fp32 and 2e-2 in bf16: the same function summed in another order (the
Pallas kernel adds tile by tile with the online rescaling). The prefill
attention against ``attend`` in fp32: 2e-5 as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash
from repro.models.attention import attend as jax_attend
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.attention import prefill_attend

TOL = {False: dict(rtol=2e-5, atol=2e-5), True: dict(rtol=2e-2, atol=2e-2)}


def _inputs(shapes, bf16, seed=0):
    """q, k, v as JAX arrays and torch tensors holding the same values
    (rounded to bf16 on both sides when asked)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        x = rng.standard_normal(shape).astype(np.float32)
        j, t = jnp.asarray(x), torch.from_numpy(x)
        out.append((j.astype(jnp.bfloat16), t.to(torch.bfloat16)) if bf16
                   else (j, t))
    return out


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_matches_pallas_interpreter(causal, bf16):
    (jq, tq), (jk, tk), (jv, tv) = _inputs([(2, 128, 64)] * 3, bf16)
    want = jax_flash(jq, jk, jv, causal=causal, q_chunk=64, kv_chunk=128,
                     interpret=True)
    got = fa.flash_attention_fwd(tq, tk, tv, causal=causal, q_chunk=64,
                                 kv_chunk=128)
    assert got.shape == (2, 128, 64) and got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[bf16])


@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_rectangular_matches_pallas_interpreter(causal):
    """Sq != Skv with q_chunk 32; causal keeps the reference's absolute
    indices (no offset)."""
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        [(2, 128, 64), (2, 384, 64), (2, 384, 64)], False, seed=1)
    want = jax_flash(jq, jk, jv, causal=causal, q_chunk=32, kv_chunk=128,
                     interpret=True)
    got = fa.flash_attention_fwd(tq, tk, tv, causal=causal, q_chunk=32,
                                 kv_chunk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[False])


@pytest.mark.parametrize("shape", [(2, 320, 320), (2, 200, 200),
                                   (2, 128, 384)],
                         ids=["square", "ragged", "rectangular"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("split", [True, False], ids=["split", "whole"])
def test_flash_tiled_walk_matches_pallas_interpreter(split, causal, d,
                                                     shape):
    """The kernel's walks in fp32, the kv walk split between two states and
    merged, or whole: 5 kv tiles (odd, unequal halves), a ragged last tile
    of 8 rows, and Sq != Skv with absolute causal indices; within 2e-5 of
    the Pallas kernel."""
    bh, sq, skv = shape
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        [(bh, sq, d), (bh, skv, d), (bh, skv, d)], False, seed=d + sq)
    q_chunk, kv_chunk = (32, 128) if sq != skv else (sq, skv)
    want = jax_flash(jq, jk, jv, causal=causal, q_chunk=q_chunk,
                     kv_chunk=kv_chunk, interpret=True)
    got = fa.flash_attention_fwd_tiled(tq, tk, tv, causal, split)
    assert got.shape == (bh, sq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[False])


def test_flash_fwd_keeps_the_reference_chunk_check():
    q = torch.zeros(1, 96, 32)
    with pytest.raises(AssertionError):
        fa.flash_attention_fwd(q, q, q, q_chunk=64)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, torch.zeros(1, 96, 16), q)


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_prefill_attend_matches_reference_attend(kv_heads):
    b, s, h, d = 2, 32, 4, 16
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        [(b, s, h, d), (b, s, kv_heads, d), (b, s, kv_heads, d)], False,
        seed=2)
    cfg = JaxModelConfig(name="t", family="dense", n_layers=1, d_model=h * d,
                         n_heads=h, n_kv_heads=kv_heads, d_ff=0,
                         vocab_size=8, head_dim=d)
    want = jax.jit(lambda q, k, v: jax_attend(q, k, v, causal=True, cfg=cfg,
                                              q_chunk=16))(jq, jk, jv)
    before = fa.flash_attention_fwd.launches
    got = prefill_attend(tq, tk, tv, causal=True)
    assert fa.flash_attention_fwd.launches == before   # no launch on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[False])
