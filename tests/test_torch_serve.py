"""The port's serving path against the reference's on bridged parameters:
``Model.prefill`` and four greedy ``Model.decode`` steps of smoke-width
dense tinygpt (GQA: 4 query heads on 2 kv heads), from the reference's
init carried over by ``bridge.to_torch``, on the same numpy prompts; and
the launcher ``launch/serve.py`` on the CPU.

On the CPU prefill attention runs the flash kernel's plain version; the
kernel path on the card is held to it in tests/test_torch_cuda.py and
chip_smoke.py.

Tolerances:
  * fp32 compute (reduced tinygpt's own setting): the same math in another
    summation order: logits within 1e-4 and caches within 1e-5, absolute
    (measured: 2.9e-7 and 1.9e-6);
  * bf16 compute (tinygpt's own): the two packages round to bf16 at other
    points (the reference's prefill attention casts p / l to bf16 before
    P V, the port's keeps p in fp32 until the output; bf16 matmul outputs
    accumulate in another order), and each rounding is up to 2^-8 of a
    value. Logits within 2e-2 of the largest |logit| and every cache leaf
    within 2e-2 of its largest |value|: a few bf16 steps (measured: 1.15e-2
    of the logits' and 1.18e-2 of the caches' scale);
  * greedy tokens equal in both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import Model

B, S, GEN = 2, 16, 4


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in leaves}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _close(got, want, bf16, atol):
    got, want = _np(got), _np(want)
    bound = 2e-2 * np.abs(want).max() if bf16 else atol
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(),
                                               bound)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(compute_dtype):
    name = "tinygpt-15m-smoke"
    bf16 = compute_dtype == "bfloat16"
    jcfg = dataclasses.replace(jax_get_config(name),
                               compute_dtype=compute_dtype)
    cfg = dataclasses.replace(get_config(name), compute_dtype=compute_dtype)
    jmodel, model = JaxModel(jcfg), Model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = bridge.to_torch(_flat(jparams), "cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jlogits, jcaches = jax.jit(
        lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=S + GEN))(
        jparams, jnp.asarray(prompts))
    logits, caches = model.prefill(params, torch.from_numpy(prompts).long(),
                                   S + GEN)
    assert logits.dtype == getattr(torch, compute_dtype)
    assert logits.shape == (B, cfg.vocab_size)
    jdecode = jax.jit(jmodel.decode)
    jtok, tok = jnp.argmax(jlogits, -1).astype(jnp.int32), logits.argmax(-1)
    for i in range(GEN):
        _close(logits, jlogits, bf16, 1e-4)
        assert tok.tolist() == np.asarray(jtok).tolist(), i
        assert set(caches) == set(jcaches) == {f"layer_{j:02d}" for j in
                                               range(cfg.n_layers)}
        for key, c in caches.items():
            for kv in ("k", "v"):
                assert c[kv].dtype == logits.dtype
                assert c[kv].shape == jcaches[key][kv].shape
                _close(c[kv], jcaches[key][kv], bf16, 1e-5)
        jlogits, jcaches = jdecode(jparams, jtok, jcaches,
                                   jnp.asarray(S + i, jnp.int32))
        logits, caches = model.decode(params, tok, caches, S + i)
        jtok, tok = jnp.argmax(jlogits, -1).astype(jnp.int32), \
            logits.argmax(-1)


def test_init_caches_are_zero_in_the_compute_dtype():
    model = Model(get_config("tinygpt-15m-smoke"))
    caches = model.init_caches(3, 10, "cpu")
    assert set(caches) == {f"layer_{j:02d}" for j in range(4)}
    c = caches["layer_00"]["k"]
    assert c.shape == (3, 10, 2, 16) and c.dtype == torch.float32
    assert not c.any()


def test_serve_launcher_serves_reference_params(tmp_path):
    """``--params``: the reference's init flattened to numpy, served by
    the launcher, greedy-decodes the reference's tokens (fp32 compute)."""
    name = "tinygpt-15m-smoke"
    jmodel = JaxModel(jax_get_config(name))
    jparams = jmodel.init(jax.random.PRNGKey(3))
    path = tmp_path / "params.npz"
    np.savez(path, **_flat(jparams))
    res = serve.main(["--smoke", "--batch", "2", "--prompt-len", "8",
                      "--gen", "4", "--seed", "5", "--params", str(path),
                      "--device", "cpu"])
    prompts = torch.randint(0, get_config(name).vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(6))
    logits, caches = jax.jit(
        lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=12))(
        jparams, jnp.asarray(prompts.numpy(), jnp.int32))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    jdecode = jax.jit(jmodel.decode)
    for i in range(3):
        logits, caches = jdecode(jparams, tok, caches,
                                 jnp.asarray(8 + i, jnp.int32))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    assert res["tokens"].tolist() == np.stack(want, 1).tolist()


def test_serve_launcher_on_cpu(capsys):
    res = serve.main(["--smoke", "--batch", "2", "--prompt-len", "8",
                      "--gen", "3", "--device", "cpu"])
    assert res["tokens"].shape == (2, 3)
    assert torch.isfinite(res["prefill_logits"]).all()
    out = capsys.readouterr().out
    assert "prefill:" in out and "ms/token" in out


def test_serve_launcher_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        serve.main(["--smoke", "--gen", "2"])
