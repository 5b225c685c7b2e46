"""The port's attention model families against the reference's: configs,
and for each of the eight dense, MoE, audio and vision architectures at
smoke width, from the reference's init carried over by ``bridge.to_torch``:
the parameter tree, ``Model.loss`` and the gradient of every leaf, prefill
and four greedy decode steps; one live ``paper_hetero_severe`` run of the
MoE arch against the reference's; the launchers on the CPU.

On the CPU prefill attention runs the flash kernel's plain version; the
kernel path on the card is held to it in tests/test_torch_cuda.py and
chip_smoke.py.

Tolerances (fp32 compute, the smoke configs' own setting, unless said):
  * loss: rtol 1e-5; gradients: within 1e-4 of each leaf's largest |grad|
    (the same math in another summation order; the MoE's dispatch and
    combine are sums of one term and zeros, exact on both sides);
  * prefill and decode: logits within 1e-4 and caches within 1e-5,
    absolute, as tests/test_torch_serve.py;
  * bf16 compute: logits and every cache within 2e-2 of their largest
    |value|, as tests/test_torch_serve.py (the two packages round to bf16
    at other points);
  * greedy tokens equal;
  * the live run: tests/test_torch_methods.py's ``check_live`` (arrivals
    equal, evals within 1e-4, parameters within 5e-4 of each leaf's
    largest |value|).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import Model as JaxModel
from repro_torch import bridge
from repro_torch import configs
from repro_torch.launch import serve, train
from repro_torch.models import Model
from test_torch_methods import _live, check_live, one_intra_op_thread  # noqa: F401

B, S, GEN = 2, 16, 4
ATTN_ARCHS = ("qwen2-7b", "granite-3-8b", "command-r-35b", "starcoder2-15b",
              "granite-moe-1b-a400m", "llama4-scout-17b-a16e",
              "hubert-xlarge", "paligemma-3b")
DECODERS = tuple(a for a in ATTN_ARCHS if a != "hubert-xlarge")


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in leaves}


def _asdict(cfg):
    return dataclasses.asdict(cfg)


@functools.cache
def _reference(name):
    """The reference's smoke config and its init (one per arch)."""
    jcfg = jconfigs.get_config(name + "-smoke")
    return jcfg, jax.jit(JaxModel(jcfg).init)(jax.random.PRNGKey(0))


def _batch(cfg, seed=0):
    """numpy inputs of the arch's front end: tokens, or frame features,
    with patches for vision; labels with a few masked (-1) positions."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    out["labels"][:, :2] = -1
    if cfg.frontend.kind == "audio":
        out["features"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    if cfg.frontend.kind == "vision":
        out["patches"] = rng.normal(
            size=(B, cfg.frontend.n_prefix_tokens, cfg.d_model)).astype(
            np.float32)
    return out


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _close(got, want, bf16, atol):
    got, want = _np(got), _np(want)
    bound = 2e-2 * np.abs(want).max() if bf16 else atol
    err = np.abs(got - want).max()
    assert err <= bound, (err, bound)


# ---------------------------------------------------------------- configs

def test_every_config_equals_the_reference():
    assert tuple(configs.ARCHS) == tuple(jconfigs.ARCHS)
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    for name in configs.ARCHS:
        assert _asdict(configs.get_config(name)) == \
            _asdict(jconfigs.get_config(name)), name
        assert _asdict(configs.get_config(name + "-smoke")) == \
            _asdict(jconfigs.get_config(name + "-smoke")), name
        assert _asdict(configs.reduced(configs.get_config(name),
                                       seq_friendly=True)) == \
            _asdict(jconfigs.reduced(jconfigs.get_config(name),
                                     seq_friendly=True)), name
        assert configs.get_config(name).is_moe == \
            jconfigs.get_config(name).is_moe
    assert {k: _asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: _asdict(v) for k, v in jconfigs.SHAPES.items()}
    got = [(_asdict(m), _asdict(s), ok, why)
           for m, s, ok, why in configs.cells()]
    want = [(_asdict(m), _asdict(s), ok, why)
            for m, s, ok, why in jconfigs.cells()]
    assert got == want and len(got) == 40
    from repro.configs import base as jbase
    from repro_torch.configs import base
    assert base.FAMILIES == jbase.FAMILIES
    assert base.BLOCK_KINDS == jbase.BLOCK_KINDS
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


# ------------------------------------------------------- params and loss

@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_parameter_tree_equals_the_reference_init(name):
    jcfg, jparams = _reference(name)
    want = {k: (v.shape, str(v.dtype)) for k, v in _flat(jparams).items()}
    model = Model(configs.get_config(name + "-smoke"))
    specs = model.param_specs()
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in specs.items()} == want
    assert list(specs) == list(bridge.to_torch(_flat(jparams), "cpu"))
    # the port's own init: the same tree, ones and zeros where the
    # reference's are, and draws of the reference's scale
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    jflat = _flat(jparams)
    for k, v in params.items():
        assert (tuple(v.shape), v.dtype) == (specs[k].shape, specs[k].dtype)
        ref = jflat[k]
        if np.all(ref == ref.flat[0]):
            assert torch.equal(v, torch.from_numpy(ref.copy())), k
        else:
            ratio = float(v.std()) / float(ref.std())
            assert 0.8 < ratio < 1.25, (k, ratio)


@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_loss_and_grads_match_reference(name):
    jcfg, jparams = _reference(name)
    cfg = configs.get_config(name + "-smoke")
    batch = _batch(cfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(JaxModel(jcfg).loss,
                                             has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = bridge.to_torch(_flat(jparams), "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    loss = Model(cfg).loss(leaves, _to_torch(batch))
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    jg = _flat(jg)
    assert set(jg) == set(leaves)
    for k, g in zip(leaves, grads):
        want = jg[k]
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + 1e-12,
                                   err_msg=k)


def test_loss_mask_and_moe_aux_follow_the_reference():
    """An explicit ``loss_mask`` replaces ``labels >= 0``; the MoE adds
    0.01 x its layer-mean load-balance loss (the reference's aux)."""
    name = "granite-moe-1b-a400m"
    jcfg, jparams = _reference(name)
    cfg = configs.get_config(name + "-smoke")
    batch = _batch(cfg, seed=3)
    batch["loss_mask"] = (np.arange(S)[None, :] % 3 != 0).repeat(B, 0)
    jl, aux = jax.jit(JaxModel(jcfg).loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = bridge.to_torch(_flat(jparams), "cpu")
    tb = _to_torch(batch)
    tb["loss_mask"] = torch.from_numpy(batch["loss_mask"])
    loss = Model(cfg).loss(params, tb)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert float(aux["aux_loss"]) > 0


# ------------------------------------------------------------- serving

def _serve_check(name, compute_dtype, caches_held=True):
    jcfg, jparams = _reference(name)
    bf16 = compute_dtype == "bfloat16"
    jcfg = dataclasses.replace(jcfg, compute_dtype=compute_dtype)
    cfg = dataclasses.replace(configs.get_config(name + "-smoke"),
                              compute_dtype=compute_dtype)
    jmodel, model = JaxModel(jcfg), Model(cfg)
    params = bridge.to_torch(_flat(jparams), "cpu")
    batch = {k: v for k, v in _batch(cfg).items() if k != "labels"}
    n = S + cfg.frontend.n_prefix_tokens
    jlogits, jcaches = jax.jit(
        lambda p, b: jmodel.prefill(p, b, cache_len=n + GEN))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, caches = model.prefill(params, _to_torch(batch), n + GEN)
    assert logits.dtype == getattr(torch, compute_dtype)
    assert logits.shape == (B, cfg.vocab_size)
    jdecode = jax.jit(jmodel.decode)
    jtok, tok = jnp.argmax(jlogits, -1).astype(jnp.int32), logits.argmax(-1)
    for i in range(GEN):
        _close(logits, jlogits, bf16, 1e-4)
        assert tok.tolist() == np.asarray(jtok).tolist(), i
        jflat, flat = _flat(jcaches), _flat_caches(caches)
        assert set(flat) == set(jflat)
        for k, c in flat.items():
            assert c.dtype == logits.dtype and c.shape == jflat[k].shape
            if caches_held:
                _close(c, jflat[k], bf16, 1e-5)
        jlogits, jcaches = jdecode(jparams, jtok, jcaches,
                                   jnp.asarray(n + i, jnp.int32))
        logits, caches = model.decode(params, tok, caches, n + i)
        jtok, tok = jnp.argmax(jlogits, -1).astype(jnp.int32), \
            logits.argmax(-1)


def _flat_caches(caches):
    """The caches keyed by path, as the reference's tree flattens."""
    out = {}
    for k, v in caches.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kv}": t for kv, t in v.items()})
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("name", DECODERS)
def test_prefill_and_decode_match_reference(name):
    _serve_check(name, "float32")


@pytest.mark.parametrize("name", ["qwen2-7b", "granite-moe-1b-a400m"])
def test_prefill_and_decode_match_reference_bf16(name):
    """bf16: the logits at every step and the greedy tokens; the caches of
    the dense arch. The MoE's caches are not held in bf16: a token whose
    2nd and 3rd experts are a near tie routes to another expert where the
    two packages round its input differently, and its k and v in the
    layers after differ by a large share of their scale (ROADMAP C5). The
    fp32 test above holds every cache."""
    _serve_check(name, "bfloat16", caches_held=not name.startswith(
        "granite-moe"))


def test_bf16_moe_caches_part_only_after_a_near_tie_route():
    """ROADMAP C5 at smoke width: where the bf16 caches of granite-moe
    part from the reference's, the first layer that parts follows an MoE
    in which that token's k-th and (k+1)-th experts were a near tie (the
    port's fp32 router probabilities within 2e-3), and only a few of the
    B x S tokens part."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import transformer
    from repro_torch.models.layers import apply_norm
    name = "granite-moe-1b-a400m"
    jcfg, jparams = _reference(name)
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_config(name + "-smoke"),
                              compute_dtype="bfloat16")
    model = Model(cfg)
    params = bridge.to_torch(_flat(jparams), "cpu")
    batch = {"tokens": _batch(cfg)["tokens"]}
    _, jcaches = jax.jit(lambda p, b: JaxModel(jcfg).prefill(p, b))(
        jparams, {"tokens": jnp.asarray(batch["tokens"])})
    _, caches = model.prefill(params, _to_torch(batch))
    want, got = _np(jcaches["k"]), _np(caches["k"])        # (L, B, S, ..)
    far = np.abs(got - want).max(axis=(3, 4)) > 2e-2 * np.abs(want).max()
    if not far.any():
        return                                   # no near tie this time
    layer = int(np.argmax(far.any(axis=(1, 2))))
    assert layer > 0 and far[layer].sum() <= 4, far.sum(axis=(1, 2))
    x, positions = model._embed(params, _to_torch(batch))
    for i, p in enumerate(model._layers(params)):
        if i == layer - 1:
            h = apply_norm(p["norm1"], x, cfg)
            q, k, v = attn_lib.qkv_project(p["attn"], h, cfg, positions)
            x2 = x + attn_lib.attn_output(
                p["attn"], attn_lib.prefill_attend(q, k, v, causal=True))
            probs = torch.softmax(apply_norm(p["norm2"], x2, cfg).float()
                                  @ p["moe"]["router"], -1)
            top = torch.sort(probs, -1, descending=True).values
            kk = cfg.moe.top_k
            gap = (top[..., kk - 1] - top[..., kk]).numpy()
            for b, t in zip(*np.nonzero(far[layer])):
                assert gap[b, t] < 2e-3, (b, t, gap[b, t])
            return
        cache = {kv: torch.zeros_like(caches[kv][i]) for kv in ("k", "v")}
        x = transformer.prefill_attn_block(p, x, cfg, positions, cache)


def test_encoder_prefill_matches_reference_and_has_no_decode():
    name = "hubert-xlarge"
    jcfg, jparams = _reference(name)
    cfg = configs.get_config(name + "-smoke")
    assert not cfg.causal and cfg.encoder_only
    model = Model(cfg)
    params = bridge.to_torch(_flat(jparams), "cpu")
    feats = _batch(cfg)["features"]
    jlogits, jcaches = jax.jit(lambda p, f: JaxModel(jcfg).prefill(
        p, {"features": f}))(jparams, jnp.asarray(feats))
    logits, caches = model.prefill(params, {"features":
                                            torch.from_numpy(feats)})
    _close(logits, jlogits, False, 1e-4)
    for kv in ("k", "v"):
        _close(caches[kv], jcaches[kv], False, 1e-5)
    with pytest.raises(ValueError, match="encoder-only"):
        model.decode(params, logits.argmax(-1), caches, S)


# ------------------------------------------------------ training, launchers

def test_live_moe_reference_run_from_the_same_bits():
    check_live(*_live("paper_hetero_severe", arch="granite-moe-1b-a400m"))


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge"])
def test_engine_refuses_the_front_end_archs(arch):
    """The sampler yields tokens only, as the reference's: an audio or
    vision arch does not train through the engine."""
    from repro_torch.scenarios import registry
    scn = registry.get_scenario("paper_hetero_severe").overridden(arch=arch)
    with pytest.raises(ValueError, match="sampler yields no"):
        scn.build(device="cpu")


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge"])
def test_serve_launcher_runs_the_front_ends_on_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3", "--repeats", "1",
                      "--device", "cpu"])
    assert torch.isfinite(res["prefill_logits"]).all()
    out = capsys.readouterr().out
    assert "prefill:" in out
    if arch == "hubert-xlarge":
        assert res["tokens"] is None and "no decode" in out
    else:
        assert res["tokens"].shape == (2, 3) and "ms/token" in out


def test_train_launcher_runs_the_moe_arch_on_cpu(capsys):
    hist = train.main(["--arch", "granite-moe-1b-a400m", "--smoke",
                       "--workers", "3", "--paces", "1,2,6", "--outer", "4",
                       "--inner", "2", "--batch", "2", "--seq", "16",
                       "--device", "cpu"])
    assert len(hist.arrivals) == 4
    assert all(np.isfinite(e["mean"]) for e in hist.evals)
    assert "done: device=cpu" in capsys.readouterr().out
