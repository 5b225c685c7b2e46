"""The port's recurrent families against the reference's: the hybrid
zamba2-2.7b (a Mamba2 stack with one shared attention + MLP block) and the
ssm xlstm-125m (mLSTM and sLSTM blocks), at smoke width (4 layers, d 64;
zamba2 two super blocks of two Mamba2 units, SSD chunk 16; xlstm sLSTM at
layer 3, mLSTM chunk 8), from the reference's init carried over by
``bridge.to_torch``. Sequences of 32 run several chunks of each scan.

No test here builds a full-width model: zamba2-2.7b is 9.26 GB in fp32,
and the suite's worker processes share one host. Full-width trees are
checked through ``param_specs`` (meta tensors) and ``jax.eval_shape``.

On the CPU the shared block's prefill attention runs the flash kernel's
plain version; the kernel path on the card is held to it in
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances (fp32 compute, the smoke configs' own setting, unless said):
  * the scans (SSD, mLSTM, sLSTM, the causal convs): outputs and states
    within 1e-5 of their largest |value| (at least 1), against the
    reference and against a chain of the port's own one-step recurrence;
  * loss: rtol 1e-5; gradients: within 1e-4 of each leaf's largest |grad|,
    the shared block's summed over its sites. The sLSTM's input-gate bias
    is the one exception: h = o c / n is unchanged when every step's log
    input gate moves by one constant, so its gradient is zero in exact
    arithmetic, and both packages hold only rounding there (2e-10 at
    smoke width); it is held under 1e-6 of the model's largest |grad|;
  * prefill and decode: logits within 1e-4; every cache leaf of the
    reference's dtype, and within 1e-5 of its largest |value| (at least
    1). A bf16 conv window (rounded from fp32 as the reference rounds it)
    may sit one bf16 step away where the two packages' fp32 values, 1e-6
    apart, straddle a rounding midpoint;
  * bf16 compute: logits within the larger of 2e-2 of their largest
    |value| (tests/test_torch_serve.py) and 1.5 times the reference's own
    bf16 distance from its fp32 logits (the bf16 test's docstring), and
    each cache of the reference's dtype;
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
from repro.models import mamba2 as jm2
from repro.models import xlstm as jxl
from repro_torch import bridge, configs
from repro_torch.launch import serve, train
from repro_torch.models import Model
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as m2
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import causal_conv
from test_torch_methods import _live, check_live, one_intra_op_thread  # noqa: F401

B, S, GEN = 2, 32, 4
ARCHS = ("zamba2-2.7b", "xlstm-125m")


def _key(entry):
    return str(entry.key) if hasattr(entry, "key") else str(entry.idx)


def _flat(tree):
    """A pytree's leaves by ``/``-joined path; tuple members by index."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(_key(k) for k in path): np.asarray(v)
            for path, v in leaves}


def _flat_torch(tree, prefix=""):
    """The port's caches flattened as ``_flat`` flattens the reference's."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat_torch(v, f"{prefix}{k}/"))
    return out


@functools.cache
def _reference(name):
    """The reference's smoke config and its init (one per arch)."""
    jcfg = jconfigs.get_config(name + "-smoke")
    return jcfg, jax.jit(JaxModel(jcfg).init)(jax.random.PRNGKey(0))


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32), np.float32)


def _close(got, want, rel=1e-5):
    """Within ``rel`` of the larger of 1 and want's largest |value|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------------ units

def _ssd_inputs(seed=0, b=2, s=S, h=4, p=8, g=2, n=8):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(x=rng.normal(size=(b, s, h, p)).astype(f32),
                dt=np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(f32),
                a=-np.linspace(1.0, 4.0, h).astype(f32),
                bm=rng.normal(size=(b, s, g, n)).astype(f32),
                cm=rng.normal(size=(b, s, g, n)).astype(f32),
                state=0.1 * rng.normal(size=(b, h, p, n)).astype(f32))


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_forward_matches_reference_and_the_step_chain(chunk):
    """Four chunks of 8 (the carried state crosses three borders) or one,
    from a given state; groups of two heads each (B and C repeated over
    heads as ``jnp.repeat`` repeats them)."""
    d = _ssd_inputs()
    jy, js = jm2.ssd_forward(*(jnp.asarray(d[k]) for k in
                               ("x", "dt", "a", "bm", "cm")), chunk,
                             init_state=jnp.asarray(d["state"]))
    y, st = m2.ssd_forward(*(_t(d[k]) for k in ("x", "dt", "a", "bm", "cm")),
                           chunk, init_state=_t(d["state"]))
    _close(y, jy)
    _close(st, js)
    state, ys = _t(d["state"]), []
    for t in range(S):
        yt, state = m2.ssd_step(state, *(_t(d[k][:, t]) for k in ("x", "dt")),
                                _t(d["a"]), _t(d["bm"][:, t]),
                                _t(d["cm"][:, t]))
        ys.append(yt)
    _close(y, torch.stack(ys, 1))
    _close(st, state)


def _mlstm_inputs(seed=1, b=2, s=S, h=2, p=8):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    q, k, v = (rng.normal(size=(b, s, h, p)).astype(f32) for _ in range(3))
    logi = rng.normal(size=(b, s, h)).astype(f32)
    logf = -np.log1p(np.exp(-(rng.normal(size=(b, s, h)) + 3.0))).astype(f32)
    return q, k, v, logi, logf


def test_mlstm_sequence_matches_reference_and_the_step_chain():
    """Four chunks of 8; the max-state starts at 0.0 on both sides."""
    arrays = _mlstm_inputs()
    jy, jst = jxl.mlstm_sequence(*(jnp.asarray(a) for a in arrays), 8)
    y, st = xl.mlstm_sequence(*(_t(a) for a in arrays), 8)
    _close(y, jy)
    for got, want in zip(st, jst):
        _close(got, want)
    q, k, v, logi, logf = (_t(a) for a in arrays)
    state = tuple(torch.zeros_like(t) for t in st)
    ys = []
    for t in range(S):
        yt, state = xl.mlstm_step(q[:, t], k[:, t], v[:, t], logi[:, t],
                                  logf[:, t], state)
        ys.append(yt)
    _close(y, torch.stack(ys, 1))
    # the max-states differ between the forms (per chunk or per step);
    # the stabilised C and n agree once scaled back by exp(m)
    for got, want in zip(st[:2], state[:2]):
        scale = torch.exp(st[2] - state[2])
        scale = scale.reshape(scale.shape + (1,) * (got.dim() - 2))
        _close(got, want / scale)


def test_slstm_cell_over_a_sequence_matches_reference():
    """The reference's sLSTM parameters (its init at smoke width), the
    cell stepped over 32 random inputs from zero state."""
    cfg = configs.get_config("xlstm-125m-smoke")
    jp = jxl.init_slstm(jax.random.PRNGKey(3), jconfigs.get_config(
        "xlstm-125m-smoke"))
    p = bridge.to_torch(_flat(jp), "cpu")
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
          for _ in range(4)]
    jst = tuple(jnp.zeros((B, cfg.d_model), jnp.float32) for _ in range(4))
    st = tuple(torch.zeros((B, cfg.d_model)) for _ in range(4))
    for t in range(S):
        jst = jxl._slstm_cell(jp, *(jnp.asarray(x[:, t]) for x in xs), jst,
                              cfg.n_heads)
        st = xl._slstm_cell(p, *(_t(x[:, t]) for x in xs), st, cfg.n_heads)
        for got, want in zip(st, jst):
            _close(got, want)


@pytest.mark.parametrize("which", ["mamba2", "xlstm"])
def test_causal_convs_carry_their_cache(which):
    """``layers.causal_conv``, the port's one conv for both blocks: three
    calls of 16, 1 and 15 steps, each from the last call's window, give
    the one call's output and window; and equal the reference's
    ``_conv1d`` (Mamba2) and ``_causal_conv`` (xLSTM)."""
    conv = causal_conv
    jconv = jm2._conv1d if which == "mamba2" else jxl._causal_conv
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    whole, last = conv(_t(x), _t(w), _t(b), None)
    jwhole, jlast = jconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          None)
    _close(whole, jwhole)
    _close(last, jlast)
    outs, cache = [], None
    for cut in (slice(0, 16), slice(16, 17), slice(17, S)):
        out, cache = conv(_t(x[:, cut]), _t(w), _t(b), cache)
        outs.append(out)
    _close(torch.cat(outs, 1), whole)
    assert torch.equal(cache, last)


# ------------------------------------------------------- params and loss

@pytest.mark.parametrize("name", ARCHS)
def test_parameter_tree_equals_the_reference_init(name):
    jcfg, jparams = _reference(name)
    jflat = _flat(jparams)
    model = Model(configs.get_config(name + "-smoke"))
    specs = model.param_specs()
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in specs.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jflat.items()}
    assert list(specs) == list(bridge.to_torch(jflat, "cpu"))
    # the port's own init: the same tree, the reference's set values
    # where its are set (ones, zeros, 3.0, A's log-spaced values), and
    # draws of the reference's scale
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    for k, v in params.items():
        assert (tuple(v.shape), v.dtype) == (specs[k].shape, specs[k].dtype)
        ref = jflat[k]
        if k.endswith("a_log"):
            np.testing.assert_allclose(v.numpy(), ref, rtol=1e-6)
        elif np.all(ref == ref.flat[0]):
            assert torch.equal(v, torch.from_numpy(ref.copy())), k
        else:
            ratio = float(v.std()) / float(ref.std())
            assert 0.8 < ratio < 1.25, (k, ratio)


@pytest.mark.parametrize("name, leaves, params", [
    ("zamba2-2.7b", 19, 2_314_535_840), ("xlstm-125m", 183, None)])
def test_full_width_tree_equals_the_reference_without_allocating(
        name, leaves, params):
    """The full-width tree through meta tensors and ``jax.eval_shape``:
    nothing is allocated. zamba2's Mamba2 leaves carry (9, 6) in front."""
    shapes, _ = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        JaxModel(jconfigs.get_config(name)).init, jax.random.PRNGKey(0)))
    want = {"/".join(_key(k) for k in path): (tuple(v.shape), str(v.dtype))
            for path, v in shapes}
    specs = Model(configs.get_config(name)).param_specs()
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in specs.items()} == want
    assert len(specs) == leaves
    if params is not None:
        assert sum(v.numel() for v in specs.values()) == params
    if name == "zamba2-2.7b":
        assert tuple(specs["super/mamba/w_in"].shape) == (9, 6, 2560, 10448)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    out["labels"][:, :2] = -1
    return out


# zero in exact arithmetic (module docstring)
ROUNDING_ONLY = ("slstm/b_i",)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference(name):
    jcfg, jparams = _reference(name)
    cfg = configs.get_config(name + "-smoke")
    batch = _batch(cfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(JaxModel(jcfg).loss,
                                             has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = {k: v.requires_grad_(True)
              for k, v in bridge.to_torch(_flat(jparams), "cpu").items()}
    loss = Model(cfg).loss(leaves, {k: torch.from_numpy(v).long()
                                    for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    jg = _flat(jg)
    assert set(jg) == set(leaves)
    top = max(float(np.abs(g).max()) for g in jg.values())
    for k, g in zip(leaves, grads):
        want = jg[k]
        if k.endswith(ROUNDING_ONLY):
            assert np.abs(g.numpy()).max() <= 1e-6 * top, k
            assert np.abs(want).max() <= 1e-6 * top, k
            continue
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + 1e-12,
                                   err_msg=k)
    if name == "zamba2-2.7b":
        assert any(k.startswith("shared/") for k in jg)


# ------------------------------------------------------------- serving

def _cache_close(got, want, key):
    """fp32: within 1e-5 of the larger of 1 and want's largest |value|; a
    bf16 window also within one bf16 step of each value (at most 2 ** -7
    of it; module docstring)."""
    got, want = _np(got), _np(want)
    bound = 1e-5 * max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want)
    if key.endswith("conv"):
        err = np.where(err <= np.abs(want) * 2.0 ** -7, 0.0, err)
    assert float(err.max()) <= bound, (key, float(err.max()), bound)


def _serving(name, compute_dtype):
    """Both models at ``compute_dtype`` from the same bits, the prompts,
    and each package's prefill and decode as functions of tokens."""
    jcfg, jparams = _reference(name)
    jmodel = JaxModel(dataclasses.replace(jcfg, compute_dtype=compute_dtype))
    model = Model(dataclasses.replace(configs.get_config(name + "-smoke"),
                                      compute_dtype=compute_dtype))
    params = bridge.to_torch(_flat(jparams), "cpu")
    jprefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t},
                                                   cache_len=S + GEN))
    jdecode = jax.jit(jmodel.decode)
    return (_batch(model.cfg)["tokens"],
            lambda t: jprefill(jparams, jnp.asarray(t)),
            lambda tok, c, pos: jdecode(jparams, jnp.asarray(tok, jnp.int32),
                                        c, jnp.asarray(pos, jnp.int32)),
            lambda t: model.prefill(params, torch.from_numpy(t).long(),
                                    S + GEN),
            lambda tok, c, pos: model.decode(params, torch.from_numpy(
                np.array(tok, np.int64)), c, pos))


def _check_caches(caches, jcaches, i, values):
    jflat, flat = _flat(jcaches), _flat_torch(caches)
    assert set(flat) == set(jflat)
    for k, c in flat.items():
        assert str(c.dtype) == "torch." + str(jflat[k].dtype), (i, k)
        assert tuple(c.shape) == jflat[k].shape, (i, k)
        if values:
            _cache_close(c, jflat[k], f"step {i} {k}")


def _to_port(tree):
    """The reference's cache tree as the port's: dicts and tuples kept,
    each array a tensor of its dtype (bf16 through fp32, exactly)."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_port(v) for v in tree)
    return torch.from_numpy(np.array(tree, np.float32)).to(
        getattr(torch, str(tree.dtype)))


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name):
    """fp32: prefill of 32 tokens (two SSD chunks, four mLSTM chunks),
    then four greedy decode steps, each from the reference's caches of the
    step before: logits, tokens and every cache leaf, its dtype included
    (the Mamba2 conv window bf16 after every step, the xLSTM windows bf16
    after the prefill and fp32 after a decode step, as the reference's).
    Each step starts from the reference's caches: a window value one bf16
    step apart (module docstring) feeds the next step's keys and would
    move an mLSTM's matrix memory by ~3e-4 of its scale."""
    tokens, jprefill, jdecode, prefill, decode = _serving(name, "float32")
    (jlogits, jcaches), (logits, caches) = jprefill(tokens), prefill(tokens)
    for i in range(GEN + 1):
        assert logits.dtype == torch.float32
        assert np.abs(_np(logits) - _np(jlogits)).max() <= 1e-4, i
        tok = logits.argmax(-1)
        assert tok.tolist() == np.asarray(jnp.argmax(jlogits, -1)).tolist()
        _check_caches(caches, jcaches, i, values=True)
        if i < GEN:
            logits, caches = decode(tok.numpy(), _to_port(jcaches), S + i)
            jlogits, jcaches = jdecode(tok.numpy(), jcaches, S + i)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference_bf16(name):
    """bf16, both packages fed the reference's greedy tokens. Through bf16
    recurrences the reference's own logits sit 3.4 % (zamba2) and 7.0 %
    (xlstm) of their largest |value| from its fp32 logits at smoke width,
    and the port's as far (2.1 %, 6.3 %): each package rounds at its own
    points (XLA keeps fused elementwise chains in fp32). So at each step
    the port's logits are held within the larger of 2e-2 and 1.5 times
    the reference's own bf16 distance from its fp32 logits (chip_smoke.py's
    band, ROADMAP C6), the port's greedy token within twice that of its
    top logit, and every cache to the reference's dtypes."""
    tokens, jprefill, jdecode, prefill, decode = _serving(name, "bfloat16")
    _, jprefill32, jdecode32, _, _ = _serving(name, "float32")
    (jlogits, jcaches), (logits, caches) = jprefill(tokens), prefill(tokens)
    jlogits32, jcaches32 = jprefill32(tokens)
    for i in range(GEN + 1):
        assert logits.dtype == torch.bfloat16
        want = _np(jlogits)
        scale = np.abs(want).max()
        band = max(2e-2, 1.5 * np.abs(want - _np(jlogits32)).max() / scale)
        got = _np(logits)
        assert np.abs(got - want).max() <= band * scale, (i, band)
        jtok = np.asarray(jnp.argmax(jlogits, -1))
        chosen = got[np.arange(B), jtok]
        assert (chosen >= got.max(-1) - 2 * band * scale).all(), i
        _check_caches(caches, jcaches, i, values=False)
        if i < GEN:
            jlogits, jcaches = jdecode(jtok, jcaches, S + i)
            jlogits32, jcaches32 = jdecode32(jtok, jcaches32, S + i)
            logits, caches = decode(jtok, caches, S + i)


@pytest.mark.parametrize("name, per_prefill", [("zamba2-2.7b", 2),
                                               ("xlstm-125m", 0)])
def test_prefill_attends_through_the_flash_wrapper_once_a_super_block(
        name, per_prefill, monkeypatch):
    """zamba2's shared block calls ``flash_attention_fwd`` once at each of
    its 2 sites in a prefill (9 at full depth); decode calls it never, nor
    does xlstm."""
    calls = []
    kernel = attn_lib.flash_attention_fwd

    def counted(*a, **k):
        calls.append(a[0].shape)
        return kernel(*a, **k)

    monkeypatch.setattr(attn_lib, "flash_attention_fwd", counted)
    cfg = configs.get_config(name + "-smoke")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    logits, caches = model.prefill(params, torch.zeros((B, 16), dtype=torch.long),
                                   18)
    assert len(calls) == per_prefill
    assert all(c == (B * cfg.n_heads, 16, cfg.head_dim) for c in calls)
    model.decode(params, logits.argmax(-1), caches, 16)
    assert len(calls) == per_prefill


# ------------------------------------------------------ training, launchers

def test_live_zamba2_reference_run_from_the_same_bits():
    check_live(*_live("paper_hetero_severe", arch="zamba2-2.7b"))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_the_recurrent_archs_on_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prompt-len", "16", "--gen", "3", "--repeats", "1",
                      "--device", "cpu"])
    assert torch.isfinite(res["prefill_logits"]).all()
    assert res["tokens"].shape == (2, 3)
    out = capsys.readouterr().out
    assert "prefill:" in out and "ms/token" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_the_recurrent_archs_on_cpu(arch, capsys):
    hist = train.main(["--arch", arch, "--smoke", "--workers", "3",
                       "--paces", "1,2,6", "--outer", "4", "--inner", "2",
                       "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert len(hist.arrivals) == 4
    assert all(np.isfinite(e["mean"]) for e in hist.evals)
    assert "done: device=cpu" in capsys.readouterr().out
