"""The port's training memory plan against the reference's, on the CPU.

  * ``attention.flash_attention`` (a ``torch.autograd.Function``) against
    the reference's ``flash_attention`` (its jnp custom-vjp): the output
    and ``jax.vjp``'s gradients against ``torch.autograd.grad``, fp32
    within rtol 1e-5 and atol 1e-6; causal or not, GQA (G = 2) or MHA,
    S = 32 in four chunks of 8 or in one (12 does not divide 32); queries
    at an offset and keys past ``kv_valid``;
  * the Function against the plain ``attend(use_flash=False)``: fp32 within
    the same bands, bf16 within 2e-2 of each output's largest |value| (the
    port's bf16 band, tests/test_torch_serve.py: the two paths round to
    bf16 at other points);
  * ``Model.loss`` and its gradients with ``q_chunk`` 8 at S = 32 and
    ``remat`` on in both packages (``remat_group`` 2 on a stacked dense
    config) against the reference's ``loss(..., q_chunk=8)``, the families'
    bands: loss rtol 1e-5, each gradient within 1e-4 of its leaf's largest
    |value|, but for the sLSTM's input-gate bias, whose gradient is zero
    in exact arithmetic: under 1e-6 of the model's largest |grad| on both
    sides, as tests/test_torch_recurrent.py holds it; remat on against
    off bit for bit in the port;
  * what autograd saves (``torch.autograd.graph.saved_tensors_hooks``): no
    saved tensor of the plan holds an (S, S) block per head, and with remat
    the activations kept (saved tensors and the checkpoints' inputs, the
    parameters' own storage not counted) are fewer bytes than without;
  * ``dist.steps.make_train_step(q_chunk=8)`` against the reference's on
    its one-device mesh, in tests/test_torch_dist.py's bands;
  * the dry-run applies the plan: a train cell with ``remat_group``,
    ``head_tp`` and ``seq_parallel`` has no ``plan_not_applied`` field and
    its config carries them, and with remat the
    count of full-width qwen2-7b ``train_4k`` (meta tensors, nothing
    allocated) exceeds the count without it by exactly the forward the
    checkpoints run again.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import InnerOptConfig as JInner
from repro.dist import sharding as jshd
from repro.dist import steps as jsteps
from repro.launch.mesh import mesh_context as jmesh_context
from repro.models import Model as JaxModel
from repro.models.attention import flash_attention as jflash
from repro_torch import bridge, configs
from repro_torch.configs.base import InnerOptConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist import steps
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models import Model
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer
from test_torch_dist import INNER, _jflat, _jmesh, _np_tree, check_step
from test_torch_methods import one_intra_op_thread  # noqa: F401
from test_torch_recurrent import ROUNDING_ONLY

B, S, Q_CHUNK = 2, 32, 8
FAMILIES = ("tinygpt-15m", "qwen2-7b", "granite-moe-1b-a400m", "zamba2-2.7b",
            "xlstm-125m")
# the stacked dense config whose checkpoints group two layers
REMAT_GROUP = {"qwen2-7b": 2}


def _qkv(heads, kv_heads, dtype=np.float32, seed=0, d=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(dtype) for shape in (
        (B, S, heads, d), (B, S, kv_heads, d), (B, S, kv_heads, d),
        (B, S, heads, d))]


def _torch_grads(fn, q, k, v, do):
    """fn's output and (dq, dk, dv) for cotangent ``do``, all as given
    tensors' copies with gradients."""
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, torch.from_numpy(do))


# ------------------------------------------------------------ the Function

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads, kv_heads", [(4, 2), (4, 4)])
@pytest.mark.parametrize("q_chunk", [Q_CHUNK, 12])
def test_flash_function_matches_the_reference_custom_vjp(causal, heads,
                                                         kv_heads, q_chunk):
    q, k, v, do = _qkv(heads, kv_heads)

    @jax.jit
    def reference(q, k, v, do):
        out, vjp = jax.vjp(lambda *a: jflash(*a, causal=causal,
                                             q_chunk=q_chunk), q, k, v)
        return out, vjp(do)
    jout, jgrads = reference(q, k, v, do)
    out, grads = _torch_grads(functools.partial(
        attn_lib.flash_attention, causal=causal, q_chunk=q_chunk), q, k, v,
        do)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    for name, g, want in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_matches_the_plain_attend(dtype, causal):
    dt = getattr(torch, dtype)
    q, k, v, do = _qkv(4, 2, seed=1)

    def run(use_flash):
        leaves = [torch.from_numpy(x).to(dt).requires_grad_(True)
                  for x in (q, k, v)]
        out = attn_lib.attend(*leaves, causal=causal, q_chunk=Q_CHUNK,
                              use_flash=use_flash)
        return [out, *torch.autograd.grad(out, leaves,
                                          torch.from_numpy(do).to(dt))]
    for name, got, want in zip(("out", "dq", "dk", "dv"), run(True),
                               run(False)):
        assert got.dtype == dt, name
        got, want = got.detach().float().numpy(), want.detach().float(
        ).numpy()
        if dt == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        else:
            err = np.abs(got - want).max()
            assert err <= 2e-2 * np.abs(want).max(), (name, err)


def test_q_offset_and_kv_valid_follow_the_reference():
    """Queries placed at ``q_offset`` for the causal mask and keys past
    ``kv_valid`` masked, in four chunks, against the reference's."""
    q, k, v, do = _qkv(4, 2, seed=3)

    @jax.jit
    def reference(q, k, v, do):
        out, vjp = jax.vjp(lambda *a: jflash(
            *a, causal=True, q_offset=4, kv_valid=jnp.asarray(20),
            q_chunk=Q_CHUNK), q, k, v)
        return out, vjp(do)
    jout, jgrads = reference(q, k, v, do)
    out, grads = _torch_grads(functools.partial(
        attn_lib.flash_attention, causal=True, q_offset=4, kv_valid=20,
        q_chunk=Q_CHUNK), q, k, v, do)
    for got, want in zip((out.detach(), *grads), (jout, *jgrads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    assert not grads[1][:, 20:].any() and not grads[2][:, 20:].any()


def test_a_chunk_that_does_not_divide_is_the_whole_sequence():
    """q_chunk 12 at S 32 gives the bits of q_chunk 32 (one chunk), and
    q_chunk past S the same."""
    q, k, v, _ = _qkv(4, 2, seed=2)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    outs = [attn_lib.flash_attention(qt, kt, vt, causal=True, q_chunk=c)
            for c in (12, S, 4 * S)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


# -------------------------------------------------------- Model.loss, remat

def _configs(name, remat=True):
    group = REMAT_GROUP.get(name, 1)
    jcfg = dataclasses.replace(jconfigs.get_config(name + "-smoke"),
                               remat=remat, remat_group=group)
    cfg = dataclasses.replace(configs.get_config(name + "-smoke"),
                              remat=remat, remat_group=group)
    return jcfg, cfg


@functools.cache
def _reference_init(name):
    jcfg, _ = _configs(name)
    return jax.jit(JaxModel(jcfg).init)(jax.random.PRNGKey(0))


def _batch(cfg, seed=0, seq=S):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": tok, "labels": labels}


def _tt(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _loss_and_grads(cfg, params, batch, q_chunk=Q_CHUNK):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    loss = Model(cfg).loss(leaves, batch, q_chunk=q_chunk)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(leaves, grads))


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_under_the_plan_match_the_reference(name):
    jcfg, cfg = _configs(name)
    jparams = _reference_init(name)
    batch = _batch(cfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        functools.partial(JaxModel(jcfg).loss, q_chunk=Q_CHUNK),
        has_aux=True))(jparams, {k: jnp.asarray(v) for k, v in
                                 batch.items()})
    params = bridge.to_torch({k: np.asarray(v) for k, v in
                              _jflat(jparams).items()}, "cpu")
    loss, grads = _loss_and_grads(cfg, params, _tt(batch))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    jg = {k: np.asarray(v) for k, v in _jflat(jg).items()}
    assert set(jg) == set(grads)
    top = max(float(np.abs(g).max()) for g in jg.values())
    for k, g in grads.items():
        if k.endswith(ROUNDING_ONLY):
            assert float(g.abs().max()) <= 1e-6 * top, k
            assert np.abs(jg[k]).max() <= 1e-6 * top, k
            continue
        np.testing.assert_allclose(g.numpy(), jg[k], rtol=0,
                                   atol=1e-4 * np.abs(jg[k]).max() + 1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_on_and_off_are_bit_equal(name):
    _, on = _configs(name, remat=True)
    off = dataclasses.replace(on, remat=False)
    params = Model(on).init(torch.Generator().manual_seed(0), "cpu")
    batch = _tt(_batch(on, seed=1))
    (l_on, g_on), (l_off, g_off) = (_loss_and_grads(c, params, batch)
                                    for c in (on, off))
    assert torch.equal(l_on, l_off)
    for k, g in g_on.items():
        assert torch.equal(g, g_off[k]), k


def test_remat_groups_must_divide_the_stacked_layers():
    _, cfg = _configs("qwen2-7b")
    cfg = dataclasses.replace(cfg, remat_group=3)
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="remat groups of 3"):
        Model(cfg).loss(params, _tt(_batch(cfg)))


# ---------------------------------------------------------- saved tensors

# no width of the smoke configs, so an (S, S) block shows; B x S whole
# MoE dispatch groups of 64
SAVED_S = 96


def _saved(fn, params, monkeypatch=None):
    """Storages autograd keeps for the backward of ``fn()``: the tensors
    it saves and, where ``transformer.checkpoint`` is called, the
    checkpoints' tensor inputs (a checkpoint keeps them and saves nothing
    else past its forward). Returns ({storage: bytes}, the saved shapes);
    the parameters' own storages are not counted."""
    params_at = {p.untyped_storage().data_ptr() for p in params.values()}
    kept, shapes = {}, []

    def keep(t):
        st = t.untyped_storage()
        if st.data_ptr() not in params_at:
            kept[st.data_ptr()] = st.nbytes()

    def pack(t):
        keep(t)
        shapes.append(tuple(t.shape))
        return t
    if monkeypatch is not None:
        real = transformer.checkpoint

        def recording(f, *args, **kw):
            for a in args:
                if isinstance(a, torch.Tensor):
                    keep(a)
            return real(f, *args, **kw)
        monkeypatch.setattr(transformer, "checkpoint", recording)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return kept, shapes, out


def _holds_square(shapes, s=SAVED_S):
    return [sh for sh in shapes if sum(d == s for d in sh) >= 2]


def test_the_plain_attend_saves_a_square_block_and_the_function_none():
    q, k, v = (torch.randn(B, SAVED_S, h, 16, requires_grad=True)
               for h in (4, 2, 2))
    _, plain, _ = _saved(lambda: attn_lib.attend(
        q, k, v, causal=True, use_flash=False), {})
    assert _holds_square(plain)
    kept, flash, _ = _saved(lambda: attn_lib.attend(
        q, k, v, causal=True, q_chunk=Q_CHUNK), {})
    assert not _holds_square(flash)
    # q, k, v, the output (B, S, KV, G, D) and lse (B, n, KV, G, C), fp32
    assert sum(kept.values()) == 4 * (3 * B * SAVED_S * 4 * 16
                                      + B * SAVED_S * 4)


@pytest.mark.parametrize("name", ["qwen2-7b", "granite-moe-1b-a400m",
                                  "zamba2-2.7b"])
def test_the_plan_saves_no_square_block_and_remat_keeps_less(name,
                                                             monkeypatch):
    _, on = _configs(name, remat=True)
    off = dataclasses.replace(on, remat=False)
    params = {k: v.requires_grad_(True) for k, v in Model(on).init(
        torch.Generator().manual_seed(0), "cpu").items()}
    batch = _tt(_batch(on, seq=SAVED_S))
    kept_off, shapes_off, loss_off = _saved(
        lambda: Model(off).loss(params, batch, q_chunk=Q_CHUNK), params)
    assert shapes_off and not _holds_square(shapes_off)
    kept_on, _, loss_on = _saved(
        lambda: Model(on).loss(params, batch, q_chunk=Q_CHUNK), params,
        monkeypatch)
    assert torch.equal(loss_on, loss_off)
    assert 0 < sum(kept_on.values()) < sum(kept_off.values())


# ------------------------------------------------------- the dist train step

def test_train_step_with_q_chunk_matches_the_reference():
    """grad_accum 2 of a batch of 4 at S 32 in chunks of 8, remat on in
    groups of 2: the reference's step and the port's, each inside its
    mesh with the specs of its own rules."""
    jcfg, cfg = _configs("qwen2-7b")
    jparams = _reference_init("qwen2-7b")
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cfg.vocab_size, (4, S)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    jmesh = _jmesh()
    sizes = dict(zip(jmesh.axis_names, jmesh.devices.shape))
    with jmesh_context(jmesh):
        jstep = jsteps.make_train_step(
            jcfg, JInner(**INNER), grad_accum=2, q_chunk=Q_CHUNK,
            param_pspecs=jshd.param_specs(jparams, axis_sizes=sizes))
        jstate, jloss = jax.jit(jstep)(
            jsteps.init_train_state(jparams),
            {k: jnp.asarray(v) for k, v in batch.items()})
    params = bridge.to_torch({k: np.asarray(v) for k, v in
                              _jflat(jparams).items()}, "cpu")
    inner = InnerOptConfig(**INNER)
    with tmesh.local_mesh("cpu") as lm, tmesh.mesh_context(lm):
        step = steps.make_train_step(
            cfg, inner, grad_accum=2, q_chunk=Q_CHUNK,
            param_pspecs=shd.param_specs(params, axis_sizes=lm.axis_sizes))
        state, loss = step(steps.init_train_state(params),
                           {k: torch.from_numpy(v) for k, v in
                            batch.items()})
    np.testing.assert_allclose(shd.gather(loss).item(), float(jloss),
                               rtol=1e-5)
    jmu = {k: np.asarray(v) for k, v in _jflat(jstate.opt.mu).items()}
    for k, v in jmu.items():
        np.testing.assert_allclose(shd.gather(state.opt.mu[k]).numpy(), v,
                                   rtol=0,
                                   atol=1e-4 * np.abs(v).max() + 1e-12,
                                   err_msg=k)
    check_step(_np_tree(state.params), {k: np.asarray(v) for k, v in
                                        _jflat(jstate.params).items()},
               jmu, inner.lr, inner.weight_decay, "qwen2-7b")


# ------------------------------------------------------------- the dry-run

def test_the_dry_run_applies_q_chunk_and_remat_group():
    cfg = configs.reduced(configs.get_config("qwen2-7b"))
    rec = dryrun.lower_cell("qwen2-7b", "train_4k",
                            tmesh.make_production_mesh(), multi_pod=False,
                            cfg=cfg, overrides={"remat_group": 2,
                                                "head_tp": True,
                                                "seq_parallel": True})
    assert rec["plan"] == {"grad_accum": 4, "q_chunk": 512,
                           "remat_group": 2, "head_tp": True,
                           "seq_parallel": True}
    # the steps apply head_tp and seq_parallel (the activation placements):
    # no knob of the plan is left unapplied, and the cell's config carries
    # them as the reference's does
    assert "plan_not_applied" not in rec
    assert not hasattr(dryrun, "PLAN_NOT_APPLIED")
    planned = dryrun._planned(cfg, rec["plan"])
    assert planned.act_batch_axes == ("data",)
    assert planned.act_model_axis == "model" and planned.seq_parallel
    assert planned.remat_group == 2


def test_remat_counts_the_layers_forward_again_at_full_width():
    """qwen2-7b train_4k on meta tensors: with remat, the step's count is
    the count without it plus the layers' forward once more (the forward
    less the LM head's product), but for each checkpoint's last product
    (a layer's w_down): no backward needs its output, and the checkpoint
    stops recomputing once every saved tensor is back. A ratio inside
    1.15-1.34, since the layers dominate the LM head at full width."""
    shape = configs.SHAPES["train_4k"]
    plan = dryrun.plan_for("qwen2-7b", shape)
    base = dryrun._planned(configs.get_config("qwen2-7b"), plan)
    assert base.remat
    on, why_on = dryrun.step_flops(base, shape, plan)
    off, why_off = dryrun.step_flops(dataclasses.replace(base, remat=False),
                                     shape, plan)
    assert why_on is None and why_off is None
    ga = plan["grad_accum"]
    tokens = shape.global_batch // ga * shape.seq_len
    model = Model(base)
    micro = {k: torch.empty((shape.global_batch // ga, shape.seq_len),
                            dtype=torch.long, device="meta")
             for k in ("tokens", "labels")}
    forward, _ = dryrun.count_flops(lambda: model.loss(
        dryrun._abstract(model.param_specs(), "meta"), micro,
        q_chunk=plan["q_chunk"]))
    lm_head = 2 * tokens * base.d_model * base.vocab_size
    w_down = 2 * tokens * base.d_ff * base.d_model * base.n_layers
    assert base.remat_group == 1
    assert on - off == ga * (forward - lm_head - w_down)
    assert 1.15 < on / off < 1.34, on / off
