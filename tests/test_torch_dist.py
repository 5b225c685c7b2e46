"""The port's distribution layer (``repro_torch.dist``, ``launch.mesh``,
``launch.inputs``) against the reference's ``repro.dist`` on the CPU.

  * the sharding rules: the spec of every leaf of every config in ARCHS at
    full width (meta tensors against ``jax.eval_shape``, nothing
    allocated) equal to the reference's PartitionSpec, on the production
    axis sizes with and without the pod axis, for both attention styles;
    cache and batch specs on tests/test_dist.py's cases and every arch's
    caches; ``stacked_axes_tree``; the abstract inputs of every cell;
  * the steps at smoke width, from the reference's init carried over by
    ``bridge.to_torch``, against the reference's own steps on a one-device
    mesh ``(pod=1, data=1, model=1)`` in this process, the port's on its
    local mesh (a process group of one, destroyed after each test):
      - loss within rtol 1e-5;
      - AdamW's first moment (0.1 x the gradient) within 1e-4 of each
        leaf's largest |value|, the families' gradient band;
      - parameters within 5e-4 of each leaf's largest |value|, the
        families' band for a run's parameters, except where the gradient
        lies inside its band of zero: there the first AdamW step is
        +-lr times a sign that the band does not fix, and such an element
        may differ by up to 2 lr (1 + wd |p|);
      - the multi-pod step's pods independent, pod 0 bit-equal to the
        single step;
      - prefill and decode within tests/test_torch_serve.py's 1e-4;
  * the outer exchange, arriving pod 1 of 2 stacked worker trees as in
    tests/test_dist.py: parameters, momentum and look-ahead within 2e-5
    (that test's band), the same HeLoCo branch in every block, the int8
    round trip bit-equal to the reference's ``_int8_roundtrip_leaf``, the
    refusal of methods with their own schedule.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.configs.base import HeLoCoConfig as JHeLoCo
from repro.configs.base import InnerOptConfig as JInner
from repro.dist import sharding as jshd
from repro.dist import steps as jsteps
from repro.launch import inputs as jinputs
from repro.launch import mesh as jmesh_lib
from repro.launch.mesh import mesh_context as jmesh_context
from repro.models import Model as JaxModel
from repro_torch import bridge, configs
from repro_torch.configs.base import HeLoCoConfig, InnerOptConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist import steps
from repro_torch.launch import inputs, mesh as tmesh
from repro_torch.models import Model
from test_torch_cuda import block_branches
from test_torch_methods import one_intra_op_thread  # noqa: F401

SIZES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})
INNER = dict(lr=1e-3, warmup_steps=1, total_steps=10)
B, S = 4, 16


def _jpath(path) -> str:
    return jshd._leaf_path(path)


def _jflat(tree, is_leaf=None):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {_jpath(p): v for p, v in leaves}


def _jspecs(tree):
    return {k: tuple(v) for k, v in _jflat(
        tree, is_leaf=lambda x: isinstance(x, P)).items()}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


@functools.cache
def _abstract(arch):
    return jax.eval_shape(JaxModel(jconfigs.get_config(arch)).init,
                          jax.random.PRNGKey(0))


# ---------------------------------------------------------------- the rules

@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_param_specs_equal_the_reference_at_full_width(arch):
    jparams = _abstract(arch)
    params = Model(configs.get_config(arch)).param_specs()
    jleaves = _jflat(jparams)
    assert set(jleaves) == set(params)
    for k, x in params.items():
        assert tuple(x.shape) == tuple(jleaves[k].shape), k
    seen = set()
    for sizes in SIZES:
        for style in ("tp", "dp"):
            want = _jspecs(jshd.param_specs(jparams, axis_sizes=sizes,
                                            attn_style=style))
            got = shd.param_specs(params, axis_sizes=sizes, attn_style=style)
            assert {k: tuple(v) for k, v in got.items()} == want, \
                (arch, sizes, style)
            seen |= {e for s in want.values() for e in s}
    assert "data" in seen
    assert shd.stacked_axes_tree(params) == _jflat(
        jshd.stacked_axes_tree(jparams))


def test_rule_unit_cases_and_tuple_data_axes():
    """tests/test_dist.py's rule cases, and the rules over a tuple data
    axis, against the reference."""
    sizes = {"pod": 2, "data": 16, "model": 16}
    cases = [("blocks/attn/wq", (28, 4096, 32, 128)),
             ("blocks/attn/wq", (28, 3584, 28, 128)),
             ("embed/tok", (49155, 4096)), ("blocks/norm1/scale", (28, 4096)),
             ("blocks/moe/w_gate", (24, 32, 1024, 512)),
             ("super/mamba/in_proj", (9, 6, 2560, 10576)),
             ("blocks_list/layer_03/mlstm/w_up", (768, 3072))]
    for name, shape in cases:
        for data_axis in ("data", ("pod", "data")):
            for style in ("tp", "dp"):
                kw = dict(data_axis=data_axis, model_axis="model",
                          axis_sizes=sizes, attn_style=style)
                assert tuple(shd.spec_for(name, shape, **kw)) == tuple(
                    jshd.spec_for(name, shape, **kw)), (name, kw)
    assert shd.spec_for("blocks/attn/wq", (28, 3584, 28, 128),
                        axis_sizes={"data": 16, "model": 16}) == \
        (None, "data", None, "model")


def test_cache_and_batch_specs_equal_the_reference():
    sizes = {"data": 16, "model": 16}
    jc = {"k": jax.ShapeDtypeStruct((28, 128, 32768, 4, 128), jnp.bfloat16),
          "v": jax.ShapeDtypeStruct((28, 128, 32768, 4, 128), jnp.bfloat16)}
    tc = {k: torch.empty(v.shape, dtype=torch.bfloat16, device="meta")
          for k, v in jc.items()}
    for bs in (True, False):
        got = shd.cache_specs(tc, batch_sharded=bs, axis_sizes=sizes)
        assert {k: tuple(v) for k, v in got.items()} == _jspecs(
            jshd.cache_specs(jc, batch_sharded=bs, axis_sizes=sizes))
    assert shd.cache_specs(tc, batch_sharded=True, axis_sizes=sizes)["k"] \
        == (None, "data", None, None, "model")
    assert shd.cache_specs(tc, batch_sharded=False, axis_sizes=sizes)["k"] \
        == (None, None, "data", None, "model")
    for arch, cfg in configs.ARCHS.items():
        jb = jinputs.batch_specs_struct(jconfigs.get_config(arch), 8, 256)
        tb = inputs.batch_specs_struct(cfg, 8, 256)
        for axes in (("data",), ("pod", "data")):
            assert {k: tuple(v) for k, v in shd.batch_specs(
                tb, batch_axes=axes).items()} == _jspecs(
                jshd.batch_specs(jb, batch_axes=axes)), (arch, axes)


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_every_arch_caches_and_inputs_equal_the_reference(arch):
    """``input_specs`` of every cell (shapes and dtypes, caches too) equal
    the reference's ``jax.eval_shape`` structs; ``cache_specs`` of every
    arch's decode caches equal the reference's, or raise as the
    reference's does (the recurrent families' states and unstacked
    per-layer caches are not the (L, B, S, KV, D) layout it unpacks)."""
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        if not configs.shape_applicable(cfg, shape)[0]:
            continue
        jin = _jflat(jinputs.input_specs(jcfg, jconfigs.SHAPES[name]))
        tin = shd.tree_leaves(inputs.input_specs(cfg, shape))
        assert set(tin) == set(jin), (arch, name)
        for k, x in tin.items():
            assert x.device.type == "meta"
            assert tuple(x.shape) == tuple(jin[k].shape), (arch, name, k)
            assert str(x.dtype).split(".")[-1] == str(jin[k].dtype), k
        if shape.kind != "decode":
            continue
        for sizes, data_axis in ((SIZES[0], "data"),
                                 (SIZES[1], ("pod", "data"))):
            for bs in (True, False):
                kw = dict(batch_sharded=bs, axis_sizes=sizes,
                          data_axis=data_axis)
                caches = inputs.input_specs(cfg, shape)["caches"]
                jcaches = jinputs.input_specs(
                    jcfg, jconfigs.SHAPES[name])["caches"]
                try:
                    want = _jspecs(jshd.cache_specs(jcaches, **kw))
                except ValueError:
                    with pytest.raises(ValueError):
                        shd.cache_specs(caches, **kw)
                    assert cfg.family in ("hybrid", "ssm") or \
                        not cfg.scan_layers, arch
                    continue
                got = shd.cache_specs(caches, **kw)
                assert {k: tuple(v) for k, v in shd.tree_leaves(
                    got).items()} == want, (arch, name, kw)


def test_meshes_and_placements():
    prod = tmesh.make_production_mesh(multi_pod=True)
    assert prod.axis_sizes == {"pod": 2, "data": 16, "model": 16}
    assert prod.size == 512 and prod.device_mesh is None
    assert tmesh.make_production_mesh().axis_sizes == \
        {"data": 16, "model": 16}
    assert tmesh.make_test_mesh().shape == (2, 4)
    assert tmesh.make_test_mesh(multi_pod=True).shape == (2, 2, 2)
    spec = shd.Spec((("pod", "data"), None, "model"))
    assert shd.shard_shape((64, 3, 32), spec, prod.axis_sizes) == (2, 3, 2)
    with pytest.raises(ValueError, match="not divisible"):
        shd.shard_shape((48, 3, 32), spec, prod.axis_sizes)
    from torch.distributed.tensor import Replicate, Shard
    assert shd.placements(spec, prod) == (Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.Spec((None, None)), prod) == \
        (Replicate(),) * 3
    assert not torch.distributed.is_initialized()
    with tmesh.local_mesh("cpu") as lm:
        assert lm.axis_sizes == {"pod": 1, "data": 1, "model": 1}
        assert tmesh.current_mesh() is None
        with tmesh.mesh_context(lm):
            assert tmesh.current_mesh() is lm
            x = torch.arange(12.0).reshape(3, 4)
            assert shd.place(x, shd.Spec(("data", "model")), lm) \
                .data_ptr() == x.data_ptr()
        assert tmesh.current_mesh() is None
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------- the steps

@functools.cache
def _reference(arch):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    return jcfg, jax.jit(JaxModel(jcfg).init)(jax.random.PRNGKey(0))


def _jmesh():
    """One device, the reference's axis names and its mesh helper's auto
    axis types (``with_sharding_constraint`` asserts on explicit ones)."""
    return jmesh_lib._mesh((1, 1, 1), ("pod", "data", "model"))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _tt(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jt(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def check_step(got, want, grads_want, lr, wd, what=""):
    """The module docstring's rule for one AdamW step: ``got`` and ``want``
    parameter dicts (numpy), ``grads_want`` the reference's first moments
    (0.1 g): outside 5e-4 of a leaf's largest |value| only where the
    gradient is inside its 1e-4 band of zero, and there by at most
    2 lr (1 + wd |p|). Returns how many elements took that exception."""
    excepted = 0
    for k, w in want.items():
        g, gm = got[k], grads_want[k]
        diff = np.abs(g - w)
        out = diff > 5e-4 * np.abs(w).max()
        near_zero = np.abs(gm) <= 1e-4 * np.abs(gm).max()
        assert (near_zero[out]).all(), (what, k, diff[out][:4])
        assert (diff[out] <= 2 * lr * (1 + wd * np.abs(w[out])) + 1e-7)\
            .all(), (what, k)
        excepted += int(out.sum())
    return excepted


def _np_tree(tree):
    return {k: _np(v) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-1b-a400m"])
def test_train_step_matches_the_reference(arch):
    """grad_accum 2 of a batch of 4, the reference's step and the port's,
    each inside its mesh with the specs of its own rules."""
    jcfg, jparams = _reference(arch)
    cfg = configs.reduced(configs.get_config(arch))
    tok = _tokens(cfg, (B, S), 1)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    jmesh = _jmesh()
    sizes = dict(zip(jmesh.axis_names, jmesh.devices.shape))
    with jmesh_context(jmesh):
        jstep = jsteps.make_train_step(
            jcfg, JInner(**INNER), grad_accum=2, q_chunk=S,
            param_pspecs=jshd.param_specs(jparams, axis_sizes=sizes))
        jstate, jloss = jax.jit(jstep)(jsteps.init_train_state(jparams),
                                       _jt(batch))
    params = bridge.to_torch(_jflat(jparams), "cpu")
    inner = InnerOptConfig(**INNER)
    with tmesh.local_mesh("cpu") as lm, tmesh.mesh_context(lm):
        step = steps.make_train_step(
            cfg, inner, grad_accum=2,
            param_pspecs=shd.param_specs(params, axis_sizes=lm.axis_sizes))
        state, loss = step(steps.init_train_state(params), _tt(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert state.step == 1 and state.opt.count == 1
    jmu = {k: np.asarray(v) for k, v in _jflat(jstate.opt.mu).items()}
    for k, v in jmu.items():
        np.testing.assert_allclose(state.opt.mu[k].numpy(), v, rtol=0,
                                   atol=1e-4 * np.abs(v).max() + 1e-12,
                                   err_msg=k)
    check_step(_np_tree(state.params), {k: np.asarray(v) for k, v in
                                        _jflat(jstate.params).items()},
               jmu, inner.lr, inner.weight_decay, arch)


def test_grad_accum_is_the_mean_of_the_microbatches():
    """grad_accum 2 against 1 on the same batch, both in the port: the
    loss within rtol 1e-5 and the step under the same rule."""
    _, jparams = _reference("qwen2-7b")
    cfg = configs.reduced(configs.get_config("qwen2-7b"))
    params = bridge.to_torch(_jflat(jparams), "cpu")
    tok = _tokens(cfg, (B, S), 2)
    batch = _tt({"tokens": tok, "labels": tok})
    inner = InnerOptConfig(**INNER)
    out = {ga: steps.make_train_step(cfg, inner, grad_accum=ga)(
        steps.init_train_state(params), batch) for ga in (1, 2)}
    np.testing.assert_allclose(out[2][1].item(), out[1][1].item(), rtol=1e-5)
    check_step(_np_tree(out[2][0].params), _np_tree(out[1][0].params),
               _np_tree(out[1][0].opt.mu), inner.lr, inner.weight_decay)
    with pytest.raises(ValueError, match="microbatches"):
        steps.make_train_step(cfg, inner, grad_accum=3)(
            steps.init_train_state(params), batch)


def test_multipod_step_keeps_pods_apart_and_matches_the_reference():
    jcfg, jparams = _reference("qwen2-7b")
    cfg = configs.reduced(configs.get_config("qwen2-7b"))
    tok = _tokens(cfg, (2, B, S), 3)
    same = {"tokens": np.repeat(tok[:1], 2, 0),
            "labels": np.repeat(tok[:1], 2, 0)}
    diff = {"tokens": tok, "labels": tok}
    jmesh = _jmesh()
    sizes = dict(zip(jmesh.axis_names, jmesh.devices.shape))
    jstack = lambda t: jax.tree.map(lambda x: jnp.stack([x, x]), t)
    with jmesh_context(jmesh):
        jstep = jax.jit(jsteps.make_multipod_train_step(
            jcfg, JInner(**INNER), jmesh, q_chunk=S,
            param_pspecs=jshd.param_specs(jparams, axis_sizes=sizes)))
        jdiff, jlosses = jstep(jstack(jsteps.init_train_state(jparams)),
                               _jt(diff))
    params = bridge.to_torch(_jflat(jparams), "cpu")
    inner = InnerOptConfig(**INNER)
    with tmesh.local_mesh("cpu") as lm, tmesh.mesh_context(lm):
        pspecs = shd.param_specs(params, axis_sizes=lm.axis_sizes)
        step = steps.make_multipod_train_step(cfg, inner, lm,
                                              param_pspecs=pspecs)
        st0 = steps.init_train_state(params)
        ns, _ = step(steps.stack_pods([st0, st0]), _tt(same))
        for k, v in ns.params.items():
            assert torch.equal(v[0], v[1]), k
        nd, losses = step(steps.stack_pods([st0, st0]), _tt(diff))
        single, loss0 = steps.make_train_step(
            cfg, inner, param_pspecs=pspecs)(
            st0, {k: torch.from_numpy(v[0]) for k, v in diff.items()})
    last = list(nd.params)[-1]
    assert not torch.allclose(nd.params[last][0], nd.params[last][1])
    assert losses.shape == (2,) and torch.equal(losses[0], loss0)
    for k, v in single.params.items():
        assert torch.equal(nd.params[k][0], v), k
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    jmu = {k: np.asarray(v) for k, v in _jflat(jdiff.opt.mu).items()}
    check_step(_np_tree(nd.params), {k: np.asarray(v) for k, v in
                                     _jflat(jdiff.params).items()},
               jmu, inner.lr, inner.weight_decay, "multipod")


def test_prefill_and_decode_steps_match_the_reference_and_the_model():
    jcfg, jparams = _reference("qwen2-7b")
    cfg = configs.reduced(configs.get_config("qwen2-7b"))
    params = bridge.to_torch(_jflat(jparams), "cpu")
    tok = _tokens(cfg, (2, S), 4)
    n = S + 2
    jpre = jax.jit(jsteps.make_prefill_step(jcfg, cache_len=n, q_chunk=S))
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    jlogits, jcaches = jpre(jparams, {"tokens": jnp.asarray(tok)})
    pre = steps.make_prefill_step(cfg, cache_len=n)
    dec = steps.make_decode_step(cfg)
    logits, caches = pre(params, {"tokens": torch.from_numpy(tok)})
    mlogits, mcaches = Model(cfg).prefill(params, torch.from_numpy(tok)
                                          .long(), n)
    assert torch.equal(logits, mlogits)
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=0, atol=1e-4)
    token = logits.argmax(-1).to(torch.int32)
    jlogits, _ = jdec(jparams, jnp.asarray(token.numpy()), jcaches,
                      jnp.asarray(S, jnp.int32))
    logits, _ = dec(params, token, caches, torch.tensor(S, dtype=torch.int32))
    mlogits, _ = Model(cfg).decode(params, token.long(), mcaches, S)
    assert torch.equal(logits, mlogits)
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=0, atol=1e-4)


# ---------------------------------------------------- the outer exchange

@functools.cache
def _exchange_inputs():
    """The reference's test inputs (worker trees theta - 0.05, theta + 0.02)
    with a momentum per leaf of a cosine to Delta near 1, -1 or 0.1, so
    that blocks take the keep, anti and weak branches of Alg. 2."""
    jcfg, jparams = _reference("qwen2-7b")
    rng = np.random.default_rng(5)
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    mom, wp = [], []
    for i, x in enumerate(leaves):
        a, b = ((1.0, 0.1), (-1.0, 0.1), (0.1, 1.0))[i % 3]
        noise = rng.normal(size=x.shape).astype(np.float32)
        mom.append(jnp.asarray(0.01 * (-a + b * noise), jnp.float32))
        x = np.asarray(x)
        wp.append(jnp.asarray(np.stack([x - np.float32(0.05),
                                        x + np.float32(0.02)])))
    return (jcfg, jparams, jax.tree_util.tree_unflatten(treedef, mom),
            jax.tree_util.tree_unflatten(treedef, wp))


def _jbranches(delta, mom, h, stacked):
    """The reference's branch of every block, by its own cosine
    (``correct_block``: normalized vectors, then their dot), in one jitted
    program."""
    flat_stacked = _jflat(stacked)

    def codes(delta, mom):
        out = {}
        for k, d in _jflat(delta).items():
            blocks = int(np.prod(d.shape[:flat_stacked[k]]))
            u = d.astype(jnp.float32).reshape(blocks, -1)
            v = _jflat(mom)[k].astype(jnp.float32).reshape(blocks, -1)
            nu, nv = jnp.linalg.norm(u, axis=1), jnp.linalg.norm(v, axis=1)
            c = jnp.sum(u / jnp.maximum(nu, h.eps)[:, None]
                        * (v / jnp.maximum(nv, h.eps)[:, None]), axis=1)
            code = jnp.where(c >= h.c_ok, 0, jnp.where(c < 0.0, 1, 2))
            out[k] = jnp.where((nu < h.eps) | (nv < h.eps), 3, code)
        return out

    return {k: np.asarray(v) for k, v in jax.jit(codes)(delta, mom).items()}


@pytest.mark.parametrize("int8", [False, True])
def test_outer_exchange_matches_the_reference(int8):
    jcfg, jparams, jmom, jwp = _exchange_inputs()
    cfg = configs.reduced(configs.get_config("qwen2-7b"))
    jmesh = _jmesh()
    jstacked = jshd.stacked_axes_tree(jparams)
    with jmesh_context(jmesh):
        jfn = jsteps.make_outer_exchange(
            jcfg, jmesh, h=JHeLoCo(), outer_lr=0.7, mu=0.9, method="heloco",
            arriving_pod=1, stacked_axes=jstacked, compress_int8=int8)
        jp, jm, jbar = jax.jit(jfn)(jparams, jmom, jwp)
    params = bridge.to_torch(_jflat(jparams), "cpu")
    mom = bridge.to_torch(_jflat(jmom), "cpu")
    wp = bridge.to_torch(_jflat(jwp), "cpu")
    stacked = shd.stacked_axes_tree(params)
    with tmesh.local_mesh("cpu") as lm, tmesh.mesh_context(lm):
        fn = steps.make_outer_exchange(
            cfg, lm, h=HeLoCoConfig(), outer_lr=0.7, mu=0.9, method="heloco",
            arriving_pod=1, stacked_axes=stacked, compress_int8=int8)
        p, m, bar = fn(params, mom, wp)
    for got, want in ((p, jp), (m, jm), (bar, jbar)):
        want = _jflat(want)
        assert set(got) == set(want)
        for k, v in got.items():
            assert tuple(v.shape) == tuple(want[k].shape), k
            np.testing.assert_allclose(_np(v), _np(want[k]), rtol=2e-5,
                                       atol=2e-5, err_msg=k)
    jdelta = jax.jit(lambda p, w: jax.tree.map(
        lambda a, b: a.astype(jnp.float32) - b[1].astype(jnp.float32), p,
        w))(jparams, jwp)
    delta = {k: params[k].float() - wp[k][1].float() for k in params}
    for k, d in delta.items():
        np.testing.assert_array_equal(d.numpy(), _np(_jflat(jdelta)[k]))
    if int8:
        # op by op: under jit XLA turns the division by 127 into a product
        # with its rounded reciprocal, one ulp off the scale for some
        # absmax values (the jitted exchanges above agree within 2e-5)
        jdelta = jax.tree.map(jsteps._int8_roundtrip_leaf, jdelta)
        delta = {k: steps.int8_roundtrip_leaf(d) for k, d in delta.items()}
        for k, d in delta.items():
            np.testing.assert_array_equal(d.numpy(), _np(_jflat(jdelta)[k]),
                                          err_msg=k)
    got = block_branches(delta, mom, HeLoCoConfig(), stacked)
    want = _jbranches(jdelta, jmom, JHeLoCo(), jstacked)
    codes = set()
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        codes |= set(v.tolist())
    assert {0, 1, 2} <= codes, codes


def test_int8_roundtrip_is_the_references_bit_for_bit():
    rng = np.random.default_rng(6)
    cases = [rng.normal(size=(33, 17)).astype(np.float32),
             np.zeros((5,), np.float32),
             (np.arange(-254, 255, dtype=np.float32) / 2),   # .5 ties
             np.float32([3e-13, -1e-13, 0.0])]
    for x in cases:
        want = np.asarray(jsteps._int8_roundtrip_leaf(jnp.asarray(x)))
        got = steps.int8_roundtrip_leaf(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["delayed_nesterov", "fedbuff"])
def test_exchange_refuses_custom_schedules_as_the_reference(method):
    jcfg = jconfigs.reduced(jconfigs.get_config("qwen2-7b"))
    with pytest.raises(NotImplementedError) as jerr:
        jsteps.make_outer_exchange(jcfg, _jmesh(), h=JHeLoCo(), outer_lr=0.7,
                                   mu=0.9, method=method)
    with pytest.raises(NotImplementedError) as err:
        steps.make_outer_exchange(
            configs.reduced(configs.get_config("qwen2-7b")),
            tmesh.make_test_mesh(multi_pod=True), h=HeLoCoConfig(),
            outer_lr=0.7, mu=0.9, method=method)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("method", ["nesterov", "mla"])
def test_exchange_of_the_standard_schedule_methods(method):
    """Nesterov (the pseudo-gradient as it is) and MLA (tau = 0: no shift)
    through the exchange, against the reference's."""
    jcfg, jparams, jmom, jwp = _exchange_inputs()
    jmesh = _jmesh()
    with jmesh_context(jmesh):
        jp, jm, _ = jax.jit(jsteps.make_outer_exchange(
            jcfg, jmesh, h=JHeLoCo(), outer_lr=0.7, mu=0.9, method=method,
            arriving_pod=0))(jparams, jmom, jwp)
    fn = steps.make_outer_exchange(
        configs.reduced(configs.get_config("qwen2-7b")),
        tmesh.make_test_mesh(multi_pod=True), h=HeLoCoConfig(),
        outer_lr=0.7, mu=0.9, method=method, arriving_pod=0)
    p, m, bar = fn(*(bridge.to_torch(_jflat(t), "cpu")
                     for t in (jparams, jmom, jwp)))
    assert next(iter(bar.values())).shape[0] == 2
    for got, want in ((p, jp), (m, jm)):
        want = _jflat(want)
        for k, v in got.items():
            np.testing.assert_allclose(_np(v), _np(want[k]), rtol=2e-5,
                                       atol=2e-5, err_msg=k)


def test_steps_need_an_ambient_mesh_for_their_specs():
    cfg = configs.reduced(configs.get_config("qwen2-7b"))
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    step = steps.make_train_step(
        cfg, InnerOptConfig(**INNER),
        param_pspecs=shd.param_specs(params, axis_sizes={"data": 1,
                                                         "model": 1}))
    tok = torch.zeros((2, S), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="mesh_context"):
        step(steps.init_train_state(params), {"tokens": tok, "labels": tok})
