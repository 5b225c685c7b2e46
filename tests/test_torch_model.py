"""The port's worker side against the reference on bridged parameters: the
dense transformer's loss and the gradient of every leaf, one AdamW step,
and one inner round's pseudo-gradient, on the same numpy batches.

Tolerances:
  * fp32 compute (reduced tinygpt's own setting): the same math in another
    summation order, so loss rtol 1e-5 and gradients within 1e-5 of each
    leaf's largest |value| (measured: 1.5e-6);
  * bf16 compute (tinygpt's default): the two packages round to bf16 at
    different points (scores, softmax probabilities, the backward), so
    loss rtol 2e-3 and gradients within 5e-2 relative L2 error per leaf
    (measured: 1.1e-4 and 2.3e-2);
  * AdamW from identical gradients: elementwise fp32, rtol 1e-6 plus 1e-8
    absolute (below 1% of one step at lr 3e-3);
  * one inner round (2 AdamW steps): Adam divides by sqrt(v), so a grad
    difference of 1e-6 can move a coordinate with a near-zero gradient by a
    visible fraction of a step; the bound is 2% of the largest |Delta|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import InnerOptConfig as JaxInnerOptConfig
from repro.data.synthetic import ShardSampler as JaxShardSampler
from repro.data.synthetic import make_language_specs as jax_specs
from repro.models import Model as JaxModel
from repro.optim.adamw import adamw_update as jax_adamw
from repro.optim.adamw import init_adam as jax_init_adam
from repro.train.inner import pseudo_gradient as jax_pseudo_gradient
from repro.train.inner import run_inner as jax_run_inner
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import InnerOptConfig
from repro_torch.data.synthetic import ShardSampler, make_language_specs
from repro_torch.models import Model
from repro_torch.optim.adamw import adamw_update, init_adam
from repro_torch.train.inner import batch_to_device, pseudo_gradient, run_inner

INNER = dict(lr=3e-3, warmup_steps=2, total_steps=24)


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in leaves}


def _setup(compute_dtype):
    name = "tinygpt-15m-smoke"
    jcfg = dataclasses.replace(jax_get_config(name), compute_dtype=compute_dtype)
    cfg = dataclasses.replace(get_config(name), compute_dtype=compute_dtype)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    specs = make_language_specs(cfg.vocab_size, n_langs=4, seed=0)
    batch = ShardSampler(specs, 1, 4, 32, seed=3).sample(0)
    return jmodel, jparams, Model(cfg), bridge.to_torch(_flat(jparams), "cpu"), batch


def _loss_and_grads(compute_dtype):
    jmodel, jparams, model, params, batch = _setup(compute_dtype)
    (jl, _), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    loss = model.loss(leaves, batch_to_device(batch, "cpu"))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return float(jl), _flat(jg), loss.item(), {k: g.numpy() for k, g in
                                               grads.items()}


def test_loss_and_grads_match_reference_fp32():
    jl, jg, loss, grads = _loss_and_grads("float32")
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert set(grads) == set(jg) and len(grads) == 43
    for k, want in jg.items():
        np.testing.assert_allclose(grads[k], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max() + 1e-12,
                                   err_msg=k)


def test_loss_and_grads_match_reference_bf16():
    jl, jg, loss, grads = _loss_and_grads("bfloat16")
    np.testing.assert_allclose(loss, jl, rtol=2e-3)
    for k, want in jg.items():
        want = want.astype(np.float32)
        err = np.linalg.norm(grads[k] - want) / max(np.linalg.norm(want), 1e-12)
        assert err < 5e-2, (k, err)


def test_adamw_steps_match_reference():
    _jm, jparams, _m, params, _b = _setup("float32")
    rng = np.random.default_rng(0)
    jstate, state = jax_init_adam(jparams), init_adam(params)
    jcfg, cfg = JaxInnerOptConfig(**INNER), InnerOptConfig(**INNER)
    for _ in range(3):        # count 1..3: warm-up, then cosine
        g = {k: (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in _flat(jparams).items()}
        jg = jax.tree.unflatten(jax.tree.structure(jparams),
                                [g[k] for k in _flat(jparams)])
        jparams, jstate = jax.jit(jax_adamw, static_argnums=3)(
            jparams, jg, jstate, jcfg)
        params, state = adamw_update(params, bridge.to_torch(g, "cpu"), state,
                                     cfg)
        for k, want in _flat(jparams).items():
            np.testing.assert_allclose(params[k].numpy(), want, rtol=1e-6,
                                       atol=1e-8, err_msg=k)
    assert state.count == int(jstate.count) == 3


def test_inner_round_pseudo_gradient_matches_reference():
    jmodel, jparams, model, params, _b = _setup("float32")
    jspecs = jax_specs(128, n_langs=4, seed=0)
    specs = make_language_specs(128, n_langs=4, seed=0)
    jres = jax_run_inner(jmodel, JaxInnerOptConfig(**INNER), jparams,
                         jax_init_adam(jparams),
                         JaxShardSampler(jspecs, 2, 2, 16, seed=977), 2)
    res = run_inner(model, InnerOptConfig(**INNER), params, init_adam(params),
                    ShardSampler(specs, 2, 2, 16, seed=977), 2)
    np.testing.assert_allclose(res.losses.numpy(), np.asarray(jres.losses),
                               rtol=1e-5)
    jd = _flat(jax_pseudo_gradient(jparams, jres.params))
    d = pseudo_gradient(params, res.params)
    scale = max(np.abs(v).max() for v in jd.values())
    for k, want in jd.items():
        np.testing.assert_allclose(d[k].numpy(), want, rtol=0,
                                   atol=2e-2 * scale, err_msg=k)


def test_port_init_draws_reference_distributions():
    model = Model(get_config("tinygpt-15m-smoke"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    assert list(params) == list(model.param_specs())
    tok = params["embed/tok"]
    assert abs(tok.std().item() - 0.02) < 2e-3
    w = params["blocks_list/layer_00/mlp/w_down"]
    assert abs(w.std().item() - 128 ** -0.5) < 0.1 * 128 ** -0.5
    assert torch.equal(params["final_norm/scale"], torch.ones(64))
    assert torch.equal(params["final_norm/bias"], torch.zeros(64))
