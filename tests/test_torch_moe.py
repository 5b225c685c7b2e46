"""The port's ``apply_moe`` against the reference's on the same numpy inputs
and parameters: scatter and einsum dispatch, the shared expert, a capacity
overflow, exact router ties, several token groups, and bf16 compute.

Tolerances:
  * fp32: outputs within 1e-5 of their largest |value| and the aux loss
    within rtol 1e-6: the routing is the same (the router's fp32 logits of
    the same bits; probabilities apart by more than their rounding), the
    dispatch and combine are sums of one term and zeros, and the experts'
    matmuls sum in another order;
  * bf16: outputs within 2e-2 of their largest |value| (the two packages
    round the experts' products and silu(g) * u at other points, a few
    bf16 steps), the aux loss within rtol 1e-6 (fp32 on both sides);
  * the top-k experts and their order: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe

B, S = 4, 16


def _cfgs(arch="granite-moe-1b-a400m", **moe_kw):
    """The reference's and the port's smoke config of ``arch`` with the
    MoE fields ``moe_kw`` replaced."""
    def one(cfg):
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                **moe_kw))
    return (one(jax_get_config(arch + "-smoke")),
            one(get_config(arch + "-smoke")))


def _params(cfg, seed=0, router=None):
    rng = np.random.default_rng(seed)
    d, e, ff = cfg.d_model, cfg.moe.n_experts, cfg.moe.expert_d_ff
    p = {"router": (0.02 * rng.normal(size=(d, e))).astype(np.float32)
         if router is None else router.astype(np.float32),
         "w_gate": (d ** -0.5 * rng.normal(size=(e, d, ff))).astype(np.float32),
         "w_up": (d ** -0.5 * rng.normal(size=(e, d, ff))).astype(np.float32),
         "w_down": (ff ** -0.5 * rng.normal(size=(e, ff, d))).astype(np.float32)}
    if cfg.moe.shared_expert:
        p["shared"] = {
            "w_gate": (d ** -0.5 * rng.normal(size=(d, ff))).astype(np.float32),
            "w_up": (d ** -0.5 * rng.normal(size=(d, ff))).astype(np.float32),
            "w_down": (ff ** -0.5 * rng.normal(size=(ff, d))).astype(np.float32)}
    return p


def _flat(p):
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out.update({f"{k}/{j}": torch.from_numpy(w) for j, w in v.items()})
        else:
            out[k] = torch.from_numpy(v)
    return out


def _x(cfg, seed=1, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, cfg.d_model)) + offset).astype(np.float32)


def _run(jcfg, cfg, p, x, dtype="float32"):
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jout, jaux = jax.jit(lambda p, x: jmoe.apply_moe(p, x, jcfg))(
        jax.tree.map(jnp.asarray, p), jx)
    out, aux = moe.apply_moe(_flat(p), torch.from_numpy(x).to(
        getattr(torch, dtype)), cfg)
    assert out.dtype == getattr(torch, dtype) and out.shape == x.shape
    return (np.asarray(jnp.asarray(jout, jnp.float32)), float(jaux),
            out.float().numpy(), aux.item())


def _check(jcfg, cfg, p, x, dtype="float32"):
    jout, jaux, out, aux = _run(jcfg, cfg, p, x, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(out, jout, rtol=0,
                               atol=tol * np.abs(jout).max())
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    return out


def _kept(cfg, p, x):
    """The first group's top-k experts, in order: the port's, checked equal
    to ``jax.lax.top_k``'s."""
    g = min(cfg.moe.group_size, B * S)
    xg = x.reshape(-1, cfg.d_model)[:g]
    probs = jax.nn.softmax(jnp.asarray(xg) @ p["router"], -1)
    _, ji = jax.lax.top_k(probs, cfg.moe.top_k)
    _, ti = moe.route(torch.softmax(torch.from_numpy(xg) @ torch.from_numpy(
        p["router"]), -1), cfg.moe.top_k)
    assert ti.tolist() == np.asarray(ji).tolist()
    return ti


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_dispatch_matches_reference(dispatch):
    jcfg, cfg = _cfgs(dispatch=dispatch)
    p = _params(cfg)
    _check(jcfg, cfg, p, _x(cfg))


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_shared_expert_matches_reference(dispatch):
    jcfg, cfg = _cfgs("llama4-scout-17b-a16e", dispatch=dispatch)
    assert cfg.moe.shared_expert and cfg.moe.top_k == 1
    _check(jcfg, cfg, _params(cfg, seed=2), _x(cfg))


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_capacity_overflow_drops_the_same_pairs(dispatch):
    """A router biased toward expert 0 sends every token there: past the
    capacity its pairs are dropped, in token-major order on both sides."""
    jcfg, cfg = _cfgs(dispatch=dispatch)
    router = 0.02 * np.random.default_rng(4).normal(size=(cfg.d_model, 4))
    router[:, 0] += 0.5
    p = _params(cfg, router=router)
    x = _x(cfg, offset=1.0)
    ti = _kept(cfg, p, x)
    g = min(cfg.moe.group_size, B * S)
    assert (ti[:, 0] == 0).all()
    assert moe.expert_capacity(cfg, g) < g      # half the pairs overflow
    out = _check(jcfg, cfg, p, x)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_exact_router_ties_pick_the_lower_index(dispatch):
    """A zero router ties every expert (the top 2 are 0 and 1, in that
    order, for every token, and half the pairs overflow); a router with
    two equal columns ties experts 1 and 2 (top-1: 1 wins): the lower
    index wins on both sides."""
    jcfg, cfg = _cfgs(dispatch=dispatch)
    zero = _params(cfg, router=np.zeros((cfg.d_model, 4)))
    x = _x(cfg)
    ti = _kept(cfg, zero, x)
    assert (ti == torch.tensor([0, 1])).all()
    _check(jcfg, cfg, zero, x)
    # top-1: where column 1 . x > 0, experts 1 and 2 tie at the top
    jcfg, cfg = _cfgs(dispatch=dispatch, top_k=1)
    router = 0.02 * np.random.default_rng(5).normal(size=(cfg.d_model, 4))
    router[:, 2] = router[:, 1]
    router[:, 3] = -router[:, 1]
    router[:, 0] = 0.0
    tied = _params(cfg, router=router)
    ti = _kept(cfg, tied, x)
    assert not (ti == 2).any() and (ti == 1).any() and (ti == 3).any()
    _check(jcfg, cfg, tied, x)


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_several_groups_average_the_aux(dispatch):
    jcfg, cfg = _cfgs(dispatch=dispatch, group_size=16)
    assert B * S // cfg.moe.group_size == 4
    _check(jcfg, cfg, _params(cfg, seed=6), _x(cfg, seed=7))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama4-scout-17b-a16e"])
def test_bf16_matches_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    _check(jcfg, cfg, _params(cfg, seed=8), _x(cfg, seed=9), "bfloat16")


def test_groups_must_divide_the_tokens():
    _, cfg = _cfgs(group_size=24)
    p = _flat(_params(cfg))
    with pytest.raises(ValueError):
        moe.apply_moe(p, torch.zeros((B, S, cfg.d_model)), cfg)
