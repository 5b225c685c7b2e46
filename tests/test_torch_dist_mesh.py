"""The port's placed dist steps on meshes of 8 CPU ranks, against the port's
one-device run and the reference's own run on 8 fake devices.

Ranks: 8 gloo processes, spawned (``torch_dist_worlds.spawn``: one
intra-op thread each, a ``FileStore`` under the test's tmp dir), one world
for both mesh shapes, each shape's cases run inside it in turn:

  * (pod 2, data 2, model 2), reduced qwen2-7b with
    ``act_batch_axes=("data",)``: tests/test_dist.py's own case. The
    multi-pod step (identical pods stay bit-equal, different batches
    diverge, pod 0 bit-equal to the single step on its (data 2, model 2)
    submesh; no collective's group holds ranks of both pods), the HeLoCo
    exchange with arriving pod 1 (its only cross-pod collectives are the
    arriving pod's leaves, one broadcast each) and the int8 exchange (its
    round trip bit-equal leaf by leaf to the one-device round trip, its
    parameters within 0.02 relative of the uncompressed exchange's, as the
    reference asserts), each block's HeLoCo branch from the placed
    statistics equal to the reference's;
  * (data 2, model 4) under the dry-run plan's ``head_tp`` and
    ``seq_parallel``: the train step at grad_accum 1 and 2, prefill, and
    decode with batch-sharded caches, then with sequence-sharded ones; the
    refusals of ``process_mesh`` (a mesh that is not the world; a CUDA
    mesh of more ranks than the host has cards).

The reference runs the same steps on the same bits in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
tests/test_dist.py does), at the same time as the ranks, and passes its
results back as npz. Bands, tests/test_torch_dist.py's: the loss within
rtol 1e-5; first moments within 1e-4 of each leaf's largest |value|;
parameters under ``check_step`` (5e-4 of a leaf's largest |value|, but for
elements whose gradient lies inside its band of zero); the exchange's
parameters, momentum and look-ahead within 2e-5; prefill and decode
logits and caches within 1e-4.

In this process: the one-card mesh (``local_mesh``, a world of one)
places every step and is bit-equal to the unplaced steps, the rehearsal
of chip_smoke.py's part (f).
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_dist_worlds as worlds
from repro import configs as jconfigs
from repro.configs.base import HeLoCoConfig as JHeLoCo
from repro_torch import bridge, configs
from repro_torch.configs.base import HeLoCoConfig, InnerOptConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist import steps
from repro_torch.launch import mesh as tmesh
from test_torch_dist import (INNER, _exchange_inputs, _jbranches, _jflat,
                             check_step)
from test_torch_methods import one_intra_op_thread  # noqa: F401

B, S = 4, 16
N_CACHE = S + 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's steps on 8 fake devices, inputs and outputs as flat npz
# dicts keyed by the port's "/"-joined paths
_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced
from repro.configs.base import HeLoCoConfig, InnerOptConfig
from repro.dist import sharding as shd
from repro.dist import steps
from repro.launch.mesh import make_test_mesh, mesh_context
from repro.models import build_model

src, dst = sys.argv[1], sys.argv[2]
inp = dict(np.load(src))
base = reduced(get_config("qwen2-7b"))
model = build_model(base)
shape = jax.eval_shape(model.init, jax.random.PRNGKey(0))

def tree(prefix):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shape)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(inp[prefix + shd._leaf_path(p)]) for p, _ in leaves])

def flat(prefix, t):
    leaves, _ = jax.tree_util.tree_flatten_with_path(t)
    return {prefix + shd._leaf_path(p): np.asarray(v, np.float32)
            for p, v in leaves}

params = tree("params/")
out = {}
inner = InnerOptConfig(lr=1e-3, warmup_steps=1, total_steps=10)

# (pod 2, data 2, model 2): the multi-pod step and the exchanges
cfg = dataclasses.replace(base, act_batch_axes=("data",))
mesh = make_test_mesh(multi_pod=True)
sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
pspecs = shd.param_specs(params, axis_sizes=sizes)
step = steps.make_multipod_train_step(cfg, inner, mesh, q_chunk=16,
                                      param_pspecs=pspecs)
stack = lambda t: jax.tree.map(lambda x: jnp.stack([x, x]), t)
batch = {"tokens": jnp.asarray(inp["pods/tokens"]),
         "labels": jnp.asarray(inp["pods/tokens"])}
with mesh_context(mesh):
    nd, losses = jax.jit(step)(stack(steps.init_train_state(params)), batch)
out.update(flat("multipod/params/", nd.params))
out.update(flat("multipod/mu/", nd.opt.mu))
out["multipod/losses"] = np.asarray(losses)
mom, wp = tree("momentum/"), tree("worker/")
for int8 in (False, True):
    fn = steps.make_outer_exchange(
        cfg, mesh, h=HeLoCoConfig(), outer_lr=0.7, mu=0.9, method="heloco",
        arriving_pod=1, stacked_axes=shd.stacked_axes_tree(params),
        compress_int8=int8)
    with mesh_context(mesh):
        p, m, bar = jax.jit(fn)(params, mom, wp)
    tag = "int8/" if int8 else "exchange/"
    for name, t in (("p/", p), ("m/", m), ("bar/", bar)):
        out.update(flat(tag + name, t))

# (data 2, model 4) under head_tp + seq_parallel
cfg = dataclasses.replace(base, act_batch_axes=("data",),
                          act_model_axis="model", seq_parallel=True)
mesh = make_test_mesh()
sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
pspecs = shd.param_specs(params, axis_sizes=sizes)
batch = {"tokens": jnp.asarray(inp["plan/tokens"]),
         "labels": jnp.asarray(inp["plan/labels"])}
with mesh_context(mesh):
    for ga in (1, 2):
        st, loss = jax.jit(steps.make_train_step(
            cfg, inner, grad_accum=ga, q_chunk=16, param_pspecs=pspecs))(
            steps.init_train_state(params), batch)
        out[f"train{ga}/loss"] = np.asarray(loss)
        out.update(flat(f"train{ga}/params/", st.params))
        out.update(flat(f"train{ga}/mu/", st.opt.mu))
    n = int(inp["serve/cache_len"])
    prompt = jnp.asarray(inp["serve/prompt"])
    logits, caches = jax.jit(steps.make_prefill_step(
        cfg, cache_len=n, q_chunk=prompt.shape[1]))(params,
                                                    {"tokens": prompt})
    out["prefill/logits"] = np.asarray(logits, np.float32)
    out.update(flat("prefill/caches/", caches))
    dec = jax.jit(steps.make_decode_step(cfg))
    for bs in (True, False):
        specs = shd.cache_specs(caches, batch_sharded=bs, axis_sizes=sizes)
        placed = jax.tree.map(lambda x, s: jax.device_put(
            x, NamedSharding(mesh, s)), caches, specs,
            is_leaf=lambda x: isinstance(x, P))
        dl, dc = dec(params, jnp.asarray(inp["serve/token"]), placed,
                     jnp.asarray(prompt.shape[1], jnp.int32))
        out[f"decode{int(bs)}/logits"] = np.asarray(dl, np.float32)
        out.update(flat(f"decode{int(bs)}/caches/", dc))
np.savez(dst, **out)
print("REFERENCE_OK")
"""


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 128, shape).astype(np.int32)


def _flat_np(tree):
    return {k: np.asarray(v, np.float32) for k, v in _jflat(tree).items()}


def _sub(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _n(tree):
    return {k: shd.gather(v).float().numpy() for k, v in tree.items()}


@functools.cache
def _inputs():
    """The reference's init of reduced qwen2-7b and
    tests/test_torch_dist.py's exchange trees (numpy, flat), the batches and
    the serving inputs."""
    _, jparams, jmom, jwp = _exchange_inputs()
    params = _flat_np(jparams)
    pods = _tokens((2, B, S), 3)
    plan = _tokens((B, S), 1)
    prompt = _tokens((2, S), 4)
    return dict(params=params, momentum=_flat_np(jmom),
                worker=_flat_np(jwp), pods=pods, plan=plan,
                plan_labels=np.roll(plan, -1, axis=1), prompt=prompt,
                token=np.array([3, 77], np.int32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's 8-device results, the ranks' results on both meshes
    and the port's one-device results, each started at once."""
    tmp = tmp_path_factory.mktemp("mesh")
    x = _inputs()
    npz = {**{f"params/{k}": v for k, v in x["params"].items()},
           **{f"momentum/{k}": v for k, v in x["momentum"].items()},
           **{f"worker/{k}": v for k, v in x["worker"].items()},
           "pods/tokens": x["pods"], "plan/tokens": x["plan"],
           "plan/labels": x["plan_labels"], "serve/prompt": x["prompt"],
           "serve/token": x["token"], "serve/cache_len": np.int32(N_CACHE)}
    np.savez(tmp / "in.npz", **npz)
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                            str(tmp / "in.npz"), str(tmp / "out.npz")],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        base = configs.reduced(configs.get_config("qwen2-7b"))
        pods_cfg = dataclasses.replace(base, act_batch_axes=("data",))
        plan_cfg = worlds.planned(base, seq_parallel=True)
        got = worlds.spawn(worlds.world_meshes, 8, tmp, {
            "pods": dict(
                cfg=pods_cfg, inner=INNER, params=x["params"],
                batch_same={"tokens": np.repeat(x["pods"][:1], 2, 0),
                            "labels": np.repeat(x["pods"][:1], 2, 0)},
                batch_diff={"tokens": x["pods"], "labels": x["pods"]},
                momentum=x["momentum"], worker_params=x["worker"]),
            "plan": dict(
                cfg=plan_cfg, inner=INNER, params=x["params"],
                batch={"tokens": x["plan"], "labels": x["plan_labels"]},
                prompt=x["prompt"], token=x["token"], cache_len=N_CACHE)})
        pods, plan = got["pods"], got["plan"]
        one = _one_device(pods_cfg, plan_cfg, x)
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert "REFERENCE_OK" in stdout, stdout + stderr
    return pods, plan, one, dict(np.load(tmp / "out.npz"))


def _one_device(pods_cfg, plan_cfg, x):
    """The port's steps on whole tensors in this process."""
    inner = InnerOptConfig(**INNER)
    params = _t(x["params"])
    st0 = steps.init_train_state(params)
    out = {}
    nd, losses = steps.make_multipod_train_step(pods_cfg, inner, None,
                                                q_chunk=16)(
        steps.stack_pods([st0, st0]),
        {"tokens": torch.from_numpy(x["pods"]),
         "labels": torch.from_numpy(x["pods"])})
    out["multipod"] = (losses.numpy(), _n(nd.params), _n(nd.opt.mu))
    mom, wp = _t(x["momentum"]), _t(x["worker"])
    for int8 in (False, True):
        fn = steps.make_outer_exchange(
            pods_cfg, tmesh.make_test_mesh(multi_pod=True), h=HeLoCoConfig(),
            outer_lr=0.7, mu=0.9, arriving_pod=1,
            stacked_axes=shd.stacked_axes_tree(params), compress_int8=int8)
        out["int8" if int8 else "exchange"] = tuple(
            _n(t) for t in fn(params, mom, wp))
    batch = {"tokens": torch.from_numpy(x["plan"]),
             "labels": torch.from_numpy(x["plan_labels"])}
    for ga in (1, 2):
        st, loss = steps.make_train_step(plan_cfg, inner, grad_accum=ga,
                                         q_chunk=16)(st0, batch)
        out[f"train_{ga}"] = (float(loss), _n(st.params), _n(st.opt.mu))
    logits, caches = steps.make_prefill_step(plan_cfg, cache_len=N_CACHE)(
        params, {"tokens": torch.from_numpy(x["prompt"])})
    dl, caches = steps.make_decode_step(plan_cfg)(
        params, torch.from_numpy(x["token"]), caches, S)
    out["serve"] = (logits.numpy(), dl.numpy(), _n(caches))
    return out


def _close_step(got, want, what):
    """loss, parameters, first moments against (loss, params, mu)."""
    loss, params, mu = got
    wloss, wparams, wmu = want
    np.testing.assert_allclose(loss, wloss, rtol=1e-5, err_msg=what)
    assert set(params) == set(wparams), what
    for k, v in wmu.items():
        np.testing.assert_allclose(mu[k], v, rtol=0,
                                   atol=1e-4 * np.abs(v).max() + 1e-12,
                                   err_msg=f"{what} {k}")
    check_step(params, wparams, wmu, INNER["lr"],
               InnerOptConfig().weight_decay, what)


# ------------------------------------------------ (pod 2, data 2, model 2)

def test_multipod_pods_stay_apart_on_two_pods(runs):
    pods = runs[0]
    for k, v in pods["same"].items():
        np.testing.assert_array_equal(v[0], v[1], err_msg=k)
    last = list(pods["diff"])[-1]
    assert not np.allclose(pods["diff"][last][0], pods["diff"][last][1])
    assert pods["single_mesh"] == {"data": 2, "model": 2}
    assert pods["pod0_bit_equal_single"]
    assert pods["losses"][0] == np.float32(pods["single_loss"])


def test_multipod_step_matches_the_port_and_the_reference(runs):
    pods, _, one, ref = runs
    got = (pods["losses"], pods["diff"], pods["diff_mu"])
    for what, want in (("one device", one["multipod"]),
                       ("reference", (ref["multipod/losses"],
                                      _sub(ref, "multipod/params/"),
                                      _sub(ref, "multipod/mu/")))):
        _close_step(got, want, f"multipod against the {what}")


def test_multipod_step_runs_no_collective_across_pods(runs):
    pods = runs[0]
    assert pods["multipod_collectives"] > 0
    assert pods["multipod_crossing"] == []


@pytest.mark.parametrize("int8", [False, True])
def test_exchange_on_two_pods_matches_the_port_and_the_reference(runs, int8):
    pods, _, one, ref = runs
    tag = "int8" if int8 else "exchange"
    got = pods[tag]
    for what, want in (("one device", one[tag]),
                       ("reference", tuple(_sub(ref, f"{tag}/{n}/")
                                           for n in ("p", "m", "bar")))):
        for g, w in zip(got, want):
            assert set(g) == set(w), what
            for k, v in w.items():
                assert g[k].shape == v.shape, (what, k)
                np.testing.assert_allclose(g[k], v, rtol=2e-5, atol=2e-5,
                                           err_msg=f"{tag} {what} {k}")
    if int8:
        num = sum(float(((got[0][k] - v) ** 2).sum())
                  for k, v in pods["exchange"][0].items())
        den = sum(float((v ** 2).sum()) for v in pods["exchange"][0].values())
        assert (num / den) ** 0.5 < 0.02


def test_exchange_crosses_pods_only_with_the_arriving_leaves(runs):
    pods = runs[0]
    n = len(pods["exchange"][0])
    for tag in ("exchange", "int8"):
        crossing = pods[tag + "_crossing"]
        assert len(crossing) == n, (tag, crossing)
        assert {name for name, _ in crossing} == {"broadcast"}
        assert pods[tag + "_collectives"] > n


def test_int8_round_trip_on_shards_is_the_one_device_round_trip(runs):
    pods = runs[0]
    x = _inputs()
    for k, v in x["params"].items():
        d = torch.tensor(v) - torch.tensor(x["worker"][k][1])
        np.testing.assert_array_equal(
            pods["int8_roundtrip"][k],
            steps.int8_roundtrip_leaf(d).numpy(), err_msg=k)


@pytest.mark.parametrize("int8", [False, True])
def test_exchange_branches_on_shards_are_the_references(runs, int8):
    pods = runs[0]
    jcfg, jparams, jmom, jwp = _exchange_inputs()
    from repro.dist import sharding as jshd
    from repro.dist import steps as jsteps
    jdelta = jax.tree.map(lambda a, b: a.astype(np.float32)
                          - b[1].astype(np.float32), jparams, jwp)
    if int8:
        jdelta = jax.tree.map(jsteps._int8_roundtrip_leaf, jdelta)
    want = _jbranches(jdelta, jmom, JHeLoCo(), jshd.stacked_axes_tree(
        jparams))
    got = pods["codes"][int8]
    seen = set()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        seen |= set(v.tolist())
    assert {0, 1, 2} <= seen, seen


# ------------------------------------- (data 2, model 4), head_tp + SP

@pytest.mark.parametrize("ga", [1, 2])
def test_placed_train_step_under_the_plan(runs, ga):
    _, plan, one, ref = runs
    assert len(plan[f"placements_{ga}"]) > 1
    _close_step(plan[f"train_{ga}"], one[f"train_{ga}"], "one device")
    _close_step(plan[f"train_{ga}"], (
        float(ref[f"train{ga}/loss"]), _sub(ref, f"train{ga}/params/"),
        _sub(ref, f"train{ga}/mu/")), "reference")


@pytest.mark.parametrize("batch_sharded", [True, False])
def test_placed_prefill_and_decode_under_the_plan(runs, batch_sharded):
    _, plan, one, ref = runs
    logits, dlogits, caches, placements = plan[f"serve_{batch_sharded}"]
    data_dim = "dim=1" if batch_sharded else "dim=2"
    assert all(f"Shard({data_dim})" in p for p in placements.values()), \
        placements
    wlogits, wdlogits, wcaches = one["serve"]
    for what, (wl, wd, wc) in (
            ("one device", (wlogits, wdlogits, wcaches)),
            ("reference", (ref["prefill/logits"],
                           ref[f"decode{int(batch_sharded)}/logits"],
                           _sub(ref, f"decode{int(batch_sharded)}"
                                     "/caches/")))):
        np.testing.assert_allclose(logits, wl, rtol=0, atol=1e-4,
                                   err_msg=what)
        np.testing.assert_allclose(dlogits, wd, rtol=0, atol=1e-4,
                                   err_msg=what)
        for k, v in wc.items():
            np.testing.assert_allclose(caches[k], v, rtol=0, atol=1e-4,
                                       err_msg=f"{what} {k}")


def test_process_mesh_refuses_what_the_world_cannot_hold(runs):
    refusals = runs[1]["refusals"]
    assert runs[1]["world"] == 8
    assert refusals[((2, 2), "cpu")].startswith("ValueError"), refusals
    assert refusals[((2, 4), "cuda")].startswith("RuntimeError"), refusals
    assert "cards" in refusals[((2, 4), "cuda")]
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        with tmesh.process_mesh((1,), ("data",), "cpu"):
            pass


# ------------------------------------------------ the one-card mesh

def test_one_card_mesh_places_every_step_bit_equal_to_the_unplaced():
    """chip_smoke.py's part (f) on the CPU: every placement and local_map
    site on a world of one, bit-equal to the unplaced steps (the exchange
    through the kernels' structure, their plain versions here)."""
    x = _inputs()
    base = configs.reduced(configs.get_config("qwen2-7b"))
    cfg = worlds.planned(base, seq_parallel=True)
    inner = InnerOptConfig(**INNER)
    params = _t(x["params"])
    st0 = steps.init_train_state(params)
    batch = {"tokens": torch.from_numpy(x["plan"]),
             "labels": torch.from_numpy(x["plan_labels"])}
    with tmesh.local_mesh("cpu") as lm, tmesh.mesh_context(lm):
        pspecs = shd.param_specs(params, axis_sizes=lm.axis_sizes)
        for ga in (1, 2):
            placed, ploss = steps.make_train_step(
                cfg, inner, grad_accum=ga, q_chunk=8, param_pspecs=pspecs)(
                st0, batch)
            plain, loss = steps.make_train_step(
                base, inner, grad_accum=ga, q_chunk=8)(st0, batch)
            assert torch.equal(shd.gather(ploss), loss)
            assert all(shd.is_placed(v) for v in placed.params.values())
            for a, b in ((placed.params, plain.params),
                         (placed.opt.mu, plain.opt.mu)):
                for k, v in b.items():
                    assert torch.equal(shd.gather(a[k]), v), (ga, k)
        prompt = torch.from_numpy(x["prompt"])
        token = torch.from_numpy(x["token"])
        pp = shd.place_tree(params, pspecs, lm)
        ptok, ptoken = (shd.place_tree(t, shd.batch_specs(t), lm)
                        for t in (prompt, token))
        for bs in (True, False):
            pl, pc = steps.make_prefill_step(cfg, cache_len=N_CACHE)(
                pp, {"tokens": ptok})
            dl, dc = steps.make_decode_step(cfg)(
                pp, ptoken, shd.place_caches(pc, lm, batch_sharded=bs), S)
            ul, uc = steps.make_prefill_step(base, cache_len=N_CACHE)(
                params, {"tokens": prompt})
            udl, uc = steps.make_decode_step(base)(params, token, uc, S)
            assert torch.equal(shd.gather(pl), ul)
            assert torch.equal(shd.gather(dl), udl)
            for k, v in uc.items():
                assert torch.equal(shd.gather(dc[k]), v), k
        mom, wp = _t(x["momentum"]), _t(x["worker"])
        for int8 in (False, True):
            kw = dict(h=HeLoCoConfig(), outer_lr=0.7, mu=0.9,
                      arriving_pod=1, compress_int8=int8, use_kernel=True,
                      stacked_axes=shd.stacked_axes_tree(params))
            got = steps.make_outer_exchange(base, lm, param_pspecs=pspecs,
                                            **kw)(params, mom, wp)
            want = steps.make_outer_exchange(
                base, tmesh.make_test_mesh(multi_pod=True), **kw)(
                params, mom, wp)
            for g, w in zip(got, want):
                for k, v in w.items():
                    assert torch.equal(shd.gather(g[k]), v), (int8, k)
