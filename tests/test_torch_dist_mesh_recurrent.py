"""Placed serving of the recurrent families on a mesh of 8 CPU ranks,
against the port's one-device run and the reference's own run on 8 fake
devices.

zamba2-2.7b (hybrid: Mamba2 units and the shared attention block) and
xlstm-125m (ssm: mLSTM and sLSTM blocks) at smoke width, fp32, from the
reference's init, on a (data 2, model 4) mesh of 8 gloo ranks under the
dry-run plan's ``head_tp`` (``act_batch_axes=("data",)``,
``act_model_axis="model"``): the placed prefill of a (4, 16) prompt, then
2 placed decode steps on the caches it returned
(``torch_dist_worlds.world_recurrent``). Each recurrent block's state lies
on the rank's batch shard (``layers.mixer_on_batch_shard``); the shared
block's k and v caches are replicated, as every prefill leaves them.

The reference runs the same steps on the same bits in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
tests/test_torch_dist_mesh.py does), its parameters at its own
PartitionSpecs and the prompt over data, at the same time as the ranks.

Tolerances:
  * logits of every step: atol 1e-4 (tests/test_torch_dist_mesh.py's
    ``test_placed_prefill_and_decode_under_the_plan``);
  * every cache leaf, after the prefill and after the last step: within
    1e-4 of the larger of 1 and the leaf's largest |value|. Against the
    reference, whose fp32 sums run in XLA's order, the states that sum
    a chunk's products part most: after the last step zamba2's Mamba2
    SSM state (largest |value| ~21) by ~4e-4 and xlstm's mLSTM C (~6) by
    ~2e-4, 2e-5 and 3e-5 of their scale; against the one-device run
    every leaf stays within 1e-5. A leaf of scale 1 or less is held at
    atol 1e-4. A bf16 conv window may also sit one bf16 step away (2 **
    -7 of the value) where the fp32 values it was rounded from straddle
    a rounding midpoint (tests/test_torch_recurrent.py's band for the
    same windows).

Also: the states come back as DTensors with their batch dim over data
after the prefill and after every step; rank 0's collective records of
each step equal the dry-run's count of the same step on a fake world of 8
ranks (kinds, ops, groups, order and bytes); and on a mesh of one rank in
this process every placed serving step is bit-equal to the unplaced one
and runs no collective (the rehearsal of chip_smoke.py's part (f)).
"""
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_dist_worlds as worlds
from repro.dist import sharding as jshd
from repro.models import Model as JaxModel
from repro import configs as jconfigs
from repro_torch import bridge, configs
from repro_torch.dist import sharding as shd
from repro_torch.dist import steps
from repro_torch.launch import mesh as tmesh
from test_torch_methods import one_intra_op_thread  # noqa: F401

ARCHS = ("zamba2-2.7b", "xlstm-125m")
B, S, DECODES = 4, 16, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's prefill and decode steps on 8 fake devices, inputs and
# outputs as flat npz dicts keyed by "/"-joined paths
_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.dist import sharding as shd
from repro.dist import steps
from repro.launch.mesh import make_test_mesh, mesh_context
from repro.models import build_model

src, dst, archs = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
inp = dict(np.load(src))
mesh = make_test_mesh()
sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
out = {}

def flat(prefix, t):
    leaves, _ = jax.tree_util.tree_flatten_with_path(t)
    return {prefix + shd._leaf_path(p): np.asarray(v, np.float32)
            for p, v in leaves}

for arch in archs:
    cfg = dataclasses.replace(get_config(arch + "-smoke"),
                              act_batch_axes=("data",),
                              act_model_axis="model")
    shape = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shape)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(inp[f"{arch}/params/" + shd._leaf_path(p)])
        for p, _ in leaves])
    pspecs = shd.param_specs(params, axis_sizes=sizes)
    params = jax.tree.map(lambda x, s: jax.device_put(
        x, NamedSharding(mesh, s)), params, pspecs)
    prompt = jax.device_put(jnp.asarray(inp[f"{arch}/prompt"]),
                            NamedSharding(mesh, P("data")))
    tokens = inp[f"{arch}/tokens"]
    s = prompt.shape[1]
    with mesh_context(mesh):
        logits, caches = jax.jit(steps.make_prefill_step(
            cfg, cache_len=s + len(tokens), q_chunk=s))(params,
                                                        {"tokens": prompt})
        out[f"{arch}/logits/0"] = np.asarray(logits, np.float32)
        out.update(flat(f"{arch}/prefill_caches/", caches))
        dec = jax.jit(steps.make_decode_step(cfg))
        for i, t in enumerate(tokens):
            logits, caches = dec(params, jnp.asarray(t), caches,
                                 jnp.asarray(s + i, jnp.int32))
            out[f"{arch}/logits/{i + 1}"] = np.asarray(logits, np.float32)
        out.update(flat(f"{arch}/caches/", caches))
np.savez(dst, **out)
print("REFERENCE_OK")
"""


def _cfg(arch):
    """The smoke config with the dry-run plan's head_tp hints."""
    return worlds.planned(configs.reduced(configs.get_config(arch)))


@functools.cache
def _inputs(arch):
    """The reference's init of the smoke config (flat numpy, by the port's
    paths), the prompt and the decode steps' tokens, from the seed."""
    jparams = jax.jit(JaxModel(jconfigs.get_config(arch + "-smoke")).init)(
        jax.random.PRNGKey(0))
    leaves, _ = jax.tree_util.tree_flatten_with_path(jparams)
    params = {jshd._leaf_path(p): np.asarray(v) for p, v in leaves}
    rng = np.random.default_rng(ARCHS.index(arch))
    vocab = configs.get_config(arch + "-smoke").vocab_size
    prompt = rng.integers(0, vocab, (B, S)).astype(np.int32)
    tokens = rng.integers(0, vocab, (DECODES, B)).astype(np.int32)
    return params, prompt, tokens


def _serve(cfg, params, prompt, tokens):
    """(logits of each step, caches after the prefill and after the last
    step, each flat and gathered, the last caches as returned) of the
    prefill and decode steps on the placements the inputs carry."""
    prefill = steps.make_prefill_step(cfg, cache_len=S + DECODES)
    decode = steps.make_decode_step(cfg)

    def flat(caches):
        return {k: shd.gather(v) for k, v in shd.tree_leaves(caches).items()}
    lg, caches = prefill(params, {"tokens": prompt})
    logits, first = [shd.gather(lg)], {k: v.clone() for k, v in
                                       flat(caches).items()}
    for i, t in enumerate(tokens):
        lg, caches = decode(params, t, caches, S + i)
        logits.append(shd.gather(lg))
    return logits, first, flat(caches), caches


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 8-rank results, the one-device results, the reference's) by
    arch, each started at once."""
    tmp = tmp_path_factory.mktemp("recurrent")
    npz, payload, one = {}, {}, {}
    for arch in ARCHS:
        params, prompt, tokens = _inputs(arch)
        npz.update({f"{arch}/params/{k}": v for k, v in params.items()})
        npz[f"{arch}/prompt"], npz[f"{arch}/tokens"] = prompt, tokens
        payload[arch] = (_cfg(arch), params, prompt, list(tokens))
    np.savez(tmp / "in.npz", **npz)
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                            str(tmp / "in.npz"), str(tmp / "out.npz"),
                            ",".join(ARCHS)],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        got = worlds.spawn(worlds.world_recurrent, 8, tmp, payload)
        for arch in ARCHS:
            params, prompt, tokens = _inputs(arch)
            logits, first, last, _ = _serve(
                _cfg(arch), bridge.to_torch(params, "cpu"),
                torch.from_numpy(prompt),
                [torch.from_numpy(t) for t in tokens])
            one[arch] = dict(logits=[x.numpy() for x in logits],
                             prefill_caches={k: v.float().numpy()
                                             for k, v in first.items()},
                             caches={k: v.float().numpy()
                                     for k, v in last.items()})
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert "REFERENCE_OK" in stdout, stdout + stderr
    out = dict(np.load(tmp / "out.npz"))
    want = {arch: dict(
        logits=[out[f"{arch}/logits/{i}"] for i in range(1 + DECODES)],
        **{tree: {k[len(f"{arch}/{tree}/"):]: v for k, v in out.items()
                  if k.startswith(f"{arch}/{tree}/")}
           for tree in ("prefill_caches", "caches")}) for arch in ARCHS}
    return got, one, want


def _cache_close(got, want, what):
    """The module docstring's band: 1e-4 of max(1, the leaf's largest
    |value|); a bf16 window also within one bf16 step of each value."""
    assert got.shape == want.shape, what
    bound = 1e-4 * max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want)
    if what.endswith("conv"):
        err = np.where(err <= np.abs(want) * 2.0 ** -7, 0.0, err)
    assert float(err.max()) <= bound, (what, float(err.max()), bound)


@pytest.mark.parametrize("against", ["one device", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_prefill_and_decode_on_eight_ranks(runs, arch, against):
    got, one, ref = runs
    got, want = got[arch], (one if against == "one device" else ref)[arch]
    assert len(got["logits"]) == len(want["logits"]) == 1 + DECODES
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4,
                                   err_msg=f"{against} step {i}")
    for tree in ("prefill_caches", "caches"):
        assert set(got[tree]) == set(want[tree]), (against, tree)
        for k, v in want[tree].items():
            _cache_close(got[tree][k], v, f"{against} {tree} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_states_stay_on_the_batch_shard(runs, arch):
    """After the prefill and after each decode step, every recurrent
    state leaf is a DTensor with its batch dim (2 for the hybrid's
    stacked (n_super, per, B, ..) states, 0 for a layer's) over data and
    replicated over model; the hybrid's k and v caches are replicated."""
    batch_dim = 2 if arch == "zamba2-2.7b" else 0
    for step in runs[0][arch]["placements"]:
        for k, pl in step.items():
            want = ("(Replicate(), Replicate())" if k.split("/")[-1]
                    in ("k", "v") else
                    f"(Shard(dim={batch_dim}), Replicate())")
            assert pl == want, (k, pl)
    n = len(runs[0][arch]["placements"][0])
    assert n == (4 if arch == "zamba2-2.7b" else 17), n


@pytest.fixture(scope="module")
def fake_counts():
    """The dry-run's count (``launch.dryrun.count_collectives``: rank 0 of
    a fake world of 8 ranks, CPU fake tensors placed before the count) of
    each serving step the world runs, on the same mesh, with arguments of
    the same shapes, dtypes and placements; a decode step's caches are
    those the fake prefill and the steps before it returned."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun
    prompt = torch.empty((B, S), dtype=torch.int32, device="meta")
    token = torch.empty((B,), dtype=torch.int32, device="meta")
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        params = dryrun.abstract_params(cfg)
        with tmesh.abstract_world(tmesh.make_test_mesh()) as world, \
                tmesh.mesh_context(world), FakeTensorMode():
            pspecs = shd.param_specs(params, axis_sizes=world.axis_sizes)

            def place(t):
                return dryrun.abstract_placed(t, shd.batch_specs(t), world,
                                              "cpu")

            def build(i):
                pp = dryrun.abstract_placed(params, pspecs, world, "cpu")
                pre = steps.make_prefill_step(cfg, cache_len=S + DECODES)
                tok = place(prompt)
                if i == 0:
                    return lambda: pre(pp, {"tokens": tok})
                dec = steps.make_decode_step(cfg)
                _, caches = pre(pp, {"tokens": tok})
                for j in range(i - 1):
                    _, caches = dec(pp, place(token), caches, S + j)
                t = place(token)
                return lambda: dec(pp, t, caches, S + i - 1)
            out[arch] = [dryrun.count_collectives(functools.partial(build, i))
                         for i in range(1 + DECODES)]
    assert not torch.distributed.is_initialized()
    return out


@pytest.mark.parametrize("step", range(1 + DECODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_fake_world_count_is_the_gloo_worlds_record(runs, fake_counts, arch,
                                                    step):
    """Rank 0's record of the prefill (step 0) and of each decode step on 8
    gloo ranks equals the dry-run's count of the same step."""
    records, why = fake_counts[arch][step]
    assert why is None, why
    got = runs[0][arch]["records"][step]
    assert len(got) > 0, (arch, step)
    assert [tuple(r) for r in records] == [tuple(r) for r in got]


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_serving_is_bit_equal_to_the_unplaced(arch):
    """On ``local_mesh`` (a world of one) the placed prefill and decode
    steps, the states on the batch shard, run no collective and return
    the unplaced steps' bits: every step's logits and every cache leaf, of
    its dtype, after the prefill and after the last step."""
    params, prompt, tokens = _inputs(arch)
    params = bridge.to_torch(params, "cpu")
    prompt = torch.from_numpy(prompt)
    tokens = [torch.from_numpy(t) for t in tokens]
    base = configs.reduced(configs.get_config(arch))
    want = _serve(base, params, prompt, tokens)
    with tmesh.local_mesh("cpu") as lm, tmesh.mesh_context(lm):
        pp = shd.place_tree(params, shd.param_specs(
            params, axis_sizes=lm.axis_sizes), lm)

        def place(t):
            return shd.place_tree(t, shd.batch_specs(t), lm)
        with worlds.CollectiveLog() as log:
            got = _serve(_cfg(arch), pp, place(prompt),
                         [place(t) for t in tokens])
        assert log.records == [], log.records
        assert all(shd.is_placed(v)
                   for v in shd.tree_leaves(got[3]).values())
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert torch.equal(g, w), (arch, i)
    for g, w in zip(got[1:3], want[1:3]):
        assert set(g) == set(w)
        for k, v in w.items():
            assert g[k].dtype == v.dtype and torch.equal(g[k], v), (arch, k)
