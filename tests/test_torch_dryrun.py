"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's ``repro/launch/dryrun.py``.

The reference module sets ``XLA_FLAGS`` to 512 host devices when it is
imported, which would change the device count of every later test in this
process, so it is never imported here: its plan (``GRAD_ACCUM``,
``Q_CHUNK``, ``plan_for``) is read from its source with ``ast``. The
per-device argument bytes are held to bytes computed here from the
reference's own PartitionSpecs (``repro.dist.sharding``) over its
``jax.eval_shape`` structs, for two archs on both production meshes. The
reference's own record of one smoke cell is read from a subprocess that
imports its dry-run module after fixing the device count at 8.
"""
import ast
import dataclasses
import json
import math
import os
import typing
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.dist import sharding as jshd
from repro.launch import inputs as jinputs
from repro.models import Model as JaxModel
from repro_torch import configs
from repro_torch.launch import dryrun, mesh as tmesh

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "src" / "repro" / "launch" / "dryrun.py"


def _reference_plan():
    """GRAD_ACCUM, Q_CHUNK and plan_for from the reference's source."""
    tree = ast.parse(REFERENCE.read_text())
    ns = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Name) and node.targets[0].id in (
                "GRAD_ACCUM", "Q_CHUNK"):
            ns[node.targets[0].id] = ast.literal_eval(node.value)
        if isinstance(node, ast.FunctionDef) and node.name == "plan_for":
            fn = ast.Module(body=[node], type_ignores=[])
            exec(compile(fn, str(REFERENCE), "exec"),
                 {"Dict": typing.Dict, "Any": typing.Any,
                  "Optional": typing.Optional, "ShapeConfig": object, **ns},
                 ns)
    return ns


def test_plan_equals_the_references_source():
    ref = _reference_plan()
    assert dryrun.GRAD_ACCUM == ref["GRAD_ACCUM"]
    assert dryrun.Q_CHUNK == ref["Q_CHUNK"]
    for arch in list(configs.ARCHS) + ["no-such-arch"]:
        for name, shape in configs.SHAPES.items():
            for over in (None, {"grad_accum": 1, "remat_group": 4},
                         {"head_tp": True}):
                assert dryrun.plan_for(arch, shape, over) == \
                    ref["plan_for"](arch, jconfigs.SHAPES[name], over), \
                    (arch, name, over)


def _jbytes(tree, specs, sizes, prefix=()):
    """Per-device bytes of a reference tree under its PartitionSpecs."""
    leaves = jax.tree_util.tree_leaves(tree)
    specs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    total = 0
    for x, s in zip(leaves, specs):
        entries = tuple(prefix) + tuple(s)
        shape = tuple(x.shape)
        parts = [1] * len(shape)
        for i, e in enumerate(entries):
            if e is not None:
                names = (e,) if isinstance(e, str) else e
                parts[i] = math.prod(sizes[n] for n in names)
        assert all(d % p == 0 for d, p in zip(shape, parts))
        total += math.prod(d // p for d, p in zip(shape, parts)) * \
            np.dtype(x.dtype).itemsize
    return total


def _reference_bytes(arch, shape_name, multi):
    """The reference cell's arguments as its ``lower_cell`` places them."""
    cfg = jconfigs.get_config(arch)
    shape = jconfigs.SHAPES[shape_name]
    sizes = ({"pod": 2, "data": 16, "model": 16} if multi
             else {"data": 16, "model": 16})
    data_axes = ("pod", "data") if multi else ("data",)
    params = jax.eval_shape(JaxModel(cfg).init, jax.random.PRNGKey(0))
    pspecs = jshd.param_specs(params, axis_sizes=sizes)
    ins = jinputs.input_specs(cfg, shape)
    if shape.kind == "train":
        pod = ("pod",) if multi else ()
        f32 = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
            ((2,) if multi else ()) + x.shape, np.float32), params)
        if multi:
            params = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
                (2,) + x.shape, x.dtype), params)
            batch = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
                (2,) + x.shape, x.dtype), ins["batch"])
            bspecs = jshd.batch_specs(ins["batch"], batch_axes=("data",))
        else:
            batch = ins["batch"]
            bspecs = jshd.batch_specs(batch, batch_axes=data_axes)
        scalar = 4   # the int32 count and step, on every device
        return (_jbytes(params, pspecs, sizes, pod)
                + 2 * _jbytes(f32, pspecs, sizes, pod) + 2 * scalar
                + _jbytes(batch, bspecs, sizes, pod))
    if shape.kind == "prefill":
        return (_jbytes(params, pspecs, sizes)
                + _jbytes(ins["batch"], jshd.batch_specs(
                    ins["batch"], batch_axes=data_axes), sizes))
    batch_sharded = shape.global_batch >= sizes["data"]
    cspecs = jshd.cache_specs(ins["caches"], batch_sharded=batch_sharded,
                              axis_sizes=sizes,
                              data_axis=data_axes if multi else "data")
    tok = (P(data_axes),) if batch_sharded else (P(),)
    return (_jbytes(params, pspecs, sizes)
            + _jbytes((ins["token"],), tok, sizes)
            + _jbytes(ins["caches"], cspecs, sizes) + 4)


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-1b-a400m"])
def test_argument_bytes_equal_the_references_placements(arch):
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        for multi in (False, True):
            got = dryrun.argument_bytes(
                configs.get_config(arch), configs.SHAPES[shape_name],
                tmesh.make_production_mesh(multi_pod=multi), multi_pod=multi)
            assert sum(got.values()) == _reference_bytes(
                arch, shape_name, multi), (arch, shape_name, multi, got)


def test_a_cell_record_on_meta_tensors():
    """One cell at smoke width (the reference's ``lower_cell`` takes a cfg
    the same way): its keys, the even split, the collective fields counted
    and the fields left unmodelled, and the multi-pod twin reusing the
    flops count for two pods."""
    cfg = configs.reduced(configs.get_config("qwen2-7b"))
    memo = {}
    single = dryrun.lower_cell("qwen2-7b", "train_4k",
                               tmesh.make_production_mesh(), multi_pod=False,
                               cfg=cfg, memo=memo)
    multi = dryrun.lower_cell("qwen2-7b", "train_4k",
                              tmesh.make_production_mesh(multi_pod=True),
                              multi_pod=True, cfg=cfg, memo=memo)
    assert len(memo) == 1
    for rec in (single, multi):
        assert {"arch", "shape", "kind", "mesh", "plan", "n_devices",
                "flops_total", "flops_per_device", "flops_split", "memory",
                "not_modelled", "flops_counted", "count_seconds"} <= set(rec)
        assert set(rec["not_modelled"]) == {
            "temp_bytes", "code_bytes", "bytes_per_device", "output_bytes",
            "alias_bytes", "peak_estimate_bytes"}
        assert {"collectives", "collective_group_sizes",
                "wire_bytes_per_device", "collectives_counted"} <= set(rec)
        assert "collectives_reason" not in rec
        assert rec["collectives_counted"].startswith(
            f"executed in one step by rank 0 of a fake world of "
            f"{rec['n_devices']} ranks")
        assert rec["wire_bytes_per_device"] > 0
        assert set(rec["count_seconds"]) == {"argument_bytes", "flops",
                                             "collectives"}
        assert "temp_bytes" not in rec["memory"]
        assert rec["flops_per_device"] == rec["flops_total"] / \
            rec["n_devices"]
        assert rec["plan"] == {"grad_accum": 4, "q_chunk": 512}
        json.dumps(rec)
    assert (single["n_devices"], multi["n_devices"]) == (256, 512)
    assert multi["flops_total"] == 2 * single["flops_total"]
    # a dense model's step, forward and backward: 6 N T for the N weights
    # of its matmuls (the untied lm_head too, not the token lookup) over T
    # tokens, and 14 S^2 H D a layer and a sequence for the attention's
    # products of 2 S^2 H D each (the causal mask skips no work): the
    # scores and their product with v forward; the chunked backward
    # recomputes the scores, then dv, dp, dq and dk (the reference's
    # custom-vjp), and 2 S H D for delta = sum(do * out), an einsum that
    # the counter counts as a batched product. The reduced config has no
    # remat: no forward again
    n = sum(math.prod(x.shape) for k, x in dryrun.abstract_params(
        cfg).items() if k.split("/")[-1] in (
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"))
    seq, batch = 4096, 256
    assert not cfg.remat
    assert single["flops_total"] == 6 * n * seq * batch + (
        14 * seq ** 2 + 2 * seq) * cfg.n_heads * cfg.head_dim * \
        cfg.n_layers * batch


def test_a_cell_that_cannot_be_counted_records_why():
    flops, why = dryrun.count_flops(
        lambda: (_ for _ in ()).throw(RuntimeError("data-dependent")))
    assert flops is None and "data-dependent" in why


def test_the_references_directory_is_refused(tmp_path):
    assert dryrun.main(["--out", str(ROOT / "results" / "dryrun"),
                        "--arch", "qwen2-7b"]) == 2
    assert dryrun.main(["--out", str(ROOT / "results" / "dryrun" / "x"),
                        "--arch", "qwen2-7b"]) == 2
    assert not (ROOT / "results" / "dryrun").exists()
    assert not dryrun.refused_out(str(tmp_path))
    assert not dryrun.refused_out(dryrun.DEFAULT_OUT)


def test_cli_writes_skip_and_outer_exchange_records(tmp_path, capsys):
    """hubert-xlarge's decode cells are skipped (encoder-only) with the
    reference's record; the outer exchange's pod-axis bytes and the
    collectives of its placed program."""
    out = tmp_path / "dr"
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                        "--out", str(out), "--outer-exchange",
                        "--compress-int8"]) == 0
    for mesh in ("single", "multi"):
        rec = json.loads((out / f"hubert-xlarge__decode_32k__{mesh}.json")
                         .read_text())
        assert rec == {"arch": "hubert-xlarge", "shape": "decode_32k",
                       "skipped": "encoder-only arch has no decode step",
                       "mesh": mesh}
    ex = json.loads((out / "hubert-xlarge__outer_exchange__multi.json")
                    .read_text())
    params = dryrun.abstract_params(configs.get_config("hubert-xlarge"))
    pod = ex["pod_axis_bytes_per_device"]
    n = sum(math.prod(x.shape) for x in params.values())
    assert n / 256 <= pod["delta_in"] < 4 * n / 256
    assert pod["lookahead_out"] == ex["memory"]["argument_bytes_by_input"][
        "params"]
    # delta_in is the modelled int8 wire format (n + 4 bytes a leaf); the
    # placed program broadcasts the fp32 shards over pod (4 n bytes)
    n_shard = pod["delta_in"] - 4 * len(params)
    assert ex["collectives"]["broadcast"] == {
        "count": len(params), "result_bytes": 4 * n_shard,
        "wire_bytes": 4 * n_shard}
    assert ex["collective_group_sizes"]["2"] == len(params)
    assert "0 cells without a count" in capsys.readouterr().out
    assert os.listdir(out)


def test_a_cell_that_fails_records_no_count(tmp_path, capsys):
    """xlstm-125m's decode cell fails at its caches' specs (the reference's
    ``cache_specs`` has no layout for recurrent states): its record holds
    the error and the three collective fields null with the reason, and
    the CLI lists it."""
    out = tmp_path / "dr"
    assert dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                        "--mesh", "single", "--out", str(out)]) == 0
    rec = json.loads((out / "xlstm-125m__decode_32k__single.json")
                     .read_text())
    assert "unpack" in rec["error"]
    assert rec["collectives"] is rec["collective_group_sizes"] is \
        rec["wire_bytes_per_device"] is None
    assert rec["collectives_reason"] == "the cell failed before the count"
    assert "1 cells without a count" in capsys.readouterr().out


# the reference's dry-run of one smoke cell on 8 fake devices (its module
# fixes the device count when imported, so it runs in a subprocess): the
# group-size histogram of its compiled collectives
_REFERENCE_CELL = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.devices()   # the device count is fixed before the dry-run module
from repro.configs import get_config
from repro.launch import dryrun as jd
from repro.launch.mesh import make_test_mesh
arch, shape = sys.argv[1], sys.argv[2]
rec = jd.lower_cell(arch, shape, make_test_mesh(), multi_pod=False,
                    cfg=get_config(arch + "-smoke"))
print("HIST " + json.dumps(rec["collective_group_sizes"]))
"""


def test_a_recurrent_prefill_cell_records_counted_collectives(monkeypatch):
    """zamba2-2.7b's prefill_32k on the single-pod production mesh at full
    width, cut to one super block (6 Mamba2 units and one shared-block
    site): the placed prefill runs on the fake world, its states on the
    batch shard, and the record holds the three collective fields. Each
    group lies along the data axis, the model axis or both; taken to the
    test mesh (data 2, model 4) by the axes it spans, the group sizes are
    the set of the reference's HLO histogram for the smoke cell there
    (the counts differ by design: the port counts what one step executes,
    the reference each instruction)."""
    import subprocess
    import sys
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_CELL, "zamba2-2.7b",
         "prefill_32k"], env=dict(os.environ, PYTHONPATH="src",
                                  OMP_NUM_THREADS="1"),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        full = configs.get_config("zamba2-2.7b")
        cfg = dataclasses.replace(full, n_layers=full.shared_attn_every)
        seen = []
        count = dryrun.step_collectives
        monkeypatch.setattr(dryrun, "step_collectives", lambda *a, **k:
                            seen.append(count(*a, **k)) or seen[-1])
        mesh = tmesh.make_production_mesh()
        rec = dryrun.lower_cell("zamba2-2.7b", "prefill_32k", mesh,
                                multi_pod=False, cfg=cfg)
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    lines = [line for line in stdout.splitlines() if line.startswith("HIST ")]
    assert lines, stdout + stderr
    want = {int(k) for k in json.loads(lines[0][5:])}
    assert "collectives_reason" not in rec and "error" not in rec, rec
    assert rec["wire_bytes_per_device"] > 0
    assert sum(rec["collective_group_sizes"].values()) == sum(
        v["count"] for v in rec["collectives"].values()) > 0
    records, why = seen[0]
    assert why is None, why
    layout = np.arange(mesh.size).reshape(mesh.shape)
    test_sizes = tmesh.make_test_mesh().axis_sizes
    sizes = set()
    for r in records:
        coords = np.argwhere(np.isin(layout, r.ranks))
        spans = [a for i, a in enumerate(mesh.axis_names)
                 if len(set(coords[:, i])) > 1]
        assert len(coords) == math.prod(mesh.axis_sizes[a] for a in spans)
        sizes.add(math.prod(test_sizes[a] for a in spans))
    assert sizes == want, (sizes, want)
