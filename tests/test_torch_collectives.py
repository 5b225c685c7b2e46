"""The port's collective statistics (``repro_torch.utils.collectives``) and
the dry-run's collective fields against the reference's
``repro/utils/hlo.py`` and its compiled programs.

  (a) the per-kind formulas: the same collectives as HLO lines for the
      reference's parser (a JAX-free module) and as the port's records give
      the same count, result bytes and wire bytes, and the same histogram;
  (b) the recorder records each collective once, per kind, eager and
      functional, on a fake world of 8 ranks;
  (c) against the reference's compiled HLO on 8 fake devices (a subprocess
      with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``; the
      reference's dry-run module is imported only there, after the device
      count is fixed), qwen2-7b-smoke on ``make_test_mesh(multi_pod=True)``:
      no collective of the multi-pod train step spans the two pods, in
      either package; the outer exchange's cross-pod wire bytes are equal,
      fp32 and int8. Both packages' group-size histograms of the six smoke
      cells are printed (``-s``);
  (d) the production meshes, full width cut to 2 layers (qwen2-7b,
      granite-moe), meta tensors on a fake world: the multi-pod train_4k
      step has no group of size 2 and none of 32 or more (``hlo.py``'s own
      criterion), and the outer exchange's size-2 (pod) collectives carry
      4 bytes for each element of the pseudo-gradient's shards.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.utils import hlo
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.utils import collectives as coll

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HLO_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")

# ------------------------------------------------------------ (a) formulas


def _groups_text(g, n, iota):
    if iota:
        return f"replica_groups=[{n // g},{g}]<=[{n}]"
    groups = [",".join(str(i) for i in range(j, j + g))
              for j in range(0, n, g)]
    return "replica_groups={{" + "},{".join(groups) + "}}"


def _hlo_line(kind, shape, g, iota):
    dims = ",".join(str(d) for d in shape)
    if kind == "collective-permute":
        groups = "source_target_pairs={{0,1},{1,0}}"
    else:
        groups = _groups_text(g, 16, iota)
    return (f"  %{kind}.7 = f32[{dims}]{{1,0}} {kind}(%p.1), channel_id=1, "
            f"{groups}, use_global_device_ids=true")


@pytest.mark.parametrize("g", [2, 4, 16])
def test_formulas_equal_the_references_collective_stats(g):
    lines, records = [], []
    for i, kind in enumerate(HLO_KINDS):
        for j, shape in enumerate(((64, 32), (3, 5 + i), (128, 7))):
            lines.append(_hlo_line(kind, shape, g, iota=bool(j % 2)))
            # a collective-permute's pairs are a group of two
            ranks = tuple(range(2 if kind == "collective-permute" else g))
            records.append(coll.Collective(kind, "op", ranks,
                                           4 * math.prod(shape)))
    lines.append("  %all-gather-done.3 = f32[8]{0} all-gather-done(%s)")
    text = "\n".join(lines)
    want = hlo.collective_stats(text)
    got = coll.collective_stats(records)
    assert set(got) == set(HLO_KINDS) | {"broadcast"}
    for kind in HLO_KINDS:
        assert got[kind] == want[kind], (kind, got[kind], want[kind])
    assert got["broadcast"] == {"count": 0, "result_bytes": 0,
                                "wire_bytes": 0}
    assert coll.total_wire_bytes(got) == hlo.total_wire_bytes(want)
    assert coll.group_size_histogram(records) == \
        hlo.group_size_histogram(text)
    for size in (2, g, 8):
        assert coll.has_axis_collectives(records, size) == \
            hlo.has_axis_collectives(text, 16, size)


def test_broadcast_wire_is_what_each_receiver_takes_in():
    """A broadcast's wire is its bytes: XLA's all-reduce over a group of
    two moves the same."""
    b = 4096
    stats = coll.collective_stats([coll.Collective("broadcast", "op",
                                                   (0, 4), b)])
    assert stats["broadcast"] == {"count": 1, "result_bytes": b,
                                  "wire_bytes": b}
    line = _hlo_line("all-reduce", (32, 32), 2, iota=False)
    assert hlo.collective_stats(line)["all-reduce"]["wire_bytes"] == b


# ------------------------------------------------------ (b) the recorder

def _one(rec, fn):
    """The records that ``fn()`` adds to ``rec``."""
    n = len(rec.records)
    fn()
    return rec.records[n:]


def _coalesced(group, fn):
    with dist._coalescing_manager(group=group, async_ops=True) as cm:
        fn()
    cm.wait()


def test_recorder_counts_each_collective_once_per_kind():
    """Each eager ``torch.distributed`` collective (its Python wrapper
    reaches the dispatcher as one ``c10d`` op; coalesced ones as one op)
    and each functional one (DTensor's) gives exactly one record, with its
    kind, group and result bytes: every entry of the recorder's tables;
    DTensor's implicit and explicit redistributions are recorded on their
    local tensors; ``wait_tensor`` is not a collective; a collective with
    no kind raises."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)

    def t(*shape):
        return torch.empty(shape, device="meta")

    with tmesh.abstract_world(tmesh.make_test_mesh()) as world:
        dm = world.device_mesh
        data = dm.get_group("data")           # ranks (0, 4)
        model = dm.get_group("model")         # ranks (0, 1, 2, 3)
        d, m = (0, 4), (0, 1, 2, 3)
        x = t(8, 16)                          # 512 bytes
        cases = [
            ("all_reduce", lambda: dist.all_reduce(x, group=data),
             "all-reduce", "c10d.allreduce_", d, 512),
            ("broadcast", lambda: dist.broadcast(x, src=0, group=model),
             "broadcast", "c10d.broadcast_", m, 512),
            ("all_gather", lambda: dist.all_gather(
                [t(8, 16) for _ in m], x, group=model),
             "all-gather", "c10d.allgather_", m, 2048),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                t(32, 16), x, group=model),
             "all-gather", "c10d._allgather_base_", m, 2048),
            ("reduce_scatter", lambda: dist.reduce_scatter(
                t(2, 16), [t(2, 16) for _ in m], group=model),
             "reduce-scatter", "c10d.reduce_scatter_", m, 128),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                t(2, 16), x, group=model),
             "reduce-scatter", "c10d._reduce_scatter_base_", m, 128),
            ("all_to_all_single", lambda: dist.all_to_all_single(
                t(8, 16), x, group=model),
             "all-to-all", "c10d.alltoall_base_", m, 512),
            ("funcol.all_reduce", lambda: funcol.wait_tensor(
                funcol.all_reduce(x, "sum", data)),
             "all-reduce", "_c10d_functional.all_reduce", d, 512),
            ("funcol.all_gather_tensor", lambda: funcol.wait_tensor(
                funcol.all_gather_tensor(x, 0, model)),
             "all-gather", "_c10d_functional.all_gather_into_tensor", m,
             2048),
            ("funcol.reduce_scatter_tensor", lambda: funcol.wait_tensor(
                funcol.reduce_scatter_tensor(x, "sum", 0, model)),
             "reduce-scatter", "_c10d_functional.reduce_scatter_tensor", m,
             128),
            ("funcol.all_to_all_single", lambda: funcol.wait_tensor(
                funcol.all_to_all_single(x, None, None, model)),
             "all-to-all", "_c10d_functional.all_to_all_single", m, 512),
            ("funcol.broadcast", lambda: funcol.wait_tensor(
                funcol.broadcast(x, 0, model)),
             "broadcast", "_c10d_functional.broadcast", m, 512),
            ("funcol.all_reduce_coalesced", lambda: [
                funcol.wait_tensor(y) for y in funcol.all_reduce_coalesced(
                    [x, t(4)], "sum", data)],
             "all-reduce", "_c10d_functional.all_reduce_coalesced", d, 528),
            ("funcol.all_gather_into_tensor_coalesced", lambda: [
                funcol.wait_tensor(y) for y in
                funcol.all_gather_into_tensor_coalesced([x, t(4)], model)],
             "all-gather",
             "_c10d_functional.all_gather_into_tensor_coalesced", m, 2112),
            ("funcol.reduce_scatter_tensor_coalesced", lambda: [
                funcol.wait_tensor(y) for y in
                funcol.reduce_scatter_tensor_coalesced(
                    [x, t(4)], "sum", [0, 0], model)],
             "reduce-scatter",
             "_c10d_functional.reduce_scatter_tensor_coalesced", m, 132),
        ]
        # the eager coalesced ops have no meta kernel: CPU tensors, which
        # the fake group leaves as they are; the functional ops' in-place
        # and out= forms called directly
        F = torch.ops._c10d_functional
        z, gn = torch.zeros(8, 16), model.group_name
        world8 = tuple(range(8))
        cases += [
            ("all_reduce_coalesced", lambda: dist.all_reduce_coalesced(
                [z, torch.zeros(4)], group=data),
             "all-reduce", "c10d.allreduce_coalesced_", d, 528),
            ("all_gather_coalesced", lambda: dist.all_gather_coalesced(
                [[torch.zeros(8, 16)] for _ in world8], [z]),
             "all-gather", "c10d.allgather_coalesced_", world8, 4096),
            ("all_gather_into_tensor, coalesced", lambda: _coalesced(
                model, lambda: (
                    dist.all_gather_into_tensor(torch.zeros(32, 16), z,
                                                group=model, async_op=True),
                    dist.all_gather_into_tensor(
                        torch.zeros(16), torch.zeros(4), group=model,
                        async_op=True))),
             "all-gather", "c10d.allgather_into_tensor_coalesced_", m, 2112),
            ("reduce_scatter_tensor, coalesced", lambda: _coalesced(
                model, lambda: (
                    dist.reduce_scatter_tensor(torch.zeros(2, 16), z,
                                               group=model, async_op=True),
                    dist.reduce_scatter_tensor(
                        torch.zeros(1), torch.zeros(4), group=model,
                        async_op=True))),
             "reduce-scatter", "c10d.reduce_scatter_tensor_coalesced_", m,
             132),
            ("all_to_all", lambda: dist.all_to_all(
                [t(2, 16) for _ in m], [t(2, 16) for _ in m], group=model),
             "all-to-all", "c10d.alltoall_", m, 512),
            ("F.all_reduce_", lambda: F.wait_tensor(
                F.all_reduce_(z, "sum", gn)),
             "all-reduce", "_c10d_functional.all_reduce_", m, 512),
            ("F.all_reduce_coalesced_", lambda: [
                F.wait_tensor(y) for y in F.all_reduce_coalesced_(
                    [z, torch.zeros(4)], "sum", gn)],
             "all-reduce", "_c10d_functional.all_reduce_coalesced_", m, 528),
            ("F.all_gather_into_tensor_out", lambda: F.wait_tensor(
                F.all_gather_into_tensor_out(z, 4, gn,
                                             out=torch.zeros(32, 16))),
             "all-gather", "_c10d_functional.all_gather_into_tensor_out", m,
             2048),
            ("F.reduce_scatter_tensor_out", lambda: F.wait_tensor(
                F.reduce_scatter_tensor_out(z, "sum", 4, gn,
                                            out=torch.zeros(2, 16))),
             "reduce-scatter", "_c10d_functional.reduce_scatter_tensor_out",
             m, 128),
            ("F.broadcast_", lambda: F.wait_tensor(F.broadcast_(z, 0, gn)),
             "broadcast", "_c10d_functional.broadcast_", m, 512),
        ]
        with coll.CollectiveRecorder() as rec:
            for name, fn, kind, op, ranks, nbytes in cases:
                got = _one(rec, fn)
                assert got == [coll.Collective(kind, op, ranks, nbytes)], \
                    (name, got)
            # DTensor: an explicit redistribution, and the all-gather that
            # a product's sharding propagation inserts
            a = DTensor.from_local(t(8, 16), dm, (Shard(0), Replicate()),
                                   run_check=False)
            got = _one(rec, lambda: a.redistribute(dm, (Replicate(),
                                                        Replicate())))
            assert got == [coll.Collective(
                "all-gather", "_c10d_functional.all_gather_into_tensor", d,
                1024)], got
            p = DTensor.from_local(t(8, 16), dm, (Replicate(), Partial()),
                                   run_check=False)
            got = _one(rec, lambda: p.redistribute(dm, (Replicate(),
                                                        Replicate())))
            assert got == [coll.Collective(
                "all-reduce", "_c10d_functional.all_reduce", m, 512)], got
            # (16, 16) @ (16, 32), both rows over data: the product's
            # strategy gathers one of them over data first
            w = DTensor.from_local(t(8, 32), dm, (Shard(0), Replicate()),
                                   run_check=False)
            got = _one(rec, lambda: torch.mm(a, w))
            assert [(r.kind, r.ranks) for r in got] == \
                [("all-gather", d)], got
            # a Shard-to-Shard redistribution: one all-to-all on a CUDA
            # mesh (meta tensors need no card), an all-gather and a chunk
            # on a CPU one
            from torch.distributed.device_mesh import DeviceMesh
            for dev, want in (("cuda", [coll.Collective(
                    "all-to-all", "_dtensor.shard_dim_alltoall", m, 256)]),
                    ("cpu", [coll.Collective(
                        "all-gather",
                        "_c10d_functional.all_gather_into_tensor", m,
                        1024)])):
                mesh = DeviceMesh(dev, torch.arange(8).reshape(2, 4),
                                  mesh_dim_names=("data", "model"))
                s0 = DTensor.from_local(t(4, 16), mesh,
                                        (Replicate(), Shard(0)),
                                        run_check=False)
                got = _one(rec, lambda: s0.redistribute(
                    mesh, (Replicate(), Shard(1))))
                assert got == want, (dev, got)
            with pytest.raises(NotImplementedError, match="no kind"):
                dist.reduce(x, dst=0, group=model)
    assert not dist.is_initialized()


def test_abstract_world_refuses_a_second_group_and_cleans_up():
    with tmesh.abstract_world(tmesh.make_production_mesh(multi_pod=True)) \
            as world:
        assert dist.get_world_size() == 512 and dist.get_rank() == 0
        assert world.device_mesh.shape == (2, 16, 16)
        assert world.axis_sizes == {"pod": 2, "data": 16, "model": 16}
        with pytest.raises(RuntimeError, match="no process group"):
            with tmesh.abstract_world(tmesh.make_test_mesh()):
                pass
    assert not dist.is_initialized()


def test_placed_arguments_make_the_steps_placement_a_no_op():
    """An argument placed before the count (``DTensor.from_local`` of a
    meta shard, no collective) is at its spec already: the step's own
    ``place`` of it runs no collective and keeps it."""
    cfg = configs.reduced(configs.get_config("qwen2-7b"))
    params = dryrun.abstract_params(cfg)
    with tmesh.abstract_world(tmesh.make_test_mesh()) as world:
        pspecs = shd.param_specs(params, axis_sizes=world.axis_sizes)
        with coll.CollectiveRecorder() as rec:
            placed = dryrun.abstract_placed(params, pspecs, world, "meta")
            again = {k: shd.place(v, pspecs[k], world, k)
                     for k, v in placed.items()}
        assert rec.records == []
        for k, v in placed.items():
            assert again[k].placements == v.placements
            assert again[k].to_local().shape == v.to_local().shape == \
                shd.shard_shape(params[k].shape, pspecs[k],
                                world.axis_sizes)
            assert v.shape == params[k].shape


# ---------------------------------------- (c) against the reference's HLO

_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.devices()   # the device count is fixed before the dry-run module
from repro.configs import get_config
from repro.launch import dryrun as jd
from repro.launch.mesh import make_test_mesh
from repro.utils import hlo

lines = {}
analyze = jd._analyze
def keep(lowered, compiled, seconds):
    rec = analyze(lowered, compiled, seconds)
    rec["lines"] = [l for l in compiled.as_text().splitlines()
                    if hlo._LINE.search(l) and "-done(" not in l]
    return rec
jd._analyze = keep
cfg = get_config("qwen2-7b-smoke")
out = {}
for shape in ("train_4k", "prefill_32k", "decode_32k"):
    for multi in (False, True):
        rec = jd.lower_cell("qwen2-7b", shape, make_test_mesh(
            multi_pod=multi), multi_pod=multi, cfg=cfg)
        out[f"{shape}/{'multi' if multi else 'single'}"] = {
            "lines": rec["lines"], "hist": rec["collective_group_sizes"]}
for int8 in (False, True):
    rec = jd.lower_outer_exchange("qwen2-7b-smoke",
                                  make_test_mesh(multi_pod=True),
                                  compress_int8=int8)
    out[f"exchange/{int8}"] = {"lines": rec["lines"],
                               "hist": rec["collective_group_sizes"]}
json.dump(out, open(sys.argv[1], "w"))
print("REFERENCE_OK")
"""


def replica_groups(line, n=8):
    """The groups of an HLO collective line on ``n`` devices, as lists of
    device ids: the explicit ``{{0,4},{1,5}}`` form, the iota
    ``[a,b]<=[dims]T(perm)`` form (iota over prod(dims), reshaped to dims,
    transposed by perm, reshaped to a groups of b), the empty form (one
    group of all), and a collective-permute's ``source_target_pairs``."""
    import re
    m = re.search(r"replica_groups=\{(\{[\d,]*\}(?:,\{[\d,]*\})*)\}", line)
    if m:
        return [[int(i) for i in g.split(",") if i]
                for g in re.findall(r"\{([\d,]*)\}", m.group(1))]
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\]"
                  r"(?:T\(([\d,]+)\))?", line)
    if m:
        a, b = int(m.group(1)), int(m.group(2))
        dims = [int(d) for d in m.group(3).split(",")]
        ids = np.arange(math.prod(dims)).reshape(dims)
        if m.group(4):
            ids = ids.transpose([int(p) for p in m.group(4).split(",")])
        return ids.reshape(a, b).tolist()
    if "replica_groups={}" in line:
        return [list(range(n))]
    m = re.search(r"source_target_pairs=(\{[{}\d,]*\})", line)
    if m:
        return [[int(a), int(b)]
                for a, b in re.findall(r"\{(\d+),(\d+)\}", m.group(1))]
    raise AssertionError(f"no replica groups in {line[:200]}")


def test_replica_group_forms_parse():
    assert replica_groups("replica_groups={{0,4},{2,6},{1,5},{3,7}}, x") == \
        [[0, 4], [2, 6], [1, 5], [3, 7]]
    assert replica_groups("replica_groups=[4,2]<=[8], x") == \
        [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert replica_groups("replica_groups=[4,2]<=[2,2,2]T(0,2,1), x") == \
        [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert replica_groups("replica_groups=[4,2]<=[2,2,2]T(1,0,2), x") == \
        [[0, 1], [4, 5], [2, 3], [6, 7]]
    assert replica_groups("replica_groups=[2,4]<=[4,2]T(1,0), x") == \
        [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert replica_groups("replica_groups={}, x") == [list(range(8))]
    assert replica_groups("source_target_pairs={{0,1},{1,0}}, x") == \
        [[0, 1], [1, 0]]


PODS = ([0, 1, 2, 3], [4, 5, 6, 7])   # (pod 2, data 2, model 2), row-major


def _crosses(group):
    return sum(bool(set(group) & set(p)) for p in PODS) > 1


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """The reference's compiled collectives of the six smoke cells and the
    two exchanges (a subprocess, started first), and the port's records of
    the same, counted in this process meanwhile."""
    tmp = tmp_path_factory.mktemp("hlo")
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                            str(tmp / "ref.json")], env=env, cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        cfg = configs.get_config("qwen2-7b-smoke")
        port, memo = {}, {}
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            for multi in (False, True):
                port[f"{shape}/{'multi' if multi else 'single'}"] = \
                    dryrun.lower_cell("qwen2-7b", shape,
                                      tmesh.make_test_mesh(multi_pod=multi),
                                      multi_pod=multi, cfg=cfg, memo=memo)
        for int8 in (False, True):
            port[f"exchange/{int8}"] = dryrun.lower_outer_exchange(
                "qwen2-7b-smoke", tmesh.make_test_mesh(multi_pod=True),
                compress_int8=int8)
        records = {"train_4k/multi": dryrun.step_collectives(
            dryrun._planned(cfg, port["train_4k/multi"]["plan"]),
            configs.SHAPES["train_4k"], port["train_4k/multi"]["plan"],
            tmesh.make_test_mesh(multi_pod=True), multi_pod=True)[0]}
        for int8 in (False, True):
            records[f"exchange/{int8}"] = dryrun.exchange_collectives(
                cfg, tmesh.make_test_mesh(multi_pod=True),
                compress_int8=int8)[0]
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert "REFERENCE_OK" in stdout, stdout + stderr
    with open(tmp / "ref.json") as f:
        return json.load(f), port, records


def test_six_smoke_cells_and_exchanges_have_counts(smoke):
    """Every record holds the reference's three fields and says what was
    counted; both packages' histograms are printed for the record."""
    ref, port, _ = smoke
    assert set(ref) == set(port)
    table = {}
    for name, rec in port.items():
        assert rec["collectives_counted"].startswith("executed in one step")
        assert set(rec["collectives"]) == set(coll.KINDS)
        assert rec["wire_bytes_per_device"] == coll.total_wire_bytes(
            rec["collectives"])
        assert sum(rec["collective_group_sizes"].values()) == sum(
            v["count"] for v in rec["collectives"].values()) > 0
        table[name] = {"reference": {int(k): v for k, v in
                                     ref[name]["hist"].items()},
                       "port": rec["collective_group_sizes"]}
    print("GROUP_SIZE_HISTOGRAMS " + json.dumps(table, sort_keys=True))


def test_multipod_train_crosses_no_pod_in_either_package(smoke):
    ref, _, records = smoke
    lines = ref["train_4k/multi"]["lines"]
    assert lines
    crossing = [line for line in lines
                if any(_crosses(g) for g in replica_groups(line))]
    assert crossing == []
    port = records["train_4k/multi"]
    assert port and not [r for r in port if _crosses(r.ranks)]


@pytest.mark.parametrize("int8", [False, True])
def test_exchange_cross_pod_wire_equals_the_references_hlo(smoke, int8):
    """The bytes that cross the pod axis per device: the reference's
    all-reduces over the pod pairs, the port's broadcasts, both the fp32
    pseudo-gradient's shards (168,192 B for qwen2-7b-smoke on this mesh),
    with and without int8."""
    ref, port, records = smoke
    lines = [line for line in ref[f"exchange/{int8}"]["lines"]
             if any(_crosses(g) for g in replica_groups(line))]
    want = hlo.total_wire_bytes(hlo.collective_stats("\n".join(lines)))
    crossing = [r for r in records[f"exchange/{int8}"] if _crosses(r.ranks)]
    assert {r.kind for r in crossing} == {"broadcast"}
    got = coll.total_wire_bytes(coll.collective_stats(crossing))
    assert got == want == 168_192, (got, want)
    rec = port[f"exchange/{int8}"]
    assert rec["collectives"]["broadcast"]["wire_bytes"] == got
    # the modelled wire format: fp32 is what moves; int8 would be smaller
    delta_in = rec["pod_axis_bytes_per_device"]["delta_in"]
    assert (delta_in == got) if not int8 else (delta_in < got / 3)


# -------------------------------- (d) the production meshes at full width

@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-1b-a400m"])
def test_production_multipod_train_and_exchange(arch):
    shape = configs.SHAPES["train_4k"]
    plan = dryrun.plan_for(arch, shape)
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=2)
    mesh = tmesh.make_production_mesh(multi_pod=True)
    records, why = dryrun.step_collectives(dryrun._planned(cfg, plan), shape,
                                           plan, mesh, multi_pod=True)
    assert why is None, why
    hist = coll.group_size_histogram(records)
    assert hist and not coll.has_axis_collectives(records, 2), hist
    assert max(hist) < 32, hist
    records, why = dryrun.exchange_collectives(cfg, mesh)
    assert why is None, why
    params = dryrun.abstract_params(cfg)
    pspecs = shd.param_specs(params, axis_sizes=mesh.axis_sizes)
    elements = sum(math.prod(shd.shard_shape(x.shape, pspecs[k],
                                             mesh.axis_sizes))
                   for k, x in params.items())
    pod = [r for r in records if len(r.ranks) == 2]
    assert {r.kind for r in pod} == {"broadcast"}
    assert len(pod) == len(params)
    assert sum(r.result_bytes for r in pod) == 4 * elements
