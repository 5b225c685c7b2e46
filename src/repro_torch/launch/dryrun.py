"""Multi-pod dry-run of the port: every (architecture x input shape x mesh)
cell of the reference's plan, on the abstract production meshes and meta
tensors, with no allocation and no device.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell for 256 or 512 fake TPU devices and reads XLA's analyses of the
compiled program. The port compiles nothing; ``lower_cell`` instead:

  * applies the sharding rules (``dist.sharding``) and checks that every
    placement divides its dim (a cell whose placement does not divide
    raises, and its record holds the error);
  * records the per-device argument bytes from the placements: params,
    AdamW state (fp32 moments, int32 count) and step, batch, caches (with
    the pod axis ahead of every spec on the multi-pod train cell);
  * records ``flops_total`` of one step, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` on meta tensors (prefill
    on CPU fake tensors: its attention goes through the flash kernel's
    wrapper, which runs the plain version only for CPU tensors). The
    counter counts matmul-class operations (mm, bmm, addmm, baddbmm,
    convolution, attention), not elementwise ones. A train step runs the
    plan's memory plan: attention in query chunks of ``q_chunk`` and,
    under the config's ``remat``, checkpoints of ``remat_group`` layers,
    whose forward runs again in the backward and is counted again, as
    XLA counts a rematerialised program (up to each checkpoint's last
    product: no backward needs its output, so it is not recomputed).
    Microbatches and pods have the same shapes, so one microbatch of one
    pod is counted and the total is that times ``grad_accum`` times the
    pods; ``flops_per_device`` is ``flops_total / n_devices``, an even
    split that the record states.
    Where a step cannot run on meta tensors the record holds
    ``flops_total: null`` and the reason. The plan's ``head_tp`` and
    ``seq_parallel`` go into the config as the reference's activation
    placements (``act_model_axis``, ``seq_parallel``): the steps apply
    them on a mesh of ranks, and on these abstract meshes they place
    nothing;
  * records ``collectives`` (per kind: count, result bytes, wire bytes),
    ``collective_group_sizes`` and ``wire_bytes_per_device``, the
    reference's fields, from the program the port runs: inside
    ``launch.mesh.abstract_world`` (a fake world of the mesh's 256 or 512
    ranks in this process, as rank 0), the cell's step is built as
    ``dist/steps.py`` builds it for a mesh of ranks, its arguments made
    DTensors at their placements (meta shards, ``DTensor.from_local``: no
    collective, as the reference's arguments arrive placed through
    ``in_shardings``), and one whole step runs under
    ``utils.collectives.CollectiveRecorder``: every microbatch's forward
    and backward and the AdamW update (the multi-pod step as rank 0, on
    its pod's ("data", "model") submesh); prefill on CPU fake tensors, as
    for its flops. The per-kind wire estimates are the reference's
    (``utils.collectives``). The count is of collectives executed, where
    the reference counts HLO instructions, a while loop's body once
    (``collectives_counted`` says so); where the step cannot run on
    abstract tensors the fields are null and ``collectives_reason`` holds
    why;
  * ``lower_outer_exchange`` records the pod-axis bytes per device of the
    arriving pseudo-gradient in its modelled wire format (fp32, or int8
    and a scale), and of the look-ahead sent back; and the collectives of
    the placed exchange, which broadcasts the pseudo-gradient's fp32
    shards over ``pod``, as the reference's program moves them.

The fields the reference reads from XLA's compiled program that have no
counterpart here (temporary and code bytes, XLA's cost and memory
analyses) are named under ``not_modelled`` with the reason.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both] [--out results/torch_dryrun]
        [--outer-exchange] [--compress-int8] [--skip-existing]
        [--plan JSON] [--tag T]

Records are written as ``<out>/<arch>__<shape>__<single|multi>[__tag].json``
(the reference's names); the reference's own directory, ``results/dryrun``,
is refused. Nothing is set in the environment at import.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.configs.base import (HeLoCoConfig, InnerOptConfig,
                                      ModelConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import Spec
from repro_torch.launch.inputs import abstract_params, input_specs
from repro_torch.launch.mesh import (Mesh, abstract_world,
                                     make_production_mesh, mesh_context)
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamState
from repro_torch.utils import collectives as coll

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_OUT = "results/torch_dryrun"
REFERENCE_OUT = "results/dryrun"

# --------------------------------------------------------------------------
# Per-cell execution plan (the reference's baseline; --plan overrides)
# --------------------------------------------------------------------------

GRAD_ACCUM = {
    "zamba2-2.7b": 8, "qwen2-7b": 4, "granite-3-8b": 8, "command-r-35b": 8,
    "starcoder2-15b": 8, "granite-moe-1b-a400m": 4, "llama4-scout-17b-a16e": 8,
    "hubert-xlarge": 2, "xlstm-125m": 4, "paligemma-3b": 2,
}
Q_CHUNK = {"train": 512, "prefill": 256, "decode": 0}


def plan_for(arch: str, shape: ShapeConfig, overrides: Optional[Dict] = None
             ) -> Dict[str, Any]:
    plan = {
        "grad_accum": GRAD_ACCUM.get(arch, 4) if shape.kind == "train" else 1,
        "q_chunk": Q_CHUNK[shape.kind] or 128,
    }
    if overrides:
        plan.update(overrides)
    return plan


_HLO = "read from XLA's compiled program by the reference; the port " \
       "compiles no program"
NOT_MODELLED = {
    "temp_bytes": _HLO, "code_bytes": _HLO,
    "bytes_per_device": "XLA's cost analysis in the reference",
    "output_bytes": "XLA's memory analysis in the reference",
    "alias_bytes": "XLA's memory analysis in the reference",
    "peak_estimate_bytes": "needs temp_bytes",
}
FLOPS_COUNTED = (
    "torch.utils.flop_counter.FlopCounterMode on meta tensors (prefill: CPU "
    "fake tensors through the kernels' plain versions): matmul-class "
    "operations only; one microbatch of one pod counted, times grad_accum "
    "and the pods")
FLOPS_SPLIT = "even: flops_total / n_devices"
COLLECTIVES_COUNTED = (
    "executed in one step by rank 0 of a fake world of {n} ranks; the "
    "reference counts each HLO instruction once, a while loop's body "
    "(scanned layers, the grad-accum loop) once. The world's mesh is a CPU "
    "mesh, on which DTensor runs a Shard-to-Shard redistribution as an "
    "all-gather and a chunk (one all-to-all on a CUDA mesh)")


# --------------------------------------------------------------------------
# Per-device bytes from the placements
# --------------------------------------------------------------------------

def tree_bytes(tree: Any, specs: Any, axis_sizes: Dict[str, int]) -> int:
    """Per-device bytes of a tree of tensors under a tree of specs of the
    same structure; raises ValueError where a placement does not divide."""
    specs = shd.tree_leaves(specs)
    total = 0
    for path, x in shd.tree_leaves(tree).items():
        shard = shd.shard_shape(x.shape, specs[path], axis_sizes, path)
        total += math.prod(shard) * x.element_size()
    return total


def _pod(tree: Any, specs: Any):
    """The tree with a leading pod axis of 2 on every leaf, and its specs
    with ``pod`` ahead (a per-pod replica)."""
    return (shd.tree_map(lambda _, x: torch.empty(
                (2,) + tuple(x.shape), dtype=x.dtype, device="meta"), tree),
            shd.tree_map(lambda _, s: Spec(("pod",) + tuple(s)), specs))


def _scalar(dtype=torch.int32) -> torch.Tensor:
    return torch.empty((), dtype=dtype, device="meta")


def cell_arguments(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *,
                   multi_pod: bool, attn_style: str = "tp"):
    """Every argument of the cell's step as ``{name: (tree, specs)}``, as
    the reference's ``jax.jit(...).lower`` takes them: train (params, AdamW
    mu and nu in fp32, its int32 count, the int32 step, the batch), prefill
    (params, batch), decode (params, token, caches, pos)."""
    axis_sizes = mesh.axis_sizes
    data_axes = ("pod", "data") if multi_pod else ("data",)
    params = abstract_params(cfg)
    pspecs = shd.param_specs(params, axis_sizes=axis_sizes,
                             attn_style=attn_style)
    ins = input_specs(cfg, shape)
    if shape.kind == "train":
        f32 = {k: torch.empty(x.shape, dtype=torch.float32, device="meta")
               for k, x in params.items()}
        args = {"params": (params, pspecs), "opt.mu": (f32, pspecs),
                "opt.nu": (f32, pspecs),
                "opt.count": (_scalar(), Spec(())),
                "step": (_scalar(), Spec(()))}
        if multi_pod:
            args = {k: _pod(*v) for k, v in args.items()}
            args["batch"] = _pod(ins["batch"], shd.batch_specs(
                ins["batch"], batch_axes=("data",)))
        else:
            args["batch"] = (ins["batch"], shd.batch_specs(
                ins["batch"], batch_axes=data_axes))
        return args
    if shape.kind == "prefill":
        return {"params": (params, pspecs),
                "batch": (ins["batch"], shd.batch_specs(
                    ins["batch"], batch_axes=data_axes))}
    batch_sharded = shape.global_batch >= axis_sizes.get("data", 1)
    cspecs = shd.cache_specs(
        ins["caches"], batch_sharded=batch_sharded, axis_sizes=axis_sizes,
        data_axis=data_axes if multi_pod else "data")
    return {"params": (params, pspecs),
            "token": (ins["token"],
                      Spec((data_axes,)) if batch_sharded else Spec((None,))),
            "caches": (ins["caches"], cspecs),
            "pos": (ins["pos"], Spec(()))}


def argument_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *,
                   multi_pod: bool, attn_style: str = "tp") -> Dict[str, int]:
    """Per-device bytes of each argument of the cell's step."""
    return {name: tree_bytes(tree, specs, mesh.axis_sizes)
            for name, (tree, specs) in cell_arguments(
                cfg, shape, mesh, multi_pod=multi_pod,
                attn_style=attn_style).items()}


# --------------------------------------------------------------------------
# Operations counted on abstract tensors
# --------------------------------------------------------------------------

def count_flops(fn: Callable[[], Any]):
    """(flops, None) of ``fn()`` under ``FlopCounterMode``, or (None, the
    reason) when it cannot run on abstract tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    try:
        with counter:
            fn()
    except Exception as e:   # the record keeps what stopped the count
        return None, f"{type(e).__name__}: {e}"
    return float(counter.get_total_flops()), None


def _abstract(tree: Any, device) -> Any:
    """Fresh tensors of ``tree``'s shapes and dtypes on ``device`` (the
    meta device, or CPU inside ``FakeTensorMode``), int32 widened to the
    int64 PyTorch indexes with."""
    return shd.tree_map(lambda _, x: torch.empty(
        x.shape, dtype=torch.long if x.dtype == torch.int32 else x.dtype,
        device=device), tree)


def step_flops(cfg: ModelConfig, shape: ShapeConfig, plan: Dict[str, Any]):
    """(flops of one step of one pod, None) or (None, reason): a train
    step's forward and backward of one microbatch (attention in chunks of
    the plan's ``q_chunk``, the forward of every checkpoint counted again
    under ``cfg.remat``) times ``grad_accum``; a prefill; one decode step
    at the cache's last position."""
    model = build_model(cfg)
    ins = input_specs(cfg, shape)
    if shape.kind == "train":
        ga = int(plan["grad_accum"])
        if shape.global_batch % ga:
            return None, (f"batch {shape.global_batch} is not {ga} equal "
                          "microbatches")
        micro = shd.tree_map(lambda _, x: torch.empty(
            (x.shape[0] // ga,) + tuple(x.shape[1:]), dtype=x.dtype,
            device="meta"), ins["batch"])

        def one():
            params = {k: v.requires_grad_(True) for k, v in _abstract(
                model.param_specs(), "meta").items()}
            loss = model.loss(params, _abstract(micro, "meta"),
                              q_chunk=int(plan["q_chunk"]))
            torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
        flops, why = count_flops(one)
        return (None, why) if flops is None else (flops * ga, None)
    if shape.kind == "prefill":
        from torch._subclasses.fake_tensor import FakeTensorMode

        def one():
            with FakeTensorMode():
                model.prefill(_abstract(model.param_specs(), "cpu"),
                              _abstract(ins["batch"], "cpu"),
                              cache_len=shape.seq_len)
        return count_flops(one)

    def one():
        model.decode(_abstract(model.param_specs(), "meta"),
                     _abstract(ins["token"], "meta"),
                     _abstract(ins["caches"], "meta"), shape.seq_len - 1)
    return count_flops(one)


# --------------------------------------------------------------------------
# Collectives counted on a fake world
# --------------------------------------------------------------------------

def _placed(x: torch.Tensor, spec: Spec, mesh: Mesh, device) -> Any:
    """A tensor of ``x``'s shape and dtype at ``spec``'s placements on
    ``mesh``: this rank's shard, fresh on ``device``, as a DTensor (no
    collective)."""
    from torch.distributed.tensor import DTensor
    local = shd.shard_shape(x.shape, spec, mesh.axis_sizes)
    return DTensor.from_local(
        torch.empty(local, dtype=x.dtype, device=device), mesh.device_mesh,
        shd.placements(spec, mesh), run_check=False,
        shape=torch.Size(x.shape), stride=torch.empty(
            x.shape, device="meta").stride())


def abstract_placed(tree: Any, specs: Any, mesh: Mesh, device) -> Any:
    """Every leaf of ``tree`` as ``_placed`` at its spec in ``specs``."""
    flat = shd.tree_leaves(specs)
    return shd.tree_map(lambda path, x: _placed(x, flat[path], mesh, device),
                        tree)


def _abstract_mode(fake: bool):
    """(a context, the device of the abstract tensors made in it): CPU
    fake tensors (``FakeTensorMode``) where the program takes the kernels'
    plain versions, which run only for CPU tensors; else meta tensors."""
    if not fake:
        return contextlib.nullcontext(), "meta"
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(), "cpu"


def count_collectives(fn: Callable[[], Callable[[], Any]]):
    """(records, None) of the step that ``fn()`` builds, run under
    ``CollectiveRecorder`` (what ``fn`` itself runs, the placement of the
    arguments, is not recorded), or (None, the reason) when it cannot
    run on abstract tensors."""
    try:
        run = fn()
        with coll.CollectiveRecorder() as rec:
            run()
    except Exception as e:   # the record keeps what stopped the count
        return None, f"{type(e).__name__}: {e}"
    return rec.records, None


def step_collectives(cfg: ModelConfig, shape: ShapeConfig,
                     plan: Dict[str, Any], mesh: Mesh, *, multi_pod: bool,
                     attn_style: str = "tp"):
    """(records, None) or (None, reason): the collectives of one whole step
    of the cell's placed program on ``mesh``, as rank 0 of a fake world of
    its size (``abstract_world``), its arguments at ``cell_arguments``'
    placements before the count: a train step's every microbatch, forward,
    backward and AdamW update (the multi-pod step on rank 0's pod), a
    prefill (on CPU fake tensors), one decode step at the cache's last
    position."""
    from repro_torch.dist import steps
    mode, device = _abstract_mode(fake=shape.kind == "prefill")
    with abstract_world(mesh) as world, mesh_context(world), mode:
        def build():
            args = {name: abstract_placed(tree, specs, world, device)
                    for name, (tree, specs) in cell_arguments(
                        cfg, shape, world, multi_pod=multi_pod,
                        attn_style=attn_style).items()}
            if shape.kind == "prefill":
                step = steps.make_prefill_step(cfg, cache_len=shape.seq_len)
                return lambda: step(args["params"], args["batch"])
            if shape.kind == "decode":
                step = steps.make_decode_step(cfg)
                return lambda: step(args["params"], args["token"],
                                    args["caches"], shape.seq_len - 1)
            pspecs = shd.param_specs(abstract_params(cfg),
                                     axis_sizes=world.axis_sizes,
                                     attn_style=attn_style)
            kw = dict(grad_accum=int(plan["grad_accum"]),
                      q_chunk=int(plan["q_chunk"]), param_pspecs=pspecs)
            step = (steps.make_multipod_train_step(
                cfg, InnerOptConfig(), world, **kw) if multi_pod else
                steps.make_train_step(cfg, InnerOptConfig(), **kw))
            state = steps.TrainState(args["params"], AdamState(
                args["opt.mu"], args["opt.nu"], 0), 0)
            return lambda: step(state, args["batch"])
        return count_collectives(build)


def collective_fields(records, n_devices: int) -> Dict[str, Any]:
    """The reference's three fields from a count's records, and what was
    counted."""
    stats = coll.collective_stats(records)
    return {"collectives": stats,
            "collective_group_sizes": coll.group_size_histogram(records),
            "wire_bytes_per_device": coll.total_wire_bytes(stats),
            "collectives_counted": COLLECTIVES_COUNTED.format(n=n_devices)}


def _uncounted_fields(why: str) -> Dict[str, Any]:
    return {"collectives": None, "collective_group_sizes": None,
            "wire_bytes_per_device": None, "collectives_reason": why}


# --------------------------------------------------------------------------
# Cells
# --------------------------------------------------------------------------

def _planned(cfg: ModelConfig, plan: Dict[str, Any]) -> ModelConfig:
    """The reference's per-plan config: activation hints, the layers a
    remat checkpoint groups and, for an MoE, its dispatch group and
    mode."""
    cfg = dataclasses.replace(
        cfg, act_batch_axes=("data",),
        act_model_axis=("model" if plan.get("head_tp") else ""),
        seq_parallel=bool(plan.get("seq_parallel")),
        remat_group=int(plan.get("remat_group", 1)))
    if cfg.is_moe and (plan.get("moe_group") or plan.get("moe_dispatch")
                       or plan.get("moe_vmap")):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, group_size=int(plan.get("moe_group", cfg.moe.group_size)),
            group_mode=("vmap" if plan.get("moe_vmap")
                        else cfg.moe.group_mode),
            dispatch=plan.get("moe_dispatch", cfg.moe.dispatch)))
    return cfg


def lower_cell(arch: str, shape_name: str, mesh: Mesh, *, multi_pod: bool,
               overrides: Optional[Dict] = None,
               cfg: Optional[ModelConfig] = None,
               memo: Optional[Dict] = None) -> Dict[str, Any]:
    """One cell's record on the abstract ``mesh`` (see the module's
    docstring). ``memo`` keeps each (config, shape, plan)'s per-pod flops,
    so the multi-pod cell reuses its single-pod twin's. ``count_seconds``
    holds the seconds of each group of fields."""
    shape = SHAPES[shape_name]
    plan = plan_for(arch, shape, overrides)
    cfg = _planned(cfg or get_config(arch), plan)
    style = "dp" if plan.get("attn_dp") else "tp"
    seconds = {}
    t0 = time.perf_counter()
    args = argument_bytes(cfg, shape, mesh, multi_pod=multi_pod,
                          attn_style=style)
    seconds["argument_bytes"] = time.perf_counter() - t0
    key = json.dumps([dataclasses.asdict(cfg), shape_name, plan],
                     sort_keys=True, default=str)
    memo = {} if memo is None else memo
    t0 = time.perf_counter()
    if key not in memo:
        memo[key] = step_flops(cfg, shape, plan)
    flops, why = memo[key]
    seconds["flops"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    records, cwhy = step_collectives(cfg, shape, plan, mesh,
                                     multi_pod=multi_pod, attn_style=style)
    seconds["collectives"] = time.perf_counter() - t0
    pods = 2 if multi_pod and shape.kind == "train" else 1
    total = None if flops is None else flops * pods
    rec = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": "multi" if multi_pod else "single", "plan": plan,
        "n_devices": mesh.size, "axis_sizes": mesh.axis_sizes,
        "flops_total": total,
        "flops_per_device": None if total is None else total / mesh.size,
        "flops_split": FLOPS_SPLIT,
        **(_uncounted_fields(cwhy) if records is None
           else collective_fields(records, mesh.size)),
        "memory": {"argument_bytes": sum(args.values()),
                   "argument_bytes_by_input": args},
        "not_modelled": NOT_MODELLED,
        "count_seconds": seconds,
    }
    if total is None:
        rec["flops_reason"] = why
    else:
        rec["flops_counted"] = FLOPS_COUNTED
    return rec


def exchange_collectives(cfg: ModelConfig, mesh: Mesh, *,
                         compress_int8: bool = False,
                         method: str = "heloco"):
    """(records, None) or (None, reason): the collectives of the placed
    outer exchange (``dist.steps.make_outer_exchange`` with
    ``param_pspecs``) on ``mesh``, as rank 0 of a fake world of its size,
    on CPU fake tensors (the shards' reductions run on the kernels' route,
    their plain versions for CPU tensors): the arriving pod's
    pseudo-gradient shards broadcast over ``pod`` (fp32 with or without
    ``compress_int8``: the round trip runs after the transfer), the block
    sums and the int8 absmax all-reduced over the ranks that hold a leaf's
    other shards."""
    from repro_torch.dist import steps
    params = abstract_params(cfg)
    mode, device = _abstract_mode(fake=True)
    with abstract_world(mesh) as world, mesh_context(world), mode:
        def build():
            pspecs = shd.param_specs(params, axis_sizes=world.axis_sizes)
            mom = {k: torch.empty(x.shape, dtype=torch.float32,
                                  device="meta") for k, x in params.items()}
            p = abstract_placed(params, pspecs, world, device)
            m = abstract_placed(mom, pspecs, world, device)
            w = abstract_placed(*_pod(params, pspecs), world, device)
            fn = steps.make_outer_exchange(
                cfg, world, h=HeLoCoConfig(), outer_lr=0.7, mu=0.9,
                method=method, arriving_pod=0,
                stacked_axes=shd.stacked_axes_tree(params),
                compress_int8=compress_int8, param_pspecs=pspecs)
            return lambda: fn(p, m, w)
        return count_collectives(build)


def lower_outer_exchange(arch: str, mesh: Mesh, *,
                         compress_int8: bool = False,
                         method: str = "heloco") -> Dict[str, Any]:
    """The HeLoCo outer round on the multi-pod mesh: per-device argument
    bytes (params, fp32 momentum, the worker trees with the pod axis);
    ``pod_axis_bytes_per_device``, what crosses the pod axis per device in
    the modelled wire format: the arriving pod's pseudo-gradient shard
    (``delta_in``: fp32, or with ``compress_int8`` int8 and one fp32 scale
    a leaf) and the look-ahead shard sent back (the params' dtype); and
    the collectives of the placed exchange (``exchange_collectives``),
    what the program moves: the pseudo-gradient's shards cross in fp32,
    int8 or not, as they do in the reference's program. It has no
    matmul-class operation, so no flops are counted."""
    cfg = get_config(arch)
    sizes = mesh.axis_sizes
    t0 = time.perf_counter()
    params = abstract_params(cfg)
    pspecs = shd.param_specs(params, axis_sizes=sizes)
    mom = {k: torch.empty(x.shape, dtype=torch.float32, device="meta")
           for k, x in params.items()}
    args = {"params": tree_bytes(params, pspecs, sizes),
            "momentum": tree_bytes(mom, pspecs, sizes),
            "worker_params": tree_bytes(*_pod(params, pspecs), sizes)}
    shards = {k: math.prod(shd.shard_shape(x.shape, pspecs[k], sizes, k))
              for k, x in params.items()}
    delta_in = sum(n + 4 for n in shards.values()) if compress_int8 \
        else 4 * sum(shards.values())
    bar_out = sum(n * params[k].element_size() for k, n in shards.items())
    seconds = {"argument_bytes": time.perf_counter() - t0}
    t0 = time.perf_counter()
    records, why = exchange_collectives(cfg, mesh,
                                        compress_int8=compress_int8,
                                        method=method)
    seconds["collectives"] = time.perf_counter() - t0
    return {
        "arch": arch, "shape": "outer_exchange", "kind": "outer",
        "mesh": "multi", "plan": {"compress_int8": compress_int8,
                                  "method": method},
        "n_devices": mesh.size, "axis_sizes": sizes,
        "flops_total": None,
        "flops_reason": "elementwise only: FlopCounterMode counts "
                        "matmul-class operations",
        **(_uncounted_fields(why) if records is None
           else collective_fields(records, mesh.size)),
        "memory": {"argument_bytes": sum(args.values()),
                   "argument_bytes_by_input": args},
        "pod_axis_bytes_per_device": {"delta_in": delta_in,
                                      "lookahead_out": bar_out},
        "not_modelled": NOT_MODELLED,
        "count_seconds": seconds,
    }


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def refused_out(out: str) -> bool:
    """True when ``out`` lies under the reference's record directory."""
    path = Path(out).resolve()
    return any(path == ref or ref in path.parents
               for ref in {(ROOT / REFERENCE_OUT).resolve(),
                           Path(REFERENCE_OUT).resolve()})


def _write(path: str, rec: Dict[str, Any]):
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def _wire_text(rec: Dict[str, Any]) -> str:
    wire = rec["wire_bytes_per_device"]
    return "null" if wire is None else f"{wire:.3e}B"


def _uncounted_collectives(tag: str, rec: Dict[str, Any]):
    why = rec.get("collectives_reason")
    return [] if why is None else [(tag, "collectives: " + why)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--outer-exchange", action="store_true",
                    help="also record the HeLoCo outer round per arch "
                         "(multi)")
    ap.add_argument("--compress-int8", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--plan", default=None,
                    help='JSON plan overrides, e.g. \'{"grad_accum":1,'
                         '"remat_group":4,"head_tp":true}\'')
    ap.add_argument("--tag", default="",
                    help="suffix for output files (perf iterations)")
    args = ap.parse_args(argv)
    if refused_out(args.out):
        print(f"refusing --out {args.out}: {REFERENCE_OUT} holds the "
              f"reference's records; the port writes {DEFAULT_OUT}",
              file=sys.stderr)
        return 2
    overrides = json.loads(args.plan) if args.plan else None

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else list(ASSIGNED)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    memo: Dict = {}
    uncounted = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            ok, why = shape_applicable(cfg, SHAPES[shape_name])
            for multi in meshes:
                mesh_name = "multi" if multi else "single"
                tag = (f"{arch}__{shape_name}__{mesh_name}"
                       + (f"__{args.tag}" if args.tag else ""))
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if "error" not in json.load(f):
                            print(f"HAVE {tag}", flush=True)
                            continue
                if not ok:
                    _write(path, {"arch": arch, "shape": shape_name,
                                  "skipped": why, "mesh": mesh_name})
                    print(f"SKIP {tag}: {why}", flush=True)
                    continue
                try:
                    rec = lower_cell(arch, shape_name,
                                     make_production_mesh(multi_pod=multi),
                                     multi_pod=multi, overrides=overrides,
                                     memo=memo)
                except Exception as e:   # one cell's failure is its record
                    _write(path, {"arch": arch, "shape": shape_name,
                                  "mesh": mesh_name, "error": repr(e),
                                  **_uncounted_fields(
                                      "the cell failed before the count")})
                    uncounted.append((tag, repr(e)))
                    print(f"FAIL {tag}: {e!r}", flush=True)
                    traceback.print_exc()
                    continue
                _write(path, rec)
                mem = rec["memory"]["argument_bytes"] / 2**30
                flops = rec["flops_per_device"]
                if flops is None:
                    uncounted.append((tag, "flops: " + rec["flops_reason"]))
                uncounted += _uncounted_collectives(tag, rec)
                print(f"OK   {tag}: {sum(rec['count_seconds'].values()):.1f}s"
                      " flops/dev="
                      + (f"{flops:.3e}" if flops is not None else "null")
                      + f" args/dev={mem:.2f}GiB wire/dev="
                      + _wire_text(rec), flush=True)
        if args.outer_exchange:
            tag = f"{arch}__outer_exchange__multi"
            try:
                rec = lower_outer_exchange(
                    arch, make_production_mesh(multi_pod=True),
                    compress_int8=args.compress_int8)
            except Exception as e:   # one cell's failure is its record
                uncounted.append((tag, repr(e)))
                print(f"FAIL {tag}: {e!r}", flush=True)
                traceback.print_exc()
                continue
            _write(os.path.join(args.out, tag + ".json"), rec)
            uncounted += _uncounted_collectives(tag, rec)
            pod = rec["pod_axis_bytes_per_device"]
            print(f"OK   {tag}: delta in {pod['delta_in']:.3e}B, look-ahead "
                  f"out {pod['lookahead_out']:.3e}B per device, wire/dev="
                  + _wire_text(rec), flush=True)
    print(f"\n{len(uncounted)} cells without a count on abstract tensors"
          + (":" if uncounted else ""))
    for tag, why in uncounted:
        print(f"  {tag}: {why}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
