"""Worlds of CPU ranks for the port's placed dist steps (no JAX here: the
spawned ranks import only this module and ``repro_torch``).

``spawn(fn, world, tmp, payload)`` starts ``world`` processes (spawned,
never forked; one intra-op thread each), which meet through a
``FileStore`` under ``tmp`` (no fixed port: several test files run at
once) in a gloo process group, and each runs ``fn(rank, payload)``. It
returns rank 0's return value, and raises with the first failing rank's
traceback. The rank functions below run one mesh shape each and loop over
their cases inside it, because a world takes seconds to start.

``CollectiveLog`` records the ranks of the group of every collective run
while it is active: the functional collectives that DTensor's
redistributions run, and the c10d ones that the exchange's ``local_map``
function calls.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

TIMEOUT = 300


def _rank_main(fn, rank, world, store_path, payload, results):
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        try:
            out = fn(rank, payload)
        finally:
            dist.destroy_process_group()
        results.put(("ok", rank, out if rank == 0 else None))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))


def spawn(fn, world: int, tmp, payload, timeout: float = TIMEOUT):
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(str(tmp), f"store_{fn.__name__}")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, store,
                                                  payload, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out = None
    try:
        for _ in range(world):
            try:
                kind, rank, value = results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"{fn.__name__}: a rank did not finish "
                                   f"in {timeout} s")
            if kind == "error":
                raise RuntimeError(f"{fn.__name__} rank {rank}:\n{value}")
            if rank == 0:
                out = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return out


class CollectiveLog(TorchDispatchMode):
    """The group (its global ranks) of each collective run inside the
    block, with the collective's name."""

    def __enter__(self):
        import torch.distributed as dist
        self.calls = []
        self._saved = {}
        for name in ("all_reduce", "broadcast", "all_gather",
                     "all_gather_into_tensor", "reduce_scatter_tensor",
                     "all_to_all_single", "scatter", "reduce"):
            orig = getattr(dist, name)
            self._saved[name] = orig

            def wrapped(*args, _orig=orig, _name=name, **kw):
                group = kw.get("group")
                self.calls.append((_name, tuple(
                    dist.get_process_group_ranks(group) if group is not None
                    else range(dist.get_world_size()))))
                return _orig(*args, **kw)
            setattr(dist, name, wrapped)
        return super().__enter__()

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, orig in self._saved.items():
            setattr(dist, name, orig)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "_c10d_functional" and \
                not func.__name__.startswith("wait_tensor"):
            from torch.distributed.distributed_c10d import (
                _resolve_process_group, get_process_group_ranks)
            names = [a.name for a in func._schema.arguments]
            if "group_name" not in names:
                return func(*args, **kwargs)
            i = names.index("group_name")
            group = kwargs["group_name"] if i >= len(args) else args[i]
            if isinstance(group, str):
                group = _resolve_process_group(group)
            self.calls.append((func.__name__,
                               tuple(get_process_group_ranks(group))))
        return func(*args, **kwargs)

    def crossing(self, pods):
        """The calls whose group holds ranks of more than one of ``pods``
        (lists of global ranks)."""
        return [(n, g) for n, g in self.calls
                if sum(bool(set(g) & set(p)) for p in pods) > 1]


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _np(tree):
    from repro_torch.dist import sharding as shd
    return {k: shd.gather(v).detach().float().numpy()
            for k, v in tree.items()}


def pod_groups(mesh):
    """Each pod's global ranks, from the mesh's layout."""
    layout = mesh.device_mesh.mesh
    return [layout[i].flatten().tolist() for i in range(layout.shape[0])]


# ---------------------------------------------------------------- worlds

def world_pods(rank, payload):
    """The reference's own case on (pod 2, data 2, model 2): the multi-pod
    step (identical pods, different batches, pod 0 against the single step
    on its (data 2, model 2) submesh), the HeLoCo exchange with arriving
    pod 1, the int8 exchange and its round trip leaf by leaf, each block's
    branch from the placed statistics; the collectives of the multi-pod
    step and of the exchange."""
    import torch.distributed as dist
    from repro_torch.configs.base import HeLoCoConfig, InnerOptConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import steps
    from repro_torch.kernels import heloco_correct as hk
    from repro_torch.launch.mesh import mesh_context, process_mesh
    cfg, inner = payload["cfg"], InnerOptConfig(**payload["inner"])
    params = _t(payload["params"])
    out = {}
    with process_mesh((2, 2, 2), ("pod", "data", "model"), "cpu") as mesh, \
            mesh_context(mesh):
        pods = pod_groups(mesh)
        pspecs = shd.param_specs(params, axis_sizes=mesh.axis_sizes)
        step = steps.make_multipod_train_step(cfg, inner, mesh, q_chunk=16,
                                              param_pspecs=pspecs)
        st0 = steps.init_train_state(params)
        with CollectiveLog() as log:
            ns, _ = step(steps.stack_pods([st0, st0]),
                         _t(payload["batch_same"]))
            nd, losses = step(steps.stack_pods([st0, st0]),
                              _t(payload["batch_diff"]))
        out["multipod_collectives"] = len(log.calls)
        out["multipod_crossing"] = log.crossing(pods)
        out["same"] = _np(ns.params)
        out["diff"] = _np(nd.params)
        out["diff_mu"] = _np(nd.opt.mu)
        out["losses"] = shd.gather(losses).numpy()
        single, loss0 = steps.make_train_step(
            cfg, inner, q_chunk=16, param_pspecs=pspecs)(
            st0, {k: v[0] for k, v in _t(payload["batch_diff"]).items()})
        dm = next(iter(single.params.values())).device_mesh
        out["single_mesh"] = dict(zip(dm.mesh_dim_names, dm.shape))
        # pod 0's ranks hold the single step's bits of pod 0's batch
        same_as_pod0 = torch.tensor(int(all(
            torch.equal(single.params[k].to_local(),
                        nd.params[k].to_local()[0])
            for k in single.params))) if mesh.coordinate("pod") == 0 \
            else torch.tensor(1)
        dist.all_reduce(same_as_pod0, op=dist.ReduceOp.MIN)
        out["pod0_bit_equal_single"] = bool(same_as_pod0)
        out["single_loss"] = float(shd.gather(loss0))

        mom, wp = _t(payload["momentum"]), _t(payload["worker_params"])
        stacked = shd.stacked_axes_tree(params)
        h = HeLoCoConfig()
        for int8 in (False, True):
            fn = steps.make_outer_exchange(
                cfg, mesh, h=h, outer_lr=0.7, mu=0.9, method="heloco",
                arriving_pod=1, stacked_axes=stacked, compress_int8=int8,
                param_pspecs=pspecs)
            with CollectiveLog() as log:
                p2, m2, bar = fn(params, mom, wp)
            tag = "int8" if int8 else "exchange"
            out[tag] = (_np(p2), _np(m2), _np(bar))
            out[tag + "_crossing"] = log.crossing(pods)
            out[tag + "_collectives"] = len(log.calls)
        # the int8 round trip and each block's branch, leaf by leaf, from
        # the placed shards (the statistics summed over a leaf's shards)
        rt, codes = {}, {False: {}, True: {}}
        for k, spec in pspecs.items():
            d = shd.place(params[k].float() - wp[k][1].float(), spec, mesh)
            md = shd.place(mom[k], spec, mesh).to_local().float()
            reduce_max = steps._reducer(d, dist.ReduceOp.MAX)
            reduce_sum = steps._reducer(d, dist.ReduceOp.SUM)
            rt[k] = shd.from_shard(steps.int8_roundtrip_leaf(
                d.to_local(), reduce_amax=reduce_max), spec, mesh)
            for int8, lu in ((False, d.to_local()), (True, rt[k].to_local())):
                blocks = int(np.prod(lu.shape[:stacked.get(k, 0)]))
                dot, uu, vv = reduce_sum(hk.block_stats_ref(
                    lu.reshape(blocks, -1), md.reshape(blocks, -1))).unbind(1)
                nu, nv = torch.sqrt(uu), torch.sqrt(vv)
                c = dot / torch.clamp_min(nu * nv, h.eps * h.eps)
                code = torch.where(c >= h.c_ok, 0,
                                   torch.where(c < 0.0, 1, 2))
                codes[int8][k] = torch.where((nu < h.eps) | (nv < h.eps), 3,
                                             code).numpy()
        out["int8_roundtrip"] = _np(rt)
        out["codes"] = codes
        out["placements"] = {k: str(shd.placements(s, mesh))
                             for k, s in pspecs.items()}
    return out if rank == 0 else None


def world_plan(rank, payload):
    """Placement under the plan on (data 2, model 4), head_tp and
    seq_parallel: the train step at grad_accum 1 and 2, prefill, decode
    with batch-sharded caches and with sequence-sharded ones; then the
    refusals: a mesh that is not the world, a CUDA mesh of more ranks than
    cards."""
    from repro_torch.configs.base import InnerOptConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import steps
    from repro_torch.launch.mesh import mesh_context, process_mesh
    cfg, inner = payload["cfg"], InnerOptConfig(**payload["inner"])
    params = _t(payload["params"])
    batch = _t(payload["batch"])
    out = {}
    with process_mesh((2, 4), ("data", "model"), "cpu") as mesh, \
            mesh_context(mesh):
        pspecs = shd.param_specs(params, axis_sizes=mesh.axis_sizes)
        for ga in (1, 2):
            st, loss = steps.make_train_step(
                cfg, inner, grad_accum=ga, q_chunk=16,
                param_pspecs=pspecs)(steps.init_train_state(params), batch)
            out[f"train_{ga}"] = (float(shd.gather(loss)), _np(st.params),
                                  _np(st.opt.mu))
            out[f"placements_{ga}"] = sorted({
                str(v.placements) for v in st.params.values()})
        tok = torch.from_numpy(payload["prompt"])
        token = torch.from_numpy(payload["token"])
        n, s = payload["cache_len"], payload["prompt"].shape[1]
        # the caller places the serving steps' inputs, as the reference's
        # test does
        pp = shd.place_tree(params, pspecs, mesh)
        tok, token = (shd.place_tree(t, shd.batch_specs(t), mesh)
                      for t in (tok, token))
        pre = steps.make_prefill_step(cfg, cache_len=n)
        dec = steps.make_decode_step(cfg)
        for bs in (True, False):
            logits, caches = pre(pp, {"tokens": tok})
            caches = shd.place_caches(caches, mesh, batch_sharded=bs)
            cache_pl = {k: str(v.placements) for k, v in caches.items()}
            dlogits, caches = dec(pp, token, caches, s)
            out[f"serve_{bs}"] = (shd.gather(logits).numpy(),
                                  shd.gather(dlogits).numpy(),
                                  _np(caches), cache_pl)
    import torch.distributed as dist
    refusals = {}
    for shape, dev in (((2, 2), "cpu"), ((2, 4), "cuda")):
        try:
            with process_mesh(shape, ("data", "model"), dev):
                refusals[(shape, dev)] = None
        except (ValueError, RuntimeError) as e:
            refusals[(shape, dev)] = f"{type(e).__name__}: {e}"
    out["refusals"] = refusals
    out["world"] = dist.get_world_size()
    return out if rank == 0 else None


def world_meshes(rank, payload):
    """``world_pods`` then ``world_plan`` in one world (a world takes
    seconds to start): payload and result ``{"pods": .., "plan": ..}``."""
    return {name: fn(rank, payload[name])
            for name, fn in (("pods", world_pods), ("plan", world_plan))}


def world_families(rank, payload):
    """Every family's train step at smoke width on (data 2, model 4) with
    head_tp: loss, first moments and parameters of each, and the
    placements the step left on them."""
    from repro_torch.configs.base import InnerOptConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import steps
    from repro_torch.launch.mesh import mesh_context, process_mesh
    inner = InnerOptConfig(**payload["inner"])
    out = {}
    with process_mesh((2, 4), ("data", "model"), "cpu") as mesh, \
            mesh_context(mesh):
        for arch, (cfg, params, batch) in payload["cases"].items():
            params, batch = _t(params), _t(batch)
            pspecs = shd.param_specs(params, axis_sizes=mesh.axis_sizes)
            st, loss = steps.make_train_step(
                cfg, inner, q_chunk=16, param_pspecs=pspecs)(
                steps.init_train_state(params), batch)
            out[arch] = (float(shd.gather(loss)), _np(st.params),
                         _np(st.opt.mu),
                         sum(any(type(p).__name__ == "Shard"
                                 for p in v.placements)
                             for v in st.params.values()))
    return out if rank == 0 else None


def planned(cfg, *, head_tp=True, seq_parallel=False):
    """The dry-run's per-plan activation hints on a smoke config."""
    return dataclasses.replace(cfg, act_batch_axes=("data",),
                               act_model_axis="model" if head_tp else "",
                               seq_parallel=seq_parallel)
