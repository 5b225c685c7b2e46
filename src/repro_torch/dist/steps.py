"""The distributed steps, on the port's ``Model``.

Port of ``repro/dist/steps.py``:

  init_train_state / make_train_step      single-pod AdamW training step
                                          (``grad_accum`` microbatches)
  make_multipod_train_step                per-pod independent replicas:
                                          each pod's ranks run the
                                          single-pod step on their own
                                          ("data", "model") submesh, so no
                                          value of one pod reaches another
  make_prefill_step / make_decode_step    serving path
  make_outer_exchange                     the HeLoCo outer round: the only
                                          cross-pod traffic (one pod's
                                          pseudo-gradient in, corrected
                                          outer update + broadcast
                                          look-ahead init out)

Placement is the reference's, as DTensor placements on a real
``DeviceMesh`` (``launch.mesh.process_mesh``, or ``local_mesh``'s one
card): given ``param_pspecs``, a train step places its parameters, AdamW
moments and batch (``sharding.place``) on the ambient mesh
(``sharding.mesh_context``) and runs the model as a DTensor program, the
activations pinned where the reference pins them (``cfg.act_batch_axes``,
``act_model_axis``, ``seq_parallel``) and what has no DTensor sharding
strategy run under ``local_map`` (``models/``). Its state comes back as
DTensors at their placements (``sharding.gather`` makes them whole).
Without ``param_pspecs`` a step runs on whole tensors. The serving steps
run on the placements their inputs carry, as the reference's do: the
caller places the parameters and the caches (``sharding.place_tree``,
``place_caches``). On an abstract mesh (the production meshes, read by
the dry-run) a placement only checks that it divides.

On the card the outer exchange runs the ported kernels and nothing else
for the functions they compute (``use_kernel``, on by default for CUDA
tensors): HeLoCo's correction through ``block_stats`` + ``correct_apply``
(``core.heloco.block_correct(use_kernel=True)``), the Nesterov step
through ``outer_update_2d`` (``kernels.ops.outer_update_block``), and the
int8 round trip through ``absmax`` + ``quantize_2d`` + ``dequantize_2d``
(``kernels.quantize``). On the CPU it runs the
plain versions, the reference's math. Placed, the kernels (or their plain
versions) run on each rank's shards under ``local_map``: the arriving
pod's pseudo-gradient is broadcast over the ``pod`` axis (the only
collective across pods), ``block_stats``' per-block sums and the int8
scale's absmax are reduced over the ranks that hold a leaf's other
shards, and everything else is elementwise on the shard.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional

import torch

from repro_torch.configs.base import HeLoCoConfig, InnerOptConfig, ModelConfig
from repro_torch.core import methods as outer_methods
from repro_torch.core.heloco import OuterState, lookahead_init, outer_update
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import Spec, current_mesh, place
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qk
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamState, adamw_update, init_adam

Params = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    """Parameters, AdamW state and step count. Under the multi-pod step
    every tensor carries a leading pod axis; the counts are shared, since
    the pods step together."""
    params: Params
    opt: AdamState
    step: int


def init_train_state(params: Mapping[str, torch.Tensor]) -> TrainState:
    return TrainState(params=dict(params), opt=init_adam(params), step=0)


def stack_pods(states: List[TrainState]) -> TrainState:
    """Per-pod states -> one state with a leading pod axis on every tensor
    (copies)."""
    def stack(trees):
        return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}
    counts = {(s.opt.count, s.step) for s in states}
    if len(counts) != 1:
        raise ValueError(f"pods at different steps: {sorted(counts)}")
    return TrainState(stack([s.params for s in states]),
                      AdamState(stack([s.opt.mu for s in states]),
                                stack([s.opt.nu for s in states]),
                                states[0].opt.count),
                      states[0].step)


def pod_state(state: TrainState, i: int) -> TrainState:
    """Pod ``i``'s state from a stacked one (views)."""
    def pick(tree):
        return {k: v[i] for k, v in tree.items()}
    return TrainState(pick(state.params),
                      AdamState(pick(state.opt.mu), pick(state.opt.nu),
                                state.opt.count), state.step)


def _ambient():
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("placement specs given but no ambient mesh: run "
                           "the step inside mesh_context")
    return mesh


def _pod_free(mesh):
    """The single-pod steps' mesh: the rank's own pod's ("data", "model")
    submesh of a mesh with a ``pod`` axis (the whole of a one-card mesh's).
    Parameters never shard over ``pod``, and DTensor's sharding propagation
    weighs every placement of every mesh axis at each operation."""
    if mesh.device_mesh is None or "pod" not in mesh.axis_names:
        return mesh
    return mesh.sub(tuple(a for a in mesh.axis_names if a != "pod"))


def _constrain(tree: Params, pspecs: Optional[Mapping[str, Spec]],
               mesh=None) -> Params:
    if pspecs is None:
        return tree
    mesh = mesh or _ambient()
    return {k: place(x, pspecs[k], mesh, k) for k, x in tree.items()}


def _placed_mesh(mesh) -> bool:
    return mesh is not None and mesh.device_mesh is not None


def _dispatch(on: bool):
    """DTensor dispatch for a placed step: plain tensors that the model
    makes on the fly (positions, masks, RoPE tables) count as replicated,
    as they are the same on every rank."""
    if not on:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _batch_axes(cfg: ModelConfig, mesh) -> tuple:
    return tuple(a for a in (cfg.act_batch_axes or ("data",))
                 if a in mesh.axis_names)


def _place_batch(batch, cfg: ModelConfig, mesh):
    """A batch's leading dim over the config's batch axes (``batch_specs``;
    whole tensors, the same on every rank, or DTensors)."""
    if not _placed_mesh(mesh):
        return batch
    return shd.place_tree(batch, shd.batch_specs(
        batch, batch_axes=_batch_axes(cfg, mesh)), mesh)


def _indices(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """int32 token and label batches (the reference's input dtype) widened
    to the int64 that PyTorch indexes with."""
    return {k: v.long() if v.dtype == torch.int32 else v
            for k, v in batch.items()}


def _microbatches(batch: Mapping[str, torch.Tensor], n: int
                  ) -> List[Dict[str, torch.Tensor]]:
    """The reference's split: microbatch i is rows [i B/n, (i+1) B/n) of
    the whole batch (a placed batch is gathered first, so that a
    microbatch holds the same rows as on one device)."""
    batch = {k: shd.gather(v) for k, v in batch.items()}
    split = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
             for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, inner: InnerOptConfig, *,
                    grad_accum: int = 1, q_chunk: int = 128,
                    param_pspecs: Optional[Mapping[str, Spec]] = None):
    """One AdamW step, ``step(state, batch) -> (state, loss)``.
    ``grad_accum`` splits the batch into microbatches run one after the
    other: the mean of their losses and of their fp32 gradients, the
    reference's math at 1/n the activation memory. ``q_chunk``: the
    attention's query chunk in ``Model.loss``. With ``param_pspecs`` the
    parameters and both AdamW moments are DTensors at their specs on the
    ambient mesh, each (micro)batch is placed by ``batch_specs`` over the
    config's ``act_batch_axes`` (default ``data``), the gradients are
    brought to their parameters' placements and AdamW runs elementwise on
    the local shards; the loss comes back replicated."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    model = build_model(cfg)

    def value_and_grad(params: Params, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = model.loss(leaves, batch, q_chunk=q_chunk)
        if shd.is_placed(loss):
            loss = loss.redistribute(loss.device_mesh, shd.placements_by_axis(
                loss.device_mesh))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
        grads = dict(zip(leaves, grads))
        for k, g in grads.items():
            if shd.is_placed(g) and g.placements != params[k].placements:
                grads[k] = g.redistribute(g.device_mesh, params[k].placements)
        return loss.detach(), grads

    def step(state: TrainState, batch):
        mesh = None if param_pspecs is None else _pod_free(_ambient())
        params = _constrain(state.params, param_pspecs, mesh)
        opt = state.opt._replace(
            mu=_constrain(state.opt.mu, param_pspecs, mesh),
            nu=_constrain(state.opt.nu, param_pspecs, mesh))
        placed = _placed_mesh(mesh)
        with _dispatch(placed), shd.mesh_context(mesh):
            if grad_accum > 1:
                lead = next(iter(batch.values())).shape[0]
                if lead % grad_accum:
                    raise ValueError(f"batch {lead} is not {grad_accum} "
                                     "equal microbatches")
                grads = {k: torch.zeros_like(p, dtype=torch.float32)
                         for k, p in params.items()}
                loss = torch.zeros((), dtype=torch.float32,
                                   device=next(iter(params.values())).device)
                for mb in _microbatches(batch, grad_accum):
                    if placed:
                        mb = _place_batch(mb, cfg, mesh)
                    mloss, mgrads = value_and_grad(params, _indices(mb))
                    for k, g in mgrads.items():
                        grads[k].add_(g.float() / grad_accum)
                    loss = loss + mloss / grad_accum
                    del mgrads
            else:
                if placed:
                    batch = _place_batch(batch, cfg, mesh)
                loss, grads = value_and_grad(params, _indices(batch))
            new_params, new_opt = adamw_update(params, grads, opt, inner)
        new_params = _constrain(new_params, param_pspecs, mesh)
        return TrainState(new_params, new_opt, state.step + 1), loss

    return step


def _pod_local(x, spec: Spec, mesh) -> torch.Tensor:
    """This rank's local tensor of a whole or pod-placed leaf: its pods
    (the leading axis) and its shard of each."""
    return place(x, Spec(("pod",) + tuple(spec)), mesh).to_local()


def _from_pods(local: torch.Tensor, spec: Spec, mesh):
    """Local per-pod results (leading axis: this rank's pods) -> a DTensor
    with ``pod`` ahead of ``spec``, with no collective."""
    return shd.from_shard(local, Spec(("pod",) + tuple(spec)), mesh)


def make_multipod_train_step(cfg: ModelConfig, inner: InnerOptConfig, mesh,
                             *, grad_accum: int = 1, q_chunk: int = 128,
                             param_pspecs: Optional[Mapping[str, Spec]] = None
                             ):
    """Per-pod replica step: every tensor of the state and the batch carries
    a leading pod axis, and the single-pod step runs on each pod's slice:
    the DiLoCo inner round is communication-free across the worker
    boundary, the reference's vmap guarantee. ``step(state, batch) ->
    (state, losses (n_pods,))``.

    Without ``param_pspecs`` the pods run one after the other on whole
    tensors. With them (``pod`` ahead of each spec): on a mesh of real
    ranks each rank keeps its pods' shards (a pod axis of size 1 holds
    every pod) and runs the single-pod step on its pod's ("data",
    "model") submesh, so every collective's group lies inside one pod; the
    state comes back as DTensors with ``pod`` ahead of each spec. On an
    abstract mesh the pod placement is only checked."""
    base = make_train_step(cfg, inner, grad_accum=grad_accum,
                           q_chunk=q_chunk, param_pspecs=param_pspecs)
    plain = make_train_step(cfg, inner, grad_accum=grad_accum,
                            q_chunk=q_chunk)
    pod_pspecs = None
    if param_pspecs is not None:
        pod_pspecs = {k: Spec(("pod",) + tuple(s))
                      for k, s in param_pspecs.items()}

    def loop(state: TrainState, batch):
        n_pods = next(iter(state.params.values())).shape[0]
        outs, losses = [], []
        for i in range(n_pods):
            new, loss = plain(pod_state(state, i),
                              {k: v[i] for k, v in batch.items()})
            outs.append(new)
            losses.append(loss)
        return stack_pods(outs), torch.stack(losses)

    def step(state: TrainState, batch):
        amb = None if param_pspecs is None else _ambient()
        if not _placed_mesh(amb):
            state = state._replace(params=_constrain(state.params,
                                                     pod_pspecs))
            new_state, losses = loop(state, batch)
            return new_state._replace(params=_constrain(new_state.params,
                                                        pod_pspecs)), losses
        sub = _pod_free(amb)
        specs = dict(param_pspecs)
        local = {name: {k: _pod_local(v, specs[k], amb)
                        for k, v in tree.items()}
                 for name, tree in (("params", state.params),
                                    ("mu", state.opt.mu),
                                    ("nu", state.opt.nu))}
        bspecs = shd.tree_leaves(shd.batch_specs(
            {k: v[0] for k, v in batch.items()},
            batch_axes=_batch_axes(cfg, sub)))
        lbatch = {k: _pod_local(v, bspecs[k], amb) for k, v in batch.items()}
        outs, losses = {"params": [], "mu": [], "nu": []}, []
        with shd.mesh_context(sub):
            for i in range(next(iter(lbatch.values())).shape[0]):
                def on_sub(tree, i=i):
                    return {k: shd.from_shard(v[i], specs[k], sub)
                            for k, v in tree.items()}
                pstate = TrainState(on_sub(local["params"]), AdamState(
                    on_sub(local["mu"]), on_sub(local["nu"]),
                    state.opt.count), state.step)
                new, loss = base(pstate, {
                    k: shd.from_shard(v[i], bspecs[k], sub)
                    for k, v in lbatch.items()})
                outs["params"].append(new.params)
                outs["mu"].append(new.opt.mu)
                outs["nu"].append(new.opt.nu)
                losses.append(loss.to_local())
                count = new.opt.count

        def restack(trees):
            return {k: _from_pods(torch.stack([t[k].to_local()
                                               for t in trees]),
                                  specs[k], amb) for k in specs}
        new_state = TrainState(restack(outs["params"]), AdamState(
            restack(outs["mu"]), restack(outs["nu"]), count), state.step + 1)
        return new_state, _from_pods(torch.stack(losses), Spec(()), amb)

    return step


def _placed_params(params: Mapping[str, torch.Tensor]) -> bool:
    return any(shd.is_placed(v) for v in params.values())


def make_prefill_step(cfg: ModelConfig, *, cache_len: int):
    """``step(params, batch) -> (logits, caches)``: ``Model.prefill`` (one
    flash-attention launch an attention layer on the card). It runs on the
    placements its inputs carry: the caller places the parameters (and the
    batch) on the ambient mesh, as the reference's caller does."""
    model = build_model(cfg)

    def step(params, batch):
        if not isinstance(batch, torch.Tensor):
            batch = _indices(batch)
        with _dispatch(_placed_params(params)):
            return model.prefill(params, batch, cache_len=cache_len)

    return step


def make_decode_step(cfg: ModelConfig):
    """``step(params, token, caches, pos) -> (logits, caches)``:
    ``Model.decode``, on the placements its inputs carry (the caller
    places the caches, ``sharding.place_caches``)."""
    model = build_model(cfg)

    def step(params, token, caches, pos):
        with _dispatch(_placed_params(params)):
            return model.decode(params, token.long(), caches, int(pos))

    return step


# ---------------------------------------------------------------------------
# HeLoCo outer exchange: the only cross-pod communication
# ---------------------------------------------------------------------------

def int8_roundtrip_leaf(x: torch.Tensor, use_kernel: bool = False,
                        reduce_amax: Optional[Callable] = None
                        ) -> torch.Tensor:
    """Per-tensor absmax int8 fake-quantization of fp32 ``x``, the wire
    format of the compressed exchange: scale = max(absmax, 1e-12) / 127,
    q = clip(round-half-even(x / scale), -127, 127), back as q * scale,
    with true divisions. ``use_kernel``: absmax + quantize_2d +
    dequantize_2d (``kernels.quantize``); else their plain versions, the
    same bits. ``reduce_amax``: the whole leaf's absmax from this shard's,
    when ``x`` is one rank's shard of the leaf (the scale is the leaf's)."""
    absmax, quantize, dequantize = (
        (qk.absmax, qk.quantize_2d, qk.dequantize_2d) if use_kernel else
        (qk.absmax_ref, qk.quantize_2d_ref, qk.dequantize_2d_ref))
    xc = x.float().contiguous()
    amax = absmax(xc)
    if reduce_amax is not None:
        amax = reduce_amax(amax)
    return dequantize(*quantize(xc, amax))


def _reducer(x, op):
    """``t`` -> its reduction by ``op`` over the mesh axes on which the
    DTensor ``x`` is sharded (the ranks that hold its other shards), in
    place; the identity where no such axis has more than one rank."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    dm = x.device_mesh
    groups = [dm.get_group(a) for a, pl in shd.mesh_axes(x).items()
              if isinstance(pl, Shard)
              and dm.size(dm.mesh_dim_names.index(a)) > 1]

    def reduce(t: torch.Tensor) -> torch.Tensor:
        for g in groups:
            dist.all_reduce(t, op=op, group=g)
        return t
    return reduce


def make_outer_exchange(cfg: ModelConfig, mesh, *, h: HeLoCoConfig,
                        outer_lr: float, mu: float, method: str = "heloco",
                        arriving_pod: int = 0,
                        stacked_axes: Optional[Mapping[str, int]] = None,
                        compress_int8: bool = False,
                        use_kernel: Optional[bool] = None,
                        param_pspecs: Optional[Mapping[str, Spec]] = None):
    """The outer round for one arriving pod:

        fn(params, momentum, worker_params) -> (new_params, new_momentum,
                                                bar)

    ``worker_params`` carries a leading pod axis; the arriving pod's
    pseudo-gradient Delta = theta - theta_w[arriving_pod] (fp32; int8
    round-tripped with ``compress_int8``) is corrected by the method
    against the server momentum and applied through the Nesterov outer
    update (rho = 1); ``bar`` is the Eq. 5 look-ahead initialization,
    broadcast to every pod of the mesh (an expanded view, (n_pods, ...)).

    ``use_kernel`` (None: the tensors' device is CUDA) runs the kernels
    named in the module's docstring; False the plain versions, on any
    device. Methods with their own outer schedule or state are refused, as
    the reference refuses them.

    With ``param_pspecs`` on a mesh of real ranks (``mesh`` itself, whose
    ``pod`` axis holds the pods): the parameters and momentum are placed at
    their specs, the worker trees with ``pod`` ahead, and the round runs
    on each rank's shards under ``local_map``; the outputs are DTensors at
    those placements, ``bar`` with ``pod`` ahead."""
    del cfg   # the reference's signature; the exchange reads only the trees
    n_pods = mesh.axis_sizes.get("pod", 1)
    m = outer_methods.resolve(method)
    if m.custom_update:
        raise NotImplementedError(
            f"outer method {m.name!r} needs per-method auxiliary state; "
            "the multi-pod outer exchange only supports methods on the "
            "standard Nesterov schedule")

    def local_round(params: Params, momentum: Params, arriving: Params,
                    kern: bool, reduce_stats=None, reduce_amax=None):
        """The round on whole leaves, or on one rank's shards of them with
        the reductions over their other shards."""
        ctx = outer_methods.ArrivalCtx(outer_lr=outer_lr, mu=mu, h=h,
                                       tau=0.0, stacked_axes=stacked_axes,
                                       use_kernel=kern,
                                       reduce_stats=reduce_stats)
        delta = {k: p.float() - arriving[k].float()
                 for k, p in params.items()}
        if compress_int8:
            for k in delta:
                delta[k] = int8_roundtrip_leaf(
                    delta[k], use_kernel=kern, reduce_amax=None
                    if reduce_amax is None else reduce_amax[k])
        g = m.correct(m, ctx, delta, momentum)
        del delta
        if kern:
            new_p, new_m = {}, {}
            for k in params:
                new_p[k], new_m[k] = ops.outer_update_block(
                    params[k], momentum[k], g.pop(k), outer_lr, mu, 1.0)
            state = OuterState(new_p, new_m, step=1)
        else:
            state = outer_update(OuterState(dict(params), dict(momentum), 0),
                                 g, outer_lr, mu)
        del g
        return state, lookahead_init(state, outer_lr, mu)

    def fn(params: Params, momentum: Params, worker_params: Params):
        first = next(iter(params.values()))
        kern = first.device.type == "cuda" if use_kernel is None \
            else use_kernel
        if param_pspecs is not None and _placed_mesh(mesh):
            return placed_fn(params, momentum, worker_params, kern)
        state, bar = local_round(params, momentum, {
            k: w[arriving_pod] for k, w in worker_params.items()}, kern)
        bar_pods = {k: x.unsqueeze(0).expand((n_pods,) + tuple(x.shape))
                    for k, x in bar.items()}
        return state.params, state.momentum, bar_pods

    def placed_fn(params, momentum, worker_params, kern):
        import torch.distributed as dist
        specs = dict(param_pspecs)
        keys = list(params)
        p = {k: place(params[k], specs[k], mesh, k) for k in keys}
        mo = {k: place(momentum[k], specs[k], mesh, k) for k in keys}
        wp = {k: place(worker_params[k], Spec(("pod",) + tuple(specs[k])),
                       mesh, k) for k in keys}
        dm = mesh.device_mesh
        pod_group = dm.get_group("pod") if "pod" in mesh.axis_names else None
        coord = mesh.coordinate("pod") if pod_group is not None else 0
        stats = {k: _reducer(p[k], dist.ReduceOp.SUM) for k in keys}
        amax = {k: _reducer(p[k], dist.ReduceOp.MAX) for k in keys}
        n = len(keys)

        def local(*ts):
            lp, lm, lw = (dict(zip(keys, ts[i * n:(i + 1) * n]))
                          for i in range(3))
            if n_pods == 1 or pod_group is None:
                arriving = {k: w[arriving_pod] for k, w in lw.items()}
            else:
                # the arriving pod's leaves cross the pod axis: one
                # broadcast a leaf, the round's only cross-pod traffic
                src = dist.get_global_rank(pod_group, arriving_pod)
                arriving = {}
                for k, w in lw.items():
                    t = (w[0].contiguous() if coord == arriving_pod
                         else torch.empty_like(w[0]))
                    dist.broadcast(t, src=src, group=pod_group)
                    arriving[k] = t
            state, bar = local_round(lp, lm, arriving, kern, stats, amax)
            per = lw[keys[0]].shape[0]
            return tuple([state.params[k] for k in keys]
                         + [state.momentum[k] for k in keys]
                         + [bar[k].unsqueeze(0).expand(
                             (per,) + tuple(bar[k].shape)) for k in keys])

        pl = [p[k].placements for k in keys]
        wpl = [wp[k].placements for k in keys]
        out = shd.on_shards(local, [p[k] for k in keys]
                            + [mo[k] for k in keys] + [wp[k] for k in keys],
                            pl + pl + wpl, tuple(pl + pl + wpl),
                            device_mesh=dm)
        return (dict(zip(keys, out[:n])), dict(zip(keys, out[n:2 * n])),
                dict(zip(keys, out[2 * n:])))

    return fn


__all__ = ["TrainState", "init_train_state", "stack_pods", "pod_state",
           "make_train_step", "make_multipod_train_step",
           "make_prefill_step", "make_decode_step", "make_outer_exchange",
           "int8_roundtrip_leaf"]
