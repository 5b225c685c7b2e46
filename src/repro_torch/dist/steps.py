"""The distributed steps, on the port's ``Model``.

Port of ``repro/dist/steps.py``:

  init_train_state / make_train_step      single-pod AdamW training step
                                          (``grad_accum`` microbatches)
  make_multipod_train_step                per-pod independent replicas:
                                          the per-pod step over the leading
                                          pod axis, one pod at a time, so no
                                          value of one pod reaches another
  make_prefill_step / make_decode_step    serving path
  make_outer_exchange                     the HeLoCo outer round: the only
                                          cross-pod traffic (one pod's
                                          pseudo-gradient in, corrected
                                          outer update + broadcast
                                          look-ahead init out)

Placement is expressed only at a step's edges, where the reference calls
``with_sharding_constraint``: ``sharding.place`` with the leaf's spec on
the ambient mesh (``sharding.mesh_context``). The model computes on
local tensors. A mesh of the port has one device (``launch.mesh.
local_mesh``), so a placement moves nothing; the production meshes are
abstract and read by the dry-run.

On the card the outer exchange runs the ported kernels and nothing else
for the functions they compute (``use_kernel``, on by default for CUDA
tensors): HeLoCo's correction through ``block_stats`` + ``correct_apply``
(``core.heloco.block_correct(use_kernel=True)``), the Nesterov step
through ``outer_update_2d`` (``kernels.ops.outer_update_block``), and the
int8 round trip through ``absmax`` + ``quantize_2d`` + ``dequantize_2d``
(``ops.quantize_block`` / ``dequantize_block``). On the CPU it runs the
plain versions, the reference's math.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional

import torch

from repro_torch.configs.base import HeLoCoConfig, InnerOptConfig, ModelConfig
from repro_torch.core import methods as outer_methods
from repro_torch.core.heloco import OuterState, lookahead_init, outer_update
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


def _constrain(tree: Params, pspecs: Optional[Mapping[str, Spec]]) -> Params:
    if pspecs is None:
        return tree
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("placement specs given but no ambient mesh: run "
                           "the step inside mesh_context")
    return {k: place(x, pspecs[k], mesh, k) for k, x in tree.items()}


def _indices(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """int32 token and label batches (the reference's input dtype) widened
    to the int64 that PyTorch indexes with."""
    return {k: v.long() if v.dtype == torch.int32 else v
            for k, v in batch.items()}


def _microbatches(batch: Mapping[str, torch.Tensor], n: int
                  ) -> List[Dict[str, torch.Tensor]]:
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
    attention's query chunk in ``Model.loss``."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    model = build_model(cfg)

    def value_and_grad(params: Params, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = model.loss(leaves, batch, q_chunk=q_chunk)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
        return loss.detach(), dict(zip(leaves, grads))

    def step(state: TrainState, batch):
        params = _constrain(state.params, param_pspecs)
        batch = _indices(batch)
        if grad_accum > 1:
            lead = next(iter(batch.values())).shape[0]
            if lead % grad_accum:
                raise ValueError(f"batch {lead} is not {grad_accum} equal "
                                 "microbatches")
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            for mb in _microbatches(batch, grad_accum):
                mloss, mgrads = value_and_grad(params, mb)
                for k, g in mgrads.items():
                    grads[k].add_(g.float() / grad_accum)
                loss = loss + mloss / grad_accum
                del mgrads
        else:
            loss, grads = value_and_grad(params, batch)
        new_params, new_opt = adamw_update(params, grads, state.opt, inner)
        new_params = _constrain(new_params, param_pspecs)
        return TrainState(new_params, new_opt, state.step + 1), loss

    return step


def make_multipod_train_step(cfg: ModelConfig, inner: InnerOptConfig, mesh,
                             *, grad_accum: int = 1, q_chunk: int = 128,
                             param_pspecs: Optional[Mapping[str, Spec]] = None
                             ):
    """Per-pod replica step: every tensor of the state and the batch carries
    a leading pod axis, and the single-pod step runs on each pod's slice in
    turn (the reference vmaps it): the DiLoCo inner round is
    communication-free across the worker boundary. ``step(state, batch) ->
    (state, losses (n_pods,))``. The pod placement (``pod`` ahead of each
    spec) is applied to the stacked leaves."""
    base = make_train_step(cfg, inner, grad_accum=grad_accum,
                           q_chunk=q_chunk)
    pod_pspecs = None
    if param_pspecs is not None:
        pod_pspecs = {k: Spec(("pod",) + tuple(s))
                      for k, s in param_pspecs.items()}

    def step(state: TrainState, batch):
        state = state._replace(params=_constrain(state.params, pod_pspecs))
        n_pods = next(iter(state.params.values())).shape[0]
        outs, losses = [], []
        for i in range(n_pods):
            new, loss = base(pod_state(state, i),
                             {k: v[i] for k, v in batch.items()})
            outs.append(new)
            losses.append(loss)
        new_state = stack_pods(outs)
        new_state = new_state._replace(
            params=_constrain(new_state.params, pod_pspecs))
        return new_state, torch.stack(losses)

    return step


def make_prefill_step(cfg: ModelConfig, *, cache_len: int):
    """``step(params, batch) -> (logits, caches)``: ``Model.prefill`` (one
    flash-attention launch an attention layer on the card)."""
    model = build_model(cfg)

    def step(params, batch):
        if not isinstance(batch, torch.Tensor):
            batch = _indices(batch)
        return model.prefill(params, batch, cache_len=cache_len)

    return step


def make_decode_step(cfg: ModelConfig):
    """``step(params, token, caches, pos) -> (logits, caches)``:
    ``Model.decode``."""
    model = build_model(cfg)

    def step(params, token, caches, pos):
        return model.decode(params, token.long(), caches, int(pos))

    return step


# ---------------------------------------------------------------------------
# HeLoCo outer exchange: the only cross-pod communication
# ---------------------------------------------------------------------------

def int8_roundtrip_leaf(x: torch.Tensor, use_kernel: bool = False
                        ) -> torch.Tensor:
    """Per-tensor absmax int8 fake-quantization of fp32 ``x``, the wire
    format of the compressed exchange: scale = max(absmax, 1e-12) / 127,
    q = clip(round-half-even(x / scale), -127, 127), back as q * scale,
    with true divisions. ``use_kernel``: absmax + quantize_2d +
    dequantize_2d (``kernels.ops``); else their plain versions, the same
    bits."""
    if use_kernel:
        q, scale, _ = ops.quantize_block(x)
        return ops.dequantize_block(q, scale, x.shape)
    return qk.dequantize_2d_ref(*qk.quantize_2d_ref(x))


def make_outer_exchange(cfg: ModelConfig, mesh, *, h: HeLoCoConfig,
                        outer_lr: float, mu: float, method: str = "heloco",
                        arriving_pod: int = 0,
                        stacked_axes: Optional[Mapping[str, int]] = None,
                        compress_int8: bool = False,
                        use_kernel: Optional[bool] = None):
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
    the reference refuses them."""
    del cfg   # the reference's signature; the exchange reads only the trees
    n_pods = mesh.axis_sizes.get("pod", 1)
    m = outer_methods.resolve(method)
    if m.custom_update:
        raise NotImplementedError(
            f"outer method {m.name!r} needs per-method auxiliary state; "
            "the multi-pod outer exchange only supports methods on the "
            "standard Nesterov schedule")

    def fn(params: Params, momentum: Params, worker_params: Params):
        first = next(iter(params.values()))
        kern = first.device.type == "cuda" if use_kernel is None \
            else use_kernel
        ctx = outer_methods.ArrivalCtx(outer_lr=outer_lr, mu=mu, h=h,
                                       tau=0.0, stacked_axes=stacked_axes,
                                       use_kernel=kern)
        delta = {k: p.float() - worker_params[k][arriving_pod].float()
                 for k, p in params.items()}
        if compress_int8:
            for k in delta:
                delta[k] = int8_roundtrip_leaf(delta[k], use_kernel=kern)
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
        bar = lookahead_init(state, outer_lr, mu)
        bar_pods = {k: x.unsqueeze(0).expand((n_pods,) + tuple(x.shape))
                    for k, x in bar.items()}
        return state.params, state.momentum, bar_pods

    return fn


__all__ = ["TrainState", "init_train_state", "stack_pods", "pod_state",
           "make_train_step", "make_multipod_train_step",
           "make_prefill_step", "make_decode_step", "make_outer_exchange",
           "int8_roundtrip_leaf"]
