"""The per-leaf kernel path's correction pass (``core/heloco.py:
block_correct(use_kernel=True)``): one ``block_stats`` and one
``correct_apply`` per leaf, and one ``branch_scalars`` call over the
stacked stats of all leaves in place of one per leaf.

``branch_scalars`` is per-block math, so stacking changes no bit: the
stacked call equals the per-leaf calls exactly, and the pass equals the
one-leaf entry point ``ops.heloco_correct_block`` leaf by leaf, exactly.
(Against the reference the per-leaf path is held in tests/test_torch_leaf.py.)
"""
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import HeLoCoConfig
from repro_torch.core import heloco
from repro_torch.kernels import heloco_correct as hk
from repro_torch.kernels import ops
from repro_torch.kernels.packed import branch_scalars
from repro_torch.models import Model

H = HeLoCoConfig()


def _leaves(seed):
    """tinygpt's 43 leaves at smoke width: deltas and momenta whose blocks
    fall in every branch of Alg. 2 (along, against, across the momentum, a
    zero momentum)."""
    specs = Model(get_config("tinygpt-15m-smoke")).param_specs()
    rng = np.random.default_rng(seed)
    deltas, moms = {}, {}
    for i, (k, spec) in enumerate(specs.items()):
        d = rng.standard_normal(spec.shape).astype(np.float32)
        noise = rng.standard_normal(spec.shape).astype(np.float32)
        m = ((2.0 * d + 0.1 * noise, -d + 0.1 * noise, 0.1 * d + noise,
              np.zeros_like(d))[i % 4])
        deltas[k], moms[k] = torch.from_numpy(d), torch.from_numpy(m)
    return deltas, moms


def test_stacked_branch_scalars_equal_per_leaf_calls():
    deltas, moms = _leaves(0)
    assert len(deltas) == 43
    stats = [hk.block_stats(d.reshape(1, -1), moms[k].reshape(1, -1))
             for k, d in deltas.items()]
    cu, cv = branch_scalars(torch.cat(stats), H)
    per_leaf = [branch_scalars(s, H) for s in stats]
    assert torch.equal(cu, torch.cat([c for c, _ in per_leaf]))
    assert torch.equal(cv, torch.cat([c for _, c in per_leaf]))
    # all four branches occur: keep (cu = 1, cv = 0), anti (cu = 1, cv != 0),
    # weak (cu != 1)
    assert (cv == 0).any() and ((cu == 1) & (cv != 0)).any() and \
        (cu != 1).any()


def test_block_correct_makes_one_branch_scalars_call(monkeypatch):
    deltas, moms = _leaves(1)
    deltas = {k: (d.to(torch.bfloat16) if i % 5 == 0 else d)
              for i, (k, d) in enumerate(deltas.items())}
    stacked = {k: 1 for k, d in deltas.items() if d.dim() >= 2 and
               d.shape[0] in (2, 4)}
    calls = []

    def counted(stats, h):
        calls.append(stats.shape)
        return branch_scalars(stats, h)

    want = {k: ops.heloco_correct_block(d, moms[k], H,
                                        stacked_axes=stacked.get(k, 0))
            for k, d in deltas.items()}
    monkeypatch.setattr(ops, "branch_scalars", counted)
    got = heloco.block_correct(deltas, moms, H, stacked_axes=stacked,
                               use_kernel=True)
    blocks = sum(int(np.prod(d.shape[:stacked.get(k, 0)]))
                 for k, d in deltas.items())
    assert calls == [(blocks, 3)]
    assert list(got) == list(deltas)
    for k, d in deltas.items():
        assert got[k].dtype == d.dtype and torch.equal(got[k], want[k]), k
