"""The port's Synchronizer against the reference's on the same numpy
pseudo-gradient sequence, with staleness, delay weighting and dropped
arrivals: records equal, packed params/momentum and the look-ahead worker
init within fp32 bounds after EVERY arrival.

Tolerance: rtol 1e-5 / atol 1e-6. Each arrival's branch scalars come from
per-block sums that the two packages add in different orders (~1e-7
relative), and eight arrivals compound that through the momentum.
"""
import jax
import numpy as np
import pytest
import torch

from repro.async_engine.server import Synchronizer as JaxSynchronizer
from repro.configs.base import OuterOptConfig as JaxOuterOptConfig
from repro_torch import bridge
from repro_torch.async_engine.server import Synchronizer
from repro_torch.configs.base import OuterOptConfig

SHAPES = {"emb": (40, 30), "head": (17,), "layers": {"b": (3, 5),
                                                       "w": (3, 4, 5)},
          "norm": (129,)}
# (s_i, worker) per arrival; with drop_stale_after=2 arrivals at
# t=3, 5 and 7 (staleness 3, 4, 5) are dropped
SCHEDULE = [(0, 0), (0, 1), (1, 0), (0, 2), (3, 1), (1, 3), (5, 0), (2, 2)]
TOL = dict(rtol=1e-5, atol=1e-6)


def _tree(rng, scale=1.0):
    return jax.tree.map(
        lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
        SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in leaves}


def _deltas(rng):
    """Each delta leans on the previous one (along it, against it, or
    neither), so the momentum-relative branches all occur."""
    prev, out = None, []
    for k in range(len(SCHEDULE)):
        noise = _tree(rng, 0.01)
        if prev is None:
            d = noise
        else:
            a = (1.0, -1.0, 0.1)[k % 3]
            d = jax.tree.map(lambda p, n: (a * p + n).astype(np.float32),
                             prev, noise)
        out.append(d)
        prev = d
    return out


@pytest.mark.parametrize("weighting", [False, True])
def test_synchronizer_matches_reference_after_every_arrival(weighting):
    rng = np.random.default_rng(0)
    init = _tree(rng)
    cfg = dict(drop_stale_after=2, delay_weighting=weighting)
    ref = JaxSynchronizer(init, JaxOuterOptConfig(**cfg), n_workers=4)
    ours = Synchronizer(bridge.to_torch(_flat(init), "cpu"),
                        OuterOptConfig(**cfg), n_workers=4)
    for (s_i, wid), delta in zip(SCHEDULE, _deltas(rng)):
        want = ref.on_arrival(delta, s_i, wid, sim_time=1.0, lang="de")
        got = ours.on_arrival(bridge.to_torch(_flat(delta), "cpu"), s_i, wid,
                              sim_time=1.0, lang="de")
        assert got.__dict__ == {k: want.__dict__[k] for k in got.__dict__}
        np.testing.assert_allclose(ours._pbuf.numpy(),
                                   np.asarray(ref._pbuf), **TOL)
        np.testing.assert_allclose(ours._mbuf.numpy(),
                                   np.asarray(ref._mbuf), **TOL)
        ref_init = _flat(ref.worker_init())
        for k, v in ours.worker_init().items():
            np.testing.assert_allclose(v.numpy(), ref_init[k], **TOL)
    assert [r.dropped for r in ours.records] == \
        [False, False, False, True, False, True, False, True]
    assert ours.t == ref.t == len(SCHEDULE)
    state = ours.state
    assert state.step == len(SCHEDULE)
    for k, v in _flat(ref.state.params).items():
        np.testing.assert_allclose(state.params[k].numpy(), v, **TOL)


def test_commit_key_makes_arrivals_idempotent():
    rng = np.random.default_rng(1)
    ours = Synchronizer(bridge.to_torch(_flat(_tree(rng)), "cpu"),
                        OuterOptConfig(), n_workers=2)
    delta = bridge.to_torch(_flat(_tree(rng, 0.01)), "cpu")
    first = ours.on_arrival(delta, 0, 0, commit_key=(0, 0, 1))
    p = ours._pbuf.clone()
    again = ours.on_arrival(delta, 0, 0, commit_key=(0, 0, 1))
    assert again is first and ours.t == 1
    assert torch.equal(ours._pbuf, p)
    assert len(ours.records) == 1


def test_worker_init_is_theta_without_lookahead():
    rng = np.random.default_rng(2)
    init = bridge.to_torch(_flat(_tree(rng)), "cpu")
    ours = Synchronizer(init, OuterOptConfig(lookahead_init=False),
                        n_workers=2)
    ours.on_arrival(bridge.to_torch(_flat(_tree(rng, 0.01)), "cpu"), 0, 0)
    assert all(torch.equal(a, b) for a, b in
               zip(ours.worker_init().values(), ours.state.params.values()))
