"""The port's per-leaf outer step against the reference's: the per-leaf
kernel entry points (``kernels/ops.py``, the reference's Pallas kernels in
interpret mode on the CPU), ``block_correct`` on a tree with stacked layer
axes, the per-leaf ``Synchronizer(packed=False)`` of all 8 methods after
every arrival, the port's per-leaf server against its packed server, and
one live ``paper_hetero_severe`` run with both engines' servers swapped for
per-leaf kernel servers.

On the CPU each kernel wrapper runs its plain version; the kernels
themselves are held to those on the card (tests/test_torch_cuda.py).

Tolerances:
  * ``heloco_correct_block`` and ``outer_update_block`` against the
    reference's: the reference's own bands (tests/test_kernels.py): 2e-5
    fp32, 2e-2 bf16, 1e-5 for the five branch cases. The block sums add in
    another order than the Pallas interpreter's, and XLA may contract a
    multiply-add into one rounding where the port rounds each op;
  * ``block_correct``: 2e-5, 2e-2 for bf16 leaves;
  * per-leaf Synchronizer against the reference's, after every arrival:
    rtol 1e-5 / atol 1e-6, as the packed one in tests/test_torch_methods.py;
  * the port's per-leaf server against its packed server: 3e-5, the band of
    tests/test_packed.py:163-168 (the per-leaf step orders its scalar
    products as the reference's jnp does, the fused sweep as its kernel);
  * the live run: ``check_live`` of tests/test_torch_methods.py (arrivals
    equal, evals within 1e-4, parameters within 5e-4 of each leaf's
    largest |value|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.async_engine.engine import make_engine as jax_make_engine
from repro.async_engine.engine import make_eval_fn as jax_make_eval_fn
from repro.async_engine.server import Synchronizer as JaxSynchronizer
from repro.configs.base import HeLoCoConfig as JaxHeLoCoConfig
from repro.configs.base import OuterOptConfig as JaxOuterOptConfig
from repro.core import heloco as jheloco
from repro.core import methods as jmethods
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.scenarios import registry as jregistry
from repro_torch import bridge
from repro_torch.async_engine.engine import make_eval_fn
from repro_torch.async_engine.server import Synchronizer
from repro_torch.configs.base import HeLoCoConfig, OuterOptConfig
from repro_torch.core import heloco, methods, packing
from repro_torch.kernels import ops, ref
from repro_torch.scenarios import registry
from test_kernels import SHAPES
from test_packed import STACKED as JSTACKED
from test_packed import _tree as _jtree
from test_torch_methods import (  # noqa: F401 (an autouse fixture)
    DROPPED, METHODS, SCHEDULE, _deltas, check_live, one_intra_op_thread,
)
from test_torch_server import _flat, _tree

H = HeLoCoConfig()
JH = JaxHeLoCoConfig()
TOL = dict(rtol=1e-5, atol=1e-6)
# stacked layer axes of the trees of tests/test_torch_server.py (the
# servers) and tests/test_packed.py (block_correct)
STACKED = {"layers/b": 1, "layers/w": 1}
JAX_STACKED = {"emb": 0, "head": 0, "layers": {"b": 1, "w": 1}, "norm": 0}


def _tol(bf16):
    return dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=2e-5, atol=2e-5)


def _pair(x, bf16):
    """The same fp32 numpy values as a JAX array and a torch tensor, both
    rounded to bf16 (to nearest even on both sides) when asked."""
    j, t = jnp.asarray(x), torch.from_numpy(np.array(x, np.float32))
    return (j.astype(jnp.bfloat16), t.to(torch.bfloat16)) if bf16 else (j, t)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


# ---------------------------------------------------------------------------
# kernels/ops.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_heloco_correct_block_matches_reference(shape, bf16):
    rng = np.random.default_rng(len(shape) * 1000 + int(np.prod(shape)))
    (ju, tu), (jv, tv) = (_pair(rng.standard_normal(shape, np.float32), bf16)
                          for _ in range(2))
    want = jops.heloco_correct_block(ju, jv, JH, interpret=True)
    got = ops.heloco_correct_block(tu, tv, H)
    assert got.shape == shape and got.dtype == tu.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_tol(bf16))
    np.testing.assert_allclose(_np(ref.ref_heloco_correct(tu, tv, H)),
                               _np(jref.ref_heloco_correct(ju, jv, JH)),
                               **_tol(bf16))


@pytest.mark.parametrize("case", ["aligned", "anti", "weak", "zero_u",
                                  "zero_v"])
def test_heloco_correct_block_branches_match_reference(case):
    base = np.arange(1.0, 513.0, dtype=np.float32)
    u, v = {
        "aligned": (base, 2 * base),
        "anti": (base, -base),
        "weak": (base, np.roll(base, 256) - base.mean()),
        "zero_u": (np.zeros_like(base), base),
        "zero_v": (base, np.zeros_like(base)),
    }[case]
    want = jops.heloco_correct_block(jnp.asarray(u), jnp.asarray(v), JH,
                                     interpret=True)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    got = ops.heloco_correct_block(tu, tv, H)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(got), _np(ref.ref_heloco_correct(tu, tv, H)), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_outer_update_block_matches_reference(shape, bf16):
    rng = np.random.default_rng(7)
    jp, tp = _pair(rng.standard_normal(shape, np.float32), bf16)
    m, g = (rng.standard_normal(shape, np.float32) for _ in range(2))
    want = jops.outer_update_block(jp, jnp.asarray(m), jnp.asarray(g), 0.7,
                                   0.9, 0.447, interpret=True)
    got = ops.outer_update_block(tp, torch.from_numpy(m), torch.from_numpy(g),
                                 0.7, 0.9, 0.447)
    assert got[0].dtype == tp.dtype and got[1].dtype == torch.float32
    want_ref = jref.ref_outer_update(jp, jnp.asarray(m), jnp.asarray(g), 0.7,
                                     0.9, 0.447)
    got_ref = ref.ref_outer_update(tp, torch.from_numpy(m),
                                   torch.from_numpy(g), 0.7, 0.9, 0.447)
    for a, b in (*zip(got, want), *zip(got_ref, want_ref)):
        np.testing.assert_allclose(_np(a), _np(b), **_tol(bf16))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_block_correct_with_stacked_axes_matches_reference(use_kernel, bf16):
    """tests/test_packed.py's tree: a (3, 4, 5) and a (3, 5) leaf stacked
    over 3 layers, each layer its own block."""
    delta = _jtree(jax.random.PRNGKey(0), bf16)
    mom = jax.tree.map(lambda x: x.astype(jnp.float32),
                       _jtree(jax.random.PRNGKey(1)))
    want = _flat(jheloco.block_correct(delta, mom, JH, stacked_axes=JSTACKED,
                                       use_kernel=use_kernel))
    tdelta = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if bf16 else torch.float32)
        for k, v in _flat(delta).items()}
    tmom = bridge.to_torch(_flat(mom), "cpu")
    got = heloco.block_correct(tdelta, tmom, H, stacked_axes=STACKED,
                               use_kernel=use_kernel)
    other = heloco.block_correct(tdelta, tmom, H, stacked_axes=STACKED,
                                 use_kernel=not use_kernel)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == tdelta[k].dtype
        np.testing.assert_allclose(_np(got[k]), v.astype(np.float32),
                                   **_tol(bf16), err_msg=k)
        np.testing.assert_allclose(_np(got[k]), _np(other[k]), **_tol(bf16),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# The per-leaf Synchronizer
# ---------------------------------------------------------------------------

def _servers(name, packed_port=False, use_kernel=True):
    """The reference's per-leaf server and the port's (per-leaf, or packed
    with ``packed_port``) on the same initial tree, with staleness, delay
    weighting, drops and stacked layer axes."""
    rng = np.random.default_rng(3)
    init = _tree(rng)
    cfg = dict(method=name, drop_stale_after=3, delay_weighting=True,
               **jmethods.get(name).defaults())
    ref_srv = JaxSynchronizer(init, JaxOuterOptConfig(**cfg), n_workers=4,
                              stacked_axes=JAX_STACKED, packed=False,
                              use_kernel=use_kernel)
    ours = Synchronizer(bridge.to_torch(_flat(init), "cpu"),
                        OuterOptConfig(**cfg), n_workers=4,
                        stacked_axes=STACKED, packed=packed_port,
                        use_kernel=use_kernel)
    deltas = _deltas(rng, len(SCHEDULE))
    return ref_srv, ours, deltas, [bridge.to_torch(_flat(d), "cpu")
                                   for d in deltas]


def _close_states(got, want, **tol):
    """Two dict OuterStates (want: numpy leaves) leaf by leaf."""
    for part in ("params", "momentum", "aux"):
        a, b = getattr(got, part), getattr(want, part)
        assert (a is None) == (b is None), part
        for k, v in (b or {}).items():
            np.testing.assert_allclose(_np(a[k]), np.asarray(v, np.float32),
                                       **tol, err_msg=f"{part} {k}")


def _numpy_state(state):
    return state._replace(**{part: _flat(getattr(state, part))
                             for part in ("params", "momentum", "aux")
                             if getattr(state, part) is not None})


def _drive(ours, other, to_port, other_deltas, check, name):
    """Feed SCHEDULE (barrier rounds of three for sync_nesterov) to both
    servers, calling ``check()`` after every arrival."""
    if name == "sync_nesterov":
        for r in range(4):
            got = ours.on_sync_round(to_port[3 * r:3 * r + 3], sim_time=r)
            want = other.on_sync_round(other_deltas[3 * r:3 * r + 3],
                                       sim_time=r)
            assert got.__dict__ == {k: want.__dict__[k] for k in got.__dict__}
            check()
        return
    for (s_i, wid), d, od in zip(SCHEDULE, to_port, other_deltas):
        got = ours.on_arrival(d, s_i, wid, sim_time=1.0, lang="de")
        want = other.on_arrival(od, s_i, wid, sim_time=1.0, lang="de")
        assert got.__dict__ == {k: want.__dict__[k] for k in got.__dict__}
        check()
    assert [r.dropped for r in ours.records] == DROPPED


@pytest.mark.parametrize("name,use_kernel",
                         [(n, True) for n in METHODS] + [("heloco", False)])
def test_per_leaf_synchronizer_matches_reference_after_every_arrival(
        name, use_kernel):
    ref_srv, ours, deltas, to_port = _servers(name, use_kernel=use_kernel)
    assert not ours.packed and ours.layout is None

    def check():
        assert ours.t == ref_srv.t
        _close_states(ours.state, _numpy_state(ref_srv.state), **TOL)
        want = _flat(ref_srv.worker_init())
        for k, v in ours.worker_init().items():
            np.testing.assert_allclose(v.numpy(), want[k], **TOL)

    _drive(ours, ref_srv, to_port, deltas, check, name)


@pytest.mark.parametrize("name", METHODS)
def test_per_leaf_server_matches_the_packed_server(name):
    _, leaf, _, to_port = _servers(name)
    packed = Synchronizer(leaf.state.params, leaf.cfg, n_workers=4,
                          stacked_axes=STACKED)
    copies = [{k: v.clone() for k, v in d.items()} for d in to_port]

    def check():
        assert leaf.t == packed.t
        _close_states(leaf.state, _numpy_state(packed.state),
                      rtol=3e-5, atol=3e-5)

    _drive(leaf, packed, to_port, copies, check, name)


def test_per_leaf_state_setter_and_packed_deltas():
    _, ours, _, to_port = _servers("delayed_nesterov")
    ours.on_arrival(to_port[0], 0, 0)
    saved = ours.state
    ours.on_arrival(to_port[1], 0, 1)
    assert ours.t == 2
    ours.state = saved
    assert ours.t == 1 and ours.state is saved
    layout = packing.build_layout(saved.params)
    with pytest.raises(TypeError, match="per-leaf"):
        ours.on_arrival(packing.Packed(packing.pack(layout, to_port[1])), 1, 1)


@pytest.mark.parametrize("name", ["heloco", "fedbuff"])
def test_per_leaf_apply_arrivals_matches_the_packed_flush(name):
    """heloco.apply_arrivals (K sequential per-leaf steps) against the
    packed K-stacked commit, as tests/test_scale.py holds the reference's
    (its band: rtol 1e-5, atol 5e-6)."""
    rng = np.random.default_rng(5)
    params = bridge.to_torch(_flat(_tree(rng)), "cpu")
    deltas = [bridge.to_torch(_flat(d), "cpu") for d in _deltas(rng, 4)]
    m = methods.get(name)
    rhos = [1.0 / np.sqrt(1.0 + (j % 3)) for j in range(4)]
    taus = [float(j % 3) for j in range(4)]
    phases = list(range(2, 6)) if m.uses_buffer else None
    kw = dict(method=m, outer_lr=0.7, mu=0.9, h=H, rhos=rhos, taus=taus,
              phases=phases)
    state = heloco.apply_arrivals(
        heloco.init_outer_state(params, with_aux=m.uses_buffer), deltas,
        stacked_axes=STACKED, use_kernel=True, **kw)
    layout = packing.build_layout(params, STACKED)
    got = heloco.apply_arrivals_packed(
        packing.pack(layout, params), packing.zeros(layout, "cpu"), deltas, layout,
        abuf=packing.zeros(layout, "cpu") if m.uses_buffer else None, **kw)
    assert state.step == 4
    parts = ("params", "momentum", "aux")[:len(got)]
    for part, buf in zip(parts, got):
        for k, v in packing.unpack(layout, buf).items():
            np.testing.assert_allclose(
                v.numpy(), getattr(state, part)[k].numpy(), rtol=1e-5,
                atol=5e-6, err_msg=f"{name} {part} {k}")


@pytest.mark.parametrize("name", ["heloco", "fedbuff"])
def test_packed_state_setter_round_trips_a_saved_state(name):
    """A saved OuterState set back on a packed server restores its buffers
    (the accumulator too): the next arrival then lands bit for bit where it
    landed the first time."""
    _, ours, _, to_port = _servers(name, packed_port=True)
    ours.on_arrival(to_port[0], 0, 0)
    saved = ours.state
    ours.on_arrival(to_port[1], 0, 1)
    first = ours.state
    ours.state = saved
    assert ours.t == 1
    assert (ours.state.aux is None) == (name != "fedbuff")
    for part in ("params", "momentum", "aux"):
        a, b = getattr(ours.state, part), getattr(saved, part)
        assert (a is None) == (b is None), part
        for k in b or {}:
            assert torch.equal(a[k], b[k]), f"{part} {k}"
    ours.on_arrival(to_port[1], 0, 1)
    for part in ("params", "momentum", "aux"):
        for k, v in (getattr(first, part) or {}).items():
            assert torch.equal(getattr(ours.state, part)[k], v), \
                f"{part} {k}"


# ---------------------------------------------------------------------------
# One live run through both engines with per-leaf kernel servers
# ---------------------------------------------------------------------------

def test_live_paper_hetero_severe_on_per_leaf_kernel_servers():
    scn = jregistry.get_scenario("paper_hetero_severe")
    jeng = jax_make_engine(scn)
    eng = registry.get_scenario("paper_hetero_severe").build(
        device="cpu", init_params=_flat(jeng.server.state.params))
    jeng.server = JaxSynchronizer(jeng.server.state.params, jeng.cfg.outer,
                                  jeng.cfg.n_workers, packed=False,
                                  use_kernel=True)
    eng.server = Synchronizer(eng.server.state.params, eng.cfg.outer,
                              eng.cfg.n_workers, packed=False,
                              use_kernel=True)
    jhist = jeng.run(eval_every=scn.eval_cadence,
                     eval_fn=jax_make_eval_fn(jeng, batch=scn.eval_batch))
    hist = eng.run(eval_every=scn.eval_cadence,
                   eval_fn=make_eval_fn(eng, batch=scn.eval_batch))
    assert not eng.server.packed and eng.server.layout is None
    check_live(jeng, jhist, eng, hist)
