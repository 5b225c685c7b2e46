"""The port's pseudo-gradient compression (``core/compression.py``) and the
plain versions of its three packed int8 kernels against the reference's,
whose Pallas kernels run in interpret mode on the CPU as the reference's own
tests run them.

Every comparison here is bit for bit: a max is exact in any order, and the
quantization is one IEEE division, one round-half-to-even and one product
per element on both sides. The inputs hold values placed exactly on .5
quantization ties (a block whose largest |value| is 63.5 has scale 0.5, so
(n + 0.5) * 0.5 divides to n + 0.5 exactly) and all-zero blocks (the 1e-12
scale floor). The kernels themselves are held to these plain versions on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.async_engine.server import Synchronizer as JaxSynchronizer
from repro.configs import get_config as jax_get_config
from repro.configs.base import OuterOptConfig as JaxOuterOptConfig
from repro.core import compression as jcomp
from repro.core import packing as jpacking
from repro.kernels import packed as jpk
from repro.models import Model as JaxModel
from repro_torch import bridge
from repro_torch.async_engine.server import Synchronizer
from repro_torch.configs.base import OuterOptConfig
from repro_torch.core import compression, packing
from repro_torch.kernels import packed as pk
from test_torch_server import SCHEDULE, _deltas, _flat, _tree
from test_torch_server import TOL as SERVER_TOL

# the reference's tests/test_packed.py:_tree shapes, with its stacked axes
STACKED_SHAPES = {"emb": (40, 30), "layers": {"w": (3, 4, 5), "b": (3, 5)},
                  "norm": (129,), "head": (17,)}
STACKED_AXES = {"emb": 0, "layers": {"w": 1, "b": 1}, "norm": 0, "head": 0}
TIES = (np.arange(-20, 20) + 0.5) * 0.5      # x / 0.5 lands on n + 0.5


@functools.lru_cache(maxsize=1)
def _smoke_shapes():
    params = JaxModel(jax_get_config("tinygpt-15m-smoke")).init(
        jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: tuple(x.shape), params)


def _with_ties(x: np.ndarray) -> np.ndarray:
    """Scale 0.5 for the block that starts the array (its |max| is 63.5)
    and exact .5 ties after it."""
    flat = x.reshape(-1)
    n = min(len(TIES), flat.size - 1)
    flat[0] = 63.5
    flat[1:1 + n] = TIES[:n]
    return x


def _delta_tree(shapes, seed, zero=(), ties=()):
    """A numpy pseudo-gradient of the given shapes: N(0, 0.01^2) values,
    the leaves named in ``zero`` all zero and those in ``ties`` with
    :func:`_with_ties`."""
    rng = np.random.default_rng(seed)
    flat_shapes = _flat(jax.tree.map(np.zeros, shapes,
                                     is_leaf=lambda s: isinstance(s, tuple)))
    out = {}
    for path, a in flat_shapes.items():
        x = (0.01 * rng.standard_normal(a.shape)).astype(np.float32)
        if path in zero:
            x[...] = 0.0
        if path in ties:
            x = _with_ties(x)
        out[path] = x
    return out


def _nested(flat):
    """``{"a/b": x}`` -> ``{"a": {"b": x}}`` as jnp arrays, the reference's
    pytree."""
    tree = {}
    for path, x in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(x)
    return tree


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


CASES = {
    # the engine's layout: full leaves of the reduced tinygpt
    "tinygpt_smoke": (lambda: _smoke_shapes(), None,
                      {"zero": ("final_norm/bias",),
                       "ties": ("embed/tok", "blocks_list/layer_01/mlp/w_in")}),
    # a stacked layer axis: each layer is its own block
    "stacked": (lambda: STACKED_SHAPES, STACKED_AXES,
                {"zero": ("head",), "ties": ("emb", "layers/w")}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_int8_error_feedback_bit_identical_to_reference(case):
    """Two rounds of ``roundtrip_with_error_feedback`` through the packed
    layout: the first with no error feedback yet, the second carrying the
    first's. Decoded buffer, new ef and wire bytes equal the reference's."""
    shapes_fn, stacked, special = CASES[case]
    shapes = shapes_fn()
    d0 = _delta_tree(shapes, 0, **special)
    jlayout = jpacking.build_layout(_nested(d0), stacked)
    flat_stacked = _flat(stacked) if stacked is not None else None
    layout = packing.build_layout(d0, flat_stacked)
    ef, jef = None, None
    for rnd in range(2):
        d = d0 if rnd == 0 else _delta_tree(shapes, 1)
        jdec, jef, jbytes = jcomp.roundtrip_with_error_feedback(
            _nested(d), jef, "int8", layout=jlayout)
        dec, ef, nbytes = compression.roundtrip_with_error_feedback(
            bridge.to_torch(d, "cpu"), ef, "int8", layout=layout)
        assert isinstance(dec, packing.Packed)
        _eq(dec.buf, jdec.buf)
        _eq(ef, jef)
        assert nbytes == jbytes == layout.total_elems + 4 * layout.n_blocks


def test_packed_int8_roundtrip_is_three_kernel_sweeps():
    d = _delta_tree(STACKED_SHAPES, 2)
    layout = packing.build_layout(d, _flat(STACKED_AXES))
    jlayout = jpacking.build_layout(_nested(d), STACKED_AXES)
    buf = packing.pack(layout, bridge.to_torch(d, "cpu"))
    dec, nbytes = compression.packed_int8_roundtrip(buf, layout)
    jdec, jbytes = jcomp.packed_int8_roundtrip(jnp.asarray(buf.numpy()),
                                               jlayout)
    _eq(dec, jdec)
    assert nbytes == jbytes
    # a Packed value passes through pack(): the arrival path takes it as is
    assert packing.pack(layout, packing.Packed(dec)) is dec


def _kernel_inputs(seed=3):
    """An (8, 128) buffer of 4 blocks of 2 rows: block 0 on .5 ties at scale
    0.5, block 1 all zero, blocks 2 and 3 N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    x[0:2] = np.resize(TIES, (2, 128)).astype(np.float32)
    x[0, 0] = 63.5
    x[2:4] = 0.0
    row_block = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    return x, row_block


def test_kernel_plain_versions_bit_identical_to_pallas():
    x, row_block = _kernel_inputs()
    # scales: the ties' exact 0.5, the zero floor, and two scales small
    # enough that x / s leaves [-127, 127] (the clip)
    scale = np.array([0.5, 1e-12 / 127, 0.004, 0.01], np.float32)
    xt = torch.from_numpy(x)
    st, rbt = torch.from_numpy(scale), torch.from_numpy(row_block)
    rows = jnp.asarray(scale[row_block][:, None])
    q = pk.packed_quant(xt, st, rbt)
    jq = jpk.packed_quant(jnp.asarray(x), rows, interpret=True)
    _eq(q, jq)
    assert (np.abs(q.numpy()[4:].astype(int)) == 127).any()      # clipped
    np.testing.assert_array_equal(q.numpy()[0, 1:5], np.rint(x[0, 1:5] / 0.5))
    _eq(pk.packed_dequant(q, st, rbt),
        jpk.packed_dequant(jq, rows, interpret=True))
    x[7, 5] = np.nan
    absmax = pk.packed_rowabs(torch.from_numpy(x))
    jabs = np.asarray(jpk.packed_rowabs(jnp.asarray(x), interpret=True))
    assert absmax.shape == (8, 1) and torch.isnan(absmax[7, 0])
    np.testing.assert_array_equal(absmax.numpy(), jabs)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_per_leaf_roundtrip_bit_identical_to_reference(kind):
    """The per-leaf paths (no layout), two rounds with error feedback. The
    top-k input has ties in |value| across signs; both sides keep the lower
    index."""
    d0 = _delta_tree(STACKED_SHAPES, 4, zero=("head",), ties=("emb",))
    d0["norm"][:40] = np.where(np.arange(40) % 2, 0.02, -0.02)
    ef, jef = None, None
    for rnd in range(2):
        d = d0 if rnd == 0 else _delta_tree(STACKED_SHAPES, 5)
        jdec, jef, jbytes = jcomp.roundtrip_with_error_feedback(
            _nested(d), jef, kind, topk_ratio=0.1)
        dec, ef, nbytes = compression.roundtrip_with_error_feedback(
            bridge.to_torch(d, "cpu"), ef, kind, topk_ratio=0.1)
        for path, want in _flat(jdec).items():
            _eq(dec[path], want)
        for path, want in _flat(jef).items():
            _eq(ef[path], want)
        assert nbytes == jbytes


def test_uncompressed_roundtrip_matches_reference():
    d = _delta_tree(STACKED_SHAPES, 6)
    jdec, jef, jbytes = jcomp.roundtrip_with_error_feedback(
        _nested(d), None, "none")
    dec, ef, nbytes = compression.roundtrip_with_error_feedback(
        bridge.to_torch(d, "cpu"), None, "none")
    # the reference's error feedback is zeros; the port keeps none
    assert ef is None and nbytes == jbytes
    for path, want in _flat(jef).items():
        assert not want.any()
        _eq(dec[path], _flat(jdec)[path])


def test_packed_wrong_shape_refused():
    layout = packing.build_layout({"a": np.zeros(300, np.float32)})
    with pytest.raises(ValueError, match="packed buffer"):
        packing.pack(layout, packing.Packed(
            torch.zeros(layout.n_rows + 1, 128)))


def test_int8_arrivals_match_reference_synchronizer_after_every_arrival():
    """The int8 worker path into the server, fed the same numpy
    pseudo-gradients on both sides: each worker's packed round-trip with its
    own error feedback (decoded buffer and ef bit for bit), then the
    ``Packed`` arrival through the packed Synchronizer, whose state stays
    within tests/test_torch_server.py's bounds after every arrival. A live
    run cannot hold this: a 1-ulp drift of the inner rounds can flip an
    int8 rounding decision."""
    rng = np.random.default_rng(7)
    init = _tree(rng)
    ref = JaxSynchronizer(init, JaxOuterOptConfig(compression="int8"),
                          n_workers=4)
    ours = Synchronizer(bridge.to_torch(_flat(init), "cpu"),
                        OuterOptConfig(compression="int8"), n_workers=4)
    efs, jefs = {}, {}
    for (s_i, wid), delta in zip(SCHEDULE, _deltas(rng)):
        jdec, jefs[wid], jbytes = jcomp.roundtrip_with_error_feedback(
            delta, jefs.get(wid), "int8", layout=ref.layout)
        dec, efs[wid], nbytes = compression.roundtrip_with_error_feedback(
            bridge.to_torch(_flat(delta), "cpu"), efs.get(wid), "int8",
            layout=ours.layout)
        _eq(dec.buf, jdec.buf)
        _eq(efs[wid], jefs[wid])
        assert nbytes == jbytes
        want = ref.on_arrival(jdec, s_i, wid)
        got = ours.on_arrival(dec, s_i, wid)
        assert got.__dict__ == {k: want.__dict__[k] for k in got.__dict__}
        np.testing.assert_allclose(ours._pbuf.numpy(), np.asarray(ref._pbuf),
                                   **SERVER_TOL)
        np.testing.assert_allclose(ours._mbuf.numpy(), np.asarray(ref._mbuf),
                                   **SERVER_TOL)
