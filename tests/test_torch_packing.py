"""Packed layout of the port against the reference: the same rows, blocks
and bytes for reduced tinygpt, full-width tinygpt (layout only) and a
pytree with stacked layer axes. Layouts are integer maps and packing is a
copy, so everything here is compared exactly."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import packing as jpk
from repro.models import Model as JaxModel
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import packing
from repro_torch.models import Model


def _paths(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in leaves}


def _stacked_tree(seed=0):
    """Multi-leaf pytree incl. stacked layer axes (the reference's
    ``tests/test_packed.py:_tree`` shapes, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    tree = {"emb": f(40, 30), "layers": {"w": f(3, 4, 5), "b": f(3, 5)},
            "norm": f(129), "head": f(17)}
    stacked = {"emb": 0, "layers": {"w": 1, "b": 1}, "norm": 0, "head": 0}
    return tree, stacked


def _assert_same_layout(ours, ref):
    assert ours.paths == tuple(_paths(jax.tree.unflatten(
        ref.treedef, list(range(len(ref.leaves))))))
    assert (ours.n_rows, ours.data_rows, ours.n_blocks, ours.total_elems) == \
        (ref.n_rows, ref.data_rows, ref.n_blocks, ref.total_elems)
    np.testing.assert_array_equal(ours.row_block, ref.row_block)
    np.testing.assert_array_equal(ours.block_sizes, ref.block_sizes)
    assert ours.block_row_ranges == ref.block_row_ranges


@functools.lru_cache(maxsize=1)
def _reduced_tree():
    return JaxModel(jax_get_config("tinygpt-15m-smoke")).init(
        jax.random.PRNGKey(0))


def _reduced_params():
    return {k: np.asarray(v) for k, v in _paths(_reduced_tree()).items()}


def test_layout_and_bytes_match_reference_on_reduced_tinygpt():
    flat = _reduced_params()
    ref_tree = _reduced_tree()
    ref = jpk.build_layout(ref_tree)
    ours = packing.build_layout(flat)
    _assert_same_layout(ours, ref)
    buf = packing.pack(ours, bridge.to_torch(flat, "cpu"))
    np.testing.assert_array_equal(buf.numpy(),
                                  np.asarray(jpk.pack(ref, ref_tree)))


def test_full_width_tinygpt_layout_matches_reference():
    cfg = jax_get_config("tinygpt-15m")
    shapes = jax.eval_shape(JaxModel(cfg).init, jax.random.PRNGKey(0))
    ref = jpk.build_layout(shapes)
    ours = packing.build_layout(_paths(shapes))
    _assert_same_layout(ours, ref)
    # the port's own model declares the same leaves and shapes
    port_shapes = Model(get_config("tinygpt-15m")).param_specs()
    assert {k: tuple(v.shape) for k, v in port_shapes.items()} == \
        {k: tuple(v.shape) for k, v in _paths(shapes).items()}
    assert packing.build_layout(port_shapes).row_block.tobytes() == \
        ref.row_block.tobytes()
    assert (ours.n_rows, ours.n_blocks, ours.total_elems) == \
        (125_128, 43, 16_016_128)


def test_stacked_axes_layout_and_bytes_match_reference():
    tree, stacked = _stacked_tree()
    ref = jpk.build_layout(tree, stacked)
    ours = packing.build_layout(_paths(tree), _paths(stacked))
    _assert_same_layout(ours, ref)
    buf = packing.pack(ours, bridge.to_torch(_paths(tree), "cpu"))
    np.testing.assert_array_equal(buf.numpy(),
                                  np.asarray(jpk.pack(ref, tree)))


@pytest.mark.parametrize("which", ["reduced", "stacked"])
def test_unpack_inverts_pack(which):
    if which == "reduced":
        flat, stacked = _reduced_params(), None
    else:
        tree, st = _stacked_tree(1)
        flat, stacked = _paths(tree), _paths(st)
    params = bridge.to_torch(flat, "cpu")
    layout = packing.build_layout(params, stacked)
    back = packing.unpack(layout, packing.pack(layout, params))
    assert list(back) == list(layout.paths)
    for k, v in params.items():
        assert back[k].dtype == v.dtype
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_pack_rejects_mismatched_params():
    params = {"a": torch.zeros(3), "b": torch.zeros(2, 2)}
    layout = packing.build_layout(params)
    with pytest.raises(ValueError):
        packing.pack(layout, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        packing.pack(layout, {"a": torch.zeros(4), "b": torch.zeros(2, 2)})
