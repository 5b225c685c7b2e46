"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one. The file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: p'/m'(/b') of the fused updates bit for bit (the source is
built with --fmad=false, so each product and sum rounds as in PyTorch);
per-row and per-block sums, which the kernel adds in a shuffle tree, each
within 1e-5 of its own scale: sqrt(uu*vv) for a dot product, the value
itself for a sum of squares.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import HeLoCoConfig
from repro_torch.core import packing
from repro_torch.kernels import packed as pk

H = HeLoCoConfig()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _layout(rows_per_leaf):
    return packing.build_layout(
        {f"leaf{i:02d}": torch.empty(r * 128 - 5) for i, r in
         enumerate(rows_per_leaf)})


def _buffers(layout, dev, n, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((layout.n_rows, 128), generator=gen, device=dev)
            for _ in range(n)]


def _close_sums(got, want):
    """Rows of (dot, uu, vv[, more sums of squares]), each entry within 1e-5
    of its own scale: sqrt(uu * vv) for the dot, itself for the others."""
    got, want = got.double().cpu(), want.double().cpu()
    scale = want.abs()
    scale[:, 0] = (want[:, 1] * want[:, 2]).sqrt()
    bad = ((got - want).abs() > 1e-5 * scale).nonzero()
    assert not len(bad), (f"{len(bad)} sums off, first at {bad[0].tolist()}: "
                          f"got {got[tuple(bad[0])]} want {want[tuple(bad[0])]}")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(1,), (3, 1, 33), (2048, 5, 2049)])
def test_row_stats_and_block_stats_match_plain(cuda, rows):
    layout = _layout(rows)
    d, m = _buffers(layout, cuda, 2)
    n0 = pk.packed_row_stats.launches
    got = pk.packed_row_stats(d, m)
    torch.cuda.synchronize()
    assert pk.packed_row_stats.launches == n0 + 1
    _close_sums(got, pk.packed_row_stats_ref(d, m))
    blocks = pk.packed_stats(d, m, layout)
    assert torch.equal(blocks, pk.packed_stats(d, m, layout))
    _close_sums(blocks.cpu(), pk.packed_stats(d.cpu(), m.cpu(), layout))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(1,), (3, 1, 33), (2048, 5, 2049)])
def test_correct_outer_bit_identical_to_plain(cuda, rows):
    layout = _layout(rows)
    p, m, d = _buffers(layout, cuda, 3, seed=1)
    cu, cv = pk.branch_scalars(pk.packed_stats(d, m, layout), H)
    rb, _ = layout.device_tables(cuda)
    want = pk.packed_correct_outer_ref(p, m, d, cu, cv, rb, 0.7, 0.9, 0.5,
                                       with_stats=True)
    n0 = pk.packed_correct_outer.launches
    p1, m1 = pk.packed_correct_outer(p, m, d, cu, cv, rb, 0.7, 0.9, 0.5)
    p2, m2, s = pk.packed_correct_outer(p, m, d, cu, cv, rb, 0.7, 0.9, 0.5,
                                        with_stats=True)
    torch.cuda.synchronize()
    assert pk.packed_correct_outer.launches == n0 + 2
    assert torch.equal(p1, want[0]) and torch.equal(m1, want[1])
    assert torch.equal(p2, p1) and torch.equal(m2, m1)
    _close_sums(s, want[2])
    pk.packed_correct_outer(p, m, d, cu, cv, rb, 0.7, 0.9, 0.5, out=(p, m))
    torch.cuda.synchronize()
    assert torch.equal(p, p1) and torch.equal(m, m1)


# (am, bm, ab, cg, cm, ca): a delayed-Nesterov boundary and a FedBuff
# non-boundary arrival (cg = 0: the parameters come back unchanged)
ACC_TABLES = {"dn_boundary": (0.9, 0.025, 0.0, 1.0, 0.9, 0.0),
              "fedbuff_hold": (1.0, 0.0, 1.0, 0.0, 0.0, 0.0)}


def _coeffs(layout, dev, seed=2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = layout.n_blocks
    return (torch.rand(n, generator=gen, device=dev) + 0.5,
            torch.rand(n, generator=gen, device=dev) - 0.5,
            -0.3 * torch.rand(n, generator=gen, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(1,), (3, 1, 33), (2048, 5, 2049)])
def test_correct_outer_quad_bit_identical_to_plain(cuda, rows):
    layout = _layout(rows)
    p, m, d = _buffers(layout, cuda, 3, seed=3)
    cu, cv, cq = _coeffs(layout, cuda)
    rb, _ = layout.device_tables(cuda)
    args = (cu, cv, cq, rb, 0.07, 0.9, 0.5)
    want = pk.packed_correct_outer_quad_ref(p, m, d, *args, with_stats=True)
    n0 = pk.packed_correct_outer_quad.launches
    p1, m1 = pk.packed_correct_outer_quad(p, m, d, *args)
    p2, m2, s = pk.packed_correct_outer_quad(p, m, d, *args, with_stats=True)
    torch.cuda.synchronize()
    assert pk.packed_correct_outer_quad.launches == n0 + 2
    assert torch.equal(p1, want[0]) and torch.equal(m1, want[1])
    assert torch.equal(p2, p1) and torch.equal(m2, m1)
    _close_sums(s, want[2])
    pk.packed_correct_outer_quad(p, m, d, *args, out=(p, m))
    torch.cuda.synchronize()
    assert torch.equal(p, p1) and torch.equal(m, m1)


@pytest.mark.cuda
@pytest.mark.parametrize("table", sorted(ACC_TABLES))
@pytest.mark.parametrize("rows", [(1,), (3, 1, 33), (2048, 5, 2049)])
def test_correct_outer_acc_bit_identical_to_plain(cuda, rows, table):
    layout = _layout(rows)
    p, m, b, d = _buffers(layout, cuda, 4, seed=4)
    cu, cv, _ = _coeffs(layout, cuda)
    rb, _ = layout.device_tables(cuda)
    args = (cu, cv, rb, 0.7, 0.5, *ACC_TABLES[table])
    want = pk.packed_correct_outer_acc_ref(p, m, b, d, *args, with_stats=True)
    n0 = pk.packed_correct_outer_acc.launches
    got = pk.packed_correct_outer_acc(p, m, b, d, *args)
    stats = pk.packed_correct_outer_acc(p, m, b, d, *args, with_stats=True)
    torch.cuda.synchronize()
    assert pk.packed_correct_outer_acc.launches == n0 + 2
    assert all(torch.equal(g, w) for g, w in zip(got, want[:3]))
    assert all(torch.equal(g, w) for g, w in zip(stats[:3], got))
    _close_sums(stats[3], want[3])
    if table == "fedbuff_hold":
        assert torch.equal(got[0], p)
    pk.packed_correct_outer_acc(p, m, b, d, *args, out=(p, m, b))
    torch.cuda.synchronize()
    assert all(torch.equal(x, g) for x, g in zip((p, m, b), got))


@pytest.mark.cuda
def test_kernels_refuse_mixed_devices(cuda):
    layout = _layout((2,))
    d, m = _buffers(layout, cuda, 2)
    with pytest.raises(ValueError):
        pk.packed_row_stats(d, m.cpu())
    cu = torch.ones(layout.n_blocks, device=cuda)
    rb = torch.from_numpy(layout.row_block)        # on the CPU
    with pytest.raises(ValueError):
        pk.packed_correct_outer(d, m, d, cu, cu, rb, 0.7, 0.9, 1.0)
    with pytest.raises(ValueError):
        pk.packed_correct_outer_quad(d, m, d, cu, cu, cu, rb, 0.07, 0.9, 1.0)
    with pytest.raises(ValueError):
        pk.packed_correct_outer_acc(d, m, d.cpu(), d, cu, cu,
                                    layout.device_tables(cuda)[0], 0.7, 1.0,
                                    *ACC_TABLES["dn_boundary"])


# kernel launches per arrival (per barrier round for sync_baseline)
LAUNCHES = {
    "paper_hetero_severe": {"packed_row_stats": 1, "packed_correct_outer": 1},
    "drop_stale": {"packed_row_stats": 1, "packed_correct_outer": 1},
    "dcasgd": {"packed_correct_outer_quad": 1},
    "delayed_nesterov": {"packed_correct_outer_acc": 1},
    "fedbuff": {"packed_correct_outer_acc": 1},
    "poly_stale": {"packed_correct_outer": 1},
    "sync_baseline": {"packed_correct_outer": 1},
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_smoke_scenario_on_the_card_matches_golden(cuda, name):
    from repro_torch.scenarios import registry, run
    scn = registry.get_scenario(name)
    pk.reset_launch_counts()
    eng, hist = run.run(scn, "cuda")
    assert run.compare(scn, hist) == []
    applied = sum(not a["dropped"] for a in hist.arrivals)
    want = {k: LAUNCHES[name].get(k, 0) * applied for k in pk.launch_counts()}
    assert pk.launch_counts() == want
    assert eng.server._pbuf.device.type == "cuda"
    assert all(np.isfinite(e["mean"]) for e in hist.evals)
