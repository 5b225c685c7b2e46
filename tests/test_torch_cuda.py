"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one. The file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: p'/m' of the fused update bit for bit (the source is built
with --fmad=false, so each product and sum rounds as in PyTorch); per-row
and per-block sums, which the kernel adds in a shuffle tree, each within
1e-5 of its own scale: sqrt(uu*vv) for a dot product, the value itself for
a sum of squares.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import HeLoCoConfig
from repro_torch.core import packing
from repro_torch.kernels import packed as pk

ROOT = Path(__file__).resolve().parents[1]
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


@pytest.mark.cuda
def test_smoke_slice_on_the_card_matches_golden_arrivals(cuda):
    from repro_torch.async_engine.engine import make_engine, make_eval_fn
    from repro_torch.launch.train import parse_args, run_config_from_args
    args = parse_args(["--smoke", "--workers", "4", "--paces", "1,2,6,15",
                       "--outer", "12", "--inner", "2", "--batch", "2",
                       "--seq", "16", "--device", "cuda"])
    eng = make_engine(run_config_from_args(args), device="cuda")
    pk.reset_launch_counts()
    hist = eng.run(eval_every=3, eval_fn=make_eval_fn(eng, batch=8))
    rows = [[a["outer_step"], a["worker_id"],
             a["outer_step"] - 1 - a["staleness"], a["staleness"], a["lang"],
             a["rho"], a["sim_time"], bool(a["dropped"])]
            for a in hist.arrivals]
    golden = json.loads(
        (ROOT / "results/golden/paper_hetero_severe.json").read_text())
    assert rows == golden["arrivals"]
    assert pk.launch_counts() == {"packed_row_stats": 12,
                                  "packed_correct_outer": 12}
    assert all(np.isfinite(e["mean"]) for e in hist.evals)
