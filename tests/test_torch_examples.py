"""The port's examples (``examples/*_torch.py``) on the CPU at short
settings, and the ad-hoc scenario helpers they use held equal to the
reference harness's (``benchmarks/common.py``)."""
import importlib.util
import math
from pathlib import Path

import pytest

from benchmarks import common as jcommon
from repro_torch.scenarios import adhoc
from repro_torch.sweeps import cache
from test_torch_methods import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_adhoc_helpers_equal_the_reference_harness():
    assert adhoc.METHODS == jcommon.METHODS
    assert list(adhoc.METHODS) == list(jcommon.METHODS)
    cases = [dict(method="async-heloco", non_iid=True, outer_steps=30,
                  inner_steps=8),
             dict(method="sync-nesterov", non_iid=False, outer_steps=4,
                  inner_steps=2, dylu=True, compression="int8",
                  drop_stale_after=2, mixture_alpha=0.3, seed=3,
                  engine="wallclock"),
             dict(method="dcasgd", non_iid=True, outer_steps=5,
                  inner_steps=1, shard_assignment="flexible", batch_size=2,
                  seq_len=16, name="x")]
    for kw in cases:
        for paces in ((0.74, 1.5, 3, 6, 7.5), (1, 2)):
            assert adhoc.scenario_for(paces, **kw).to_dict() == \
                jcommon.scenario_for(paces, **kw).to_dict(), kw


def test_quickstart_runs_on_the_cpu(capsys):
    hist = _example("quickstart_torch").main(
        ["--device", "cpu", "--outer", "6", "--inner", "2", "--eval-every",
         "3"])
    out = capsys.readouterr().out
    assert "arrivals=6 tokens=" in out and "device=cpu" in out
    assert [e["step"] for e in hist.evals] == [3, 6]
    assert all(math.isfinite(e["mean"]) for e in hist.evals)
    assert "staleness: mean=" in out
    assert len([ln for ln in out.splitlines() if ln[:4].strip().isdigit()]) \
        == 2


def test_heterogeneous_async_runs_on_the_cpu(capsys, tmp_path, monkeypatch):
    monkeypatch.setattr(cache, "RESULTS_DIR", str(tmp_path))
    mod = _example("heterogeneous_async_torch")
    out = mod.main(["--device", "cpu", "--paces", "1,2,6", "--methods",
                    "async-heloco,sync-nesterov", "--outer", "4", "--inner",
                    "1", "--compression", "int8", "--drop-stale-after", "2"])
    text = capsys.readouterr().out
    rows = [ln.split(",") for ln in text.splitlines() if ln.startswith(
        ("async-heloco,", "sync-nesterov,"))]
    assert [r[0] for r in rows] == ["async-heloco", "sync-nesterov"]
    for r in rows:
        assert all(math.isfinite(float(x)) for x in r[1:])
    assert out["async-heloco"]["config"]["compression"] == "int8"
    assert len(list(tmp_path.glob("example_*.json"))) == 2
    with pytest.raises(SystemExit, match="unknown method"):
        mod.main(["--device", "cpu", "--methods", "no-such"])
    hist = mod.main(["--scenario", "sync_baseline", "--device", "cpu"])
    assert len(hist["sync_baseline"].arrivals) == 4
    assert "arrivals=4" in capsys.readouterr().out


def test_elastic_failover_runs_on_the_cpu(capsys, tmp_path):
    hist, latest, restored, hist2 = _example("elastic_failover_torch").main(
        ["--device", "cpu", "--inner", "2", "--outer", "60", "--more", "2",
         "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    w1 = [a["sim_time"] for a in hist.arrivals if a["worker_id"] == 1]
    w9 = [a["sim_time"] for a in hist.arrivals if a["worker_id"] == 9]
    # crashed at t=20 (its round lost), back at t=50; joined at t=40
    assert w1 and not [t for t in w1 if 20 < t < 50] and max(w1) > 50
    assert w9 and min(w9) > 40
    assert Path(latest).name == "step_60.npz" and restored == 60
    assert sorted(p.name for p in tmp_path.glob("*.npz"))[-1] == \
        "step_60.npz"
    assert "restored outer step 60" in out and "continued to step 62" in out
    assert all(math.isfinite(e["mean"]) for e in hist.evals + hist2.evals)
