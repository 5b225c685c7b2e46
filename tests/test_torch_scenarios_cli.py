"""The port's scenario CLI (``repro_torch.scenarios.run`` and ``python -m
repro_torch.scenarios``) against the reference's ``repro.scenarios.run``:
``list`` prints what the reference prints for every filter, the
selection of ``record``/``verify`` (names, ``--all``, the filters) is the
reference's, ``record`` writes the reference's golden format to the
port's own directory with a committed golden's arrivals, tokens,
communication and final time, and a directory under ``results/golden``
is refused with nothing written."""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.scenarios import run as jrun
from repro_torch.scenarios import run, trace
from test_torch_methods import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FILTERS = [[], ["--engine-filter", "sim"], ["--engine-filter", "wallclock"],
           ["--transport-filter", "inproc"], ["--transport-filter", "socket"],
           ["--engine-filter", "wallclock", "--transport-filter", "socket"],
           ["--engine-filter", "sim", "--transport-filter", "socket"]]


@pytest.mark.parametrize("flags", FILTERS, ids=lambda f: " ".join(f) or "all")
def test_list_prints_what_the_reference_prints(flags, capsys):
    assert jrun.main(["list", *flags]) == 0
    want = capsys.readouterr().out
    assert run.main(["list", *flags]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[-1].endswith(" scenarios")


@pytest.mark.parametrize("names,all_", [((), False), ((), True),
                                        (("dcasgd", "chaos_lossy",
                                          "socket_hetero"), False),
                                        (("dcasgd", "fedbuff"), True)])
def test_selection_is_the_references(names, all_):
    for flags in FILTERS:
        ns = argparse.Namespace(names=list(names), all=all_,
                                engine_filter=None, transport_filter=None)
        for a, b in zip(flags[::2], flags[1::2]):
            setattr(ns, a[2:].replace("-", "_"), b)
        want = [s.name for s in jrun._grouped(jrun._select(ns))]
        got = [s.name for s in run.select(names, all_, ns.engine_filter,
                                          ns.transport_filter)]
        assert got == want, (names, all_, flags)


def test_record_writes_the_golden_format(tmp_path, capsys):
    assert run.main(["record", "sync_baseline", "--dir", str(tmp_path),
                     "--device", "cpu"]) == 0
    assert "recorded sync_baseline" in capsys.readouterr().out
    path = tmp_path / "sync_baseline.json"
    got = json.loads(path.read_text())
    want = trace.load_golden("sync_baseline")
    assert set(got) == set(want)
    for key in ("schema", "scenario", "engine", "mode", "exact", "arrivals",
                "tokens", "comm_bytes", "final_time"):
        assert got[key] == want[key], key
    assert len(got["evals"]) == len(want["evals"])
    assert set(got["param_fingerprint"]) == set(want["param_fingerprint"])
    assert path.read_text() == json.dumps(got, indent=1, sort_keys=True)
    assert os.listdir(tmp_path) == ["sync_baseline.json"]


def test_record_refuses_the_references_goldens(capsys):
    golden = ROOT / "results" / "golden"
    before = {p: p.stat().st_mtime_ns for p in golden.rglob("*")}
    for d in ("results/golden", str(golden), str(golden / "streams"),
              str(golden / "new")):
        assert run.main(["record", "sync_baseline", "--dir", d,
                         "--device", "cpu"]) == 2
        assert "refusing" in capsys.readouterr().err
    with pytest.raises(ValueError, match="reference's goldens"):
        trace.record(run.registry.get_scenario("sync_baseline"), golden,
                     device="cpu")
    assert {p: p.stat().st_mtime_ns for p in golden.rglob("*")} == before
    assert run.RECORD_DIR == ROOT / "results" / "torch_golden"
    assert not trace.refused_dir(run.RECORD_DIR)


def test_verify_takes_the_selection_flags(capsys):
    assert run.main(["verify", "--engine-filter", "sim", "--transport-filter",
                     "socket", "--device", "cpu"]) == 2
    assert "no scenarios selected" in capsys.readouterr().err
    assert run.main(["verify", "chaos_lossy", "--cross-only",
                     "--device", "cpu"]) == 2
    assert "--cross-only applies to sim" in capsys.readouterr().err
    assert run.main(["verify", "sync_baseline", "--device", "cpu"]) == 0
    assert "PASS sync_baseline" in capsys.readouterr().out


def test_python_dash_m_lists_the_scenarios():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.scenarios", "list",
         "--engine-filter", "wallclock"], capture_output=True, text=True,
        check=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.stdout.splitlines()[0] == \
        "-- engine=wallclock transport=inproc --"
    assert "socket_hetero" in out.stdout
