"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and none of the port's examples imports JAX, the
reference package or the reference's benchmark harness, and no entry point
drops to the CPU unless asked to."""
import pkgutil
import re
import runpy
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.async_engine import engine as engine_lib
from repro_torch.configs.base import RunConfig
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.launch.mesh import local_mesh
from repro_torch.scenarios.spec import Scenario
from repro_torch.sweeps import __main__ as sweeps_cli

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = [str(p) for p in sorted((ROOT / "examples").glob("*_torch.py"))]
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|repro|benchmarks)(\.|\s|$)",
    re.MULTILINE)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax_or_reference():
    mods = _modules()
    assert {"repro_torch.kernels.packed", "repro_torch.checkpoint.ckpt",
            "repro_torch.sweeps.cache", "repro_torch.sweeps.__main__",
            "repro_torch.dist.sharding", "repro_torch.dist.steps",
            "repro_torch.launch.mesh", "repro_torch.launch.inputs",
            "repro_torch.launch.dryrun", "repro_torch.scenarios.__main__",
            "repro_torch.scenarios.adhoc"} <= set(mods) and len(mods) >= 20
    code = ("import sys\n"
            f"for m in {mods!r}: __import__(m)\n"
            "import runpy\n"
            f"for e in {EXAMPLES!r}: runpy.run_path(e, run_name='example')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')]\n"
            "assert not bad, bad\n"
            "import os\n"
            "assert 'XLA_FLAGS' not in os.environ\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})


def test_sources_name_no_jax_or_reference_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", *map(Path, EXAMPLES)]
    assert len(files) >= 20
    for f in files:
        hit = FORBIDDEN.search(f.read_text())
        assert hit is None, f"{f}: {hit.group(0)!r}"


def test_launcher_without_gpu_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def never(*a, **k):
        raise AssertionError("the launcher built an engine without a GPU")
    monkeypatch.setattr(Scenario, "build", never)
    for argv in (["--smoke", "--outer", "1", "--inner", "1"],
                 ["--scenario", "dcasgd"]):
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        engine_lib.make_engine(RunConfig(model=get_config("tinygpt-15m-smoke")))
    with pytest.raises(RuntimeError, match="cuda"):
        sweeps_cli.main(["run", "smoke"])
    with pytest.raises(RuntimeError, match="cuda"):
        with local_mesh():
            pass
    assert len(EXAMPLES) == 3
    for path in EXAMPLES:
        example = runpy.run_path(path, run_name="example")
        with pytest.raises(RuntimeError, match="cuda"):
            example["main"](["--outer", "1", "--inner", "1"])
