"""The PyTorch port stands alone: ``repro_torch`` and ``chip_smoke.py``
import neither jax nor the JAX package ``repro``."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

MODULES = [
    "repro_torch",
    "repro_torch.sim",
    "repro_torch.sim.engine",
    "repro_torch.sim.executor",
    "repro_torch.kernels.ops",
    "repro_torch.kernels.build",
    "repro_torch.models",
    "repro_torch.clients",
    "repro_torch.orbits",
    "repro_torch.orbits.routing",
    "repro_torch.sim.strategies.fedisl",
    "repro_torch.sim.strategies.fedsink",
    "repro_torch.sim.strategies.fedhap_async",
    "repro_torch.sim.strategies.fedhap_buffered",
    "repro_torch.faults",
    "repro_torch.configs",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.rwkv6_wkv",
    "repro_torch.kernels.selective_scan",
    "repro_torch.models.rwkv",
    "repro_torch.models.ssm",
    "repro_torch.models.moe",
    "repro_torch.configs.jamba_v01_52b",
    "repro_torch.models.transformer",
    "repro_torch.launch.serve",
    "repro_torch.sim.strategies.fedsat",
    "repro_torch.sim.strategies.fedspace",
    "repro_torch.checkpoint",
    "repro_torch.core",
    "repro_torch.core.aggregation",
    "repro_torch.core.strategies",
    "repro_torch.sim.timeline",
    "repro_torch.optim",
    "repro_torch.optim.optimizers",
    "repro_torch.core.dissemination",
    "repro_torch.core.mesh_round",
    "repro_torch.core.fed_step",
    "repro_torch.launch.train",
    "repro_torch.launch.flash_bwd_time",
    "repro_torch.debug",
    "repro_torch.debug.sanitize",
    "repro_torch.data.eo",
    "repro_torch.launch.sim_time",
    "repro_torch.launch.recurrent_bwd_time",
    "repro_torch.launch.mesh",
]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_import_loads_no_jax_and_no_repro():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in MODULES)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", \
        f"importing the port loaded: {proc.stdout.strip()}"


def _imported_names(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_static_scan_no_jax_or_repro_imports(path):
    bad = [n for n in _imported_names(path) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"
