"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro`` or of
``benchmarks`` (whose modules import JAX), and neither does
``tests/torch_mesh_ranks.py``, which the mesh tests' ranks run.

A fresh interpreter imports every module of the port and the smoke script
and then looks at ``sys.modules``; an AST scan of the sources catches an
import that only a code path not taken at import time would run.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the mesh tests' ranks run torch_mesh_ranks, which must stand alone too
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "tests" / "torch_mesh_ranks.py"]

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
print(json.dumps({"modules": names, "loaded": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"))}))
"""


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env, check=True,
                         timeout=120)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.serve.engine" in got["modules"]
    assert "repro_torch.kernels.segment_attention.ops" in got["modules"]
    assert {"repro_torch.core.telemetry", "repro_torch.serve.traffic",
            "repro_torch.serve.chaos",
            "repro_torch.serve.router"} <= set(got["modules"])
    assert {"repro_torch.distributed.sharding",
            "repro_torch.distributed.collectives",
            "repro_torch.launch.mesh",
            "repro_torch.serve.block_store"} <= set(got["modules"])
    assert got["loaded"] == []


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_reference_package(path):
    bad = [n for n in _imports(path)
           if n.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")]
    assert bad == []
