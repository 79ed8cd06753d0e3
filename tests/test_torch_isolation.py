"""``repro_torch`` stands alone: it imports neither ``jax`` nor ``repro``.

A fresh interpreter imports every module of the package and must then hold
no ``jax*`` and no ``repro`` / ``repro.*`` module; and no module of the
package names one in an import statement, also inside a function (an import
that only runs when some path is taken).
"""

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def modules():
    names = ["repro_torch"]
    for info in pkgutil.walk_packages([str(PKG)], prefix="repro_torch."):
        names.append(info.name)
    return sorted(names)


def test_every_module_is_found():
    names = modules()
    for required in (
        "repro_torch.core.market",
        "repro_torch.engine.batch",
        "repro_torch.engine.torch_backend",
        "repro_torch.kernels._build",
        "repro_torch.kernels.spot_sweep.kernel",
        "repro_torch.kernels.spot_sweep.ops",
        "repro_torch.kernels.spot_sweep.ref",
        "repro_torch.obs.retrace",
    ):
        assert required in names


def test_importing_the_package_loads_no_jax_and_no_repro():
    code = (
        "import importlib, json, sys\n"
        f"for name in {modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'repro' or m.startswith('repro.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120, check=True
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), f"{path.name}:{node.lineno} imports {name}"
