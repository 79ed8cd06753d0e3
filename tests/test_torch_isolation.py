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
        "repro_torch.kernels._launch",
        "repro_torch.kernels.spot_sweep.kernel",
        "repro_torch.kernels.spot_sweep.ops",
        "repro_torch.kernels.spot_sweep.ref",
        "repro_torch.kernels.flash_attention.kernel",
        "repro_torch.kernels.flash_attention.ops",
        "repro_torch.kernels.flash_attention.ref",
        "repro_torch.kernels.rglru_scan.kernel",
        "repro_torch.kernels.rglru_scan.ops",
        "repro_torch.kernels.rglru_scan.ref",
        "repro_torch.kernels.ssm_scan.kernel",
        "repro_torch.kernels.ssm_scan.ops",
        "repro_torch.kernels.ssm_scan.ref",
        "repro_torch.configs",
        "repro_torch.configs.falcon_mamba_7b",
        "repro_torch.configs.glm4_9b",
        "repro_torch.configs.recurrentgemma_9b",
        "repro_torch.configs.arctic_480b",
        "repro_torch.configs.internlm2_20b",
        "repro_torch.configs.internvl2_1b",
        "repro_torch.configs.kimi_k2_1t_a32b",
        "repro_torch.configs.shapes",
        "repro_torch.configs.starcoder2_3b",
        "repro_torch.configs.starcoder2_7b",
        "repro_torch.configs.whisper_large_v3",
        "repro_torch.models.moe",
        "repro_torch.models.config",
        "repro_torch.models.layers",
        "repro_torch.models.params",
        "repro_torch.models.rglru",
        "repro_torch.models.ssm",
        "repro_torch.models.transformer",
        "repro_torch.obs.retrace",
        "repro_torch.train.steps",
        "repro_torch.checkpoint",
        "repro_torch.checkpoint.manager",
        "repro_torch.checkpoint.tree",
        "repro_torch.core.billing",
        "repro_torch.core.events",
        "repro_torch.core.lifecycle",
        "repro_torch.core.simulator",
        "repro_torch.data",
        "repro_torch.data.pipeline",
        "repro_torch.faults",
        "repro_torch.faults.plan",
        "repro_torch.kernels.ckpt_codec.kernel",
        "repro_torch.kernels.ckpt_codec.ops",
        "repro_torch.kernels.ckpt_codec.ref",
        "repro_torch.launch",
        "repro_torch.launch.train",
        "repro_torch.optim",
        "repro_torch.optim.adamw",
        "repro_torch.optim.schedule",
        "repro_torch.train.spot_trainer",
        "repro_torch.core.appdef",
        "repro_torch.core.provision",
        "repro_torch.data.threefry",
        "repro_torch.engine.parity",
        "repro_torch.engine.reference",
        "repro_torch.launch.policy_compare",
        "repro_torch.market",
        "repro_torch.market.auction",
        "repro_torch.market.background",
        "repro_torch.market.spot_market",
        "repro_torch.fleet",
        "repro_torch.fleet.batch",
        "repro_torch.fleet.controller",
        "repro_torch.fleet.policies",
        "repro_torch.fleet.sweep",
        "repro_torch.fleet.workload",
        "repro_torch.engine.fleetgrid",
        "repro_torch.kernels.fleet_step.ops",
        "repro_torch.kernels.fleet_step.ref",
        "repro_torch.launch.market_contention",
        "repro_torch.obs.exporters",
        "repro_torch.serving",
        "repro_torch.serving.autoscaler",
        "repro_torch.serving.engine",
        "repro_torch.serving.replicas",
        "repro_torch.serving.slo",
        "repro_torch.serving.traffic",
        "repro_torch.launch.spot_serving",
        "repro_torch.suite",
        "repro_torch.suite.__main__",
        "repro_torch.suite.hashing",
        "repro_torch.suite.layers",
        "repro_torch.suite.runner",
        "repro_torch.suite.spec",
        "repro_torch.suite.store",
        "repro_torch.suite.trend",
        "repro_torch.optim.compress",
        "repro_torch.parallel",
        "repro_torch.parallel.gloo_cuda",
        "repro_torch.parallel.ranks",
        "repro_torch.parallel.sharding",
        "repro_torch.parallel.sp_decode",
        "repro_torch.launch.elastic_restart",
        "repro_torch.models.moe_ep",
        "repro_torch.launch.mesh",
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
