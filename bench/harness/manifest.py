"""``BENCHMARK.json`` and the files it names, found by name under a checkout's
root: ``bench/traffic/<traffic>.json``, ``bench/limits/<workload>.json``,
``bench/metrics/<metric>.py`` and each configuration's ``file``."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, workload: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == workload:
                return w
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "bench" / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        """``{number: limit}`` of the cell's comparison."""
        return json.loads((self.root / "bench" / "limits" / f"{workload}.json").read_text())["limits"]

    def _applies(self, metric: dict, workload: str, reported: set | None = None) -> bool:
        if "workloads" in metric:
            return workload in metric["workloads"]
        return reported is None or metric["moves"] in reported

    def end_to_end(self, workload: str) -> list[dict]:
        return [m for m in self.data["end_to_end"] if self._applies(m, workload)]

    def per_layer(self, workload: str) -> list[dict]:
        reported = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"] if self._applies(m, workload, reported)]

    def reader(self, metric: str):
        """The ``read(run)`` function of ``bench/metrics/<metric>.py``."""
        path = self.root / "bench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_').replace('-', '_')}",
                                                      path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
