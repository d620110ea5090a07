"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix;
the configuration's file is given in ``configs``, the mix's is
``benchmark/traffic/<traffic>.json``, a per-layer metric's reader is
``benchmark/metrics/<name>.py`` and each work stage is a module of
``benchmark/stages/``.  Adding a cell, a mix, a metric or a stage adds
files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent        # benchmark/
ROOT = HERE.parent


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"_bench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    def __init__(self, name: str, root: Path = ROOT):
        self.bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = json.loads(
            (root / self.config_entry["file"]).read_text())
        self.mix = json.loads((HERE / "traffic" /
                               f"{self.workload['traffic']}.json")
                              .read_text())
        self.chips = int(self.workload["chips"])

    def _applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"] if self._applies(m)]

    def per_layer(self) -> list:
        return [m for m in self.bench["per_layer"] if self._applies(m)]

    @staticmethod
    def reader(metric_name: str):
        return load_module(HERE / "metrics" / f"{metric_name}.py")

    @staticmethod
    def stages() -> list:
        return [load_module(p)
                for p in sorted((HERE / "stages").glob("*.py"))]
