"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (its ``file``), a traffic mix
(``perfbench/traffic/<traffic>.json``) and has its comparison limits in
``perfbench/limits/<cell>.json``.  A traffic mix names its ``kind``, and
the kind's driver is ``perfbench/drivers/<kind>.py``.  Every metric is a
reader in ``perfbench/metrics/<metric>.py``.  Adding a cell, a
configuration, a traffic mix, a traffic kind or a metric is adding files
and entries; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.exists():
            raise SystemExit(f"no BENCHMARK.json in {self.root}")
        self.data = json.loads(path.read_text())
        self.pb = self.root / self.data["paths"][0]
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(have: {', '.join(sorted(self.cells))})")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        entry = self.configs[cell["config"]]
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.pb / "traffic" / f"{cell['traffic']}.json").read_text())

    def limits(self, cell: dict) -> dict:
        return json.loads((self.pb / "limits" / f"{cell['name']}.json").read_text())

    def metrics(self, cell: dict, trace: bool) -> list:
        """The cell's end-to-end metrics (``trace`` false) or per-layer
        metrics (``trace`` true), in file order."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if "workloads" not in m or cell["name"] in m["workloads"]]

    def _load(self, folder: str, name: str):
        path = self.pb / folder / f"{name}.py"
        if not path.is_file():
            raise SystemExit(f"no {folder[:-1]} {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{folder}_" + name.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric_name: str):
        """The ``read(record) -> float | None`` of ``metrics/<name>.py``."""
        return self._load("metrics", metric_name).read

    def driver(self, kind: str):
        """The ``Driver`` class of ``drivers/<kind>.py``."""
        return self._load("drivers", kind).Driver
