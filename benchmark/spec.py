"""Finds every piece of a cell by its name in ``BENCHMARK.json``:

- ``benchmark/configs/<config>.json``: the configuration (its ``family``
  names the program glue in ``benchmark/families/<family>.py``);
- ``benchmark/traffic/<mix>.json``: the traffic mix;
- ``benchmark/reference/<config>.py``: the configuration's plain reference;
- ``benchmark/limits/<cell>.json``: the limits that decide ``correct``;
- ``benchmark/metrics/<metric>.py``: one reader for each metric.

A later change adds a configuration, a mix, a cell or a metric as new
files and entries; no file here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))


def load_module(path: str, key: str):
    """The module at ``path``, loaded once under the name ``key``."""
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        if spec is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One cell and everything found for it."""
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def family(self):
        """The program glue of the configuration's family."""
        fam = self.config["family"]
        return load_module(os.path.join(HERE, "families", f"{fam}.py"),
                           f"benchmark_family_{fam}")

    def reference(self):
        """The configuration's plain reference."""
        name = self.config["name"]
        return load_module(os.path.join(HERE, "reference", f"{name}.py"),
                           f"benchmark_reference__{name}")

    def metrics(self, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports:
        those that list it under ``workloads``, or list none."""
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]


def metric_reader(name: str):
    """The reader module of metric ``name``."""
    return load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                       f"benchmark_metric__{name}")


def load_cell(root: str, workload: str) -> Cell:
    """The cell ``workload`` of the ``BENCHMARK.json`` under ``root``."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(by_name)}")
    w = by_name[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(HERE, "limits", f"{workload}.json"))
    return Cell(bench, w, config, traffic, limits)


def load_cell_names(root: str) -> list[str]:
    """Every cell of the ``BENCHMARK.json`` under ``root``."""
    return [w["name"] for w in
            _json(os.path.join(root, "BENCHMARK.json"))["workloads"]]
