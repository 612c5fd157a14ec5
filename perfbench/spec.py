"""Resolve a cell of ``BENCHMARK.json`` to its files, by name.

A cell names a configuration and a traffic mix; the configuration's entry
gives its file, whose ``driver`` key names ``drivers/<driver>.py``; the mix
is ``traffic/<mix>.json``, and every metric is read by
``metrics/<metric>.py`` (its ``read(records)``).  A metric is the cell's
when its ``workloads`` list names the cell, or when it has no such list."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    workload: dict
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path


def _metrics(entries: list, cell: str) -> list:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no cell {name!r} in {root / 'BENCHMARK.json'}")
    workload = found[0]
    entry = [c for c in bench["configs"] if c["name"] == workload["config"]][0]
    config = json.loads((root / entry["file"]).read_text())
    bench_dir = root / bench["paths"][0]
    mix = json.loads((bench_dir / "traffic" / f"{workload['traffic']}.json").read_text())
    return Cell(workload, config, mix, _metrics(bench["end_to_end"], name),
                _metrics(bench["per_layer"], name), bench_dir)


def driver(config: dict):
    """The module ``drivers/<config["driver"]>.py``."""
    name = config["driver"]
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad driver {name!r}")
    return importlib.import_module(f"{__package__}.drivers.{name}")


def reader(bench_dir: Path, metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = Path(bench_dir) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for one purpose (``stream``)."""
    return np.random.default_rng([int(seed) % 2**63, stream])
