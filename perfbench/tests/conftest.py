"""Fixtures of the benchmark's tests.

Tests marked ``card`` need a CUDA card: the ``card`` fixture decides, when
a test runs, whether one is present, and skips the test here on the CPU.
``tiny_root`` is a checkout-like directory whose ``BENCHMARK.json`` holds
the cells of the real one on a small configuration, sharing the real
traffic mixes and metric readers, for runs on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# a few thousand pixels of a sphere block small enough for the CPU
TINY_SCENE = {"cells": 6}
TINY_RENDER = {"width": 64, "height": 48}
TINY_PIXELS = 1024


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch.cuda.is_available() is False")


def tiny_config(config: dict) -> dict:
    """``config`` at a size the CPU holds: an FCC alloy block of
    ``TINY_SCENE`` cells, a small frame, fewer pixels compared; the render
    settings, the check's levels and limits as they are."""
    scene = {"kind": "fcc_alloy", "a": 3.59, "radius": 1.25,
             "elements": ["Cr", "Co", "Ni", "Fe", "Mn"], **TINY_SCENE}
    render = dict(config["render"], **TINY_RENDER)
    check = dict(config["check"], pixels=TINY_PIXELS)
    return dict(config, scene=scene, render=render, check=check)


def make_root(dst: Path) -> Path:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dst / "perfbench" / "configs").mkdir(parents=True)
    for kind in ("traffic", "metrics"):
        shutil.copytree(ROOT / "perfbench" / kind, dst / "perfbench" / kind)
    for c in bench["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        (dst / c["file"]).write_text(json.dumps(tiny_config(config)))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
