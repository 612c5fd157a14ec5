"""A run with the timed path broken underneath comes out not correct: the
whole of a run but the look for a card, on the CPU, at a small size, with
the configuration's own levels and limits.  The faults are the driver's
``FAULTS``: for the render driver a step that returns its state unchanged
(the previous step's image), the mean taken over half the AA samples, and
an answer altered where it is produced (each image's green channel raised
by 4).  One card, so no exchange between cards to leave out.  On the card,
at the cells' own sizes, ``control.py`` runs the same faults."""

import json

import pytest

from conftest import ROOT
from perfbench import harness, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
FAULTS = sorted({name for w in CELLS
                 for name in spec.driver(spec.load_cell(w).config).FAULTS})


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault):
    factory = spec.driver(spec.load_cell(cell).config).FAULTS[fault]
    r = harness.run(cell, 2**31 + 21, 1.0, False, root=tiny_root,
                    backend="cpu", system_factory=factory)
    assert r["correct"] is False, r["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_root, cell):
    import torch

    r = harness.run(cell, 2**31 + 21, 1.0, False, root=tiny_root,
                    backend="cpu", control=torch.bfloat16)
    assert r["correct"] is False, r["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_timed_path_is_correct(tiny_root, cell):
    r = harness.run(cell, 2**31 + 21, 1.0, False, root=tiny_root,
                    backend="cpu")
    assert r["correct"] is True, r["check"]
