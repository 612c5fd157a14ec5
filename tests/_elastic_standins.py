"""Test doubles for the port's elastic stacks and wrappers
(``tests/test_torch_elastic.py``).

* ``LJCalculator``: the port's twin of ``tests/_toy_calc.py:LJCalculator``,
  a port ``CalculatorMP`` (the port's ``System.calc`` takes no other) with
  the very same ``calculate``, so both packages see the same bits.
* ``install(monkeypatch)``: recording stand-ins for ``lammps``, ``ase`` and
  ``phonopy``, which neither this machine nor the card's has, put into
  ``sys.modules`` for both packages.  The ``lammps`` stand-in logs every
  call (``commands_string``, ``create_atoms``, ``extract_*``, ``close``)
  and answers with arrays drawn from a seeded generator, so two runs that
  make the same calls get the same answers and the same log.
"""

import sys
import types

import numpy as np

from _toy_calc import LJCalculator as _JaxLJ
from mdapy_tpu_torch.potentials.calculator import CalculatorMP


class LJCalculator(CalculatorMP):
    """Shifted-force 12-6 Lennard-Jones, single species, for the port."""

    def __init__(self, epsilon=0.4, sigma=2.3, rc=6.0):
        super().__init__()
        self.epsilon = float(epsilon)
        self.sigma = float(sigma)
        self.rc = float(rc)

    calculate = _JaxLJ.calculate


class Lammps:
    """``lammps.lammps``: logs every call into ``Lammps.log``."""

    log = []

    def __init__(self, cmdargs=None):
        self.n = 0
        self.rng = np.random.default_rng(len(self.log))
        self.log.append(("lammps", list(cmdargs or [])))
        self.numpy = self

    def commands_string(self, cmd):
        self.log.append(("commands_string", cmd))

    def create_atoms(self, n, ids, types, x, v):
        self.n = n
        self.log.append(("create_atoms", n, np.asarray(ids).tolist(),
                         np.asarray(types).tolist(), np.asarray(x).tolist(), v))

    def _draw(self, *shape):
        return self.rng.uniform(-1.0, 1.0, shape)

    def extract_compute(self, name, style, kind):
        self.log.append(("extract_compute", name, style, kind))
        return self._draw(self.n, 6) if kind == 2 else self._draw(self.n)

    def extract_atom(self, name):
        self.log.append(("extract_atom", name))
        if name == "type":
            return 1 + (np.arange(self.n) % 2)
        return self._draw(self.n, 3) + (5.0 if name == "x" else 0.0)

    def extract_box(self):
        self.log.append(("extract_box",))
        return [0.0, 0.1, -0.2], [10.0, 10.5, 11.0], 0.3, 0.2, 0.1, [1, 1, 1], 0

    def extract_fix(self, name, style, kind, i):
        self.log.append(("extract_fix", name, style, kind, i))
        return float(self._draw(1)[0]) * 1e3

    def get_natoms(self):
        self.log.append(("get_natoms",))
        return self.n

    def close(self):
        self.log.append(("close",))


class Atoms:
    """A minimal ``ase.Atoms``."""

    def __init__(self, symbols, positions, cell, pbc=(True, True, True)):
        self.symbols = list(symbols)
        self.positions = np.asarray(positions, float)
        self.cell = np.asarray(cell, float)
        self.pbc = np.asarray(pbc, bool)

    def get_chemical_symbols(self):
        return list(self.symbols)

    def get_cell(self):
        return self.cell.copy()

    def get_pbc(self):
        return self.pbc.copy()

    def get_positions(self):
        return self.positions.copy()


class Calculator:
    """``ase.calculators.calculator.Calculator``: keeps the atoms."""

    def __init__(self, atoms=None):
        self.atoms = atoms
        self.results = {}

    def calculate(self, atoms=None, properties=None, system_changes=None):
        if atoms is not None:
            self.atoms = atoms


class PhonopyAtoms:
    def __init__(self, symbols, cell, positions):
        self.symbols = list(symbols)
        self.cell = np.asarray(cell, float)
        self.positions = np.asarray(positions, float)


class Phonopy:
    """``phonopy.Phonopy``: its supercell and two displacements of the
    first atom, +x and -y, by ``distance``."""

    def __init__(self, unitcell, supercell_matrix, primitive_matrix=None,
                 symprec=1e-5):
        reps = np.diag(np.asarray(supercell_matrix)).astype(int)
        shifts = np.array([[i, j, k] for i in range(reps[0])
                           for j in range(reps[1]) for k in range(reps[2])])
        self.cell = unitcell.cell * reps[:, None]
        self.positions = (unitcell.positions[None]
                          + (shifts @ unitcell.cell)[:, None]).reshape(-1, 3)
        self.symbols = unitcell.symbols * len(shifts)
        self.supercells_with_displacements = []

    def generate_displacements(self, distance=0.01):
        for axis, sign in ((0, 1.0), (1, -1.0)):
            pos = self.positions.copy()
            pos[0, axis] += sign * distance
            self.supercells_with_displacements.append(
                PhonopyAtoms(self.symbols, self.cell, pos))


def _module(name, **attrs):
    mod = types.ModuleType(name)
    mod.__dict__.update(attrs)
    return mod


def install(monkeypatch):
    """Put the stand-ins into ``sys.modules``; returns the lammps log."""
    Lammps.log = []
    mods = {
        "lammps": _module("lammps", lammps=Lammps),
        "ase": _module("ase", Atoms=Atoms),
        "ase.calculators": _module("ase.calculators"),
        "ase.calculators.calculator": _module(
            "ase.calculators.calculator", Calculator=Calculator,
            all_changes=["positions", "numbers", "cell", "pbc"]),
        "phonopy": _module("phonopy", Phonopy=Phonopy),
        "phonopy.structure": _module("phonopy.structure"),
        "phonopy.structure.atoms": _module("phonopy.structure.atoms",
                                           PhonopyAtoms=PhonopyAtoms),
    }
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return Lammps.log
