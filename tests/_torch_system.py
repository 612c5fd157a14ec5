"""A stand-in for the JAX package's ``System``: the attributes that the
port's calculators, FIRE, ``AtomicStrain`` and ``WignerSeitzAnalysis`` read,
with numpy and the port's ``Box`` only (no jax, no polars), shared by the
CPU tests ``tests/test_torch_fire.py``, ``tests/test_torch_eam.py`` and
``tests/test_torch_analysis_dist.py`` and by ``chip_smoke.py`` [E1], [F1],
[P1] and [S4].  New code takes the port's ``System``
(``mdapy_tpu_torch/core/system.py``, ROADMAP A12a) instead."""

import numpy as np

from mdapy_tpu_torch.core.box import init_box
from mdapy_tpu_torch.neighbor.neighbor import neighbor_tensors


class StandInSystem:
    """Positions, a cell, an element column and a calculator.

    ``get_*`` ask the calculator, which caches its results per
    configuration; ``update_pos`` and ``update_box`` change the
    configuration as the JAX ``System`` does (``core/system.py:230-247``);
    ``build_neighbor`` builds its Verlet list on ``device`` and keeps it
    there, as tensors."""

    def __init__(self, pos, box, elements, device="cpu"):
        self._pos = np.ascontiguousarray(pos, dtype=np.float64)
        self._box = init_box(box)
        elements = np.asarray(elements, dtype=object)
        if elements.ndim == 0:
            elements = np.full(len(self._pos), elements, dtype=object)
        self.data = {"element": elements}
        self._calc = None
        self.device = device
        self.verlet_list = self.distance_list = self.neighbor_number = None

    @property
    def N(self) -> int:
        return self._pos.shape[0]

    @property
    def pos(self) -> np.ndarray:
        return self._pos

    @property
    def box(self):
        return self._box

    @property
    def calc(self):
        return self._calc

    @calc.setter
    def calc(self, value):
        value.results = {}
        self._calc = value

    def build_neighbor(self, rc: float, max_neigh=None) -> None:
        self.verlet_list, self.distance_list, self.neighbor_number = (
            neighbor_tensors(self._pos, self._box, rc, max_neigh,
                             device=self.device))

    def update_pos(self, pos) -> None:
        self._pos = np.ascontiguousarray(pos, dtype=np.float64).copy()

    def update_box(self, box) -> None:
        self._box = init_box(box, self._box.boundary, None)

    def get_energies(self) -> np.ndarray:
        return self._calc.get_energies(self)

    def get_energy(self) -> float:
        return self._calc.get_energy(self)

    def get_force(self) -> np.ndarray:
        return self._calc.get_forces(self)

    def get_stress(self) -> np.ndarray:
        return self._calc.get_stress(self)

    def get_virials(self) -> np.ndarray:
        return self._calc.get_virials(self)
