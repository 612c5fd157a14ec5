"""Calculator contract: per-atom energies, forces, per-atom virials and the
Voigt stress of a system.

The port of ``mdapy_tpu/potentials/calculator.py``: ``_FrameView`` (:16) and
``CalculatorMP`` (:40).  Calculators stage their results as torch tensors
on their device; the first ``get_*`` call brings all of them to the host as
numpy arrays together (``_fetch``), so a loop that never reads them, or
reads one, pays one transfer at most.  A calculator reads only these
attributes of a system: ``N``, ``pos``, ``box`` (``matrix``, ``origin``,
``boundary``) and ``data["element"]``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

__all__ = ["CalculatorMP"]


class _FrameView:
    """A system stand-in, so that calculators also take the reference's
    (data, box) calling convention."""

    def __init__(self, data, box):
        self.data = data
        self.box = box

    @property
    def pos(self) -> np.ndarray:
        return np.column_stack(
            [
                np.asarray(self.data["x"], np.float64),
                np.asarray(self.data["y"], np.float64),
                np.asarray(self.data["z"], np.float64),
            ]
        )

    @property
    def N(self) -> int:
        return len(np.asarray(self.data["x"]))


class CalculatorMP(ABC):
    def __init__(self):
        self.results = {}
        self._cache_token = None

    def _token(self, system):
        return (
            system.pos.tobytes(),
            np.asarray(system.box.matrix).tobytes(),
            tuple(np.asarray(system.box.boundary).tolist()),
        )

    def _ensure(self, system):
        tok = hash(self._token(system))
        if tok != self._cache_token or not self.results:
            self.results = {}
            self.calculate(system)
            self._cache_token = tok

    @staticmethod
    def _coerce(args):
        """Accept either (system) or the reference's (data, box)."""
        if len(args) == 1:
            return args[0]
        if len(args) == 2:
            return _FrameView(*args)
        raise TypeError("expected (system) or (data, box)")

    @abstractmethod
    def calculate(self, system) -> None:
        """Fill self.results with energies/forces/virials/stress."""

    def _fetch(self, key) -> np.ndarray:
        """The result ``key`` as numpy; on first access every result still
        on the device comes to the host, and the numpy copies stay."""
        v = self.results[key]
        if not isinstance(v, np.ndarray):
            for k, a in list(self.results.items()):
                if not isinstance(a, np.ndarray):
                    self.results[k] = a.detach().cpu().numpy()
            v = self.results[key]
        return v

    def get_energies(self, *args) -> np.ndarray:
        self._ensure(self._coerce(args))
        return self._fetch("energies")

    def get_energy(self, *args) -> float:
        return float(self.get_energies(*args).sum())

    def get_forces(self, *args) -> np.ndarray:
        self._ensure(self._coerce(args))
        return self._fetch("forces")

    def get_stress(self, *args) -> np.ndarray:
        self._ensure(self._coerce(args))
        return self._fetch("stress")

    def get_virials(self, *args) -> np.ndarray:
        self._ensure(self._coerce(args))
        return self._fetch("virials")

    @staticmethod
    def stress_from_virials(virials: np.ndarray, volume: float) -> np.ndarray:
        """Voigt [xx, yy, zz, yz, xz, xy] = -(V + V^T)/2 / volume."""
        v = virials.sum(axis=0).reshape(3, 3)
        stress = (-0.5 * (v + v.T) / volume).ravel()
        return stress[[0, 4, 8, 5, 2, 1]]
