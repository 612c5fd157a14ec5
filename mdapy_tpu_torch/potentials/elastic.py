"""0 K elastic constants from deformed-structure stress fits.

A host copy of ``mdapy_tpu/potentials/elastic.py`` (the whole file,
:1-157): strain -> upper-Cholesky deformation; 3 normal + 3 shear modes x
4 amounts; per-mode linear stress-vs-strain fits including the equilibrium
point; stresses in GPa via the eV/A^3 -> GPa factor 160.2176621.  The
deformed structures are the port's ``System`` on the device of the system
passed in, and they relax with the port's ``FIRE``: the forces come from
the calculator on its device (the card for the port's EAM and NEP).  The
fits are numpy, as in the JAX package, so the same stresses give the same
bits.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .minimizer import FIRE

__all__ = ["get_elastic_constant", "DeformedStructureSet", "ElasticTensor"]

EV_A3_TO_GPA = 160.2176621


def strain_from_index_amount(idx: Tuple[int, int], amount: float) -> np.ndarray:
    e = np.zeros((3, 3))
    e[idx[0], idx[1]] = amount
    e[idx[1], idx[0]] = amount
    return e


def strain_to_deformation(strain: np.ndarray) -> np.ndarray:
    return np.linalg.cholesky(2.0 * strain + np.eye(3)).T


def strain_from_deformation(F: np.ndarray) -> np.ndarray:
    F = np.asarray(F, dtype=float)
    return 0.5 * (F.T @ F - np.eye(3))


def strain_to_voigt(e: np.ndarray) -> np.ndarray:
    return np.array([e[0, 0], e[1, 1], e[2, 2], 2 * e[1, 2], 2 * e[0, 2], 2 * e[0, 1]])


def stress_to_voigt(s: np.ndarray) -> np.ndarray:
    return np.array([s[0, 0], s[1, 1], s[2, 2], s[1, 2], s[0, 2], s[0, 1]])


class DeformedStructureSet:
    """The 24 deformed copies of ``system``, each a port ``System`` on
    ``system.device``."""

    def __init__(
        self,
        system,
        norm_strains: Sequence[float] = (-0.01, -0.005, 0.005, 0.01),
        shear_strains: Sequence[float] = (-0.06, -0.03, 0.03, 0.06),
    ):
        from ..core.box import Box
        from ..core.system import System

        assert "element" in system.data.columns
        elements = np.asarray(system.data["element"]).astype(object)
        cell = system.box.matrix.copy()
        positions = system.pos - system.box.origin
        self.deformations: List[np.ndarray] = []
        self.deformed_systems: List = []
        modes = [((0, 0), norm_strains), ((1, 1), norm_strains), ((2, 2), norm_strains),
                 ((0, 1), shear_strains), ((0, 2), shear_strains), ((1, 2), shear_strains)]
        for ind, amounts in modes:
            for amount in amounts:
                defo = strain_to_deformation(strain_from_index_amount(ind, amount))
                new_cell = cell @ defo.T
                frac = positions @ np.linalg.inv(cell)
                new_pos = frac @ new_cell
                self.deformations.append(defo)
                self.deformed_systems.append(
                    System(pos=new_pos, box=Box(new_cell), element_list=elements,
                           device=system.device)
                )

    def __len__(self):
        return len(self.deformations)

    def __iter__(self):
        return zip(self.deformations, self.deformed_systems)


class ElasticTensor:
    def __init__(self, voigt: np.ndarray):
        self.voigt = np.asarray(voigt, dtype=float)

    @classmethod
    def from_independent_strains(
        cls, strains, stresses, eq_stress=None, tol: float = 1e-10
    ) -> "ElasticTensor":
        vstrains = np.array([strain_to_voigt(s) for s in strains])
        vstresses = np.array([stress_to_voigt(s) for s in stresses])
        if eq_stress is not None:
            veq = stress_to_voigt(np.asarray(eq_stress, dtype=float))
        else:
            veq = vstresses[np.argmin(np.linalg.norm(vstrains, axis=1))]
        C = np.zeros((6, 6))
        for ii in range(6):
            active = np.abs(vstrains[:, ii]) > tol
            others = np.all(
                np.abs(np.delete(vstrains, ii, axis=1)) <= tol, axis=1
            )
            mask = active & others
            if not mask.any():
                raise ValueError(f"No strains found for independent mode {ii}")
            xs = np.r_[vstrains[mask][:, ii], 0.0]
            ys = np.vstack([vstresses[mask], veq])
            order = np.argsort(xs)
            xs = xs[order]
            ys = ys[order]
            for jj in range(6):
                C[jj, ii] = np.polyfit(xs, ys[:, jj], 1)[0]
        C[np.abs(C) < tol] = 0.0
        return cls(C)

    @property
    def bulk_modulus_voigt(self) -> float:
        return float(self.voigt[:3, :3].sum() / 9.0)

    @property
    def shear_modulus_voigt(self) -> float:
        C = self.voigt
        return float(
            (C[0, 0] + C[1, 1] + C[2, 2] - C[0, 1] - C[0, 2] - C[1, 2]) / 15.0
            + (C[3, 3] + C[4, 4] + C[5, 5]) / 5.0
        )


def _stress_gpa(system) -> np.ndarray:
    XX, YY, ZZ, YZ, ZX, XY = system.get_stress()
    return np.array(
        [[XX, XY, ZX], [XY, YY, YZ], [ZX, YZ, ZZ]], dtype=float
    ) * EV_A3_TO_GPA


def get_elastic_constant(
    system,
    calc,
    norm_strains: Sequence[float] = (-0.01, -0.005, 0.005, 0.01),
    shear_strains: Sequence[float] = (-0.06, -0.03, 0.03, 0.06),
    fmax: float = 1e-4,
) -> ElasticTensor:
    """Relax ``system`` (a port ``System``) with its cell, deform it 24
    times, relax each copy at fixed cell and fit the 6x6 Voigt tensor
    (GPa).  The copies lie on ``system.device``; ``calc`` computes on its
    own device."""
    assert "element" in system.data.columns
    system.calc = calc
    fy = FIRE(system, optimize_cell=True)
    assert fy.run(fmax=fmax, steps=10000, show_process=False), "cell minimization failed"
    equi_stress = _stress_gpa(system)
    dfm = DeformedStructureSet(system, norm_strains, shear_strains)
    strain_list, stress_list = [], []
    for defo, dsys in dfm:
        dsys.calc = calc
        fy = FIRE(dsys)
        assert fy.run(fmax=fmax, steps=10000, show_process=False), "minimization failed"
        stress_list.append(_stress_gpa(dsys))
        strain_list.append(strain_from_deformation(defo))
    return ElasticTensor.from_independent_strains(
        strain_list, stress_list, eq_stress=equi_stress
    )
