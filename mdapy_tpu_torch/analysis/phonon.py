"""Phonon properties via phonopy (optional dependency).

A host copy of ``mdapy_tpu/analysis/phonon.py`` (:1-200, whole; parity:
reference phonon.py) — finite-displacement force constants from any of the
port's calculators, band structure / DOS / PDOS / thermal properties, and
plots.  The supercells are the port's ``System`` on the unit cell's
device.  Requires ``phonopy`` (pip install phonopy); raises the JAX
package's ImportError otherwise.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np

__all__ = ["Phonon"]


def _require_phonopy():
    try:
        from phonopy import Phonopy
        from phonopy.phonon.band_structure import (
            get_band_qpoints_and_path_connections,
        )
        from phonopy.structure.atoms import PhonopyAtoms
    except ImportError as err:  # pragma: no cover - optional dep
        raise ImportError(
            "Phonon analysis requires the optional dependency 'phonopy'. "
            "Install it with: pip install phonopy"
        ) from err
    return Phonopy, PhonopyAtoms, get_band_qpoints_and_path_connections


class Phonon:
    """Phonopy wrapper: band structure, DOS, PDOS, thermal properties."""

    def __init__(
        self,
        path: Union[str, List],
        labels: Union[str, List[str]],
        unitcell,
        symprec: float = 1e-5,
        repeat: Optional[List[int]] = None,
        displacement: float = 0.01,
        cutoff: Optional[float] = None,
    ):
        Phonopy, PhonopyAtoms, _ = _require_phonopy()
        if isinstance(path, str):
            self.path = np.array(path.split(), float).reshape(1, -1, 3)
        else:
            assert len(path[0]) == 3
            self.path = np.array(path).reshape(1, -1, 3)
        self.labels = labels.split() if isinstance(labels, str) else labels
        assert len(self.labels) == self.path.shape[1], (
            "The length of path should be equal to labels."
        )
        self.unitcell = unitcell
        assert unitcell.calc is not None, "Must set calculator for unitcell."
        if repeat is None:
            self.repeat = np.ceil(
                15.0 / unitcell.box.get_thickness()
            ).astype(int)
        else:
            self.repeat = repeat
        self.symprec = symprec
        self.displacement = float(displacement)
        self.cutoff = cutoff
        self.band_dict = None
        self.dos_dict = None
        self.pdos_dict = None
        self.thermal_dict = None

        self.phonon = Phonopy(
            unitcell=self._to_phonopy(unitcell),
            supercell_matrix=self.repeat,
            primitive_matrix="auto",
            symprec=self.symprec,
        )
        self.phonon.generate_displacements(distance=self.displacement)
        self.supercells = [
            self._from_phonopy(a)
            for a in self.phonon.supercells_with_displacements
        ]
        self.get_force_constants()

    def _to_phonopy(self, system):
        _, PhonopyAtoms, _ = _require_phonopy()
        return PhonopyAtoms(
            symbols=np.asarray(system.data["element"]).astype(str),
            cell=system.box.matrix,
            positions=system.pos,
        )

    def _from_phonopy(self, atoms):
        from ..core.system import System

        s = System(
            pos=np.asarray(atoms.positions),
            box=np.asarray(atoms.cell),
            element_list=np.asarray(atoms.symbols, dtype=object),
            device=self.unitcell.device,
        )
        s.calc = self.unitcell.calc
        return s

    def get_force_constants(self) -> None:
        forces = []
        for s in self.supercells:
            s.calc.results = {}
            f = np.array(s.get_force())
            f -= f.mean(axis=0)
            forces.append(f)
        self.phonon.produce_force_constants(forces=np.array(forces))
        if self.cutoff is not None:
            self.phonon.set_force_constants_zero_with_radius(float(self.cutoff))

    def compute_band_structure(self, npoints: int = 101) -> None:
        _, _, get_qpath = _require_phonopy()
        qpoints, connections = get_qpath(self.path, npoints=npoints)
        self.phonon.run_band_structure(
            qpoints, path_connections=connections, labels=self.labels
        )
        self.band_dict = self.phonon.get_band_structure_dict()

    def compute_dos(self, mesh: Tuple[int, ...] = (10, 10, 10)) -> None:
        self.phonon.run_mesh(mesh)
        self.phonon.run_total_dos(use_tetrahedron_method=True)
        self.dos_dict = self.phonon.get_total_dos_dict()

    def compute_pdos(self, mesh: Tuple[int, ...] = (10, 10, 10)) -> None:
        self.phonon.run_mesh(mesh, with_eigenvectors=True,
                             is_mesh_symmetry=False)
        self.phonon.run_projected_dos()
        self.pdos_dict = self.phonon.get_projected_dos_dict()

    def compute_thermal(self, t_min: float, t_step: float, t_max: float,
                        mesh: Tuple[int, ...] = (10, 10, 10)) -> None:
        self.phonon.run_mesh(mesh)
        self.phonon.run_thermal_properties(t_min=t_min, t_step=t_step,
                                           t_max=t_max)
        self.thermal_dict = self.phonon.get_thermal_properties_dict()

    # -------------------------------------------------------------- plots
    def plot_dos(self, ax=None):
        if self.dos_dict is None:
            self.compute_dos()
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        ax.plot(self.dos_dict["frequency_points"], self.dos_dict["total_dos"])
        ax.set_xlabel("Frequency (THz)")
        ax.set_ylabel("DOS")
        return ax.figure, ax

    def plot_pdos(self, ax=None):
        if self.pdos_dict is None:
            self.compute_pdos()
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        for i, pd in enumerate(self.pdos_dict["projected_dos"]):
            ax.plot(self.pdos_dict["frequency_points"], pd, label=f"atom {i}")
        ax.set_xlabel("Frequency (THz)")
        ax.set_ylabel("PDOS")
        ax.legend(fontsize=7)
        return ax.figure, ax

    def plot_thermal(self, t_min: float = 0, t_step: float = 10,
                     t_max: float = 1000, ax=None):
        if self.thermal_dict is None:
            self.compute_thermal(t_min, t_step, t_max)
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        T = self.thermal_dict["temperatures"]
        ax.plot(T, self.thermal_dict["free_energy"], label="Free energy (kJ/mol)")
        ax.plot(T, self.thermal_dict["entropy"], label="Entropy (J/K/mol)")
        ax.plot(T, self.thermal_dict["heat_capacity"], label=r"$C_v$ (J/K/mol)")
        ax.set_xlabel("Temperature (K)")
        ax.legend()
        return ax.figure, ax

    def plot_band_structure(self, ax=None):
        if self.band_dict is None:
            self.compute_band_structure()
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        dists = self.band_dict["distances"]
        freqs = self.band_dict["frequencies"]
        for d, f in zip(dists, freqs):
            ax.plot(d, f, c="C0", lw=1)
        ticks = [d[0] for d in dists] + [dists[-1][-1]]
        ax.set_xticks(ticks[: len(self.labels)])
        ax.set_xticklabels(self.labels)
        ax.set_ylabel("Frequency (THz)")
        ax.set_xlim(ticks[0], ticks[-1])
        return ax.figure, ax
