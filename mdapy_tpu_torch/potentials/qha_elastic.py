"""Quasi-harmonic temperature-dependent elastic constants.

A host copy of ``mdapy_tpu/potentials/qha_elastic.py`` (the whole file,
:1-405): build a (volume, strain-mode, eps) grid of strained unit cells;
for each cell compute the static energy plus the phonopy vibrational free
energy; fit per-mode free-energy curvatures in eps at every volume, locate
V(T) from the isotropic free-energy EOS, and interpolate the curvatures to
V(T) to get C_ij(T).  The cells are the port's ``System`` on the device of
the system passed in, and ``compute()`` returns the port's ``AtomFrame``
(the JAX package's DataFrame columns, in its order; ``.to_pandas()`` gives
the DataFrame), so no step needs pandas.

Strain modes per crystal class:
  cubic (3 modes):      [e,-e,0,0,0,0] -> C11 - C12
                        [e, e,e,0,0,0] -> (3/2)(C11 + 2 C12)
                        [0, 0,0,e,e,e] -> (3/2) C44
  hexagonal (5 modes):  [e,e,0,0,0,0]  -> C11 + C12
                        [0,0,0,0,0,e]  -> (C11 - C12)/4
                        [0,0,e,0,0,0]  -> C33/2
                        [0,0,0,e,e,0]  -> C44
                        [e,e,e,0,0,0]  -> C11 + C12 + 2 C13 + C33/2

Two execution paths: ``calc`` (any port CalculatorMP; in-process) or the
DFT round-trip (``export_inputs`` writes POSCARs + manifest.json, user runs
VASP, ``import_results`` reads OSZICAR energies + vasprun.xml forces).
Requires phonopy (and spglib for automatic class detection); without them
it raises the JAX package's ImportError.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["QHAElastic"]

EV_A3_TO_GPA = 160.2176621

CUBIC_STRAIN_MODES = (
    np.array([1.0, -1.0, 0, 0, 0, 0]),
    np.array([1.0, 1.0, 1.0, 0, 0, 0]),
    np.array([0, 0, 0, 1.0, 1.0, 1.0]),
)
HEXAGONAL_STRAIN_MODES = (
    np.array([1.0, 1.0, 0, 0, 0, 0]),
    np.array([0, 0, 0, 0, 0, 1.0]),
    np.array([0, 0, 1.0, 0, 0, 0]),
    np.array([0, 0, 0, 1.0, 1.0, 0]),
    np.array([1.0, 1.0, 1.0, 0, 0, 0]),
)


def _require_phonopy():
    try:
        from phonopy import Phonopy
        from phonopy.structure.atoms import PhonopyAtoms
    except ImportError as err:  # pragma: no cover - optional dep
        raise ImportError(
            "QHAElastic requires the optional dependency 'phonopy' "
            "(pip install phonopy)."
        ) from err
    return Phonopy, PhonopyAtoms


def _cubic_kappa_to_cij(kappa):
    # k0 = C11 - C12; k1 = 1.5 (C11 + 2 C12); k2 = 1.5 C44
    k0, k1, k2 = kappa
    c11 = (2.0 * k0 / 3.0) + (2.0 * k1 / 9.0)
    c12 = c11 - k0
    c44 = 2.0 * k2 / 3.0
    return c11, c12, c44


def _hexagonal_kappa_to_cij(kappa):
    k0, k1, k2, k3, k4 = kappa
    c11_plus_c12 = k0
    c11_minus_c12 = 4.0 * k1
    c11 = 0.5 * (c11_plus_c12 + c11_minus_c12)
    c12 = 0.5 * (c11_plus_c12 - c11_minus_c12)
    c33 = 2.0 * k2
    c44 = k3
    c13 = 0.5 * (k4 - c11_plus_c12 - 0.5 * c33)
    return c11, c12, c13, c33, c44


def _build_cij_matrix(crystal_class, kappa):
    C = np.zeros((6, 6))
    if crystal_class == "cubic":
        c11, c12, c44 = _cubic_kappa_to_cij(kappa)
        C[:3, :3] = c12
        np.fill_diagonal(C[:3, :3], c11)
        C[3, 3] = C[4, 4] = C[5, 5] = c44
    else:
        c11, c12, c13, c33, c44 = _hexagonal_kappa_to_cij(kappa)
        C[0, 0] = C[1, 1] = c11
        C[0, 1] = C[1, 0] = c12
        C[0, 2] = C[2, 0] = C[1, 2] = C[2, 1] = c13
        C[2, 2] = c33
        C[3, 3] = C[4, 4] = c44
        C[5, 5] = 0.5 * (c11 - c12)
    return C


def _voigt_to_tensor(v):
    return np.array([
        [v[0], v[5] / 2, v[4] / 2],
        [v[5] / 2, v[1], v[3] / 2],
        [v[4] / 2, v[3] / 2, v[2]],
    ])


def _deformation(strain):
    # symmetric small-strain deformation: F = 1 + eps
    return np.eye(3) + strain


class QHAElastic:
    """Temperature-dependent elastic constants in the quasi-harmonic
    approximation."""

    def __init__(
        self,
        system,
        calc=None,
        t_min: float = 0.0,
        t_max: float = 1000.0,
        t_step: float = 100.0,
        volume_strains: Sequence[float] = (-0.06, -0.03, 0.0, 0.03, 0.06),
        strain_values: Sequence[float] = (-0.02, -0.01, 0.0, 0.01, 0.02),
        supercell: Tuple[int, int, int] = (2, 2, 2),
        mesh: Tuple[int, int, int] = (10, 10, 10),
        displacement: float = 0.01,
        symprec: float = 1e-5,
        crystal_class: Optional[str] = None,
        quiet: bool = True,
    ):
        # phonopy is only needed once displacements are generated
        # (_phonopy_for); the grid build, export_inputs manifest layout and
        # compute()'s fitting math are phonopy-free
        if 0.0 not in [float(s) for s in strain_values]:
            raise ValueError("strain_values must include 0")
        if len(volume_strains) < 3:
            raise ValueError("volume_strains needs at least 3 points")
        self.system = system
        self.calc = calc
        self.temperatures = np.arange(t_min, t_max + 0.5 * t_step, t_step)
        self.volume_strains = [float(v) for v in volume_strains]
        self.strain_values = [float(s) for s in strain_values]
        self.supercell = tuple(supercell)
        self.mesh = tuple(mesh)
        self.displacement = float(displacement)
        self.symprec = float(symprec)
        self.quiet = quiet
        self.crystal_class = crystal_class or self._detect_class()
        self.modes = (CUBIC_STRAIN_MODES if self.crystal_class == "cubic"
                      else HEXAGONAL_STRAIN_MODES)
        self._build_grid()
        self.results_df = None

    # ------------------------------------------------------------- geometry
    def _detect_class(self) -> str:
        try:
            import spglib

            cell = (self.system.box.matrix,
                    (self.system.pos - self.system.box.origin)
                    @ np.linalg.inv(self.system.box.matrix),
                    [int(t) for t in np.asarray(self.system.data["type"])])
            num = spglib.get_symmetry_dataset(cell, symprec=self.symprec).number
            if 195 <= num <= 230:
                return "cubic"
            if 168 <= num <= 194:
                return "hexagonal"
            raise ValueError(
                f"space group {num}: only cubic/hexagonal are supported; "
                "pass crystal_class explicitly"
            )
        except ImportError as err:
            raise ImportError(
                "QHAElastic automatic crystal-class detection requires "
                "'spglib'; install it or pass crystal_class='cubic'/"
                "'hexagonal'."
            ) from err

    def _build_grid(self):
        """Unique cells: per volume, one eps=0 base + each (mode, eps!=0);
        grid: every (volume, mode, eps) pointing at its unique cell."""
        from ..core.box import Box
        from ..core.system import System

        cell0 = self.system.box.matrix
        pos0 = self.system.pos - self.system.box.origin
        frac0 = pos0 @ np.linalg.inv(cell0)
        elems = np.asarray(self.system.data["element"], dtype=object)
        dev = self.system.device

        self.unique_cells = []
        self.grid = []
        for vi, vs in enumerate(self.volume_strains):
            scale = (1.0 + vs) ** (1.0 / 3.0)
            vcell = cell0 * scale
            base_idx = None
            for mi, mode in enumerate(self.modes):
                for eps in self.strain_values:
                    if eps == 0.0:
                        if base_idx is None:
                            F = np.eye(3)
                            new_cell = vcell @ F.T
                            sysm = System(
                                pos=frac0 @ new_cell, box=Box(new_cell),
                                element_list=elems, device=dev,
                            )
                            base_idx = len(self.unique_cells)
                            self.unique_cells.append({
                                "system": sysm, "volume_strain": vs,
                                "mode": -1, "eps": 0.0,
                                "E_static": None, "forces": None,
                                "phonopy": None,
                            })
                        self.grid.append({"v": vi, "mode": mi, "eps": 0.0,
                                          "cell": base_idx})
                        continue
                    strain = _voigt_to_tensor(mode * eps)
                    new_cell = vcell @ _deformation(strain).T
                    sysm = System(pos=frac0 @ new_cell, box=Box(new_cell),
                                  element_list=elems, device=dev)
                    idx = len(self.unique_cells)
                    self.unique_cells.append({
                        "system": sysm, "volume_strain": vs, "mode": mi,
                        "eps": eps, "E_static": None, "forces": None,
                        "phonopy": None,
                    })
                    self.grid.append({"v": vi, "mode": mi, "eps": eps,
                                      "cell": idx})

    def _phonopy_for(self, uc):
        Phonopy, PhonopyAtoms = _require_phonopy()
        s = uc["system"]
        atoms = PhonopyAtoms(
            symbols=np.asarray(s.data["element"]).astype(str),
            cell=s.box.matrix, positions=s.pos,
        )
        ph = Phonopy(unitcell=atoms, supercell_matrix=np.diag(self.supercell),
                     primitive_matrix="auto", symprec=self.symprec)
        ph.generate_displacements(distance=self.displacement)
        return ph

    # ------------------------------------------------------------------ run
    def run(self) -> None:
        """In-process path: static energies + displacement forces via calc."""
        if self.calc is None:
            raise RuntimeError("run() needs calc; use export_inputs/"
                               "import_results for the DFT path")
        from ..core.system import System

        for uc in self.unique_cells:
            s = uc["system"]
            s.calc = self.calc
            self.calc.results = {}
            uc["E_static"] = float(s.get_energy())
            ph = self._phonopy_for(uc)
            forces = []
            for atoms in ph.supercells_with_displacements:
                sc = System(
                    pos=np.asarray(atoms.positions),
                    box=np.asarray(atoms.cell),
                    element_list=np.asarray(atoms.symbols, dtype=object),
                    device=self.system.device,
                )
                sc.calc = self.calc
                self.calc.results = {}
                f = np.array(sc.get_force())
                f -= f.mean(axis=0)
                forces.append(f)
            uc["forces"] = forces
            uc["phonopy"] = ph

    # --------------------------------------------------------------- output
    def _free_energies(self):
        """F_tot(cell, T) = E_static + F_vib(T) per atom basis (eV)."""
        out = np.zeros((len(self.unique_cells), len(self.temperatures)))
        for ci, uc in enumerate(self.unique_cells):
            ph = uc["phonopy"] or self._phonopy_for(uc)
            ph.produce_force_constants(forces=np.array(uc["forces"]))
            ph.run_mesh(self.mesh)
            ph.run_thermal_properties(
                temperatures=self.temperatures
            )
            td = ph.get_thermal_properties_dict()
            # kJ/mol (per formula unit of the phonopy primitive) -> eV/cell
            n_prim = len(ph.primitive)
            n_unit = uc["system"].N
            fvib = np.array(td["free_energy"]) * 1.036427e-2  # kJ/mol -> eV
            fvib = fvib * n_unit / n_prim
            out[ci] = uc["E_static"] + fvib
        return out

    def compute(self):
        """Return an AtomFrame with T, V(T), C_ij(T) (GPa) and B, one row a
        temperature (the columns of the JAX package's DataFrame)."""
        from ..core.frame import AtomFrame

        F = self._free_energies()  # (ncell, nT)
        nV = len(self.volume_strains)
        nM = len(self.modes)
        eps_arr = np.array(sorted(set(self.strain_values)))
        rows = []
        cell0_vol = abs(np.linalg.det(self.system.box.matrix))
        for ti, T in enumerate(self.temperatures):
            # per-volume base free energy + per-(volume, mode) curvature
            base_F = np.zeros(nV)
            vols = np.zeros(nV)
            kappa_v = np.zeros((nV, nM))
            for vi, vs in enumerate(self.volume_strains):
                vols[vi] = cell0_vol * (1.0 + vs)
                for mi in range(nM):
                    eps_list, f_list = [], []
                    for g in self.grid:
                        if g["v"] == vi and g["mode"] == mi:
                            eps_list.append(g["eps"])
                            f_list.append(F[g["cell"], ti])
                    order = np.argsort(eps_list)
                    e = np.array(eps_list)[order]
                    f = np.array(f_list)[order]
                    coef = np.polyfit(e, f, 2)
                    # kappa_k = a_k / V (the raw eps^2 coefficient, NOT the
                    # second derivative): with F = (V/2) m^T C m eps^2 this
                    # makes kappa_0 = C11 - C12 etc. (elastemp convention)
                    kappa_v[vi, mi] = coef[0] / vols[vi] * EV_A3_TO_GPA
                    if mi == 0:
                        base_F[vi] = f[np.argmin(np.abs(e))]
            # V(T) from a quadratic fit of F(V)
            c = np.polyfit(vols, base_F, 2)
            V_T = float(np.clip(-c[1] / (2 * c[0]), vols.min(), vols.max()))
            # interpolate curvatures to V(T)
            kappa_T = [
                float(np.polyval(np.polyfit(vols, kappa_v[:, mi], 2), V_T))
                for mi in range(nM)
            ]
            C = _build_cij_matrix(self.crystal_class, kappa_T)
            row = {"T": float(T), "V": V_T}
            if self.crystal_class == "cubic":
                row.update(C11=C[0, 0], C12=C[0, 1], C44=C[3, 3])
            else:
                row.update(C11=C[0, 0], C12=C[0, 1], C13=C[0, 2],
                           C33=C[2, 2], C44=C[3, 3])
            row["B"] = C[:3, :3].sum() / 9
            rows.append(row)
        self.results_df = AtomFrame(
            {k: np.array([r[k] for r in rows]) for k in rows[0]})
        return self.results_df

    # ------------------------------------------------------------ DFT path
    def export_inputs(self, path) -> None:
        """Write POSCARs + manifest.json for external VASP runs."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        manifest = {"unique_cells": []}
        for ci, uc in enumerate(self.unique_cells):
            sub = path / f"cell-{ci:03d}"
            (sub / "static").mkdir(parents=True, exist_ok=True)
            uc["system"].write_poscar(str(sub / "static" / "POSCAR"))
            ph = self._phonopy_for(uc)
            uc["phonopy"] = ph
            n_disp = 0
            for d, atoms in enumerate(ph.supercells_with_displacements, 1):
                from ..core.system import System

                sc = System(
                    pos=np.asarray(atoms.positions),
                    box=np.asarray(atoms.cell),
                    element_list=np.asarray(atoms.symbols, dtype=object),
                    device=self.system.device,
                )
                ddir = sub / f"disp-{d:03d}"
                ddir.mkdir(exist_ok=True)
                sc.write_poscar(str(ddir / "POSCAR"))
                n_disp = d
            manifest["unique_cells"].append(
                {"path": sub.name, "n_disp": n_disp}
            )
        with open(path / "manifest.json", "w") as f:
            json.dump(manifest, f, indent=1)

    def import_results(self, path) -> None:
        """Read OSZICAR energies + vasprun.xml forces back into the grid."""
        path = Path(path)
        with open(path / "manifest.json") as f:
            manifest = json.load(f)
        for uc, entry in zip(self.unique_cells, manifest["unique_cells"]):
            sub = path / entry["path"]
            text = (sub / "static" / "OSZICAR").read_text()
            m = re.findall(r"E0=\s*([-+0-9.eEdD]+)", text)
            uc["E_static"] = float(m[-1].replace("D", "E").replace("d", "e"))
            forces = []
            for d in range(1, entry["n_disp"] + 1):
                xml = (sub / f"disp-{d:03d}" / "vasprun.xml").read_text()
                block = re.search(
                    r'<varray name="forces">(.*?)</varray>', xml, re.DOTALL
                ).group(1)
                rows = re.findall(
                    r"<v>\s*([-\d.eE+]+)\s+([-\d.eE+]+)\s+([-\d.eE+]+)\s*</v>",
                    block,
                )
                f = np.array(rows, dtype=float)
                f -= f.mean(axis=0)
                forces.append(f)
            uc["forces"] = forces
            if uc["phonopy"] is None:
                uc["phonopy"] = self._phonopy_for(uc)
