"""LAMMPS-backed calculator + runner (optional dependency).

A host copy of ``mdapy_tpu/potentials/lammps.py`` (the whole file,
:1-273), itself after the reference's lammps_potential.py /
lammps_runner.py: ``LammpsPotential`` is a port ``CalculatorMP`` (its
results numpy arrays from LAMMPS), and ``LammpsRunner.get_system`` returns
a port ``System``.  Requires the ``lammps`` Python bindings; without them
it raises the JAX package's ImportError.
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Optional

import numpy as np

from .calculator import CalculatorMP

__all__ = ["LammpsPotential", "LammpsRunner", "silence"]


def _require_lammps():
    try:
        from lammps import lammps
    except ImportError as err:  # pragma: no cover - optional dep
        raise ImportError(
            "LammpsPotential/LammpsRunner require the optional 'lammps' "
            "python bindings (pip install lammps, or build LAMMPS with "
            "PYTHON support)."
        ) from err
    return lammps


@contextlib.contextmanager
def silence(enabled: bool = True):
    """Redirect C-level stdout/stderr to /dev/null while LAMMPS runs."""
    if not enabled:
        yield
        return
    devnull = os.open(os.devnull, os.O_WRONLY)
    saved = os.dup(1), os.dup(2)
    try:
        os.dup2(devnull, 1)
        os.dup2(devnull, 2)
        yield
    finally:
        os.dup2(saved[0], 1)
        os.dup2(saved[1], 2)
        os.close(devnull)
        os.close(saved[0])
        os.close(saved[1])


class LammpsPotential(CalculatorMP):
    """Single-point LAMMPS evaluation: per-atom energies/forces/virials and
    global Voigt stress. Supports any LAMMPS pair style via
    ``pair_parameter`` command strings."""

    def __init__(
        self,
        pair_parameter: str,
        element_list: List[str],
        units: str = "metal",
        centroid_stress: bool = False,
        cmdargs: Optional[List[str]] = None,
        extra_commands: Optional[str] = None,
        silence_lammps: bool = True,
    ):
        super().__init__()
        assert units == "metal", "Only support metal units now."
        self.pair_parameter = pair_parameter
        self.element_list = list(element_list)
        self.units = units
        self.centroid_stress = centroid_stress
        self.cmdargs = list(cmdargs) if cmdargs else []
        self.extra_commands = extra_commands
        self.silence_lammps = silence_lammps

    def calculate(self, system) -> None:
        lammps = _require_lammps()
        data, box = system.data, system.box
        for c in ("x", "y", "z", "element"):
            assert c in data.columns, f"data does not have {c} information."
        elems = np.asarray(data["element"]).astype(str)
        for e in set(elems.tolist()):
            assert e in self.element_list, f"element_list missing {e}."
        boundary = " ".join("p" if b else "s" for b in box.boundary)
        N = system.N
        with silence(self.silence_lammps):
            lmp = lammps(cmdargs=["-echo", "none", "-log", "none",
                                  "-screen", "none"] + self.cmdargs)
            try:
                m = box.matrix
                lmp.commands_string(f"units {self.units}")
                lmp.commands_string(f"boundary {boundary}")
                lmp.commands_string("atom_style atomic")
                lmp.commands_string(
                    f"lattice custom 1.0 a1 {m[0,0]} {m[0,1]} {m[0,2]} "
                    f"a2 {m[1,0]} {m[1,1]} {m[1,2]} "
                    f"a3 {m[2,0]} {m[2,1]} {m[2,2]} basis 0.0 0.0 0.0 "
                    "triclinic/general\n"
                    f"create_box {len(self.element_list)} NULL 0 1 0 1 0 1"
                )
                if self.extra_commands:
                    lmp.commands_string(self.extra_commands)
                lut = {e: i + 1 for i, e in enumerate(self.element_list)}
                types = np.array([lut[e] for e in elems], dtype=np.int32)
                pos = (system.pos - box.origin).ravel()
                lmp.create_atoms(N, np.arange(1, N + 1).astype(np.int32),
                                 types, pos, None)
                for i, e in enumerate(self.element_list, 1):
                    from ..core.elements import atomic_masses, atomic_numbers

                    lmp.commands_string(
                        f"mass {i} {atomic_masses[atomic_numbers[e]]}"
                    )
                lmp.commands_string(self.pair_parameter)
                stress_cmd = ("centroid/stress/atom NULL"
                              if self.centroid_stress else "stress/atom NULL")
                lmp.commands_string(
                    "compute pe_atom all pe/atom\n"
                    f"compute st_atom all {stress_cmd}\n"
                    "run 0"
                )
                energies = np.array(lmp.numpy.extract_compute(
                    "pe_atom", 1, 1))[:N].copy()
                forces = np.array(lmp.numpy.extract_atom("f"))[:N].copy()
                st = np.array(lmp.numpy.extract_compute(
                    "st_atom", 1, 2))[:N].copy()
                # LAMMPS stress/atom (bar*A^3) -> eV; reorder to row-major 3x3
                virial = -st / 1e4 / 160.21766208
                v9 = np.zeros((N, 9))
                # st columns: xx yy zz xy xz yz (stress/atom) ->
                # [xx xy xz yx yy yz zx zy zz]
                v9[:, 0], v9[:, 4], v9[:, 8] = virial[:, 0], virial[:, 1], virial[:, 2]
                v9[:, 1] = v9[:, 3] = virial[:, 3]
                v9[:, 2] = v9[:, 6] = virial[:, 4]
                v9[:, 5] = v9[:, 7] = virial[:, 5]
                self.results["energies"] = energies
                self.results["forces"] = forces
                self.results["virials"] = v9
                self.results["stress"] = self.stress_from_virials(
                    v9, abs(box.volume)
                )
            finally:
                lmp.close()


class LammpsRunner:
    """Persistent LAMMPS session for minimization / MD on a System."""

    def __init__(self, system, pair_parameter: str, element_list: List[str],
                 units: str = "metal", cmdargs: Optional[List[str]] = None,
                 silence_lammps: bool = True):
        _require_lammps()
        assert units == "metal"
        self.system = system
        self.pair_parameter = pair_parameter
        self.element_list = list(element_list)
        self.units = units
        self.cmdargs = list(cmdargs) if cmdargs else []
        self.silence_lammps = silence_lammps
        self._lmp = None
        self._setup(system)

    def _setup(self, system) -> None:
        lammps = _require_lammps()
        box = system.box
        m = box.matrix
        boundary = " ".join("p" if b else "s" for b in box.boundary)
        elems = np.asarray(system.data["element"]).astype(str)
        lut = {e: i + 1 for i, e in enumerate(self.element_list)}
        with silence(self.silence_lammps):
            lmp = lammps(cmdargs=["-echo", "none", "-log", "none",
                                  "-screen", "none"] + self.cmdargs)
            lmp.commands_string(
                f"units {self.units}\nboundary {boundary}\n"
                "atom_style atomic\n"
                f"lattice custom 1.0 a1 {m[0,0]} {m[0,1]} {m[0,2]} "
                f"a2 {m[1,0]} {m[1,1]} {m[1,2]} "
                f"a3 {m[2,0]} {m[2,1]} {m[2,2]} basis 0.0 0.0 0.0 "
                "triclinic/general\n"
                f"create_box {len(self.element_list)} NULL 0 1 0 1 0 1"
            )
            types = np.array([lut[e] for e in elems], dtype=np.int32)
            lmp.create_atoms(system.N,
                             np.arange(1, system.N + 1).astype(np.int32),
                             types, (system.pos - box.origin).ravel(), None)
            from ..core.elements import atomic_masses, atomic_numbers

            for i, e in enumerate(self.element_list, 1):
                lmp.commands_string(f"mass {i} {atomic_masses[atomic_numbers[e]]}")
            lmp.commands_string(self.pair_parameter)
        self._lmp = lmp

    def _ensure_open(self):
        if self._lmp is None:
            raise RuntimeError("LAMMPS session closed; create a new runner.")

    def minimize(self, etol: float = 0.0, ftol: float = 1e-6,
                 maxiter: int = 10000, maxeval: int = 100000) -> None:
        self._ensure_open()
        with silence(self.silence_lammps):
            self._lmp.commands_string(
                f"minimize {etol} {ftol} {maxiter} {maxeval}"
            )

    def minimize_box(self, etol: float = 0.0, ftol: float = 1e-6,
                     maxiter: int = 10000, maxeval: int = 100000,
                     ptarget: float = 0.0) -> None:
        self._ensure_open()
        with silence(self.silence_lammps):
            self._lmp.commands_string(
                f"fix boxrelax all box/relax iso {ptarget}\n"
                f"minimize {etol} {ftol} {maxiter} {maxeval}\n"
                "unfix boxrelax"
            )

    def run_md(self, ensemble: str = "nvt", temperature: float = 300.0,
               pressure: float = 0.0, timestep: float = 0.001,
               steps: int = 1000, seed: int = 1) -> None:
        self._ensure_open()
        cmds = [f"timestep {timestep}",
                f"velocity all create {temperature} {seed} mom yes rot yes"]
        if ensemble == "nve":
            cmds.append("fix md all nve")
        elif ensemble == "nvt":
            cmds.append(
                f"fix md all nvt temp {temperature} {temperature} "
                f"{100 * timestep}"
            )
        elif ensemble == "npt":
            cmds.append(
                f"fix md all npt temp {temperature} {temperature} "
                f"{100 * timestep} iso {pressure} {pressure} "
                f"{1000 * timestep}"
            )
        else:
            raise ValueError("ensemble must be nve/nvt/npt")
        cmds += [f"run {steps}", "unfix md"]
        with silence(self.silence_lammps):
            self._lmp.commands_string("\n".join(cmds))

    def get_system(self):
        """Extract the current LAMMPS state as a new port System, on the
        device of the system the runner was made with."""
        self._ensure_open()
        from ..core.box import Box
        from ..core.system import System

        lmp = self._lmp
        N = lmp.get_natoms()
        x = np.array(lmp.numpy.extract_atom("x"))[:N].copy()
        t = np.array(lmp.numpy.extract_atom("type"))[:N].copy()
        boxlo, boxhi, xy, yz, xz, *_ = lmp.extract_box()
        m = np.array([
            [boxhi[0] - boxlo[0], 0, 0],
            [xy, boxhi[1] - boxlo[1], 0],
            [xz, yz, boxhi[2] - boxlo[2]],
        ])
        elems = np.array(
            [self.element_list[int(i) - 1] for i in t], dtype=object
        )
        return System(pos=x + np.array(boxlo), box=Box(m, origin=np.array(boxlo)),
                      element_list=elems, device=self.system.device)

    def close(self) -> None:
        if self._lmp is not None:
            self._lmp.close()
            self._lmp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
