"""Finite-temperature elastic constants from MD stress fluctuations.

A host copy of ``mdapy_tpu/potentials/md_elastic.py`` (the whole file,
:1-348), itself after the reference's md_elastic.py: the Aidan Thompson
finite-T recipe (LAMMPS examples/ELASTIC/T):

1. NPT pre-relax to the equilibrium cell at (T, P); save the cell.
2. NVT reference run; time-average the stress -> sigma_0.
3. For each Voigt direction d and sign s: deform the equilibrium cell by
   ``s * delta`` (engineering strain, tilt for shears), run NVT (isothermal)
   or NVE (adiabatic), time-average the stress -> sigma_{d,s}.
4. C_id = -(sigma_{d,+}[i] - sigma_{d,-}[i]) / (2 delta); symmetrise.

Requires the ``lammps`` Python bindings; without them it raises the JAX
package's ImportError.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["MDElastic", "MDElasticResult"]

_BAR_TO_GPA = 1e-4


def _require_lammps():
    try:
        from lammps import lammps
    except ImportError as err:  # pragma: no cover - optional dep
        raise ImportError(
            "lammps Python module is required for MDElastic. Install via "
            "conda-forge lammps or build LAMMPS with PKG_PYTHON=ON."
        ) from err
    return lammps


class MDElasticResult:
    """C (6x6, GPa), reference stress, equilibrium volume, actual T."""

    def __init__(self, C: np.ndarray, stress_ref: np.ndarray, V_eq: float,
                 T_actual: float, temperature: float, ensemble: str):
        self.C = np.asarray(C, dtype=float)
        self.stress_ref = np.asarray(stress_ref, dtype=float)
        self.V_eq = float(V_eq)
        self.T_actual = float(T_actual)
        self.temperature = float(temperature)
        self.ensemble = str(ensemble)

    def cubic_average(self) -> Tuple[float, float, float]:
        C = self.C
        c11 = (C[0, 0] + C[1, 1] + C[2, 2]) / 3
        c12 = (C[0, 1] + C[0, 2] + C[1, 2]) / 3
        c44 = (C[3, 3] + C[4, 4] + C[5, 5]) / 3
        return float(c11), float(c12), float(c44)

    def vrh(self) -> Dict[str, float]:
        """Voigt-Reuss-Hill bulk and shear moduli (GPa)."""
        C = self.C
        S = np.linalg.inv(C)
        KV = C[:3, :3].sum() / 9
        GV = ((C[0, 0] + C[1, 1] + C[2, 2] - C[0, 1] - C[0, 2] - C[1, 2]) / 15
              + (C[3, 3] + C[4, 4] + C[5, 5]) / 5)
        KR = 1.0 / S[:3, :3].sum()
        GR = 15.0 / (4 * (S[0, 0] + S[1, 1] + S[2, 2])
                     - 4 * (S[0, 1] + S[0, 2] + S[1, 2])
                     + 3 * (S[3, 3] + S[4, 4] + S[5, 5]))
        K = 0.5 * (KV + KR)
        G = 0.5 * (GV + GR)
        E = 9 * K * G / (3 * K + G)
        nu = (3 * K - 2 * G) / (6 * K + 2 * G)
        return {"K": K, "G": G, "E": E, "nu": nu,
                "KV": KV, "KR": KR, "GV": GV, "GR": GR}

    def born_stable_cubic(self) -> bool:
        c11, c12, c44 = self.cubic_average()
        return c11 - c12 > 0 and c11 + 2 * c12 > 0 and c44 > 0

    def print(self) -> None:
        c11, c12, c44 = self.cubic_average()
        print(f"MDElastic @ T={self.temperature:.0f} K ({self.ensemble}):")
        print(f"  V_eq = {self.V_eq:.2f} A^3, T_actual = {self.T_actual:.1f} K")
        print(f"  C11 = {c11:.2f}  C12 = {c12:.2f}  C44 = {c44:.2f} GPa")


def assemble_elastic_tensor(stress_plus: np.ndarray,
                            stress_minus: np.ndarray,
                            delta: float) -> np.ndarray:
    """C_ij from central-difference deformation stresses.

    stress_plus/minus: (6, 6) arrays, row d = Voigt stress (GPa) of the
    +delta / -delta deformation along Voigt direction d.  Returns the
    symmetrized 6x6 stiffness (GPa).  Separated from the LAMMPS runs so
    the assembly math is testable without a LAMMPS build."""
    C = np.zeros((6, 6))
    for d in range(6):
        C[:, d] = -(stress_plus[d] - stress_minus[d]) / (2.0 * delta)
    return 0.5 * (C + C.T)


def fanout(fn, jobs, n_workers: int):
    """Run fn over jobs, either inline or on a spawn process pool.

    The reference farms its deformation runs to multiprocessing workers
    (reference md_elastic.py:157-450); each job here spawns its own LAMMPS
    instance from a restart file, so processes (not threads) are required."""
    if n_workers <= 1 or len(jobs) <= 1:
        return [fn(j) for j in jobs]
    import multiprocessing as mp_

    # spawn, not fork: a forked child cannot use a CUDA context that the
    # parent has started (the port's calculators and Systems start one on
    # the card), and each worker starts its own LAMMPS
    ctx = mp_.get_context("spawn")
    with ctx.Pool(min(n_workers, len(jobs))) as pool:
        return pool.map(fn, jobs)


def _segment_worker(args):
    """Module-level (picklable) deformation-segment job for fanout()."""
    cfg, restart, d, sign, L0 = args
    stub = MDElastic.__new__(MDElastic)
    stub.__dict__.update(cfg)
    return stub._deform_segment(restart, d, sign, np.asarray(L0))


class MDElastic:
    """Finite-T elastic constants of a System with a LAMMPS pair style."""

    def __init__(
        self,
        system,
        temperature: float,
        pair_style: str,
        pair_coeff: str,
        elements: Sequence[str],
        delta: float = 0.02,
        pressure: float = 0.0,
        ensemble: str = "isothermal",
        thermostat: str = "langevin",
        n_equil: int = 5000,
        n_run: int = 20000,
        n_relax: int = 10000,
        timestep: float = 0.001,
        seed: int = 12345,
        quiet: bool = True,
        n_workers: int = 1,
    ):
        _require_lammps()
        if ensemble not in ("isothermal", "adiabatic"):
            raise ValueError(
                f"ensemble must be 'isothermal' or 'adiabatic', got {ensemble!r}"
            )
        if delta <= 0:
            raise ValueError("delta must be positive")
        self.system = system
        self.temperature = float(temperature)
        self.pair_style = pair_style
        self.pair_coeff = pair_coeff
        self.elements = list(elements)
        self.delta = float(delta)
        self.pressure = float(pressure)
        self.ensemble = ensemble
        self.thermostat = thermostat
        self.n_equil = int(n_equil)
        self.n_run = int(n_run)
        self.n_relax = int(n_relax)
        self.timestep = float(timestep)
        self.seed = int(seed)
        self.quiet = quiet
        self.n_workers = int(n_workers)

    # ------------------------------------------------------------- helpers
    def _new_lammps(self):
        lammps = _require_lammps()
        from .lammps import silence

        with silence(self.quiet):
            lmp = lammps(cmdargs=["-echo", "none", "-log", "none",
                                  "-screen", "none"])
        return lmp

    def _setup_atoms(self, lmp, system) -> None:
        from ..core.elements import atomic_masses, atomic_numbers
        from .lammps import silence

        m = system.box.matrix
        elems = np.asarray(system.data["element"]).astype(str)
        lut = {e: i + 1 for i, e in enumerate(self.elements)}
        with silence(self.quiet):
            lmp.commands_string(
                "units metal\nboundary p p p\natom_style atomic\n"
                f"lattice custom 1.0 a1 {m[0,0]} {m[0,1]} {m[0,2]} "
                f"a2 {m[1,0]} {m[1,1]} {m[1,2]} "
                f"a3 {m[2,0]} {m[2,1]} {m[2,2]} basis 0.0 0.0 0.0 "
                "triclinic/general\n"
                f"create_box {len(self.elements)} NULL 0 1 0 1 0 1"
            )
            types = np.array([lut[e] for e in elems], dtype=np.int32)
            lmp.create_atoms(
                system.N, np.arange(1, system.N + 1).astype(np.int32),
                types, (system.pos - system.box.origin).ravel(), None,
            )
            for i, e in enumerate(self.elements, 1):
                lmp.commands_string(
                    f"mass {i} {atomic_masses[atomic_numbers[e]]}"
                )
            lmp.commands_string(
                f"pair_style {self.pair_style}\npair_coeff {self.pair_coeff}\n"
                f"timestep {self.timestep}\n"
                "compute press all pressure thermo_temp"
            )

    def _avg_stress_and_temp(self, lmp, nsteps: int) -> Tuple[np.ndarray, float]:
        """Run nsteps while time-averaging the 6 pressure components + T."""
        from .lammps import silence

        with silence(self.quiet):
            lmp.commands_string(
                "variable pxx equal pxx\nvariable pyy equal pyy\n"
                "variable pzz equal pzz\nvariable pyz equal pyz\n"
                "variable pxz equal pxz\nvariable pxy equal pxy\n"
                "variable tcur equal temp\n"
                f"fix avg all ave/time 10 {max(1, nsteps // 10)} {nsteps} "
                "v_pxx v_pyy v_pzz v_pyz v_pxz v_pxy v_tcur\n"
                f"run {nsteps}"
            )
            vals = [lmp.extract_fix("avg", 0, 1, i) for i in range(7)]
            lmp.commands_string("unfix avg")
        press = -np.array(vals[:6]) * _BAR_TO_GPA  # stress (GPa), Voigt
        return press, float(vals[6])

    # ----------------------------------------------------------------- run
    def run(self) -> MDElasticResult:
        from .lammps import silence

        T, dt = self.temperature, self.timestep
        lmp = self._new_lammps()
        restart = os.path.join(tempfile.mkdtemp(prefix="mdel_"), "eq.restart")
        try:
            self._setup_atoms(lmp, self.system)
            with silence(self.quiet):
                lmp.commands_string(
                    f"velocity all create {T} {self.seed} mom yes rot yes\n"
                    f"fix npt all npt temp {T} {T} {100 * dt} "
                    f"iso {self.pressure * 1e4} {self.pressure * 1e4} "
                    f"{1000 * dt}\n"
                    f"run {self.n_relax}\nunfix npt"
                )
                # average the relaxed cell, then fix it
                lmp.commands_string("run 0")
                boxlo, boxhi, xy, yz, xz, *_ = lmp.extract_box()
                V_eq = float(np.prod(np.array(boxhi) - np.array(boxlo)))
                lmp.commands_string(f"write_restart {restart}")
                # reference NVT run
                lmp.commands_string(
                    f"fix nvt all nvt temp {T} {T} {100 * dt}\n"
                    f"run {self.n_equil}"
                )
            stress_ref, T_actual = self._avg_stress_and_temp(lmp, self.n_run)
            with silence(self.quiet):
                lmp.close()

            # 12 deformation segments, fanned out over n_workers processes
            L0 = np.array(boxhi) - np.array(boxlo)
            cfg = self._segment_cfg()
            jobs = [(cfg, restart, d, sign, L0)
                    for d in range(6) for sign in (+1, -1)]
            stresses = fanout(_segment_worker, jobs, self.n_workers)
            s_plus = np.array(stresses[0::2])
            s_minus = np.array(stresses[1::2])
            C = assemble_elastic_tensor(s_plus, s_minus, self.delta)
            return MDElasticResult(C, stress_ref, V_eq, T_actual,
                                   self.temperature, self.ensemble)
        finally:
            try:
                os.remove(restart)
            except OSError:
                pass

    def _segment_cfg(self) -> dict:
        """Scalar-only config for the picklable segment worker (no System,
        no device arrays cross the process boundary)."""
        return dict(
            pair_style=self.pair_style, pair_coeff=self.pair_coeff,
            temperature=self.temperature, timestep=self.timestep,
            delta=self.delta, ensemble=self.ensemble,
            n_equil=self.n_equil, n_run=self.n_run, quiet=self.quiet,
        )

    def _deform_segment(self, restart: str, d: int, sign: int,
                        L0: np.ndarray) -> np.ndarray:
        from .lammps import silence

        lammps = _require_lammps()
        T, dt = self.temperature, self.timestep
        eps = sign * self.delta
        with silence(self.quiet):
            lmp = lammps(cmdargs=["-echo", "none", "-log", "none",
                                  "-screen", "none"])
            lmp.commands_string(
                f"read_restart {restart}\n"
                f"pair_style {self.pair_style}\npair_coeff {self.pair_coeff}\n"
                f"timestep {dt}\n"
                "change_box all triclinic"
            )
            if d == 0:
                cmd = f"change_box all x delta 0 {eps * L0[0]} remap units box"
            elif d == 1:
                cmd = f"change_box all y delta 0 {eps * L0[1]} remap units box"
            elif d == 2:
                cmd = f"change_box all z delta 0 {eps * L0[2]} remap units box"
            elif d == 3:
                cmd = f"change_box all yz delta {eps * L0[2]} remap units box"
            elif d == 4:
                cmd = f"change_box all xz delta {eps * L0[2]} remap units box"
            else:
                cmd = f"change_box all xy delta {eps * L0[1]} remap units box"
            lmp.commands_string(cmd)
            lmp.commands_string("compute press all pressure thermo_temp")
            if self.ensemble == "adiabatic":
                lmp.commands_string("fix md all nve")
            else:
                lmp.commands_string(
                    f"fix md all nvt temp {T} {T} {100 * dt}"
                )
            lmp.commands_string(f"run {self.n_equil}")
        stress, _ = self._avg_stress_and_temp(lmp, self.n_run)
        with silence(self.quiet):
            lmp.close()
        return stress

    def scan(self, temperatures: Sequence[float],
             log_dir: Optional[str] = None) -> List[MDElasticResult]:
        """Run the full protocol at each temperature sequentially."""
        results = []
        for T in temperatures:
            mde = MDElastic(
                self.system, T, self.pair_style, self.pair_coeff,
                self.elements, delta=self.delta, pressure=self.pressure,
                ensemble=self.ensemble, thermostat=self.thermostat,
                n_equil=self.n_equil, n_run=self.n_run,
                n_relax=self.n_relax, timestep=self.timestep,
                seed=self.seed, quiet=self.quiet,
            )
            results.append(mde.run())
        return results
