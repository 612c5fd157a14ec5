"""FIRE structural relaxation (FIRE2 + ABC-FIRE) with optional cell DoFs.

A host (numpy) copy of ``mdapy_tpu/potentials/minimizer.py`` (the whole
file: ``_AtomView`` :43, ``_StrainView`` :60, ``FIRE`` :121), kept here so
that the port imports nothing of the JAX package.  It drives any system
object by the attributes it reads: ``N``, ``pos``, ``box`` (``matrix``,
``volume``), ``calc.results``, ``update_pos``, ``update_box``,
``get_force``, ``get_energy`` and ``get_stress``; the forces come from the
system's calculator, on the card for the port's EAM and NEP.

Built from the published algorithms:

* FIRE2 stepping — Guenole et al., Comput. Mater. Sci. 175 (2020) 109584:
  semi-implicit Euler with velocity/force mixing, adaptive timestep, and
  the half-step uphill backtrack.
* ABC-FIRE bias correction — Echeverri Restrepo & Andric, Comput. Mater.
  Sci. 218 (2023) 111978: the (1 - (1-alpha)^(k+1))^-1 de-biasing factor
  with a per-component displacement cap.
* Cell relaxation — the strain-filter formalism of Tadmor et al., PRB 59,
  235 (1999) (ASE's UnitCellFilter): three extra pseudo-DoF rows carry the
  deformation gradient, driven by the virial, so one minimizer relaxes
  positions and cell together.

The extended coordinate space lives in a degree-of-freedom adapter
(`_AtomView` / `_StrainView`) that the integrator drives blindly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["FIRE"]

_EYE3 = np.eye(3)


def _symm_from_voigt(v6) -> np.ndarray:
    """Voigt [xx yy zz yz xz xy] -> symmetric 3x3."""
    xx, yy, zz, yz, xz, xy = np.asarray(v6, dtype=float)
    return np.array([[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]])


class _AtomView:
    """Position-only DoF space: rows are the N atomic coordinates."""

    def __init__(self, system):
        self.system = system
        self.rows = system.N

    def gradient_rows(self) -> np.ndarray:
        return self.system.get_force()

    def apply(self, step: np.ndarray) -> None:
        self.system.update_pos(self.system.pos + step)

    def report_energy(self) -> float:
        return self.system.get_energy()


class _StrainView:
    """Strain-extended DoF space (Tadmor/ASE filter).

    Rows 0..N-1 are atom coordinates expressed in the unstrained frame;
    rows N..N+2 carry cell_factor * deformation gradient.  Forces on the
    strain rows are the (optionally masked / symmetrized) virial.
    """

    def __init__(self, system, mask, cell_factor, hydrostatic, iso_volume,
                 pressure):
        self.system = system
        self.rows = system.N + 3
        self.reference_cell = system.box.matrix.copy()
        self.scale = cell_factor
        self.hydrostatic = hydrostatic
        self.iso_volume = iso_volume
        self.pressure = pressure
        if mask is None:
            self.mask = np.ones((3, 3))
        else:
            mask = np.asarray(mask, dtype=float)
            self.mask = _symm_from_voigt(mask) if mask.size == 6 else mask

    def _gradient(self) -> np.ndarray:
        """Deformation gradient F^T with box rows as cell vectors."""
        return np.linalg.solve(self.reference_cell, self.system.box.matrix).T

    def gradient_rows(self) -> np.ndarray:
        sysv = self.system
        cell_volume = abs(sysv.box.volume)
        stress_full = _symm_from_voigt(sysv.get_stress())
        w = (-stress_full - self.pressure * _EYE3) * cell_volume
        ft = self._gradient()
        atom_rows = sysv.get_force() @ ft
        w = np.linalg.solve(ft, w.T).T
        if self.hydrostatic:
            w = (w.trace() / 3.0) * _EYE3
        if (self.mask != 1.0).any():
            w = w * self.mask
        if self.iso_volume:
            w = w - (w.trace() / 3.0) * _EYE3
        return np.vstack((atom_rows, w / self.scale))

    def apply(self, step: np.ndarray) -> None:
        sysv = self.system
        natoms = sysv.N
        ft = self._gradient()
        frame_pos = np.linalg.solve(ft, sysv.pos.T).T + step[:natoms]
        ft_next = ft + step[natoms:] / self.scale
        strain = (ft_next - _EYE3).T * self.mask
        cell = self.reference_cell @ (_EYE3 + strain)
        sysv.update_box(cell)
        sysv.update_pos(frame_pos @ (_EYE3 + strain))

    def report_energy(self) -> float:
        # enthalpy under the imposed scalar pressure
        return self.system.get_energy() + self.pressure * abs(
            self.system.box.volume
        )


class FIRE:
    """FIRE2 / ABC-FIRE structural relaxation.

    API parity with the reference minimizer (constructor keywords and
    ``run(steps, fmax, show_process)``); see module docstring for the
    algorithm sources this implementation is built from.
    """

    def __init__(
        self,
        system,
        dt: float = 0.1,
        maxstep: float = 0.2,
        dtmax: float = 1.0,
        dtmin: float = 2e-3,
        Nmin: int = 20,
        finc: float = 1.1,
        fdec: float = 0.5,
        astart: float = 0.25,
        fa: float = 0.99,
        use_abc: bool = False,
        optimize_cell: bool = False,
        mask=None,
        cell_factor: Optional[float] = None,
        hydrostatic_strain: bool = False,
        constant_volume: bool = False,
        scalar_pressure: float = 0.0,
    ):
        self.system = system
        self.use_abc = use_abc
        self.optimize_cell = optimize_cell
        # timestep adaptation knobs
        self.dt = dt
        self.dtmax = dtmax
        self.dtmin = dtmin
        self.maxstep = maxstep
        self.finc = finc
        self.fdec = fdec
        # mixing-coefficient knobs
        self.astart = astart
        self.fa = fa
        self.a = astart
        self.Nmin = Nmin
        self.Nsteps = 0  # consecutive downhill steps
        if optimize_cell:
            self._dof = _StrainView(
                system,
                mask=mask,
                cell_factor=float(system.N) if cell_factor is None else cell_factor,
                hydrostatic=hydrostatic_strain,
                iso_volume=constant_volume,
                pressure=scalar_pressure,
            )
        else:
            self._dof = _AtomView(system)
        self.scalar_pressure = scalar_pressure

    # -- one velocity update given fresh forces; returns (velocity, forces) --
    def _advance_velocity(self, vel, frc):
        power = np.vdot(frc, vel)
        if power > 0.0:
            self.Nsteps += 1
            if self.Nsteps > self.Nmin:
                self.dt = min(self.dt * self.finc, self.dtmax)
                self.a *= self.fa
        else:
            # uphill: shrink dt, rewind half of the last kick, restart mixing
            self.Nsteps = 0
            self.dt = max(self.dt * self.fdec, self.dtmin)
            self.a = self.astart
            self._dof.apply(-0.5 * self.dt * vel)
            frc = self._dof.gradient_rows()
            vel = np.zeros_like(vel)
        return vel, frc

    def _mix(self, vel, frc):
        """FIRE velocity/force mixing; ABC variant de-biases and caps."""
        alpha = max(self.a, 1e-10) if self.use_abc else self.a
        fnorm = np.sqrt(np.vdot(frc, frc))
        vnorm = np.sqrt(np.vdot(vel, vel))
        blended = (1.0 - alpha) * vel + alpha * frc / fnorm * vnorm
        if not self.use_abc:
            return blended
        debias = 1.0 / (1.0 - (1.0 - alpha) ** (self.Nsteps + 1))
        vel = debias * blended
        if np.all(vel):
            # cap each component's displacement at maxstep, keeping sign
            cap = self.maxstep / self.dt
            mag = np.abs(vel)
            vel = np.where(mag * self.dt > self.maxstep, cap * vel / mag, vel)
        return vel

    def run(self, steps: int, fmax: float = 1e-4, show_process: bool = False) -> bool:
        """Relax for at most `steps` iterations; True once max |F| < fmax."""
        vel = None
        if show_process:
            print(f"{'it':>6} {'energy/eV':>15} {'max|F|':>15} {'P/GPa-like':>15}")
        for it in range(steps):
            frc = self._dof.gradient_rows()
            peak = np.sqrt((frc * frc).sum(axis=1).max())
            if show_process:
                pressure = -self.system.get_stress()[:3].mean()
                print(
                    f"{it:6d} {self._dof.report_energy():15.6f} "
                    f"{peak:15.6f} {pressure:15.6f}"
                )
            if peak < fmax:
                if show_process:
                    print("FIRE: converged.")
                return True
            if vel is None:
                vel = np.zeros((self._dof.rows, 3))
            else:
                vel, frc = self._advance_velocity(vel, frc)
            vel = self._mix(vel + self.dt * frc, frc)
            step = self.dt * vel
            if not self.use_abc:
                length = np.sqrt(np.vdot(step, step))
                if length > self.maxstep:
                    step = self.maxstep * step / length
            self._dof.apply(step)
        # leave no stale per-configuration cache behind on failure
        self.system.calc.results = {}
        if show_process:
            print("FIRE: step budget exhausted before reaching fmax.")
        return False
