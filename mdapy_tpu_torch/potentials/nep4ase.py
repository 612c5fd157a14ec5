"""ASE Calculator interface over the port's NEP.

A copy of ``mdapy_tpu/potentials/nep4ase.py`` (the whole file, :1-73):
exposes energy/energies/forces/stress so NEP models plug into ASE
optimizers/MD.  Each call builds a port ``System`` on ``device`` and
evaluates the port's ``NEP`` there (the card unless ``device="cpu"``).
Requires the optional ``ase`` package; without it it raises the JAX
package's ImportError.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["NEP4ASE"]


def _require_ase():
    try:
        from ase.calculators.calculator import Calculator, all_changes
    except ImportError as err:  # pragma: no cover - optional dep
        raise ImportError(
            "NEP4ASE requires the optional dependency 'ase' "
            "(pip install ase)."
        ) from err
    return Calculator, all_changes


def NEP4ASE(model_filename: str, atoms=None, device="cuda"):
    """Build an ASE calculator backed by :class:`mdapy_tpu_torch.NEP` on
    ``device``."""
    Calculator, all_changes = _require_ase()

    from ..core.box import Box
    from ..core.device import resolve_device
    from ..core.system import System
    from .nep import NEP

    class _NEP4ASE(Calculator):
        implemented_properties = ["energy", "energies", "forces", "stress"]

        def __init__(self, model_filename, atoms=None, device="cuda"):
            if not os.path.exists(model_filename):
                raise FileNotFoundError(f"{model_filename} does not exist.")
            self.device = resolve_device(device, "NEP4ASE")
            self.nep = NEP(model_filename, device=self.device)
            self.rc = max(self.nep.rc_radial, self.nep.rc_angular)
            Calculator.__init__(self, atoms=atoms)

        def calculate(self, atoms=None, properties=None,
                      system_changes=all_changes):
            Calculator.calculate(self, atoms, properties, system_changes)
            atoms = self.atoms
            symbols = np.array(atoms.get_chemical_symbols(), dtype=object)
            cell = np.array(atoms.get_cell())
            pbc = atoms.get_pbc()
            for d in range(3):
                if not pbc[d]:
                    cell[d, d] += 3 * self.rc
            system = System(
                pos=np.array(atoms.get_positions()),
                box=Box(cell, [1 if p else 0 for p in pbc]),
                element_list=symbols,
                device=self.device,
            )
            system.calc = self.nep
            energies = np.asarray(system.get_energies())
            forces = np.asarray(system.get_force())
            voigt = np.asarray(system.get_stress())  # [xx yy zz yz xz xy] eV/A^3
            self.results = {
                "energy": float(energies.sum()),
                "energies": energies,
                "forces": forces,
                # ASE Voigt order is [xx, yy, zz, yz, xz, xy] too
                "stress": -voigt,
            }

    return _NEP4ASE(model_filename, atoms=atoms, device=device)
