"""Atomic temperature from neighborhood-averaged kinetic energy.

The port of ``mdapy_tpu/analysis/atomic_temperature.py``: per atom, the
mass-weighted centre-of-mass velocity of {i + neighbors}, the kinetic
energy of the velocities relative to it, T = 2 KE / (3 n kB), with the same
unit constants (velocities in A/ps, masses in g/mol).  Per-atom row sums
over the neighbor list in float64 on ``device`` (the card unless the caller
passes ``device="cpu"``), in chunks of rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .common import row_chunks

__all__ = ["AtomicTemperature"]

KB = 1.380649e-23
AVOGADRO = 6.022140857e23
MASS_FACTOR = 1.0 / AVOGADRO / 1000.0  # g/mol -> kg
VEL_CONV = 1e4  # (A/ps)^2 -> (m/s)^2


class AtomicTemperature:
    """The lists may be numpy arrays or tensors."""

    def __init__(self, amass, vel, verlet_list, neighbor_number, rc=None,
                 distance_list=None, device="cuda"):
        self.amass = np.asarray(amass, dtype=np.float64)
        self.vel = np.asarray(vel, dtype=np.float64)
        self.verlet_list = verlet_list
        self.neighbor_number = neighbor_number
        self.rc = rc
        self.distance_list = distance_list
        self.device = resolve_device(device, "AtomicTemperature")
        self.T = None

    def compute(self):
        dev = self.device
        verlet_all = torch.as_tensor(self.verlet_list, device=dev)
        dist_all = (None if self.rc is None or self.distance_list is None
                    else torch.as_tensor(self.distance_list, device=dev))
        amass = torch.as_tensor(self.amass, device=dev)
        vel = torch.as_tensor(self.vel, device=dev)
        n, M = verlet_all.shape
        T = torch.empty(n, dtype=torch.float64, device=dev)
        for s, e in row_chunks(n, M * 8 * 12):
            verlet = verlet_all[s:e]
            valid = verlet >= 0
            if dist_all is not None:
                valid = valid & (dist_all[s:e] <= self.rc)
            j = torch.where(valid, verlet, 0).long()
            mi, vi = amass[s:e], vel[s:e]
            mj = torch.where(valid, amass[j], 0.0)                   # (n, M)
            vj = torch.where(valid[..., None], vel[j], 0.0)          # (n, M, 3)
            msum = mi + mj.sum(dim=1)
            momentum = mi[:, None] * vi + (mj[..., None] * vj).sum(dim=1)
            vmean = momentum / msum[:, None]
            nn = (1 + valid.sum(dim=1)).to(torch.float64)
            dv_i = vi - vmean
            ke = 0.5 * mi * MASS_FACTOR * torch.sum(dv_i * dv_i, dim=1) * VEL_CONV
            dv_j = vj - vmean[:, None, :]
            ke_j = 0.5 * mj * MASS_FACTOR * torch.sum(dv_j * dv_j, dim=2) * VEL_CONV
            ke = ke + torch.where(valid, ke_j, 0.0).sum(dim=1)
            T[s:e] = ke * 2.0 / (3.0 * nn * KB)
        self.T = T.cpu().numpy()
        return self
