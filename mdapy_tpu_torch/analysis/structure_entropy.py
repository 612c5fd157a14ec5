"""Per-atom pair-entropy fingerprint (Piaggi and Parrinello, JCP 2017).

The port of ``mdapy_tpu/analysis/structure_entropy.py`` (``_entropy``
:49): a Gaussian-smeared local g_i(r) on nbins = floor(rc / sigma) + 1
points, integrated by the reference's trapezoid, s_i = -pi rho sigma
sum[(g ln g - g + 1) r^2], with its prefactor, bin-0 fixup and low-g
branch.  The (atoms, M, nbins) Gaussians go in chunks of rows
(``common.CHUNK_BYTES``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.box import init_box
from ..core.device import resolve_device
from .common import row_chunks

__all__ = ["StructureEntropy"]


class StructureEntropy:
    """The lists may be numpy arrays or tensors; ``device`` is "cuda"
    (default) or "cpu"."""

    def __init__(self, pos, box, rc, sigma, use_local_density,
                 verlet_list, distance_list, neighbor_number, device="cuda"):
        self.pos = np.ascontiguousarray(pos, dtype=np.float64)
        self.box = init_box(box)
        self.rc = float(rc)
        self.sigma = float(sigma)
        self.use_local_density = bool(use_local_density)
        self.verlet_list = verlet_list
        self.distance_list = distance_list
        self.neighbor_number = neighbor_number
        self.device = resolve_device(device, "StructureEntropy")
        self.entropy = None

    def compute(self):
        dev = self.device
        verlet = torch.as_tensor(self.verlet_list, device=dev)
        dist = torch.as_tensor(self.distance_list, dtype=torch.float64,
                               device=dev)
        n, M = verlet.shape
        density = len(self.pos) / abs(self.box.volume)
        nbins = int(np.floor(self.rc / self.sigma)) + 1
        out = torch.empty(n, dtype=torch.float64, device=dev)
        for s, e in row_chunks(n, M * nbins * 8 * 4):
            out[s:e] = _entropy(verlet[s:e], dist[s:e], self.rc, self.sigma,
                                density, self.use_local_density)
        self.entropy = out.cpu().numpy()
        return self


def _entropy(verlet, dist, rc: float, sigma: float, global_density: float,
             use_local_density: bool):
    nbins = int(np.floor(rc / sigma)) + 1
    step = rc / (nbins - 1)
    rlist = torch.arange(nbins, dtype=dist.dtype, device=dist.device) * step
    rsq = rlist * rlist
    factor = (4.0 * math.pi * global_density
              * math.sqrt(2.0 * math.pi * sigma * sigma))
    prefactor = rsq * factor
    prefactor[0] = prefactor[1]

    ok = (verlet >= 0) & (dist <= rc)                   # (n, M)
    dmask = torch.where(ok, dist, 2.0 * rc + 10.0)
    delta = rlist[None, None, :] - dmask[..., None]     # (n, M, nbins)
    gauss = torch.exp(-(delta * delta) / (2.0 * sigma * sigma))
    gauss = torch.where(ok[..., None], gauss, 0.0)
    g = torch.sum(gauss, dim=1) / prefactor[None, :]    # (n, nbins)

    if use_local_density:
        density = torch.sum(ok, dim=1).double() / (4.0 / 3.0 * math.pi * rc**3)
        g = g * (global_density / torch.clamp(density, min=1e-30))[:, None]
        dens = density
    else:
        dens = torch.full((verlet.shape[0],), global_density,
                          dtype=dist.dtype, device=dist.device)

    integrand = torch.where(
        g >= 1e-10,
        (g * torch.log(torch.clamp(g, min=1e-30)) - g + 1.0) * rsq[None, :],
        rsq[None, :])
    # the reference's trapezoid: (f_j + f_j+1) without the 1/2, folded into
    # its -pi rho sigma prefactor
    s = torch.sum(integrand[:, :-1] + integrand[:, 1:], dim=1)
    return -math.pi * dens * s * sigma
