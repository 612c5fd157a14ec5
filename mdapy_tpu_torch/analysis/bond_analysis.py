"""Bond-length and bond-angle histograms.

The port of ``mdapy_tpu/analysis/bond_analysis.py`` (``_bond_hist`` :74):
lengths of the unique pairs (j > i) within rc binned by floor(r / dr);
angles of every neighbor pair (jj < kk) of each centre, theta = acos(cos)
in degrees binned by floor(theta / dtheta), nbins shared; both counted in
integers.  Rows go in chunks of ``common.CHUNK_BYTES``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.box import init_box
from ..core.device import resolve_device
from .angular_distribution_function import angle_bins
from .common import box_tensors, min_image, row_chunks

__all__ = ["BondAnalysis"]


class BondAnalysis:
    """The lists may be numpy arrays or tensors; ``device`` is "cuda"
    (default) or "cpu"."""

    def __init__(self, pos, box, rc, nbin, verlet_list, distance_list,
                 neighbor_number, device="cuda"):
        self.pos = np.ascontiguousarray(pos, dtype=np.float64)
        self.box = init_box(box)
        self.rc = float(rc)
        self.nbin = int(nbin)
        self.verlet_list = verlet_list
        self.distance_list = distance_list
        self.neighbor_number = neighbor_number
        self.device = resolve_device(device, "BondAnalysis")
        self.bond_length_distribution = None
        self.bond_angle_distribution = None

    def compute(self):
        dev = self.device
        m, inv, b = box_tensors(self.box, dev)
        ld, ad = _bond_hist(
            torch.as_tensor(self.pos, device=dev),
            torch.as_tensor(self.verlet_list, device=dev),
            torch.as_tensor(self.distance_list, dtype=torch.float64,
                            device=dev),
            m, inv, b, self.rc, self.nbin)
        self.bond_length_distribution = ld.cpu().numpy()
        self.bond_angle_distribution = ad.cpu().numpy()
        dr = self.rc / self.nbin
        dth = 180.0 / self.nbin
        self.r = (np.arange(self.nbin) + 0.5) * dr
        self.theta = (np.arange(self.nbin) + 0.5) * dth
        # reference-API names (bond_analysis.py:237 exposes r_length/r_angle)
        self.r_length = self.r
        self.r_angle = self.theta
        return self

    def plot_bond_length_distribution(self, fig=None, ax=None):
        import matplotlib.pyplot as plt

        if fig is None and ax is None:
            fig, ax = plt.subplots()
        ax.plot(self.r, self.bond_length_distribution, "o-")
        ax.set_xlabel(r"r ($\AA$)")
        ax.set_ylabel("count")
        return fig, ax

    def plot_bond_angle_distribution(self, fig=None, ax=None):
        import matplotlib.pyplot as plt

        if fig is None and ax is None:
            fig, ax = plt.subplots()
        ax.plot(self.theta, self.bond_angle_distribution, "o-")
        ax.set_xlabel(r"$\theta$ (deg)")
        ax.set_ylabel("count")
        return fig, ax


def _bond_hist(pos, verlet, dist, matrix, inv, boundary, rc: float, nbin: int):
    n, M = verlet.shape
    dr = rc / nbin
    upper_slots = torch.ones(M, M, dtype=torch.bool, device=pos.device).triu(1)
    lhist = torch.zeros(nbin + 1, dtype=torch.int64, device=pos.device)
    ahist = torch.zeros(nbin + 1, dtype=torch.int64, device=pos.device)
    for s, e in row_chunks(n, M * M * 8 * 4 + M * 3 * 8 * 4):
        vl, dl = verlet[s:e], dist[s:e]
        ok = (vl >= 0) & (dl <= rc)
        # lengths: j > i only
        rows = torch.arange(s, e, device=pos.device)[:, None]
        kbin = torch.clamp((dl / dr).to(torch.int32), max=nbin - 1)
        kbin = torch.where(ok & (vl > rows), kbin, nbin)
        lhist += torch.bincount(kbin.reshape(-1), minlength=nbin + 1)
        # angles: pairs (jj < kk) of the neighbors of each centre
        disp = min_image(pos[vl.clamp(min=0).long()] - pos[s:e, None, :],
                         matrix, inv, boundary)
        unit = disp / torch.clamp(dl, min=1e-30)[..., None]
        pair_ok = ok[:, :, None] & ok[:, None, :] & upper_slots
        tsel = torch.where(pair_ok, angle_bins(unit, nbin), nbin)
        ahist += torch.bincount(tsel.reshape(-1), minlength=nbin + 1)
    return lhist[:nbin], ahist[:nbin]
