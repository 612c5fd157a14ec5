"""Wigner-Seitz defect analysis: the occupancy of reference-lattice sites.

The port of ``mdapy_tpu/analysis/wigner_seitz_defect.py``: each atom of the
current configuration goes to its nearest reference site (``nearest_site``
:55, a cell-grid query of the current atoms against the sites, the same
machinery as the neighbor engine with a query set other than the candidate
set, its radius grown by 1.6x until every atom finds a site); per-site
occupancy 0 is a vacancy, more than 1 an interstitial, counted in
integers by ``torch.bincount``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..neighbor.neighbor import CellFrame, replicate_for_small_box

__all__ = ["WignerSeitzAnalysis", "nearest_site"]


class WignerSeitzAnalysis:
    """``ref`` is a system object (``pos``, ``box``) or a (pos, box) pair;
    ``device`` is "cuda" (default) or "cpu"."""

    def __init__(self, ref, affine: bool = False, device="cuda"):
        if hasattr(ref, "pos"):
            self.ref_pos = ref.pos
            self.ref_box = ref.box
        else:
            self.ref_pos, self.ref_box = ref
        self.ref_pos = np.ascontiguousarray(self.ref_pos, dtype=np.float64)
        self.affine = bool(affine)
        self.device = resolve_device(device, "WignerSeitzAnalysis")
        self.occupancy = None
        self.vacancy_number = 0
        self.interstitial_number = 0

    def compute(self, current):
        if hasattr(current, "pos"):
            cur_pos = current.pos
            cur_box = current.box
        else:
            cur_pos, cur_box = current
        cur_pos = np.ascontiguousarray(cur_pos, dtype=np.float64)
        if self.affine:
            map_matrix = np.linalg.solve(cur_box.matrix, self.ref_box.matrix)
            cur_pos = cur_pos @ map_matrix
        site = nearest_site(cur_pos, self.ref_pos, self.ref_box, self.device)
        occ = torch.bincount(site, minlength=len(self.ref_pos)).int()
        self.occupancy = occ.cpu().numpy()
        self.vacancy_number = int((occ == 0).sum())
        self.interstitial_number = int(torch.clamp(occ - 1, min=0).sum())
        if hasattr(current, "data"):
            current.data["site_index"] = site.int().cpu().numpy()
        return self


def nearest_site(query: np.ndarray, sites: np.ndarray, box, device):
    """Index (int64 tensor on ``device``) of the nearest reference site of
    each query point, periodic images included."""
    nsite = len(sites)
    # seed radius: twice the typical site spacing
    rc = 2.0 * (abs(box.volume) / nsite) ** (1.0 / 3.0)
    for _ in range(20):
        sites_c, box_c, _ = replicate_for_small_box(sites, box, rc)
        frame = CellFrame(sites_c, box_c, rc, device)
        cells = frame.occupancy()
        # the queries wrapped into the replicated cell before the stencil
        q = torch.as_tensor(query, device=frame.pos.device)
        frac = (q - frame.origin) @ frame.inv
        frac = frac - torch.floor(frac) * frame.boundary
        q = frac @ frame.matrix + frame.origin
        verlet, _, cnt, _ = frame.verlet(cells, int(cells[4]), 1,
                                         exclude_self=False, query_pos=q)
        if int(cnt.min()) >= 1:
            return torch.remainder(verlet[:, 0].long(), nsite)
        rc *= 1.6
    raise RuntimeError("nearest_site failed to find sites for all atoms")
