"""CHILL+ ice and water structure identification.

The port of ``mdapy_tpu/analysis/chill_plus.py``: q_3m of each atom over
its neighbors within rc (``_ylm_block(3, ...)`` :47), the bond correlation
c_ij = Re(q3_i . conj(q3_j)) / (|q3_i| |q3_j|), eclipsed bonds at -0.35 < c
< 0.25 and staggered ones at c < -0.8, and the priority chain of :67-74 for
4-coordinated atoms: 0 = Other, 1 = HexIce, 2 = CubicIce, 3 =
InterfacialIce, 4 = Hydrate, 5 = InterfacialHydrate.  The JAX package
classifies on the host; here it all runs on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.box import init_box
from ..core.device import resolve_device
from ..neighbor.neighbor import neighbor_tensors
from .common import box_tensors, min_image
from .steinhardt_bond_orientation import _ylm_block, bond_angles

__all__ = ["ChillPlus"]


class ChillPlus:
    """``device`` is "cuda" (default) or "cpu"."""

    def __init__(self, pos, box, rc: float = 3.5, max_neigh=None,
                 device="cuda"):
        self.pos = np.ascontiguousarray(pos, dtype=np.float64)
        self.box = init_box(box)
        self.rc = float(rc)
        self.max_neigh = max_neigh
        self.device = resolve_device(device, "ChillPlus")
        self.chill_plus = None

    def compute(self):
        dev = self.device
        verlet, dist, _ = neighbor_tensors(self.pos, self.box, self.rc,
                                           self.max_neigh, device=dev)
        m, inv, b = box_tensors(self.box, dev)
        pos = torch.as_tensor(self.pos, device=dev)
        j = verlet.clamp(min=0).long()
        ok = (verlet >= 0) & (dist <= self.rc)
        disp = min_image(pos[j] - pos[:, None, :], m, inv, b)
        rmag = torch.clamp(torch.sqrt(torch.sum(disp * disp, dim=-1)),
                           min=1e-30)
        yr, yi = _ylm_block(3, *bond_angles(disp, rmag))    # (n, M, 7)
        qr = torch.sum(torch.where(ok[..., None], yr, 0.0), dim=1)
        qi = torch.sum(torch.where(ok[..., None], yi, 0.0), dim=1)
        jn = torch.where(ok, verlet, 0).long()
        qnorm = torch.sqrt((qr**2 + qi**2).sum(dim=1))
        num = (torch.einsum("im,ikm->ik", qr, qr[jn])
               + torch.einsum("im,ikm->ik", qi, qi[jn]))
        c = num / (qnorm[:, None] * qnorm[jn])
        c = torch.where(torch.isfinite(c), c, 0.0)
        ne = (ok & (c > -0.35) & (c < 0.25)).sum(dim=1)
        ns = (ok & (c < -0.8)).sum(dim=1)
        # the if/elif chain of chill_plus.cpp:93-103, in priority order
        code = torch.where(
            ne == 4, 4, torch.where(
                ne == 3, 5, torch.where(
                    ns == 4, 2, torch.where(
                        (ns == 3) & (ne == 1), 1, torch.where(
                            ((ns == 3) & (ne == 0)) | (ns == 2), 3, 0)))))
        code = torch.where(ok.sum(dim=1) == 4, code, 0)
        self.chill_plus = code.int().cpu().numpy()
        return self
