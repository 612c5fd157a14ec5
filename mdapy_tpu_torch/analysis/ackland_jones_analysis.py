"""Ackland-Jones bond-angle analysis (0 = Other, 1 = FCC, 2 = HCP, 3 = BCC,
4 = ICO).

The port of ``mdapy_tpu/analysis/ackland_jones_analysis.py`` (``_aja``
:40): the chi histogram over the 8 canonical cos(theta) intervals for the
pairs of the N0 nearest of each atom's 14 nearest neighbors (N0 and N1 from
the 1.45 and 1.55 x <r^2 of the 6 nearest> shells), counted per atom in
integers by ``torch.bincount``, then the published decision tree.  Rows go
in chunks of ``common.CHUNK_BYTES``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.box import init_box
from ..core.device import resolve_device
from ..neighbor.knn import knn_tensors
from .common import box_tensors, min_image, row_chunks

__all__ = ["AcklandJonesAnalysis"]

_EDGES = (-0.945, -0.915, -0.755, -0.195, 0.195, 0.245, 0.795)


class AcklandJonesAnalysis:
    """``device`` is "cuda" (default) or "cpu"."""

    def __init__(self, pos, box, device="cuda"):
        self.pos = np.ascontiguousarray(pos, dtype=np.float64)
        self.box = init_box(box)
        self.device = resolve_device(device, "AcklandJonesAnalysis")
        self.aja = None

    def compute(self):
        dev = self.device
        n = len(self.pos)
        verlet, dist = knn_tensors(self.pos, self.box, 14, device=dev)
        m, inv, b = box_tensors(self.box, dev)
        pos = torch.as_tensor(self.pos, device=dev)
        out = torch.empty(n, dtype=torch.int32, device=dev)
        for s, e in row_chunks(n, 14 * 14 * (8 + 8 + 8) + 14 * 3 * 8 * 4):
            out[s:e] = _aja(pos, s, verlet[s:e], dist[s:e], m, inv, b)
        self.aja = out.cpu().numpy()
        return self


def _aja(pos, start: int, verlet, dist, matrix, inv, boundary):
    n = verlet.shape[0]
    d2 = dist * dist                                     # (n, 14)
    r0_sq = torch.mean(d2[:, :6], dim=1)
    N1 = torch.sum(d2 < (1.55 * r0_sq)[:, None], dim=1)
    N0 = torch.sum(d2 < (1.45 * r0_sq)[:, None], dim=1)

    disp = min_image(pos[verlet.clamp(min=0).long()]
                     - pos[start:start + n, None, :], matrix, inv, boundary)
    unit = disp / torch.clamp(dist, min=1e-30)[..., None]
    cosang = torch.einsum("imx,inx->imn", unit, unit)   # (n, 14, 14)
    mm = torch.arange(14, device=pos.device)
    pair_ok = ((mm[None, :, None] < mm[None, None, :])
               & (mm[None, :, None] < N0[:, None, None])
               & (mm[None, None, :] < N0[:, None, None]))
    edges = torch.tensor(_EDGES, dtype=cosang.dtype, device=pos.device)
    bin_idx = torch.sum(cosang[..., None] >= edges, dim=-1)   # 0..7
    # per-atom counts of the 8 bins in integers; slot 8 takes the other pairs
    flat = torch.where(pair_ok, bin_idx, 8) + 9 * torch.arange(
        n, device=pos.device)[:, None, None]
    alpha = torch.bincount(flat.reshape(-1), minlength=9 * n).view(n, 9)
    alpha = alpha[:, :8].double()

    sigma_cp = torch.abs(1.0 - alpha[:, 6] / 24.0)
    s56m4 = alpha[:, 5] + alpha[:, 6] - alpha[:, 4]
    sigma_bcc = torch.where(s56m4 != 0, 0.35 * alpha[:, 4] / s56m4,
                            sigma_cp + 1.0)
    sigma_fcc = 0.61 * (torch.abs(alpha[:, 0] + alpha[:, 1] - 6)
                        + alpha[:, 2]) / 6.0
    sigma_hcp = (torch.abs(alpha[:, 0] - 3.0)
                 + torch.abs(alpha[:, 0] + alpha[:, 1] + alpha[:, 2]
                             + alpha[:, 3] - 9)) / 12.0
    sigma_bcc = torch.where(alpha[:, 0] == 7, 0.0, sigma_bcc)
    sigma_fcc = torch.where(alpha[:, 0] == 6, 0.0, sigma_fcc)
    sigma_hcp = torch.where(alpha[:, 0] <= 3, 0.0, sigma_hcp)

    out = torch.where(sigma_fcc < sigma_hcp, 1, 2)
    out = torch.where((N1 > 12) | (N1 < 11), 0, out)
    out = torch.where(sigma_bcc <= sigma_cp, torch.where(N1 < 11, 0, 3), out)
    out = torch.where(alpha[:, 4] < 3,
                      torch.where((N1 > 13) | (N1 < 11), 0, 4), out)
    out = torch.where(alpha[:, 7] > 0, 0, out)
    return out.int()
