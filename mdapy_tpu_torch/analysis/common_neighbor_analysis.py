"""Adaptive and fixed-cutoff common neighbor analysis.

The port of ``mdapy_tpu/analysis/common_neighbor_analysis.py``: labels
0 = Other, 1 = FCC, 2 = HCP, 3 = BCC, 4 = ICO.  Adaptive mode
(``_acna_chunk`` :78) over the 14 nearest neighbors: a per-atom cutoff
(1 + sqrt 2) / 2 x the mean of the 12 nearest distances for the fcc, hcp
and ico signatures, then the 14-neighbor bcc test with the first 8
distances weighted by sqrt(4/3).  Fixed mode (``_fcna_chunk`` :112) over
the neighbors within rc, at least 14 columns.  Atoms go in chunks (the
signatures hold (atoms, M, M, M) tensors): ``common.CHUNK_BYTES`` of them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.box import init_box
from ..core.device import resolve_device
from ..neighbor.knn import knn_tensors
from ..neighbor.neighbor import neighbor_tensors
from .cna_core import bond_matrix, cna_signatures
from .common import box_tensors, min_image, row_chunks

__all__ = ["CommonNeighborAnalysis"]

OTHER, FCC, HCP, BCC, ICO = 0, 1, 2, 3, 4


def signature_bytes(M: int) -> int:
    """Bytes a row of ``cna_signatures`` over M neighbors holds at once."""
    return 3 * M**3 + M * M * 3 * 8 * 4


class CommonNeighborAnalysis:
    """``rc=None`` is the adaptive mode; ``device`` is "cuda" (default) or
    "cpu"."""

    def __init__(self, pos, box, rc=None, device="cuda"):
        self.pos = np.ascontiguousarray(pos, dtype=np.float64)
        self.box = init_box(box)
        self.rc = rc
        self.device = resolve_device(device, "CommonNeighborAnalysis")
        self.cna = None

    def compute(self):
        n = len(self.pos)
        dev = self.device
        m, inv, b = box_tensors(self.box, dev)
        pos = torch.as_tensor(self.pos, device=dev)
        out = torch.empty(n, dtype=torch.int32, device=dev)
        if self.rc is None:
            verlet, _ = knn_tensors(self.pos, self.box, 14, device=dev)
            for s, e in row_chunks(n, signature_bytes(14)):
                out[s:e] = _acna_chunk(pos, verlet[s:e], s, m, inv, b)
        else:
            verlet, _, nn = neighbor_tensors(self.pos, self.box,
                                             float(self.rc), device=dev)
            # slots past the largest count are empty in every row: drop
            # them, then pad to at least 14 columns
            M = max(14, int(nn.max()))
            vl = torch.full((n, M), -1, dtype=torch.int32, device=dev)
            w = min(M, verlet.shape[1])
            vl[:, :w] = verlet[:, :w]
            rc_sq = float(self.rc) ** 2
            for s, e in row_chunks(n, signature_bytes(M)):
                out[s:e] = _fcna_chunk(pos, vl[s:e], nn[s:e], m, inv, b, rc_sq)
        self.cna = out.cpu().numpy()
        return self


def _acna_chunk(pos, vl, start: int, matrix, inv, boundary):
    posn = pos[start:start + vl.shape[0]]
    disp = min_image(pos[vl[:, :14].clamp(min=0).long()] - posn[:, None, :],
                     matrix, inv, boundary)
    d = torch.sqrt(torch.sum(disp * disp, dim=-1))

    # fcc / hcp / ico: 12 neighbors
    rc12 = torch.mean(d[:, :12], dim=1) * (1.0 + math.sqrt(2.0)) * 0.5
    ncn, nb, mc = cna_signatures(
        bond_matrix(pos, vl, 12, matrix, inv, boundary, rc12**2), 12)
    n421 = ((ncn == 4) & (nb == 2) & (mc == 1)).sum(dim=1)
    n422 = ((ncn == 4) & (nb == 2) & (mc == 2)).sum(dim=1)
    n555 = ((ncn == 5) & (nb == 5) & (mc == 5)).sum(dim=1)
    pattern = torch.where(
        n421 == 12, FCC,
        torch.where((n421 == 6) & (n422 == 6), HCP,
                    torch.where(n555 == 12, ICO, OTHER)))

    # bcc: 14 neighbors, the first 8 distances scaled by sqrt(4/3)
    w = torch.cat([torch.full((8,), math.sqrt(4.0 / 3.0), dtype=d.dtype,
                              device=d.device),
                   torch.ones(6, dtype=d.dtype, device=d.device)])
    rc14 = torch.sum(d * w, dim=1) / 14.0 * (1.0 + math.sqrt(2.0)) * 0.5
    ncn, nb, mc = cna_signatures(
        bond_matrix(pos, vl, 14, matrix, inv, boundary, rc14**2), 14)
    is_bcc = ((((ncn == 6) & (nb == 6) & (mc == 6)).sum(dim=1) == 8)
              & (((ncn == 4) & (nb == 4) & (mc == 4)).sum(dim=1) == 6))
    return torch.where((pattern == OTHER) & is_bcc, BCC, pattern).int()


def _fcna_chunk(pos, vl, nnc, matrix, inv, boundary, rc_sq: float):
    M = vl.shape[1]
    ok = torch.arange(M, device=vl.device)[None, :] < nnc[:, None]
    bonded = bond_matrix(pos, vl, M, matrix, inv, boundary, rc_sq)
    bonded = bonded & ok[:, :, None] & ok[:, None, :]
    ncn, nb, mc = cna_signatures(bonded, M)

    def count(c, b, m):
        return (ok & (ncn == c) & (nb == b) & (mc == m)).sum(dim=1)

    n421, n422, n555 = count(4, 2, 1), count(4, 2, 2), count(5, 5, 5)
    n444, n666 = count(4, 4, 4), count(6, 6, 6)
    usable = (nnc == 12) | (nnc == 14)
    pattern = torch.where(
        n421 == 12, FCC,
        torch.where(
            (n421 == 6) & (n422 == 6), HCP,
            torch.where(n555 == 12, ICO,
                        torch.where((n666 == 8) & (n444 == 6), BCC, OTHER))))
    return torch.where(usable, pattern, OTHER).int()
