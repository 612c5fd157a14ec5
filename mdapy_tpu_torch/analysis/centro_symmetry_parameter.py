"""Centro-symmetry parameter (Kelchner et al.).

The port of ``mdapy_tpu/analysis/centro_symmetry_parameter.py``:
``csp_from_neighbors`` (:24) and ``CentroSymmetryParameter`` (:40).  For
each atom, its N nearest neighbors, the N(N-1)/2 pair sums r_ij + r_ik, and
the sum of the N/2 smallest squared norms; ``torch.topk(largest=False,
sorted=True)`` gives them in the ascending order ``lax.top_k(-vals)`` does.
Rows go in chunks, so the pair sums (N(N-1)/2 x 3 float64 a row) stay near
``common.CHUNK_BYTES``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.box import init_box
from ..core.device import resolve_device
from ..neighbor.knn import knn_tensors
from .common import box_tensors, min_image, row_chunks

__all__ = ["CentroSymmetryParameter", "csp_from_neighbors"]


def csp_from_neighbors(pos, verlet, matrix, inv, boundary, N: int):
    """csp (n,) from the first N columns of a kNN verlet list (tensors)."""
    n = pos.shape[0]
    iu, ju = torch.triu_indices(N, N, 1, device=pos.device)
    out = torch.empty(n, dtype=pos.dtype, device=pos.device)
    for s, e in row_chunks(n, len(iu) * 3 * 8 * 4 + N * 3 * 8 * 3):
        j = verlet[s:e, :N].clamp(min=0).long()
        disp = min_image(pos[j] - pos[s:e, None, :], matrix, inv, boundary)
        pair = disp[:, iu] + disp[:, ju]                     # (c, P, 3)
        vals = torch.sum(pair * pair, dim=-1)
        low = torch.topk(vals, N // 2, dim=1, largest=False, sorted=True)[0]
        out[s:e] = low.sum(dim=1)
    return out


class CentroSymmetryParameter:
    """API parity: reference centro_symmetry_parameter.py; ``device`` is
    "cuda" (default) or "cpu"."""

    def __init__(self, pos, box, N: int = 12, device="cuda"):
        if N % 2 != 0 or N <= 0:
            raise ValueError("N must be a positive even number")
        self.pos = np.ascontiguousarray(pos, dtype=np.float64)
        self.box = init_box(box)
        self.N = int(N)
        self.device = resolve_device(device, "CentroSymmetryParameter")
        self.csp = None

    def compute(self):
        verlet, _ = knn_tensors(self.pos, self.box, self.N, device=self.device)
        pos = torch.as_tensor(self.pos, device=self.device)
        m, inv, b = box_tensors(self.box, self.device)
        self.csp = csp_from_neighbors(pos, verlet, m, inv, b,
                                      self.N).cpu().numpy()
        return self
