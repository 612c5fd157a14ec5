"""Common neighbor parameter (Tsuzuki, Branicio and Rino).

The port of ``mdapy_tpu/analysis/common_neighbor_parameter.py``
(``cnp_from_neighbors`` :24, ``_cnp_chunk`` :83): cnp_i = (1/N_i) sum_{j in nb(i)} |sum_{k in cn(i,j)}
(r_ik + r_jk)|^2 over the neighbors within rc, 1000.0 for an atom without
one.  The (atoms, M, M, M) membership test goes in chunks of
``common.CHUNK_BYTES``; the sums are row sums.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.box import init_box
from ..core.device import resolve_device
from .common import box_tensors, min_image, row_chunks

__all__ = ["CommonNeighborParameter", "cnp_from_neighbors"]


class CommonNeighborParameter:
    """API parity: reference common_neighbor_parameter.py.  The lists may be
    numpy arrays or tensors; ``device`` is "cuda" (default) or "cpu"."""

    def __init__(self, pos, box, rc, verlet_list, distance_list,
                 neighbor_number, device="cuda"):
        self.pos = np.ascontiguousarray(pos, dtype=np.float64)
        self.box = init_box(box)
        self.rc = float(rc)
        self.verlet_list = verlet_list
        self.distance_list = distance_list
        self.neighbor_number = neighbor_number
        self.device = resolve_device(device, "CommonNeighborParameter")
        self.cnp = None

    def compute(self):
        dev = self.device
        m, inv, b = box_tensors(self.box, dev)
        self.cnp = cnp_from_neighbors(
            self.pos, self.verlet_list, self.distance_list, m, inv, b,
            self.rc, device=dev).cpu().numpy()
        return self


def cnp_from_neighbors(pos, verlet, dist, matrix, inv, boundary, rc,
                       device=None):
    """cnp of every atom from its neighbor list, as a tensor: the JAX
    package's function of the same name, over ``_cnp_chunk`` in chunks of
    rows.  The arguments may be tensors or arrays; it runs on ``device``,
    by default the device of ``pos`` when it is a tensor, else the card."""
    if device is None:
        device = pos.device if torch.is_tensor(pos) else "cuda"
    dev = resolve_device(device, "cnp_from_neighbors")

    pos, dist, matrix, inv, boundary = (
        torch.as_tensor(a, dtype=torch.float64, device=dev)
        for a in (pos, dist, matrix, inv, boundary))
    verlet = torch.as_tensor(verlet, device=dev)
    n, M = verlet.shape
    out = torch.empty(n, dtype=torch.float64, device=dev)
    for s, e in row_chunks(n, 3 * M**3 + M * M * 3 * 8 * 6):
        out[s:e] = _cnp_chunk(pos, verlet, dist, matrix, inv, boundary,
                              float(rc), s, e)
    return out


def _cnp_chunk(pos, verlet, dist, matrix, inv, boundary, rc: float,
               start: int, stop: int):
    vl, dl, posn = verlet[start:stop], dist[start:stop], pos[start:stop]
    ok = (vl >= 0) & (dl <= rc)
    j = vl.clamp(min=0).long()
    vj = verlet[j]                                         # (c, M, M)
    okj = (vj >= 0) & (dist[j] <= rc)
    # w[., a, s]: slot s of neighbor a is a listed neighbor of i as well
    same = vl[:, None, :, None] == vj[:, :, None, :]
    w = torch.any(ok[:, None, :, None] & okj[:, :, None, :] & same, dim=2)
    k = vj.clamp(min=0).long()
    r_ik = min_image(posn[:, None, None, :] - pos[k], matrix, inv, boundary)
    r_jk = min_image(pos[j][:, :, None, :] - pos[k], matrix, inv, boundary)
    R = torch.sum(torch.where(w[..., None], r_ik + r_jk, 0.0), dim=2)
    r2 = torch.sum(R * R, dim=-1)
    cnt = torch.sum(ok, dim=1)
    cnp = (torch.sum(torch.where(ok, r2, 0.0), dim=1)
           / torch.clamp(cnt, min=1).double())
    return torch.where(cnt > 0, cnp, 1000.0)
