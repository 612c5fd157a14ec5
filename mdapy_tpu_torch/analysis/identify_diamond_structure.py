"""Identify cubic and hexagonal diamond.

The port of ``mdapy_tpu/analysis/identify_diamond_structure.py``
(``_ids_core`` :59 and the label passes :39-53): a 12-neighbor list from
the 3 non-self neighbors of each of the 4 nearest neighbors (a stable
argsort, the reference's slot order), the fcc/hcp CNA signature on it with
cutoff 1.2071068 x its mean distance, then the 1st- and 2nd-neighbor label
passes: 0 = Other, 1 = CubicDiamond, 2/3 = its 1st/2nd neighbors, 4 =
HexDiamond, 5/6 = its 1st/2nd neighbors.  The JAX package runs the passes
as host loops; each pass marks, at once, every unlabelled neighbor of the
atoms its source label held when it began, which is what the loops do.
The signatures go in chunks of atoms (``common.CHUNK_BYTES``); results are
per row, so chunking cannot change them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.box import init_box
from ..core.device import resolve_device
from ..neighbor.knn import knn_tensors
from .cna_core import bond_matrix, cna_signatures
from .common import box_tensors, min_image, row_chunks
from .common_neighbor_analysis import signature_bytes

__all__ = ["IdentifyDiamondStructure"]


class IdentifyDiamondStructure:
    """``device`` is "cuda" (default) or "cpu"."""

    def __init__(self, pos, box, device="cuda"):
        self.pos = np.ascontiguousarray(pos, dtype=np.float64)
        self.box = init_box(box)
        self.device = resolve_device(device, "IdentifyDiamondStructure")
        self.ids = None

    def compute(self):
        dev = self.device
        n = len(self.pos)
        verlet, _ = knn_tensors(self.pos, self.box, 4, device=dev)
        m, inv, b = box_tensors(self.box, dev)
        pos = torch.as_tensor(self.pos, device=dev)
        pattern = torch.empty(n, dtype=torch.int32, device=dev)
        for s, e in row_chunks(n, signature_bytes(12)):
            pattern[s:e] = _ids_core(pos, verlet, s, e, m, inv, b)
        first = verlet[:, :4].long()
        for src, dst in ((1, 2), (4, 5), (2, 3), (5, 6)):
            near = torch.zeros(n, dtype=torch.bool, device=dev)
            near[first[pattern == src].reshape(-1)] = True
            pattern = torch.where(near & (pattern == 0), dst, pattern)
        self.ids = pattern.int().cpu().numpy()
        return self


def _ids_core(pos, verlet, start: int, stop: int, matrix, inv, boundary):
    first = verlet[start:stop, :4].long()                  # (c, 4)
    nb_of_nb = verlet[first][:, :, :4]                     # (c, 4, 4)
    self_idx = torch.arange(start, stop, device=pos.device)[:, None, None]
    not_self = nb_of_nb != self_idx
    order = torch.argsort((~not_self).to(torch.uint8), dim=2, stable=True)
    picked = torch.take_along_dim(nb_of_nb, order[:, :, :3], dim=2)
    new_verlet = picked.reshape(-1, 12)

    disp = min_image(pos[new_verlet.long()] - pos[start:stop, None, :],
                     matrix, inv, boundary)
    d = torch.sqrt(torch.sum(disp * disp, dim=-1))
    rc = torch.mean(d, dim=1) * 1.2071068
    ncn, nb, mc = cna_signatures(
        bond_matrix(pos, new_verlet, 12, matrix, inv, boundary, rc**2), 12)
    n421 = ((ncn == 4) & (nb == 2) & (mc == 1)).sum(dim=1)
    n422 = ((ncn == 4) & (nb == 2) & (mc == 2)).sum(dim=1)
    return torch.where(n421 == 12, 1,
                       torch.where((n421 == 6) & (n422 == 6), 4, 0)).int()
