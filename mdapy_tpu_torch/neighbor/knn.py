"""Exact k-nearest-neighbor search on the cell grid.

The port of ``mdapy_tpu/neighbor/knn.py``: ``knn_search`` (:27) and
``NearestNeighbor`` (:73); ``knn_tensors`` is ``knn_search`` with its
result left on the device, for the analyses.  The cell grid spans at least
rc along every axis, so the 27-cell stencil covers the whole ball of radius
rc around a query: once every atom has k candidates within rc, its k
nearest lie in that ball and the masked top-k is exact.  The host loop
grows rc (seeded from the density) by 1.5x until every atom has them,
usually in one pass.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.box import init_box
from ..core.device import resolve_device
from .neighbor import CellFrame, _positions, replicate_for_small_box

__all__ = ["NearestNeighbor", "knn_search", "knn_tensors"]


def knn_tensors(pos: np.ndarray, box, k: int,
                rc_initial: Optional[float] = None, device="cuda"):
    """``knn_search`` with its result left on ``device``: (indices (N, k)
    int32, distances (N, k)) tensors sorted ascending, for the analyses."""
    device = resolve_device(device, "knn_search")
    box = init_box(box)
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    n = pos.shape[0]
    if n <= k and not np.any(box.boundary):
        # without periodic images there simply aren't k other atoms
        raise ValueError(f"Need more than k={k} atoms, got {n}")
    if rc_initial is None:
        # density-seeded radius: k neighbors expected in a ball, 45 % margin
        vol = abs(box.volume)
        rc_initial = 1.45 * (3.0 * (k + 1) / (4.0 * np.pi * n / vol)) ** (1.0 / 3.0)
    rc = float(rc_initial)
    for _attempt in range(24):
        pos_c, box_c, n_images = replicate_for_small_box(pos, box, rc)
        frame = CellFrame(pos_c, box_c, rc, device)
        cells = frame.occupancy()
        M = int(cells[4])
        if 27 * M >= k:
            q = None if n_images == 1 else frame.pos[:n]
            verlet, dist, cnt, _ = frame.verlet(cells, M, k, query_pos=q)
            if int(cnt.min()) >= k:
                if n_images > 1:
                    verlet = torch.remainder(verlet, n).int()
                return verlet, dist
        rc *= 1.5
    raise RuntimeError("knn_search failed to converge radius (degenerate geometry?)")


def knn_search(pos: np.ndarray, box, k: int, rc_initial: Optional[float] = None,
               device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Returns (indices (N,k) int32, distances (N,k)) sorted ascending, as
    numpy arrays.

    Indices refer to original atoms (mod N under small-box replication)."""
    verlet, dist = knn_tensors(pos, box, k, rc_initial, device)
    return verlet.cpu().numpy(), dist.cpu().numpy()


class NearestNeighbor:
    """k-NN front end with the reference API.

    After ``compute()``: ``verlet_list`` (N,k) int32 sorted by distance,
    ``distance_list`` (N,k), ``neighbor_number`` = k for every atom.
    """

    def __init__(self, pos, box, k: int, device="cuda") -> None:
        self.pos = _positions(pos)
        self.box = init_box(box)
        self.k = int(k)
        self.device = resolve_device(device, "NearestNeighbor")
        self.verlet_list: Optional[np.ndarray] = None
        self.distance_list: Optional[np.ndarray] = None
        self.neighbor_number: Optional[np.ndarray] = None

    def compute(self) -> "NearestNeighbor":
        self.verlet_list, self.distance_list = knn_search(
            self.pos, self.box, self.k, device=self.device)
        self.neighbor_number = np.full(self.pos.shape[0], self.k, dtype=np.int32)
        return self
