"""Fixed-radius neighbor search front end.

The port of ``mdapy_tpu/neighbor/neighbor.py``: ``replicate_for_small_box``
(:26), ``neighbor_search`` (:53), ``neighbor_search_device`` (:143) and
``Neighbor`` (:275); ``neighbor_tensors`` is ``neighbor_search`` with its
result left on the device, for the analyses.  Fixed-capacity Verlet lists
with a hard overflow ValueError when the user passes ``max_neigh`` too
small, an auto-sizing path (a density estimate, re-run once at the true
count when a row overflows), and small-box replication so that the minimum
image holds.  Rows are sorted by distance (ascending); -1 pads empty slots.

Not ported (TPU and jit-cache machinery): the capacity high-water cache and
the bucketing of capacities to multiples of 4 and 8 (:80-104), which exist
to hit the jit cache, and ``defer_check`` with ``copy_to_host_async``
(:148, :227-235).  Eager torch sizes each call exactly: the cell capacity
``M`` is the largest occupancy, fetched once (the gather's shape needs it on
the host), and the neighbor count is fetched once after the build.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.box import Box, init_box
from ..core.device import resolve_device
from . import cell_list as cl

__all__ = ["Neighbor", "neighbor_search", "neighbor_search_device",
           "neighbor_tensors", "replicate_for_small_box"]


def replicate_for_small_box(
    pos: np.ndarray, box: Box, rc: float
) -> Tuple[np.ndarray, Box, int]:
    """Tile the system so every periodic thickness >= 2*rc.

    Image 0 is the original atom set, so replica atom ``j`` maps to original
    atom ``j % N``.  Returns (pos_rep, box_rep, n_images)."""
    box = init_box(box)
    repeat = box.check_small_box(rc)
    n_images = int(np.prod(repeat))
    if n_images == 1:
        return pos, box, 1
    shifts = []
    for ix in range(repeat[0]):
        for iy in range(repeat[1]):
            for iz in range(repeat[2]):
                shifts.append(
                    ix * box.matrix[0] + iy * box.matrix[1] + iz * box.matrix[2]
                )
    order = np.argsort([np.linalg.norm(s) for s in shifts], kind="stable")
    shifts = np.array(shifts)[order]
    assert np.allclose(shifts[0], 0.0)
    pos_rep = (pos[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    box_rep = Box(box.matrix * repeat[:, None].astype(np.float64), box.boundary, box.origin)
    return pos_rep, box_rep, n_images


class CellFrame:
    """A (possibly replicated) atom set on its device with its cell: the
    inputs every builder of ``cell_list`` takes."""

    def __init__(self, pos: np.ndarray, box: Box, rc: float, device,
                 dtype=torch.float64):
        self.box = box
        self.rc = float(rc)
        self.pos = torch.as_tensor(pos, dtype=dtype, device=device)
        self.matrix = torch.tensor(box.matrix, dtype=dtype, device=device)
        self.inv = torch.tensor(box.inverse_box, dtype=dtype, device=device)
        self.origin = torch.tensor(box.origin, dtype=dtype, device=device)
        self.boundary = torch.tensor(box.boundary, dtype=torch.int64,
                                     device=device)
        self.ncells = cl.cell_grid_shape(box.matrix, rc)

    def occupancy(self):
        """(order, sorted cell ids, cell starts, cell counts, largest count)."""
        return cl.cell_occupancy(self.pos, self.inv, self.origin,
                                 self.boundary, self.ncells)

    def verlet(self, cells, M: int, cap: int, exclude_self: bool = True,
               query_pos=None):
        """``cl.neighbor_list_fixed`` over this frame's cell list."""
        order, _, start, count, _ = cells
        return cl.neighbor_list_fixed(
            self.pos, self.matrix, self.inv, self.origin, self.boundary,
            self.rc, self.ncells, order, start, count, M, cap,
            exclude_self=exclude_self, query_pos=query_pos)

    def capacity_estimate(self, M: int) -> int:
        """Neighbors expected within rc at the mean density, with a 20 %
        margin, at most 27 * M."""
        density = self.pos.shape[0] / abs(self.box.volume)
        est = int(np.ceil(density * 4.0 / 3.0 * np.pi * self.rc**3 * 1.2)) + 8
        return max(1, min(est, 27 * M))


def _build(frame: CellFrame, n_query: int, max_neigh: Optional[int],
           exclude_self: bool = True):
    """Verlet list of the first ``n_query`` atoms of ``frame``: (verlet,
    dist, cnt) tensors, re-run once at the true capacity when a row
    overflows the estimate.  A user ``max_neigh`` that is too small raises
    (the reference's guarded-write contract)."""
    cells = frame.occupancy()
    M = int(cells[4])
    if max_neigh is None:
        cap = frame.capacity_estimate(M)
    else:
        cap = max(1, min(int(max_neigh), 27 * M))
    q = None if n_query == frame.pos.shape[0] else frame.pos[:n_query]
    verlet, dist, cnt, max_cnt = frame.verlet(cells, M, cap, exclude_self, q)
    max_cnt = int(max_cnt)
    if max_neigh is not None and max_cnt > max_neigh:
        raise ValueError(
            f"max_neigh={max_neigh} is too small: an atom has {max_cnt} "
            f"neighbors within rc={frame.rc}. Increase max_neigh."
        )
    if max_cnt > cap:
        verlet, dist, cnt, _ = frame.verlet(cells, M, max_cnt, exclude_self, q)
    return verlet, dist, cnt


def neighbor_tensors(pos: np.ndarray, box, rc: float,
                     max_neigh: Optional[int] = None, exclude_self: bool = True,
                     device="cuda"):
    """``neighbor_search`` with its result left on ``device``: (verlet (N,
    cap) int32 padded with -1, dist (N, cap), cnt (N,) int32) tensors, the
    indices those of the original atoms.  The analyses build their lists
    here, so a list made on the card stays there."""
    device = resolve_device(device, "neighbor_search")
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    n = pos.shape[0]
    if n == 0:
        raise ValueError("Empty position array")
    pos_c, box_c, n_images = replicate_for_small_box(pos, init_box(box), rc)
    frame = CellFrame(pos_c, box_c, rc, device)
    verlet, dist, cnt = _build(frame, n, max_neigh, exclude_self)
    if n_images > 1:
        verlet = torch.where(verlet >= 0, torch.remainder(verlet, n), -1).int()
    return verlet, dist, cnt


def neighbor_search(
    pos: np.ndarray,
    box,
    rc: float,
    max_neigh: Optional[int] = None,
    exclude_self: bool = True,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compute (verlet_list, distance_list, neighbor_number) for one frame,
    as numpy arrays.

    Handles small-box replication: returned indices are taken modulo N so
    they always refer to original atoms.  Raises ValueError on user-capacity
    overflow."""
    verlet, dist, cnt = neighbor_tensors(pos, box, rc, max_neigh,
                                         exclude_self, device)
    return verlet.cpu().numpy(), dist.cpu().numpy(), cnt.cpu().numpy()


def neighbor_search_device(pos: np.ndarray, box, rc: float, dtype=None,
                           device="cuda"):
    """Device-resident neighbor build for the potentials: the Verlet list
    stays on the device.

    Returns (pos (ntotal, 3), verlet (ntotal, max_neigh) int32 padded with
    -1 in original atom order, cnt (ntotal,) int32, n_images), tensors on
    ``device``.  Indices refer to the (possibly replicated) atom set, image
    0 first.  ``dtype`` is the positions' type (default float64)."""
    device = resolve_device(device, "neighbor_search_device")
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    pos_c, box_c, n_images = replicate_for_small_box(pos, init_box(box), rc)
    frame = CellFrame(pos_c, box_c, rc, device,
                      torch.float64 if dtype is None else dtype)
    verlet, _, cnt = _build(frame, pos_c.shape[0], None)
    return frame.pos, verlet, cnt, n_images


class Neighbor:
    """Class front end with the reference API.

    Parameters
    ----------
    pos : (N,3) array, or a frame with x/y/z columns
    box : Box-like
    rc : cutoff radius
    max_neigh : optional fixed capacity (ValueError on overflow)
    device : "cuda" (default) or "cpu"
    """

    def __init__(self, pos, box, rc: float, max_neigh: Optional[int] = None,
                 device="cuda") -> None:
        self.pos = _positions(pos)
        self.box = init_box(box)
        self.rc = float(rc)
        self.max_neigh = max_neigh
        self.device = resolve_device(device, "Neighbor")
        self.verlet_list: Optional[np.ndarray] = None
        self.distance_list: Optional[np.ndarray] = None
        self.neighbor_number: Optional[np.ndarray] = None

    def compute(self) -> "Neighbor":
        self.verlet_list, self.distance_list, self.neighbor_number = neighbor_search(
            self.pos, self.box, self.rc, self.max_neigh, device=self.device
        )
        return self


def _positions(pos) -> np.ndarray:
    """(N, 3) float64 positions from an array or a frame with x/y/z columns."""
    if hasattr(pos, "columns"):
        pos = np.column_stack([pos["x"], pos["y"], pos["z"]])
    return np.ascontiguousarray(pos, dtype=np.float64)
