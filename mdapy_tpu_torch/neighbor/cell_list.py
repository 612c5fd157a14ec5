"""Cell-list neighbor search in torch ops.

The port of ``mdapy_tpu/neighbor/cell_list.py``: ``cell_grid_shape`` (:39),
``compute_cell_ids`` (:57), ``cell_occupancy`` (:71), ``_stencil_cells``
(:86), ``candidate_gather`` (:111), ``_min_image_disp`` (:150) and
``neighbor_list_fixed`` (:160).

  1. fractional coordinates -> a cell id per atom (periodic axes wrapped by
     ``x - floor(x)``, free axes clamped);
  2. a stable argsort by cell id, and each cell's start and count from
     ``torch.bincount`` and a cumulative sum;
  3. per query atom, the candidates of its 27-cell stencil, ``M`` slots a
     cell (``M`` the largest occupancy), invalid slots masked;
  4. the minimum image of every candidate displacement, rounded half to
     even as ``jnp.round`` does, and a masked ``torch.topk`` over squared
     distances: (Q, max_neigh) index and distance rows in ascending order,
     the true neighbor count of each row and its maximum, which the caller
     holds against ``max_neigh`` (the overflow contract).

The work goes in chunks of query rows, as ``neighbor_list_fixed`` maps
``lax.map`` over them, so that a chunk's block of float64 displacements and
distances stays near ``CHUNK_BYTES``.  Not ported: ``neighbor_list_dense``
(:305), ``dense_eligible`` and ``_pad_halo``, the TPU's halo-window layout
with its carrying sort; ``neighbor_list_auto`` (:244) is this gather path
alone, so callers call ``neighbor_list_fixed``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "cell_grid_shape",
    "compute_cell_ids",
    "cell_occupancy",
    "candidate_gather",
    "candidate_distances",
    "select_nearest",
    "neighbor_list_fixed",
    "query_chunk",
]

# bytes of the float64 displacements (3) and squared distances (1) that one
# chunk of query rows holds, 32 B a candidate: query_chunk sizes chunks by it
CHUNK_BYTES = 1 << 30
MAX_CHUNK = 65536

# the 27 stencil offsets, in the JAX package's meshgrid("ij") order
_OFFSETS = np.stack(np.meshgrid(np.arange(-1, 2), np.arange(-1, 2),
                                np.arange(-1, 2), indexing="ij"),
                    axis=-1).reshape(27, 3)


def cell_grid_shape(box_matrix: np.ndarray, rc: float, max_cells: int = 2**22) -> Tuple[int, int, int]:
    """Cells per axis so one fractional cell spans >= rc along each face normal."""
    m = np.asarray(box_matrix, dtype=np.float64)
    vol = abs(float(np.linalg.det(m)))
    thickness = np.array(
        [
            vol / np.linalg.norm(np.cross(m[1], m[2])),
            vol / np.linalg.norm(np.cross(m[0], m[2])),
            vol / np.linalg.norm(np.cross(m[0], m[1])),
        ]
    )
    nc = np.maximum(1, np.floor(thickness / float(rc)).astype(np.int64))
    # bound total cells (degenerate tiny rc): shrink largest dims first
    while int(np.prod(nc)) > max_cells:
        nc[np.argmax(nc)] //= 2
    return int(nc[0]), int(nc[1]), int(nc[2])


def query_chunk(n_candidates: int) -> int:
    """Query rows a chunk: the largest power of two whose (rows,
    n_candidates) block of float64 displacements and distances fits
    ``CHUNK_BYTES``, at most ``MAX_CHUNK``."""
    rows = max(1, CHUNK_BYTES // (32 * max(1, n_candidates)))
    return min(MAX_CHUNK, 1 << (rows.bit_length() - 1))


def _cell_xyz(pos, inv, origin, boundary, ncells):
    """(n, 3) integer cell coordinates: periodic axes wrapped, free axes
    clamped (clamping is 1-Lipschitz, so adjacent cells stay adjacent)."""
    nc = torch.tensor(ncells, device=pos.device)
    frac = (pos - origin) @ inv
    per = boundary.bool()
    frac = torch.where(per, frac - torch.floor(frac), frac)
    idx = torch.floor(frac * nc.to(frac.dtype)).long()
    return torch.where(per, torch.remainder(idx, nc),
                       torch.minimum(torch.clamp(idx, min=0), nc - 1))


def compute_cell_ids(pos, inv, origin, boundary, ncells) -> torch.Tensor:
    """Per-atom flat cell index (int64).  ``inv`` is the inverse cell matrix."""
    _, ncy, ncz = ncells
    idx = _cell_xyz(pos, inv, origin, boundary, ncells)
    return (idx[:, 0] * ncy + idx[:, 1]) * ncz + idx[:, 2]


def cell_occupancy(pos, inv, origin, boundary, ncells):
    """Returns (order, sorted_cell_ids, cell_start, cell_count, max_occupancy),
    the last a device scalar."""
    ntot = ncells[0] * ncells[1] * ncells[2]
    cid = compute_cell_ids(pos, inv, origin, boundary, ncells)
    order = torch.argsort(cid, stable=True)
    cell_count = torch.bincount(cid, minlength=ntot)
    cell_start = torch.cumsum(cell_count, 0) - cell_count
    return order, cid[order], cell_start, cell_count, cell_count.max()


def _stencil_cells(cell_xyz, ncells, boundary):
    """(Q, 27) flat ids of the 3x3x3 stencil and a validity mask (free axes).

    With fewer than 3 cells along a periodic axis, wrapping folds distinct
    offsets onto one cell; only the first *valid* occurrence of each id is
    kept (an out-of-range entry must not shadow a later in-range one), or a
    small box would count its neighbors twice."""
    _, ncy, ncz = ncells
    dev = cell_xyz.device
    nc = torch.tensor(ncells, device=dev)
    per = boundary.bool()
    nbr = cell_xyz[:, None, :] + torch.as_tensor(_OFFSETS, device=dev)
    in_range = torch.all(per | ((nbr >= 0) & (nbr < nc)), dim=-1)
    nbr = torch.where(per, torch.remainder(nbr, nc),
                      torch.minimum(torch.clamp(nbr, min=0), nc - 1))
    flat = (nbr[..., 0] * ncy + nbr[..., 1]) * ncz + nbr[..., 2]
    if min(ncells) < 3:
        same = flat[:, :, None] == flat[:, None, :]
        earlier = torch.ones(27, 27, dtype=torch.bool, device=dev).tril(-1)
        dup = torch.any(same & earlier & in_range[:, None, :], dim=-1)
        return flat, in_range & ~dup
    # with 3 or more cells along every axis no valid id repeats
    return flat, in_range


def candidate_gather(query_pos, inv, origin, boundary, ncells, order,
                     cell_start, cell_count, M: int):
    """For each query atom: (Q, 27*M) candidate atom indices (int64, into the
    original atom order) and their validity mask."""
    cxyz = _cell_xyz(query_pos, inv, origin, boundary, ncells)
    cells, cell_ok = _stencil_cells(cxyz, ncells, boundary)
    starts = cell_start[cells]
    counts = torch.where(cell_ok, cell_count[cells], 0)
    slot = torch.arange(M, device=query_pos.device)
    valid = slot < counts[..., None]                       # (Q, 27, M)
    cand = order[torch.where(valid, starts[..., None] + slot, 0)]
    q = cand.shape[0]
    return cand.reshape(q, 27 * M), valid.reshape(q, 27 * M)


def _min_image_disp(disp, matrix, inv, boundary):
    """Minimum image of (..., 3) displacements; rounds half to even, as
    ``jnp.round`` does."""
    frac = disp @ inv
    frac = frac - torch.round(frac) * boundary
    return frac @ matrix


def candidate_distances(pos, qpos, start: int, matrix, inv, origin, boundary,
                        rc: float, ncells, order, cell_start, cell_count,
                        M: int, exclude_self: bool = True):
    """One chunk of query rows ``qpos`` (rows ``start`` on of the queries):
    (cand (Q, 27*M) int64, ok (Q, 27*M) bool: a neighbor within ``rc``,
    d2 (Q, 27*M) squared minimum-image distances)."""
    cand, valid = candidate_gather(qpos, inv, origin, boundary, ncells, order,
                                   cell_start, cell_count, M)
    disp = _min_image_disp(pos[cand] - qpos[:, None, :], matrix, inv,
                           boundary.to(pos.dtype))
    d2 = torch.sum(disp * disp, dim=-1)
    ok = valid & (d2 <= rc * rc)
    if exclude_self:
        qidx = torch.arange(start, start + qpos.shape[0], device=pos.device)
        ok &= cand != qidx[:, None]
    # exclude_self=False keeps zero-distance hits, for queries against a
    # distinct candidate set
    return cand, ok, d2


def select_nearest(cand, ok, d2, max_neigh: int):
    """The ``max_neigh`` nearest neighbors of each row in ascending order:
    (verlet int32 padded with -1, dist padded with 0)."""
    big = torch.finfo(d2.dtype).max
    top_d2, top_i = torch.topk(torch.where(ok, d2, big), max_neigh, dim=1,
                               largest=False, sorted=True)
    good = top_d2 < big
    verlet = torch.where(good, cand.gather(1, top_i), -1).int()
    dist = torch.where(good, torch.sqrt(torch.clamp(top_d2, min=0.0)), 0.0)
    return verlet, dist


def neighbor_list_fixed(pos, matrix, inv, origin, boundary, rc: float, ncells,
                        order, cell_start, cell_count, M: int, max_neigh: int,
                        exclude_self: bool = True, query_pos=None):
    """Fixed-capacity Verlet list sorted by distance.

    ``pos`` is the candidate set the cell list was built over; ``query_pos``
    (default: ``pos``) the atoms whose neighbors are wanted, used when the
    original atoms query a replicated candidate set (self-exclusion then
    compares query index i to candidate index i, which the image-0-first
    replication layout makes right).  ``max_neigh`` is at most 27 * M.

    Returns (verlet (Q, max_neigh) int32 padded with -1, dist (Q,
    max_neigh), counts (Q,) int32 true neighbor counts, their maximum as a
    device scalar).  Counts may exceed max_neigh: callers must check.
    """
    q_all = pos if query_pos is None else query_pos
    n = q_all.shape[0]
    chunk = query_chunk(27 * M)
    verlet = torch.empty(n, max_neigh, dtype=torch.int32, device=pos.device)
    dist = torch.empty(n, max_neigh, dtype=pos.dtype, device=pos.device)
    cnt = torch.empty(n, dtype=torch.int32, device=pos.device)
    for start in range(0, n, chunk):
        stop = min(n, start + chunk)
        cand, ok, d2 = candidate_distances(
            pos, q_all[start:stop], start, matrix, inv, origin, boundary, rc,
            ncells, order, cell_start, cell_count, M, exclude_self)
        cnt[start:stop] = ok.sum(dim=1)
        verlet[start:stop], dist[start:stop] = select_nearest(cand, ok, d2,
                                                              max_neigh)
    return verlet, dist, cnt, (cnt.max() if n else cnt.new_zeros(()))
