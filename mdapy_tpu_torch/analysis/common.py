"""Shared helpers of the analyses: the cell as tensors, the minimum image,
neighbor displacements and row chunks.

The port of ``mdapy_tpu/analysis/common.py``: ``min_image_jnp`` (:24),
``neighbor_disp`` (:39) and ``box_arrays`` (:54), as tensor helpers that
take a device.  Every analysis consumes the neighbor engine's contract
(-1-padded rows, distance-ascending) and works in float64 on the card and
the CPU alike; per-atom results are row sums of gathers, histograms
count in integers, and float sums into bins are row sums over each bin's
members in a fixed order (``segment_sum``), so a second call on the card
repeats the first bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["box_tensors", "min_image", "neighbor_disp", "row_chunks",
           "segment_sum"]

# bytes of the intermediates that one chunk of atom rows may hold; the
# analyses whose per-atom tensors grow as M^2 or M^3 work in chunks of rows
CHUNK_BYTES = 1 << 30


def box_tensors(box, device, dtype=torch.float64):
    """(matrix, inverse, boundary) of a ``Box`` as tensors on ``device``;
    the boundary as a float mask for the minimum image."""
    return (torch.tensor(np.asarray(box.matrix), dtype=dtype, device=device),
            torch.tensor(np.asarray(box.inverse_box), dtype=dtype,
                         device=device),
            torch.tensor(np.asarray(box.boundary), dtype=dtype, device=device))


def min_image(disp, matrix, inv, boundary):
    """Component-wise fractional minimum image of (..., 3) displacements,
    rounded half to even as ``jnp.round`` does."""
    frac = disp @ inv
    frac = frac - torch.round(frac) * boundary
    return frac @ matrix


def neighbor_disp(pos, verlet, matrix, inv, boundary, start: int = 0):
    """(n, M, 3) displacements r_j - r_i, minimum-imaged; invalid slots 0.
    ``verlet`` holds the rows of atoms ``start`` to ``start + n``."""
    j = verlet.clamp(min=0).long()
    centre = pos[start:start + verlet.shape[0], None, :]
    disp = min_image(pos[j] - centre, matrix, inv, boundary)
    return torch.where((verlet >= 0)[..., None], disp, 0.0)


def row_chunks(n: int, bytes_per_row: int):
    """(start, stop) ranges of atom rows whose intermediates, at
    ``bytes_per_row`` a row, fit ``CHUNK_BYTES``."""
    rows = max(1, CHUNK_BYTES // max(1, int(bytes_per_row)))
    for start in range(0, n, rows):
        yield start, min(n, start + rows)


def segment_sum(values, counts):
    """(..., S) sums of ``values`` (..., n), whose last axis holds segment 0's
    ``counts[0]`` entries, then segment 1's, and so on; empty segments sum
    to 0.  ``torch.segment_reduce`` sums each segment in one fixed order with
    no atomics (a segmented block reduction, or one thread a segment), so
    the card repeats its sums bit for bit."""
    counts = torch.as_tensor(counts, device=values.device).long()
    return torch.segment_reduce(values.movedim(-1, 0), "sum", lengths=counts,
                                axis=0, initial=0).movedim(0, -1)
