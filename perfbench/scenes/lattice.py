"""FCC lattice points."""

from __future__ import annotations

import numpy as np

FCC_BASIS = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                      [0.0, 0.5, 0.5]])


def fcc_block(nx: int, ny: int, nz: int, a: float) -> np.ndarray:
    """The 4 * nx * ny * nz points of an FCC block of cubic cells of edge
    ``a``, cell by cell, in [0, n * a) along each axis (float64)."""
    cells = np.mgrid[0:nx, 0:ny, 0:nz].reshape(3, -1).T
    return (cells[:, None] + FCC_BASIS[None]).reshape(-1, 3) * float(a)
