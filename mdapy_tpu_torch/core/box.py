"""Periodic-cell math the renderer needs.

A numpy copy of ``mdapy_tpu/core/box.py:min_image`` (:283), the minimum
image that ``Box.pbc`` (:231) applies, kept here so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["min_image"]


def min_image(rij, matrix, inv_matrix, boundary) -> np.ndarray:
    """Minimum-image displacement(s) of ``rij`` (..., 3) in the cell whose
    rows are ``matrix``; directions with boundary 0 are left untouched."""
    frac = np.asarray(rij, dtype=np.float64) @ inv_matrix
    frac = frac - np.floor(frac + 0.5) * np.asarray(boundary)
    return frac @ matrix
