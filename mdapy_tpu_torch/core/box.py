"""The simulation cell on the host, and the periodic-cell math around it.

A numpy copy of ``mdapy_tpu/core/box.py``: ``_parse_origin``,
``_parse_boundary`` and ``_parse_box`` (:26-66), ``Box`` (:69-257),
``init_box`` (:260), ``frac_coords`` (:276), ``min_image`` (:283) and
``wrap_positions`` (:300), kept here so that the port imports nothing of the
JAX package.  The torch code that needs the cell (the neighbor engine, the
potentials) reads ``matrix``, ``inverse_box``, ``origin`` and ``boundary``
from a ``Box`` and moves them to its device itself.

``min_image`` keeps the renderer's rounding, ``floor(x + 0.5)``; the
neighbor engine and the potentials round half to even (``torch.round``), as
``mdapy_tpu/neighbor/cell_list.py:152`` and ``potentials/eam.py:497-499``
do.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple, Union

import numpy as np

__all__ = ["Box", "init_box", "min_image", "wrap_positions", "frac_coords"]

BoxLike = Union[int, float, Iterable[float], np.ndarray, "Box"]


def _parse_origin(origin) -> np.ndarray:
    if origin is None:
        return np.zeros(3, dtype=np.float64)
    origin = np.array(origin, dtype=np.float64)
    if origin.shape != (3,):
        raise ValueError(f"Origin must be a 3-element array, got shape {origin.shape}")
    return origin


def _parse_boundary(boundary) -> np.ndarray:
    if boundary is None:
        return np.ones(3, dtype=np.int32)
    boundary = np.array(boundary, dtype=np.int32)
    if boundary.shape != (3,):
        raise ValueError(
            f"Boundary must be a 3-element array, got shape {boundary.shape}"
        )
    return np.where(boundary != 0, 1, 0).astype(np.int32)


def _parse_box(box, origin) -> tuple:
    """Accept scalar, (3,), (3,3), legacy (4,3) [last row origin], OVITO (3,4)
    [last column origin]."""
    if isinstance(box, (int, float, np.integer, np.floating)):
        matrix = np.eye(3, dtype=np.float64) * float(box)
    else:
        matrix = np.array(box, dtype=np.float64)
        if matrix.shape == (3,):
            matrix = np.diag(matrix)
        elif matrix.shape == (3, 3):
            pass
        elif matrix.shape == (4, 3):
            origin = matrix[-1] if origin is None else origin
            matrix = np.ascontiguousarray(matrix[:-1])
        elif matrix.shape == (3, 4):
            origin = matrix[:, -1] if origin is None else origin
            matrix = np.ascontiguousarray(matrix[:, :-1])
        else:
            raise ValueError(f"Invalid box shape: {matrix.shape}")
    return matrix, _parse_origin(origin)


def _is_cell(obj) -> bool:
    """True for any object that carries a cell as ``.matrix``, ``.origin``
    and ``.boundary`` (a ``Box`` of either package, or a stand-in)."""
    return all(hasattr(obj, k) for k in ("matrix", "origin", "boundary"))


class Box:
    """Immutable simulation cell.

    Attributes
    ----------
    matrix : (3,3) float64 ndarray — rows are the cell vectors a, b, c.
    origin : (3,) float64 ndarray.
    boundary : (3,) int32 ndarray — 1 = periodic, 0 = free.
    """

    __slots__ = ("_matrix", "_origin", "_boundary", "_inv", "_volume", "_triclinic")

    def __init__(
        self,
        box: BoxLike,
        boundary: Optional[Iterable[int]] = None,
        origin: Optional[Iterable[float]] = None,
    ) -> None:
        if _is_cell(box):
            matrix = np.array(box.matrix, dtype=np.float64)
            org = _parse_origin(box.origin if origin is None else origin)
            if boundary is None:
                boundary = np.array(box.boundary)
        else:
            matrix, org = _parse_box(box, origin)
        self._matrix = matrix
        self._matrix.setflags(write=False)
        self._origin = org
        self._origin.setflags(write=False)
        self._boundary = _parse_boundary(boundary)
        self._boundary.setflags(write=False)
        self._volume = float(np.linalg.det(matrix))
        self._inv = np.linalg.inv(matrix)
        self._inv.setflags(write=False)
        off = matrix - np.diag(np.diag(matrix))
        self._triclinic = bool(
            np.any(np.abs(off) > 1e-10) or np.any(np.diag(matrix) < 0)
        )

    # ---- properties --------------------------------------------------------
    @property
    def matrix(self) -> np.ndarray:
        return self._matrix

    # the reference's name for the matrix
    @property
    def box(self) -> np.ndarray:
        return self._matrix

    @property
    def origin(self) -> np.ndarray:
        return self._origin

    @property
    def boundary(self) -> np.ndarray:
        return self._boundary

    @property
    def inverse_box(self) -> np.ndarray:
        return self._inv

    @property
    def volume(self) -> float:
        return self._volume

    @property
    def triclinic(self) -> bool:
        return self._triclinic

    @property
    def lengths(self) -> np.ndarray:
        """Norms of the three cell vectors."""
        return np.linalg.norm(self._matrix, axis=1)

    @property
    def angles(self) -> np.ndarray:
        """Cell angles (alpha, beta, gamma) in degrees."""
        a, b, c = self._matrix
        na, nb, nc = self.lengths
        alpha = np.degrees(np.arccos(np.dot(b, c) / (nb * nc)))
        beta = np.degrees(np.arccos(np.dot(a, c) / (na * nc)))
        gamma = np.degrees(np.arccos(np.dot(a, b) / (na * nb)))
        return np.array([alpha, beta, gamma])

    def __repr__(self) -> str:
        return (
            f"Box information:\n{self._matrix}\nOrigin: {self._origin}\n"
            f"Triclinic: {self._triclinic}\nBoundary: {self._boundary}"
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, Box):
            return NotImplemented
        return (
            np.allclose(self._matrix, other._matrix)
            and np.allclose(self._origin, other._origin)
            and np.array_equal(self._boundary, other._boundary)
        )

    # ---- derived geometry --------------------------------------------------
    def get_thickness(self) -> np.ndarray:
        """Perpendicular distance between opposite box faces per direction."""
        m = self._matrix
        v = abs(self._volume)
        return np.array(
            [
                v / np.linalg.norm(np.cross(m[1], m[2])),
                v / np.linalg.norm(np.cross(m[0], m[2])),
                v / np.linalg.norm(np.cross(m[0], m[1])),
            ]
        )

    def check_small_box(self, rc: float) -> np.ndarray:
        """Replications needed per periodic direction so that thickness >= 2*rc."""
        thickness = self.get_thickness()
        repeat = np.ones(3, dtype=np.int32)
        for i in range(3):
            if self._boundary[i] == 1 and thickness[i] < 2 * rc:
                repeat[i] = int(np.ceil(2.0 * rc / thickness[i]))
        return repeat

    def is_general_box(self, tol: float = 1e-6) -> bool:
        """True if the cell is not in LAMMPS lower-triangular form."""
        m = self._matrix
        return bool(
            m[0, 0] <= tol
            or m[1, 1] <= tol
            or m[2, 2] <= tol
            or abs(m[0, 1]) > tol
            or abs(m[0, 2]) > tol
            or abs(m[1, 2]) > tol
        )

    def align_to_lammps_box(self) -> Tuple["Box", np.ndarray]:
        """Rotate the cell into LAMMPS lower-triangular convention.

        Returns the aligned Box and the 3x3 rotation R with
        ``aligned_matrix = matrix @ R``."""
        m = self._matrix
        ax = np.linalg.norm(m[0])
        ahat = m[0] / ax
        bx = m[1] @ ahat
        by = np.sqrt(np.linalg.norm(m[1]) ** 2 - bx**2)
        cx = m[2] @ ahat
        cy = (m[1] @ m[2] - bx * cx) / by
        cz = np.sqrt(np.linalg.norm(m[2]) ** 2 - cx**2 - cy**2)
        aligned = np.array([[ax, 0, 0], [bx, by, 0], [cx, cy, cz]], dtype=np.float64)
        rotation = np.linalg.solve(m, aligned)
        return Box(aligned, self._boundary, self._origin), rotation

    # ---- PBC math on the host ----------------------------------------------
    def pbc(self, rij: np.ndarray) -> np.ndarray:
        """Minimum-image a displacement vector (or array of them)."""
        return min_image(np.asarray(rij, dtype=np.float64), self._matrix, self._inv,
                         self._boundary)

    def wrap(self, pos: np.ndarray) -> np.ndarray:
        """Wrap absolute positions into the primary cell."""
        return wrap_positions(np.asarray(pos, dtype=np.float64), self._matrix,
                              self._inv, self._origin, self._boundary)

    def replicate(self, nx: int, ny: int, nz: int) -> "Box":
        rep = np.array([nx, ny, nz], dtype=np.float64)
        return Box(self._matrix * rep[:, None], self._boundary, self._origin)

    def to_dict(self) -> dict:
        return {
            "matrix": self._matrix.tolist(),
            "origin": self._origin.tolist(),
            "boundary": self._boundary.tolist(),
        }


def init_box(
    box: BoxLike,
    boundary: Optional[Iterable[int]] = None,
    origin: Optional[Iterable[float]] = None,
) -> Box:
    """Coerce any accepted box description into a Box (idempotent for Box).

    Besides the JAX package's forms it takes any object with ``.matrix``,
    ``.origin`` and ``.boundary``: a JAX ``Box`` or a stand-in."""
    if isinstance(box, Box) and boundary is None and origin is None:
        return box
    return Box(box, boundary, origin)


def frac_coords(pos, inv_matrix, origin=None) -> np.ndarray:
    """Cartesian -> fractional coordinates. pos: (..., 3)."""
    pos = np.asarray(pos, dtype=np.float64)
    if origin is not None:
        pos = pos - origin
    return pos @ inv_matrix


def min_image(rij, matrix, inv_matrix, boundary) -> np.ndarray:
    """Minimum-image displacement(s) of ``rij`` (..., 3) in the cell whose
    rows are ``matrix``; directions with boundary 0 are left untouched."""
    frac = np.asarray(rij, dtype=np.float64) @ inv_matrix
    frac = frac - np.floor(frac + 0.5) * np.asarray(boundary)
    return frac @ matrix


def wrap_positions(pos, matrix, inv_matrix, origin, boundary) -> np.ndarray:
    """Wrap absolute positions into [origin, origin + cell)."""
    frac = (np.asarray(pos, dtype=np.float64) - origin) @ inv_matrix
    frac = frac - np.floor(frac) * np.asarray(boundary)
    return frac @ matrix + origin
