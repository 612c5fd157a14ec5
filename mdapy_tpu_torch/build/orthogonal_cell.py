"""Triclinic -> orthogonal supercell conversion (atomsk ``-orthogonal-cell``).

A host copy of ``mdapy_tpu/build/orthogonal_cell.py`` (the whole module,
:22-180), on the port's ``Box`` and ``System``: for each Cartesian axis find
the shortest integer combination of the input lattice vectors aligned with
it, replicate + filter into the resulting diagonal box, optionally reduce to
the smallest periodic sub-cell (species-aware).  Search and replication are
vectorised numpy; the result is a ``System`` on ``device`` (the card unless
the caller passes ``device="cpu"``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.box import Box

__all__ = ["orthogonal_cell"]


def _axis_combination(box: np.ndarray, axis: int, bound: int, tol: float):
    """Shortest integer (m,n,o) with m H1 + n H2 + o H3 along +axis, or None."""
    r = np.arange(-bound, bound + 1)
    M, N, O = np.meshgrid(r, r, r, indexing="ij")
    coef = np.stack([M.ravel(), N.ravel(), O.ravel()], axis=1)
    v = coef @ box  # (K, 3)
    j, k = (axis + 1) % 3, (axis + 2) % 3
    ok = (
        (np.abs(v[:, j]) <= tol)
        & (np.abs(v[:, k]) <= tol)
        & (v[:, axis] > tol)
    )
    if not ok.any():
        return None
    idx = np.flatnonzero(ok)
    best = idx[np.argmin(v[idx, axis])]
    return tuple(int(x) for x in coef[best])


def _reduce_minimal(box, pos, elements, extras_idx, max_search, tol):
    """Smallest orthogonal sub-cell reproducing the crystal on replication."""
    n_atoms = len(pos)
    if n_atoms == 0:
        return box, pos, elements, extras_idx
    L = np.diag(box)
    frac = pos / L
    frac -= np.floor(frac + tol)
    best = (box, pos, elements, extras_idx, n_atoms)
    for nx in range(1, max_search + 1):
        for ny in range(1, max_search + 1):
            for nz in range(1, max_search + 1):
                if nx == ny == nz == 1:
                    continue
                div = np.array([nx, ny, nz])
                n_div = nx * ny * nz
                if n_atoms % n_div:
                    continue
                expected = n_atoms // n_div
                if expected >= best[4]:
                    continue
                in_first = np.all(
                    (frac >= -tol) & (frac < 1.0 / div - tol), axis=1
                )
                if int(in_first.sum()) != expected:
                    continue
                small = (frac[in_first] * div) % 1.0
                small_ele = None if elements is None else elements[in_first]
                # replicate back and match against the full set (with species)
                shifts = np.stack(np.meshgrid(
                    np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
                ), axis=-1).reshape(-1, 3)
                rep = ((small[None, :, :] + shifts[:, None, :]) / div)
                rep -= np.floor(rep + tol)
                rep = rep.reshape(-1, 3)
                diff = frac[None, :, :] - rep[:, None, :]
                diff -= np.round(diff)
                close = np.linalg.norm(diff, axis=2) < tol  # (rep, orig)
                if small_ele is not None:
                    rep_ele = np.tile(small_ele, n_div)
                    close &= rep_ele[:, None] == elements[None, :]
                # need a perfect matching; with exact lattice points each
                # replica matches exactly one original
                if not (close.any(axis=1).all() and close.any(axis=0).all()):
                    continue
                best = (
                    np.diag(L / div),
                    small * (L / div),
                    small_ele,
                    None if extras_idx is None else extras_idx[in_first],
                    expected,
                )
    return best[:4]


def orthogonal_cell(system, find_minimal: bool = False, max_search: int = 20,
                    tol: float = 1e-6, device="cuda"):
    """Convert a fully periodic (possibly triclinic) System to an equivalent
    System with a diagonal box. ``find_minimal`` additionally reduces to the
    smallest orthogonal sub-cell (species-aware)."""
    if not all(int(b) == 1 for b in system.box.boundary):
        raise ValueError(
            "orthogonal_cell requires a fully periodic input "
            "(box.boundary must be [1, 1, 1])."
        )
    box = np.asarray(system.box.matrix, dtype=float)
    origin = np.asarray(system.box.origin, dtype=float)
    if abs(np.linalg.det(box)) < tol:
        raise ValueError("Input box is singular (zero volume).")

    mno = np.zeros((3, 3), dtype=np.int64)
    for i in range(3):
        v = box[i]
        if abs(np.linalg.norm(v) - abs(v[i])) < tol and v[i] > tol:
            mno[i, i] = 1
            continue
        found = None
        for bound in (max_search, max_search * 2, max_search * 5):
            found = _axis_combination(box, i, bound, tol)
            if found is not None:
                break
        if found is None:
            raise ValueError(
                f"No integer combination of the lattice vectors aligns with "
                f"axis {'xyz'[i]} within max_search={max_search * 5}; "
                "increase max_search or tol."
            )
        mno[i] = found

    new_lengths = np.array([(mno @ box)[i, i] for i in range(3)])
    if np.any(new_lengths <= 0):
        raise ValueError("Computed lattice vectors are not positive; "
                         "input box may not be right-handed.")
    new_box = np.diag(new_lengths)

    pos = system.pos - origin
    n_atoms = len(pos)
    data = system.data
    elements = (
        np.asarray(data["element"], dtype=object) if "element" in data else None
    )

    margin = int(np.max(np.abs(mno))) + 1
    r = np.arange(-margin, margin + 1)
    shifts = np.stack(
        np.meshgrid(r, r, r, indexing="ij"), axis=-1
    ).reshape(-1, 3).astype(float) @ box
    rep_pos = (pos[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    rep_src = np.tile(np.arange(n_atoms), len(shifts))

    inside = np.all((rep_pos > -tol) & (rep_pos < new_lengths - tol), axis=1)
    sel_pos = rep_pos[inside]
    sel_src = rep_src[inside]
    expected_n = int(round(abs(np.linalg.det(mno.astype(float)))) * n_atoms)
    if len(sel_pos) != expected_n:
        raise ValueError(
            f"orthogonal_cell produced {len(sel_pos)} atoms, expected "
            f"{expected_n} = |det(mno)| * N; atoms may sit exactly on the "
            "boundary — perturb positions or tighten tol."
        )
    sel_pos = sel_pos - np.floor(sel_pos / new_lengths + tol) * new_lengths
    sel_pos = np.where(np.abs(sel_pos) < tol, 0.0, sel_pos)
    sel_ele = elements[sel_src] if elements is not None else None

    if find_minimal:
        new_box, sel_pos, sel_ele, sel_src = _reduce_minimal(
            new_box, sel_pos, sel_ele, sel_src, max_search, tol
        )

    cols = {"x": sel_pos[:, 0], "y": sel_pos[:, 1], "z": sel_pos[:, 2]}
    if sel_ele is not None:
        cols["element"] = sel_ele
    for c in data.columns:
        if c in ("x", "y", "z", "element", "id"):
            continue
        cols[c] = np.asarray(data[c])[sel_src]

    from ..core.system import System

    return System(data=cols, box=Box(new_box, boundary=[1, 1, 1]),
                  device=device)
