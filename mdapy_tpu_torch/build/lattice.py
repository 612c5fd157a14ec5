"""Crystal builders: 15 lattices, Miller/Miller-Bravais orientation, HEA.

A host copy of ``mdapy_tpu/build/lattice.py`` (the basis table ``_B`` and
its defaults, ``_hkil_to_uvw``, ``_atoms_in_supercell``,
``_lower_triangular``, ``_minimal_cell`` :24-296; ``build_crystal`` :297,
``build_hea`` :384, ``build_hea_fromsystem`` :403, ``LatticeRegistry``),
in numpy, so that the same inputs give the same float64 bits in both
packages.  Each builder returns the port's ``System`` on ``device`` (the
card unless the caller passes ``device="cpu"``).

Deviation in cost, not in result: ``build_hea_fromsystem`` shuffles the
element indices with an explicit ``np.random.RandomState(seed)`` (the global
stream only when the seed is None), which draws the same permutation as
seeding the global stream, and maps types by index, not in a Python loop
over the atoms.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from ..core.box import Box
from ..core.elements import atomic_numbers

__all__ = ["build_crystal", "build_hea", "build_hea_fromsystem", "LatticeRegistry"]

_SQRT3 = math.sqrt(3.0)


def _cube(a):
    return a * np.eye(3)


def _hexbox(a, c):
    return np.array([[a, 0, 0], [-0.5 * a, 0.5 * _SQRT3 * a, 0], [0, 0, c]])


# Crystallographic basis tables (fractional sites + species index); atomsk
# ordering conventions.
_B = {
    "sc": lambda a, c: (_cube(a), np.array([[0.0, 0, 0]]), np.array([0])),
    "fcc": lambda a, c: (
        _cube(a),
        np.array([[0, 0, 0], [0.5, 0.5, 0], [0, 0.5, 0.5], [0.5, 0, 0.5]], float),
        np.array([0, 0, 1, 1]),
    ),
    "bcc": lambda a, c: (
        _cube(a), np.array([[0, 0, 0], [0.5, 0.5, 0.5]], float), np.array([0, 1])
    ),
    "diamond": lambda a, c: (
        _cube(a),
        np.array(
            [[0, 0, 0], [0.5, 0.5, 0], [0, 0.5, 0.5], [0.5, 0, 0.5],
             [0.25, 0.25, 0.25], [0.75, 0.75, 0.25], [0.75, 0.25, 0.75],
             [0.25, 0.75, 0.75]], float,
        ),
        np.array([0, 0, 0, 0, 1, 1, 1, 1]),
    ),
    "cscl": lambda a, c: (
        _cube(a), np.array([[0, 0, 0], [0.5, 0.5, 0.5]], float), np.array([0, 1])
    ),
    "rocksalt": lambda a, c: (
        _cube(a),
        np.array(
            [[0, 0, 0], [0.5, 0.5, 0], [0, 0.5, 0.5], [0.5, 0, 0.5],
             [0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5], [0.5, 0.5, 0.5]], float,
        ),
        np.array([0, 0, 0, 0, 1, 1, 1, 1]),
    ),
    "zincblende": lambda a, c: (
        _cube(a),
        np.array(
            [[0, 0, 0], [0.5, 0.5, 0], [0, 0.5, 0.5], [0.5, 0, 0.5],
             [0.25, 0.25, 0.25], [0.75, 0.75, 0.25], [0.75, 0.25, 0.75],
             [0.25, 0.75, 0.75]], float,
        ),
        np.array([0, 0, 0, 0, 1, 1, 1, 1]),
    ),
    "fluorite": lambda a, c: (
        _cube(a),
        np.array(
            [[0, 0, 0], [0.5, 0.5, 0], [0, 0.5, 0.5], [0.5, 0, 0.5],
             [0.25, 0.25, 0.25], [0.75, 0.25, 0.25], [0.25, 0.75, 0.25],
             [0.75, 0.75, 0.25], [0.25, 0.25, 0.75], [0.75, 0.25, 0.75],
             [0.25, 0.75, 0.75], [0.75, 0.75, 0.75]], float,
        ),
        np.array([0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1]),
    ),
    "l1_2": lambda a, c: (
        _cube(a),
        np.array([[0.5, 0.5, 0], [0, 0.5, 0.5], [0.5, 0, 0.5], [0, 0, 0]], float),
        np.array([0, 0, 0, 1]),
    ),
    "perovskite": lambda a, c: (
        _cube(a),
        np.array(
            [[0.5, 0.5, 0.5], [0, 0, 0], [0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5]],
            float,
        ),
        np.array([0, 1, 2, 2, 2]),
    ),
    "hcp": lambda a, c: (
        _hexbox(a, c),
        np.array([[0, 0, 0], [1 / 3, 2 / 3, 0.5]], float),
        np.array([0, 1]),
    ),
    "wurtzite": lambda a, c: (
        _hexbox(a, c),
        np.array(
            [[1 / 3, 2 / 3, 0], [2 / 3, 1 / 3, 0.5],
             [1 / 3, 2 / 3, 3 / 8], [2 / 3, 1 / 3, 7 / 8]], float,
        ),
        np.array([0, 0, 1, 1]),
    ),
    "graphite": lambda a, c: (
        _hexbox(a, c),
        np.array([[0, 0, 0], [0, 0, 0.5], [1 / 3, 2 / 3, 0], [2 / 3, 1 / 3, 0.5]], float),
        np.array([0, 1, 0, 1]),
    ),
    "graphene": lambda a, c: (
        _hexbox(a, c),
        np.array([[0, 0, 0], [1 / 3, 2 / 3, 0]], float),
        np.array([0, 1]),
    ),
}
_B["lonsdaleite"] = _B["wurtzite"]

_ALLOWED_NSPECIES = {
    "sc": (1,), "fcc": (1, 2), "bcc": (1, 2), "diamond": (1, 2), "cscl": (2,),
    "rocksalt": (2,), "zincblende": (2,), "fluorite": (2,), "l1_2": (2,),
    "perovskite": (3,), "hcp": (1, 2), "wurtzite": (1, 2), "graphite": (1, 2),
    "graphene": (1, 2), "lonsdaleite": (1,),
}
_C_DEFAULT = {"hcp": math.sqrt(8 / 3), "wurtzite": math.sqrt(8 / 3),
              "lonsdaleite": math.sqrt(8 / 3)}
_ALIASES = {
    "rs": "rocksalt", "nacl": "rocksalt", "b1": "rocksalt", "zb": "zincblende",
    "b3": "zincblende", "wz": "wurtzite", "b4": "wurtzite", "a9": "graphite",
    "b2": "cscl", "l12": "l1_2", "hex_diamond": "lonsdaleite",
    "hexagonal_diamond": "lonsdaleite", "diamond_hex": "lonsdaleite",
}
_MILLER_HEX = {"hcp", "wurtzite", "graphite", "graphene", "lonsdaleite"}

LatticeRegistry = dict(_B)


def _norm_name(structure: str) -> str:
    s = structure.lower().strip()
    return _ALIASES.get(s, s)


def _gcd3(a, b, c):
    return math.gcd(math.gcd(abs(int(a)), abs(int(b))), abs(int(c)))


def _reduce(m):
    h, k, L = m
    if h == k == L == 0:
        raise ValueError("Miller indices cannot be all zeros")
    g = _gcd3(h, k, L) or 1
    return (h // g, k // g, L // g)


def _hkil_to_uvw(m):
    if len(m) == 4:
        h, k, i, L = m
        if h + k + i != 0:
            raise ValueError(f"Miller-Bravais constraint h+k+i=0 violated: {m}")
        u, v, w = 2 * h + k, h + 2 * k, L
    elif len(m) == 3:
        u, v, w = m
    else:
        raise ValueError(f"Hexagonal direction must be 3- or 4-index: {m}")
    g = _gcd3(u, v, w) or 1
    return (int(u) // g, int(v) // g, int(w) // g)


def _atoms_in_supercell(M: np.ndarray, basis, species):
    """Enumerate basis atoms of the original lattice inside the new cell
    defined by integer-combination matrix M (columns = new vectors)."""
    Minv = np.linalg.inv(M.astype(float))
    expected = int(round(abs(np.linalg.det(M)) * len(basis)))
    rng = int(np.max(np.abs(M))) + 1
    out_pos, out_sp = [], []
    for i in range(-rng, rng + 1):
        for j in range(-rng, rng + 1):
            for k in range(-rng, rng + 1):
                shift = np.array([i, j, k], float)
                for bidx, b0 in enumerate(basis):
                    f = Minv @ (b0 + shift)
                    f = f - np.floor(f + 1e-10)
                    if np.all(f >= -1e-8) and np.all(f < 1 - 1e-8):
                        dup = False
                        for e in out_pos:
                            dd = f - e
                            dd = dd - np.round(dd)
                            if np.linalg.norm(dd) < 1e-6:
                                dup = True
                                break
                        if not dup:
                            out_pos.append(f.copy())
                            out_sp.append(int(species[bidx]))
    if len(out_pos) != expected:
        raise RuntimeError(
            f"Miller cell enumeration found {len(out_pos)} atoms, expected {expected}"
        )
    return np.array(out_pos), np.array(out_sp, dtype=np.int32)


def _lower_triangular(cell: np.ndarray) -> np.ndarray:
    """Rotate to atomsk's lower-triangular convention (lengths/angles kept)."""
    v1, v2, v3 = cell
    a = np.linalg.norm(v1)
    b = np.linalg.norm(v2)
    c = np.linalg.norm(v3)
    cg = float(v1 @ v2 / (a * b))
    cb = float(v3 @ v1 / (c * a))
    ca = float(v2 @ v3 / (b * c))
    sg = math.sqrt(max(0.0, 1 - cg * cg))
    out = np.zeros((3, 3))
    out[0, 0] = a
    out[1, 0] = b * cg
    out[1, 1] = b * sg
    out[2, 0] = c * cb
    out[2, 1] = c * (ca - cb * cg) / sg
    out[2, 2] = math.sqrt(max(0.0, c * c - out[2, 0] ** 2 - out[2, 1] ** 2))
    out[np.abs(out) < 1e-12] = 0.0
    return out


def _minimal_cell(box, basis, species, max_search=10, tol=1e-6):
    """Smallest axis-aligned periodic sub-cell preserving species labels."""
    off = np.abs(box - np.diag(np.diag(box))).max()
    if off > tol:
        return box, basis, species
    n = len(basis)
    basis = basis - np.floor(basis + tol)
    best = (box, basis, species)
    min_atoms = n
    for nx in range(1, max_search + 1):
        for ny in range(1, max_search + 1):
            for nz in range(1, max_search + 1):
                div = nx * ny * nz
                if div == 1 or n % div or n // div >= min_atoms:
                    continue
                lim = np.array([1 / nx, 1 / ny, 1 / nz])
                small, ssp = [], []
                valid = True
                for atom, sp in zip(basis, species):
                    if np.all(atom >= -tol) and np.all(atom < lim - tol):
                        f = atom * np.array([nx, ny, nz])
                        f = f - np.floor(f + tol)
                        dup = False
                        for kk, e in enumerate(small):
                            dd = f - e
                            dd = dd - np.round(dd)
                            if np.linalg.norm(dd) < tol:
                                if ssp[kk] != sp:
                                    valid = False
                                dup = True
                                break
                        if not valid:
                            break
                        if not dup:
                            small.append(f)
                            ssp.append(int(sp))
                if not valid or len(small) != n // div:
                    continue
                # verify replication reproduces original cell
                ok = True
                for ix in range(nx):
                    for iy in range(ny):
                        for iz in range(nz):
                            for f, sp in zip(small, ssp):
                                g = (np.asarray(f) + [ix, iy, iz]) / [nx, ny, nz]
                                g = g - np.floor(g + tol)
                                hit = False
                                for atom, osp in zip(basis, species):
                                    dd = g - atom
                                    dd = dd - np.round(dd)
                                    if np.linalg.norm(dd) < tol:
                                        hit = osp == sp
                                        break
                                if not hit:
                                    ok = False
                                    break
                            if not ok:
                                break
                        if not ok:
                            break
                    if not ok:
                        break
                if ok:
                    nb = np.array(
                        [[box[0, 0] / nx, 0, 0], [0, box[1, 1] / ny, 0],
                         [0, 0, box[2, 2] / nz]]
                    )
                    best = (nb, np.array(small), np.array(ssp, dtype=np.int32))
                    min_atoms = n // div
    return best


def build_crystal(
    name,
    structure: str,
    a: float,
    miller1=None,
    miller2=None,
    miller3=None,
    nx: int = 1,
    ny: int = 1,
    nz: int = 1,
    c: Optional[float] = None,
    device="cuda",
):
    """Build a crystal supercell (atomsk-compatible). Returns a System on
    ``device``."""
    from ..core.system import System

    s = _norm_name(structure)
    if s not in _B:
        raise ValueError(f"Unsupported structure {structure!r}; options: {sorted(_B)}")
    names = (name,) if isinstance(name, str) else tuple(name)
    for e in names:
        if e != "X" and e not in atomic_numbers:
            raise ValueError(f"Unknown element symbol {e!r}")
    allowed = _ALLOWED_NSPECIES[s]
    if len(names) not in allowed and len(names) != 1:
        raise ValueError(
            f"name must be one symbol or a tuple of length {allowed} for {s!r}"
        )
    if c is None and s in _C_DEFAULT:
        c = a * _C_DEFAULT[s]
    if c is None and s in ("graphite", "graphene"):
        raise ValueError(f"{s!r} requires an explicit c parameter")

    if miller1 is None and miller2 is None and miller3 is None:
        cell, basis, species = _B[s](a, c)
        if len(names) == 1:
            species = np.zeros(len(species), dtype=np.int32)
    else:
        if s in _MILLER_HEX:
            uvw = [np.array(_hkil_to_uvw(m)) for m in (miller1, miller2, miller3)]
            cell0, basis0, species0 = _B[s](a, c)
            M = np.column_stack(uvw)
            new_cell = M.T @ cell0
            if abs(np.dot(np.cross(new_cell[0], new_cell[1]), new_cell[2])) < 1e-9:
                raise ValueError("Hexagonal Miller directions must be independent")
            basis, species = _atoms_in_supercell(M, basis0, species0)
            cell = _lower_triangular(new_cell)
        else:
            m1, m2, m3 = (_reduce(m) for m in (miller1, miller2, miller3))
            if (
                np.dot(m1, m2) != 0 or np.dot(m1, m3) != 0 or np.dot(m2, m3) != 0
            ):
                raise ValueError(
                    f"Cubic Miller indices must be orthogonal: {m1} {m2} {m3}"
                )
            cell0, basis0, species0 = _B[s](a, c)
            M = np.column_stack([m1, m2, m3]).astype(int)
            new_cell = cell0 @ M.T
            basis, species = _atoms_in_supercell(M, basis0, species0)
            lengths = np.linalg.norm(new_cell, axis=1)
            cell = np.diag(lengths)
        if len(names) == 1:
            species = np.zeros(len(species), dtype=np.int32)
        cell, basis, species = _minimal_cell(cell, basis, species)

    # replicate (vectorized broadcast, repeat_cell.cpp parity)
    pos0 = basis @ cell
    shifts = (
        np.stack(
            np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"),
            axis=-1,
        ).reshape(-1, 3).astype(float)
        @ cell
    )
    pos = (pos0[None] + shifts[:, None]).reshape(-1, 3)
    species_full = np.tile(species, nx * ny * nz)
    supercell = cell * np.array([nx, ny, nz])[:, None]
    if len(names) == 1:
        elements = np.full(len(pos), names[0], dtype=object)
        types = np.ones(len(pos), dtype=np.int32)
    else:
        elements = np.array([names[i] for i in species_full], dtype=object)
        types = (species_full + 1).astype(np.int32)
    return System(
        pos=pos, box=Box(supercell), type_list=types, element_list=elements,
        device=device,
    )


def build_hea(
    element_list,
    element_ratio,
    structure: str,
    a: float,
    miller1=None,
    miller2=None,
    miller3=None,
    nx: int = 1,
    ny: int = 1,
    nz: int = 1,
    c: Optional[float] = None,
    random_seed: Optional[int] = None,
    device="cuda",
):
    """Random HEA on a single sublattice (build_lattice.py:1032)."""
    system = build_crystal("X", structure, a, miller1, miller2, miller3, nx, ny,
                           nz, c=c, device=device)
    return build_hea_fromsystem(system, element_list, element_ratio, random_seed)


def build_hea_fromsystem(system, element_list, element_ratio, random_seed=None):
    """Randomly assign elements by ratio (build_lattice.py:1100)."""
    assert len(element_list) > 1
    assert len(set(element_list)) == len(element_list)
    assert len(element_list) == len(element_ratio)
    assert abs(np.sum(element_ratio) - 1.0) < 1e-6
    counts = np.floor(system.N * np.asarray(element_ratio)).astype(int)
    for i in range(len(element_ratio)):
        if counts[i] == 0 and element_ratio[i] > 1e-6:
            counts[i] += 1
    counts[-1] = system.N - counts[:-1].sum()
    # the shuffle draws the same permutation whatever the array's dtype, so
    # the element indices are shuffled and the names and types gathered
    idx = np.repeat(np.arange(len(element_list)), counts)
    rng = (np.random.mtrand._rand if random_seed is None
           else np.random.RandomState(int(random_seed)))
    rng.shuffle(idx)
    names = np.asarray(element_list)
    system.data["element"] = names[idx].astype(object)
    # element_list holds distinct names, so each one's type is its index + 1
    system.data["type"] = (idx + 1).astype(np.int32)
    return system
