"""Periodic Voronoi polycrystal of FCC grains (the generator of BASELINE
config 3, as the port's smoke run builds it)."""

from __future__ import annotations

import numpy as np

from .elements import rgba
from .lattice import FCC_BASIS


def _rotation(theta_deg: float, axis: int) -> np.ndarray:
    """Rotation by ``theta_deg`` degrees about coordinate axis 0, 1 or 2."""
    t = np.radians(theta_deg)
    c, s = np.cos(t), np.sin(t)
    i, j = [k for k in range(3) if k != axis]
    r = np.eye(3)
    r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
    return r


def polycrystal(box: float, grains: int, seed: int, a: float,
                min_dist: float) -> np.ndarray:
    """One random seed point and one random rotation per grain (drawn from
    ``seed`` in that order), each lattice point kept by the grain whose
    seed is nearest (periodic), then one atom of each pair closer than
    ``min_dist`` removed.  Returns the positions (float64)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    seeds = rng.random((grains, 3)) * box
    theta = rng.uniform(-180.0, 180.0, (grains, 3))
    tree = cKDTree(seeds, boxsize=box)
    # each grain's reach: its farthest owned point of a coarse grid, plus
    # two grid diagonals
    ng = 48
    g = (np.arange(ng) + 0.5) * (box / ng)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    dist, owner = tree.query(grid)
    reach = np.array([dist[owner == i].max() for i in range(grains)])
    reach += 2.0 * np.sqrt(3.0) * box / ng
    parts = []
    for i in range(grains):
        n = int(np.ceil(reach[i] / a)) + 1
        cells = np.mgrid[-n:n, -n:n, -n:n].reshape(3, -1).T
        lat = (cells[:, None] + FCC_BASIS[None]).reshape(-1, 3) * a
        lat = lat[np.einsum("ij,ij->i", lat, lat) <= reach[i] ** 2]
        rot = (_rotation(theta[i, 0], 0) @ _rotation(theta[i, 1], 1)
               @ _rotation(theta[i, 2], 2))
        p = np.mod(lat @ rot.T + seeds[i], box)
        p[p >= box] = 0.0
        parts.append(p[tree.query(p)[1] == i])
    pos = np.concatenate(parts)
    pairs = cKDTree(pos, boxsize=box).query_pairs(min_dist, output_type="ndarray")
    keep = np.ones(len(pos), bool)
    keep[pairs.max(axis=1)] = False
    return pos[keep]


def build(spec: dict, rng: np.random.Generator):
    """(positions, colors, radii) of the configuration's polycrystal; the
    structure comes from the configuration's own ``structure_seed``, so
    ``rng`` draws nothing here."""
    pos = polycrystal(float(spec["box"]), int(spec["grains"]),
                      int(spec["structure_seed"]), float(spec["a"]),
                      float(spec["min_dist"]))
    colors = np.repeat(rgba([spec["element"]]), len(pos), axis=0)
    radii = np.full(len(pos), float(spec["radius"]), np.float32)
    return pos, colors, radii
