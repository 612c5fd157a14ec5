"""Polycrystal generation by Voronoi tessellation.

A host copy of ``mdapy_tpu/build/polycrystal.py``: ``VoronoiCell``,
``voronoi_container`` (scipy ``Voronoi`` and ``ConvexHull``), ``_rot``,
``_align_rotation``, ``_points_in_polygon_2d`` and ``CreatePolycrystal``
with its graphene decoration and verbose log (seeds -> periodic Voronoi
cells -> each cell filled with a rotated replicated unit cell, filtered by
the cell's inward face half-spaces), so that the same inputs give the same
float64 bits in both packages.  The one step on the device is the overlap
filter (``_filter_overlaps``, :271-299): the per-pair-type removal rules
over the port's neighbor list on ``device`` (the card unless the caller
passes ``device="cpu"``), which also holds the ``System`` returned.
"""

from __future__ import annotations

from time import time
from typing import Iterable, Optional, Tuple, Union

import numpy as np

from ..core.box import Box, init_box
from ..core.device import resolve_device

__all__ = ["CreatePolycrystal", "VoronoiCell", "voronoi_container"]


class VoronoiCell:
    """One periodic Voronoi cell of a seed point."""

    def __init__(self, pos, vertices, face_vertices, volume, face_areas):
        self.pos = pos                      # seed position
        self.vertices = vertices            # (V, 3)
        self.face_vertices = face_vertices  # list of local vertex-index lists
        self.volume = volume
        self.face_areas = face_areas
        self.cavity_radius = float(
            np.linalg.norm(vertices - pos, axis=1).max()
        ) if len(vertices) else 0.0


def _polygon_area(verts: np.ndarray) -> float:
    c = verts.mean(axis=0)
    v = verts - c
    cross = np.cross(v, np.roll(v, -1, axis=0))
    return 0.5 * float(np.linalg.norm(cross.sum(axis=0)))


def voronoi_container(seeds: np.ndarray, box: Box):
    """Periodic Voronoi tessellation of seed points in an orthogonal box.

    Every seed is imaged over all 27 shifts so each primary cell is bounded;
    returns a list of :class:`VoronoiCell`."""
    from scipy.spatial import ConvexHull, Voronoi

    seeds = np.asarray(seeds, dtype=float)
    n = len(seeds)
    L = np.diag(np.asarray(box.matrix, dtype=float))
    origin = np.asarray(box.origin, dtype=float)
    frac = (seeds - origin) / L
    frac -= np.floor(frac)
    base = frac * L + origin
    shifts = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                  indexing="ij"), axis=-1).reshape(-1, 3)
    # primary copy first so point index i < n is seed i
    order = np.argsort((np.abs(shifts).sum(axis=1) != 0).astype(int),
                       kind="stable")
    pts = (base[None, :, :] + (shifts[order] * L)[:, None, :]).reshape(-1, 3)
    vor = Voronoi(pts)

    ridge_map = [[] for _ in range(n)]
    for (p, q), rverts in zip(vor.ridge_points, vor.ridge_vertices):
        if p < n:
            ridge_map[p].append(rverts)
        if q < n:
            ridge_map[q].append(rverts)

    cells = []
    for i in range(n):
        region = vor.regions[vor.point_region[i]]
        if -1 in region:
            raise RuntimeError("unbounded Voronoi cell; degenerate seeds?")
        gidx = list(region)
        lut = {g: k for k, g in enumerate(gidx)}
        vertices = vor.vertices[gidx]
        faces, areas = [], []
        for rverts in ridge_map[i]:
            if -1 in rverts or not all(v in lut for v in rverts):
                continue
            local = [lut[v] for v in rverts]
            faces.append(local)
            areas.append(_polygon_area(vertices[local]))
        volume = float(ConvexHull(vertices).volume)
        cells.append(VoronoiCell(base[i], vertices, faces, volume,
                                 np.asarray(areas)))
    return cells


def _rot(theta_deg: float, axis) -> np.ndarray:
    """Rodrigues rotation matrix for angle (deg) about axis."""
    axis = np.asarray(axis, dtype=float)
    nrm = np.linalg.norm(axis)
    if nrm == 0:
        raise ValueError("Rotation axis must be non-zero")
    x, y, z = axis / nrm
    t = np.radians(theta_deg)
    c, s = np.cos(t), np.sin(t)
    C = 1.0 - c
    return np.array([
        [c + C * x * x, C * x * y - s * z, C * x * z + s * y],
        [C * y * x + s * z, c + C * y * y, C * y * z - s * x],
        [C * z * x - s * y, C * z * y + s * x, c + C * z * z],
    ])


def _align_rotation(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    v1 = src / np.linalg.norm(src)
    v2 = dst / np.linalg.norm(dst)
    d = float(np.dot(v1, v2))
    if np.isclose(d, 1.0, atol=1e-6):
        return np.eye(3)
    if np.isclose(d, -1.0, atol=1e-6):
        perp = np.array([1.0, 0, 0]) if abs(v1[0]) < 0.9 else np.array([0, 1.0, 0])
        axis = np.cross(v1, perp)
        return _rot(180.0, axis / np.linalg.norm(axis))
    axis = np.cross(v1, v2)
    return _rot(np.degrees(np.arccos(np.clip(d, -1, 1))),
                axis / np.linalg.norm(axis))


def _points_in_polygon_2d(polygon: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Vectorised ray casting (right-going ray, odd crossings = inside)."""
    p1 = polygon
    p2 = np.roll(polygon, -1, axis=0)
    pts = points[:, None, :]
    v1 = p1[None, :, :]
    v2 = p2[None, :, :]
    on_vertex = np.any(np.all(np.isclose(pts, v1, atol=1e-6), axis=2), axis=1)
    y_cross = (v1[:, :, 1] > pts[:, :, 1]) != (v2[:, :, 1] > pts[:, :, 1])
    x_int = (v2[:, :, 0] - v1[:, :, 0]) * (pts[:, :, 1] - v1[:, :, 1]) / (
        v2[:, :, 1] - v1[:, :, 1] + 1e-10
    ) + v1[:, :, 0]
    crossings = np.sum(y_cross & (pts[:, :, 0] < x_int), axis=1)
    return (crossings % 2 == 1) | on_vertex


class CreatePolycrystal:
    """Build a polycrystal: Voronoi grains filled with rotated unit cells,
    optional graphene-decorated grain boundaries, overlap removal."""

    def __init__(
        self,
        unitcell,
        box: Union[int, float, Iterable[float], np.ndarray, Box],
        seed_number: int,
        seed_position: Optional[np.ndarray] = None,
        theta_list: Optional[np.ndarray] = None,
        randomseed: Optional[int] = None,
        metal_overlap_dis: Optional[float] = None,
        add_graphene: bool = False,
        metal_gra_overlap_dis: float = 3.0,
        face_threshold: float = 0.0,
        need_rotation: bool = True,
        device="cuda",
    ):
        self.device = resolve_device(device, "CreatePolycrystal")
        self.unitcell = unitcell
        self.box = init_box(box)
        if int(np.sum(self.box.boundary)) != 3:
            raise ValueError("Free boundary condition is not supported.")
        if self.box.triclinic:
            raise ValueError("Triclinic box is not supported")
        self.seed_number = int(seed_number)
        self.metal_overlap_dis = metal_overlap_dis
        self.add_graphene = add_graphene
        self.metal_gra_overlap_dis = metal_gra_overlap_dis
        self.face_threshold = face_threshold
        self.need_rotation = need_rotation
        if randomseed is None:
            randomseed = np.random.randint(0, 1_000_000_000)
        self.randomseed = int(randomseed)
        self.rng = np.random.default_rng(self.randomseed)
        if seed_position is None:
            self.seed_position = (
                self.rng.random((self.seed_number, 3)) * np.diag(self.box.matrix)
                + self.box.origin
            )
        else:
            seed_position = np.asarray(seed_position, dtype=float)
            if seed_position.shape != (self.seed_number, 3):
                raise ValueError(
                    f"seed_position shape must be ({self.seed_number}, 3), "
                    f"got {seed_position.shape}"
                )
            self.seed_position = seed_position
        if theta_list is None:
            self.theta_list = self.rng.uniform(-180, 180, (self.seed_number, 3))
        else:
            theta_list = np.asarray(theta_list, dtype=float)
            if theta_list.shape != (self.seed_number, 3):
                raise ValueError(
                    f"theta_list shape must be ({self.seed_number}, 3), "
                    f"got {theta_list.shape}"
                )
            self.theta_list = theta_list
        self.con = None

    # ---------------------------------------------------------------- pieces
    @staticmethod
    def _plane_coeffs(cell: VoronoiCell) -> np.ndarray:
        """Inward-pointing [a, b, c, d] per face (a x + b y + c z + d = 0)."""
        coeffs = np.zeros((len(cell.face_vertices), 4))
        for i, face in enumerate(cell.face_vertices):
            p1, p2, p3 = cell.vertices[face[:3]]
            nvec = np.cross(p2 - p1, p3 - p1)
            nrm = np.linalg.norm(nvec)
            if nrm < 1e-10:
                raise ValueError(f"Degenerate face vertices at face {i}")
            nvec = nvec / nrm
            d = -np.dot(nvec, p1)
            # orient inward: the seed must sit on the positive side
            if np.dot(nvec, cell.pos) + d < 0:
                nvec, d = -nvec, -d
            coeffs[i, :3] = nvec
            coeffs[i, 3] = d
        return coeffs

    def _grain_atoms(self, grain_idx, cell, rep_pos, coeffs) -> np.ndarray:
        if self.need_rotation:
            R = (
                _rot(self.theta_list[grain_idx, 0], (1, 0, 0))
                @ _rot(self.theta_list[grain_idx, 1], (0, 1, 0))
                @ _rot(self.theta_list[grain_idx, 2], (0, 0, 1))
            )
        else:
            R = np.eye(3)
        center = rep_pos.mean(axis=0)
        p = (rep_pos - center) @ R.T + cell.pos
        # inward half-space test against every face at once
        inside = np.all(p @ coeffs[:, :3].T + coeffs[:, 3] >= 0.0, axis=1)
        return p[inside]

    def _graphene_atoms(self, cell, gra_pos, coeffs) -> np.ndarray:
        out = []
        normal0 = np.array([0.0, 0.0, 1.0])
        for fi, face in enumerate(cell.face_vertices):
            if cell.face_areas[fi] <= self.face_threshold:
                continue
            verts = cell.vertices[face]
            fn = coeffs[fi, :3] / np.linalg.norm(coeffs[fi, :3])
            center = verts.mean(axis=0)
            R = _align_rotation(normal0, fn)
            rp = gra_pos @ R.T
            rp = rp - rp.mean(axis=0) + center
            # local frame: z along normal, x toward first vertex
            tx = verts[0] - center
            tx = tx - np.dot(tx, fn) * fn
            if np.linalg.norm(tx) < 1e-8:
                tx = verts[1] - center
                tx = tx - np.dot(tx, fn) * fn
            lx = tx / np.linalg.norm(tx)
            ly = np.cross(fn, lx)
            T = np.array([lx, ly, fn])
            v2 = (verts - center) @ T.T
            p2 = (rp - center) @ T.T
            close = np.abs(p2[:, 2]) < 0.5
            inside = _points_in_polygon_2d(
                v2[:, :2].astype(np.float32), p2[:, :2].astype(np.float32)
            )
            sel = rp[close & inside]
            if len(sel):
                out.append(sel)
        assert out, "No graphene atoms generated"
        return np.vstack(out)

    def _filter_overlaps(self, pos, types, grain_id) -> np.ndarray:
        """Boolean keep mask applying the per-pair-type removal rules, as
        masks over the port's neighbor list on the builder's device."""
        import torch

        from ..neighbor.neighbor import neighbor_tensors

        mm = self.metal_overlap_dis if self.metal_overlap_dis is not None else 2.0
        cc = 1.4
        mc = self.metal_gra_overlap_dis if self.add_graphene else 0.0
        rc = max(mm, cc, mc) if self.add_graphene else mm
        verlet, dist, _ = neighbor_tensors(pos, self.box, rc, device=self.device)
        dev = verlet.device
        ok = verlet >= 0
        j = torch.where(ok, verlet, 0).long()
        i = torch.arange(verlet.shape[0], device=dev)[:, None]
        if self.add_graphene:
            t = torch.as_tensor(types, device=dev)
            g = torch.as_tensor(grain_id, device=dev)
            ti, tj = t[:, None], t[j]
            gi, gj = g[:, None], g[j]
            mm_hit = ok & (ti == 1) & (tj == 1) & (dist <= mm) & (i > j)
            mc_hit = ok & (ti == 1) & (tj == 2) & (dist <= mc)
            cc_same = ok & (ti == 2) & (tj == 2) & (dist <= cc) & (gi == gj) & (i > j)
            cc_diff = ok & (ti == 2) & (tj == 2) & (dist <= cc) & (gi > gj)
            hit = mm_hit | mc_hit | cc_same | cc_diff
        else:
            hit = ok & (dist <= mm) & (i > j)
        return (~hit.any(dim=1)).cpu().numpy()

    # ------------------------------------------------------------------ run
    def compute(self, verbose: bool = True):
        from ..core.system import System
        from .lattice import build_crystal

        if verbose:
            start = time()
            print("=" * 70)
            print(" " * 20 + "POLYCRYSTAL GENERATION")
            print("=" * 70)
            print("[1/5] Generating Voronoi tessellation...")
        origin = self.box.origin.copy()
        self.con = voronoi_container(self.seed_position, self.box)
        volumes = np.array([c.volume for c in self.con])
        if verbose:
            print(f"  Number of grains: {self.seed_number}")
            print(f"  Average volume:   {volumes.mean():>10.2f} A^3")
            print(f"  Random seed:      {self.randomseed}")

        r_max = max(c.cavity_radius for c in self.con)
        thickness = self.unitcell.box.get_thickness()
        reps = np.maximum(np.ceil(2.0 * r_max / thickness).astype(int), 1)
        # replicate the unit cell about its own origin so the block covers
        # a sphere of radius r_max after centering
        u = self.unitcell
        shifts = np.stack(np.meshgrid(*[np.arange(r) for r in reps],
                                      indexing="ij"), axis=-1).reshape(-1, 3)
        rep_pos = (
            u.pos[None, :, :] + (shifts.astype(float) @ u.box.matrix)[:, None, :]
        ).reshape(-1, 3)

        gra_pos = None
        if self.add_graphene:
            cc_bond = 1.42
            a_gra = cc_bond * 3 ** 0.5
            target = 2.0 * r_max
            x1 = int(np.ceil(target / a_gra))
            y1 = int(np.ceil(target / (a_gra * 3 ** 0.5 / 2.0)))
            gra = build_crystal("C", "graphene", a_gra, nx=x1, ny=y1, nz=1, c=1.0,
                                device=self.device)
            gra_pos = gra.pos

        if verbose:
            print(f"[2/5] Generating atoms for {self.seed_number} grains...")
        pos_list, gid_list, type_list = [], [], []
        for gidx, cell in enumerate(self.con):
            coeffs = self._plane_coeffs(cell)
            p = self._grain_atoms(gidx, cell, rep_pos, coeffs)
            pos_list.append(p)
            type_list.append(np.ones(len(p), dtype=np.int32))
            n_tot = len(p)
            if self.add_graphene:
                gp = self._graphene_atoms(cell, gra_pos, coeffs)
                pos_list.append(gp)
                type_list.append(np.full(len(gp), 2, dtype=np.int32))
                n_tot += len(gp)
                if verbose:
                    print(f"  Grain {gidx + 1:>3}: metal={len(p):>6} "
                          f"carbon={len(gp):>6}")
            elif verbose:
                print(f"  Grain {gidx + 1:>3}: atoms={len(p):>6}")
            gid_list.append(np.full(n_tot, gidx + 1, dtype=np.int32))

        pos = np.vstack(pos_list)
        grain_id = np.concatenate(gid_list)
        types = np.concatenate(type_list)
        if verbose:
            print(f"  Total atoms generated: {len(pos):,}")
            print("[4/5] Removing overlapping atoms...")

        if self.add_graphene or self.metal_overlap_dis is not None:
            # wrap into the box first so the periodic cell filter sees
            # in-box coordinates
            Lbox = np.diag(self.box.matrix)
            wrapped = pos - origin
            wrapped -= np.floor(wrapped / Lbox) * Lbox
            keep = self._filter_overlaps(wrapped + origin, types, grain_id)
            if verbose:
                removed = int((~keep).sum())
                print(f"  Atoms removed: {removed:,} "
                      f"({removed / len(pos) * 100:.2f}%)")
            pos, grain_id, types = pos[keep], grain_id[keep], types[keep]

        cols = {
            "x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
            "grain_id": grain_id, "type": types,
        }
        if "element" in u.data:
            ele = str(np.asarray(u.data["element"])[0])
            cols["element"] = np.where(types == 1, ele, "C").astype(object)
        system = System(data=cols, box=self.box, device=self.device)
        system.wrap_pos()
        if verbose:
            print("=" * 70)
            print(f" Polycrystal done: {system.N:,} atoms "
                  f"in {time() - start:.2f} s")
            print("=" * 70)
        return system
