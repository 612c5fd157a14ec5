"""Voronoi tessellation: per-atom cell volume, neighbor faces, cavity radius.

The port of ``mdapy_tpu/analysis/voronoi.py`` (:1-502): ``VoronoiAnalysis``
(``_ghosted`` :45, ``_engine_run`` :80, ``compute`` :148, ``_partners``
:203, ``_walls`` :224, ``_cell_geometry`` :240, ``compute_neighbors`` :320,
``get_cell_info`` :412), ``Cell`` and ``Container`` (:458-502).  Outputs
volume, neighbor_number (faces), cavity_radius = max vertex distance, the
face-area-filtered Voronoi neighbor lists used by Steinhardt's Voronoi
weighting (keep faces with area > max(a_threshold, cell_total_area *
r_threshold)), the detailed per-cell geometry of get_cell_info, and the
Cell/Container wrappers.

The cells come from the native clipping engine (``native/voro_engine.cpp``,
OpenMP through ctypes) on the host, as in the JAX package; its neighbor
rows are filtered, sorted by distance and compacted on ``device`` (the card
by default), where ``tensors`` keeps them for the analyses.
``compute(backend="qhull")`` and ``get_cell_info`` take scipy's Qhull with
explicit periodic ghost images, by the caller's choice only.  Where the
JAX package falls back to scipy without a word when the engine does not
build (``voronoi.py:153-163``, ``:336-341``), the port raises (ROADMAP
C17); so ``compute_neighbors`` has no scipy route.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core.box import init_box
from ..core.device import resolve_device

__all__ = ["VoronoiAnalysis", "Cell", "Container"]


class VoronoiAnalysis:
    """``device`` is where ``compute_neighbors`` compacts its rows: "cuda"
    (default) or "cpu"."""

    def __init__(self, pos, box, device="cuda"):
        pos = getattr(pos, "pos", pos)
        self.pos = np.ascontiguousarray(np.asarray(pos, dtype=np.float64))
        self.box = init_box(box)
        self.device = resolve_device(device, "VoronoiAnalysis")
        self.tensors = None
        self.volume = None
        self.neighbor_number = None
        self.cavity_radius = None
        self.verlet_list = None
        self.distance_list = None
        self.face_areas = None

    # ------------------------------------------------------------------
    def _ghosted(self):
        """Original atoms + periodic ghost images within a margin.

        Small systems need ghosts beyond the first image shell (the
        reference replicates the box until N >= 50, voronoi.py:116-127);
        here the shell count per axis grows with the fractional margin.
        """
        box = self.box
        n = len(self.pos)
        # margin: a few typical interatomic spacings bounds the cell extent
        vol = abs(box.volume)
        margin = 4.0 * (vol / max(n, 1)) ** (1.0 / 3.0)
        frac_margin = margin / box.get_thickness()
        frac = (self.pos - box.origin) @ box.inverse_box
        per = box.boundary.astype(bool)
        frac = np.where(per, frac - np.floor(frac), frac)
        shells = [int(np.ceil(frac_margin[d])) if per[d] else 0 for d in range(3)]
        pts = [frac]
        ids = [np.arange(n)]
        for sx in range(-shells[0], shells[0] + 1):
            for sy in range(-shells[1], shells[1] + 1):
                for sz in range(-shells[2], shells[2] + 1):
                    if (sx, sy, sz) == (0, 0, 0):
                        continue
                    g = frac + np.array([sx, sy, sz])
                    keep = np.ones(n, dtype=bool)
                    for d in range(3):
                        keep &= (g[:, d] > -frac_margin[d]) & (g[:, d] < 1 + frac_margin[d])
                    if keep.any():
                        pts.append(g[keep])
                        ids.append(np.nonzero(keep)[0])
        allfrac = np.concatenate(pts, axis=0)
        allids = np.concatenate(ids, axis=0)
        cart = allfrac @ box.matrix + box.origin
        return cart, allids

    def _engine_run(self, max_nei: int = 64):
        """Run the native clipping engine (native/voro_engine.cpp).

        The engine builds its own fractional-space cell grid and walks
        candidate cells outward with the security-radius termination
        (image-aware — no Python-side neighbor list or replication), the
        voro++ growing-block-search idea (reference voronoi.cpp:45-60 /
        v_compute_3d.cc) re-designed around the face-loop clipping cell.
        ``max_ring`` escalates for atoms whose walk was exhausted unclosed
        (sparse/void-heavy systems).

        Returns (volume, cavity, nface, nei_idx, nei_area, nei_dist) for the
        original atoms; neighbor indices are original ids."""
        import ctypes

        from ..native import load_library

        lib = load_library("voro_engine")
        fn = lib.voro_compute_grid
        fn.restype = None

        n = len(self.pos)
        box = self.box
        diam = float(np.linalg.norm(box.matrix.sum(axis=0)))
        walls = self._walls()
        wall_rows = (
            np.array([[w[0][0], w[0][1], w[0][2], w[1]] for w in walls])
            if walls else np.zeros((0, 4))
        )
        # start the seed cube at a few typical spacings — tiny polygons make
        # the early clips cheap; any atom whose cell still touches the cube
        # raises its flag and the loop escalates both cube and ring
        vol_per = abs(box.volume) / max(n, 1)
        h0 = min(4.0 * vol_per ** (1.0 / 3.0), 1.05 * diam)
        pos64 = np.ascontiguousarray(self.pos, np.float64)
        for max_ring in (3, 6, 12, 24, 48, 96):
            volume = np.zeros(n)
            cavity = np.zeros(n)
            nface = np.zeros(n, np.int32)
            flags = np.zeros(n, np.int32)
            nei_idx = np.full((n, max_nei), -1, np.int32)
            nei_area = np.zeros((n, max_nei))
            nei_dist = np.zeros((n, max_nei))
            fn(
                pos64.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_int64(n),
                np.ascontiguousarray(box.matrix).ctypes.data_as(ctypes.c_void_p),
                np.ascontiguousarray(box.inverse_box).ctypes.data_as(ctypes.c_void_p),
                np.ascontiguousarray(box.origin).ctypes.data_as(ctypes.c_void_p),
                np.ascontiguousarray(box.boundary, np.int32).ctypes.data_as(ctypes.c_void_p),
                np.ascontiguousarray(wall_rows).ctypes.data_as(ctypes.c_void_p),
                ctypes.c_int64(len(wall_rows)), ctypes.c_double(h0),
                ctypes.c_int32(max_ring),
                volume.ctypes.data_as(ctypes.c_void_p),
                cavity.ctypes.data_as(ctypes.c_void_p),
                nface.ctypes.data_as(ctypes.c_void_p),
                flags.ctypes.data_as(ctypes.c_void_p),
                nei_idx.ctypes.data_as(ctypes.c_void_p),
                nei_area.ctypes.data_as(ctypes.c_void_p),
                nei_dist.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_int64(max_nei),
                ctypes.c_int32(0),
            )
            if not flags.any():
                break
            h0 = min(4.0 * h0, 1.05 * diam)
        return volume, cavity, nface, nei_idx, nei_area, nei_dist

    def compute(self, backend: str = "native"):
        """Per-atom volume / face count / cavity radius.

        ``backend='native'`` uses the OpenMP C++ clipping engine (fast path,
        1M-atom capable); ``'qhull'`` keeps the scipy reference path."""
        if backend == "native":
            out = self._engine_run()
            self.volume, self.cavity_radius, self.neighbor_number = out[:3]
            return self
        if backend != "qhull":
            raise ValueError(f"backend must be 'native' or 'qhull', not {backend!r}")

        from scipy.spatial import ConvexHull

        cart, ids = self._ghosted()
        n = len(self.pos)
        box = self.box
        per = box.boundary.astype(bool)
        volume = np.zeros(n)
        cavity = np.zeros(n)
        nface = np.zeros(n, dtype=np.int32)
        partners = self._partners(cart, n, per)
        walls = self._walls()
        for i in range(n):
            verts, faces, areas = self._cell_geometry(cart, i, partners[i], walls)
            hull = None
            if verts is not None:
                try:
                    hull = ConvexHull(verts)
                except Exception:
                    hull = None
            if hull is None:
                import warnings

                warnings.warn(
                    f"Voronoi cell construction failed for atom {i}; "
                    "its volume is reported as 0", RuntimeWarning,
                )
                continue
            volume[i] = hull.volume
            cavity[i] = np.max(np.linalg.norm(verts - cart[i], axis=1))
            nface[i] = len(faces)
        self.volume = volume
        self.neighbor_number = nface
        self.cavity_radius = cavity
        return self

    # ------------------------------------------------------------------
    def _partners(self, cart, n, per):
        """Candidate bisector partners per original atom."""
        if per.all():
            from scipy.spatial import Voronoi

            vor = Voronoi(cart)
            partners = [[] for _ in range(n)]
            for (a, b) in vor.ridge_points:
                if a < n:
                    partners[a].append(b)
                if b < n:
                    partners[b].append(a)
            return partners
        from scipy.spatial import cKDTree

        vol = abs(self.box.volume)
        r_ball = 8.0 * (vol / max(n, 1)) ** (1.0 / 3.0)
        tree = cKDTree(cart)
        balls = tree.query_ball_point(cart[:n], r_ball)
        return [[p for p in ball if p != i] for i, ball in enumerate(balls)]

    def _walls(self):
        """Wall half-spaces for free dims (container clipping, voro++ parity)."""
        box = self.box
        per = box.boundary.astype(bool)
        walls = []
        for d in range(3):
            if per[d]:
                continue
            nvec = box.matrix[d] / np.linalg.norm(box.matrix[d])
            lo = float(nvec @ box.origin)
            hi = float(nvec @ (box.origin + box.matrix[d]))
            walls.append((-nvec, lo))    # n.x >= lo  ->  -n.x + lo <= 0
            walls.append((nvec, -hi))    # n.x <= hi  ->   n.x - hi <= 0
        return walls

    @staticmethod
    def _cell_geometry(cart, i, partner_ids, walls):
        """Exact cell polytope and its finite-area faces.

        Returns (vertices (M,3), faces [list of ordered vertex-index lists],
        face_info [(plane_row, area)]).  Planes carrying a finite-area facet
        count as faces (wall facets included, voro++ parity; degenerate
        vertex-touching planes excluded — in perfect lattices second-shell
        bisectors pass through cell vertices).
        """
        from scipy.spatial import HalfspaceIntersection

        x = cart[i]
        A = []
        b = []
        for p in partner_ids:
            nvec = cart[p] - x
            mid = 0.5 * (cart[p] + x)
            A.append(nvec)
            b.append(-float(nvec @ mid))
        for nvec, off in walls:
            A.append(nvec)
            b.append(off)
        if not A:
            return None, [], []
        A = np.asarray(A)
        b = np.asarray(b)
        norms = np.linalg.norm(A, axis=1)
        interior = x
        slack = A @ x + b
        if np.any(slack >= -1e-12):
            # interior point via Chebyshev center (robust for on-wall atoms)
            from scipy.optimize import linprog

            res = linprog(
                c=np.r_[np.zeros(3), -1.0],
                A_ub=np.c_[A, norms],
                b_ub=-b,
                bounds=[(None, None)] * 3 + [(1e-12, None)],
                method="highs",
            )
            if not res.success:
                return None, [], []
            interior = res.x[:3]
        try:
            hs = HalfspaceIntersection(np.c_[A, b], interior)
        except Exception:
            return None, [], []
        verts = hs.intersections
        dist = np.abs(verts @ A.T + b) / norms
        faces = []
        face_info = []
        for p in range(A.shape[0]):
            on_idx = np.nonzero(dist[:, p] < 1e-7)[0]
            if len(on_idx) < 3:
                continue
            onp = verts[on_idx]
            c0 = onp.mean(axis=0)
            rel = onp - c0
            # order vertices by angle in the face plane
            nrm = A[p] / norms[p]
            u = rel[0] - (rel[0] @ nrm) * nrm
            un = np.linalg.norm(u)
            if un < 1e-12:
                continue
            u /= un
            v = np.cross(nrm, u)
            ang = np.arctan2(rel @ v, rel @ u)
            order = np.argsort(ang)
            poly = onp[order]
            area = 0.0
            for k in range(len(poly)):
                v1 = poly[k] - c0
                v2 = poly[(k + 1) % len(poly)] - c0
                area += 0.5 * np.linalg.norm(np.cross(v1, v2))
            if area < 1e-10:
                continue
            faces.append([int(on_idx[o]) for o in order])
            face_info.append((p, area))
        return verts, faces, face_info

    # ------------------------------------------------------------------
    def compute_neighbors(
        self,
        a_face_area_threshold: float = -1.0,
        r_face_area_threshold: float = -1.0,
    ):
        """Voronoi neighbor lists with face areas (reference voronoi.py:71).

        Keeps faces with area > max(a_threshold, total_cell_area * r_threshold)
        (voronoi.cpp:252-265).  Rows are compacted and distance-sorted
        (stable: equal distances keep the engine's order); -1 pads unfilled
        slots.  ``tensors`` keeps (verlet, dist, neighbor_number,
        face_areas) on ``device``.
        """
        import torch

        vol, cav, _, nei_idx, nei_area, nei_dist = self._engine_run()
        dev = self.device
        nei_idx = torch.as_tensor(nei_idx, device=dev)
        nei_area = torch.as_tensor(nei_area, device=dev)
        nei_dist = torch.as_tensor(nei_dist, device=dev)
        n = nei_idx.shape[0]
        ok = nei_idx >= 0
        area_min = torch.full((n,), max(a_face_area_threshold, 0.0),
                              dtype=torch.float64, device=dev)
        if r_face_area_threshold > 0:
            total = torch.sum(torch.where(ok, nei_area, 0.0), dim=1)
            area_min = torch.maximum(area_min, total * r_face_area_threshold)
        keep = ok & (nei_area > area_min[:, None])
        big = torch.where(keep, nei_dist, torch.inf)
        order = torch.sort(big, dim=1, stable=True).indices
        verlet = torch.gather(torch.where(keep, nei_idx, -1), 1, order)
        dist = torch.gather(torch.where(keep, nei_dist, 0.0), 1, order)
        areas = torch.gather(torch.where(keep, nei_area, 0.0), 1, order)
        nn = keep.sum(dim=1).int()
        Mc = max(1, int(nn.max()) if n else 1)
        self.tensors = (verlet[:, :Mc].contiguous(), dist[:, :Mc].contiguous(),
                        nn, areas[:, :Mc].contiguous())
        self.verlet_list, self.distance_list, self.neighbor_number, \
            self.face_areas = (t.cpu().numpy() for t in self.tensors)
        self.volume = vol
        self.cavity_radius = cav
        return self

    # ------------------------------------------------------------------
    def get_cell_info(self):
        """Detailed per-cell geometry (reference voronoi.py:184).

        Returns (face_vertices_indices, face_vertices_positions, volume,
        radius, face_areas) — per atom: faces as vertex-index lists into the
        atom's unique vertex array (voronoi.cpp:499-531 layout), that vertex
        array as (M, 3) coordinates, cell volume, cavity radius (farthest
        vertex), and per-face areas.  Orthogonal boxes only (reference
        asserts the same, voronoi.py:234).
        """
        assert not self.box.triclinic, "Only support orthogonal box."
        assert len(self.pos) > 1, "At least has one atom."
        from scipy.spatial import ConvexHull

        cart, ids = self._ghosted()
        n = len(self.pos)
        per = self.box.boundary.astype(bool)
        partners = self._partners(cart, n, per)
        walls = self._walls()
        fvi: List[List[List[int]]] = []
        fvp: List[List[List[float]]] = []
        volume: List[float] = []
        radius: List[float] = []
        fareas: List[List[float]] = []
        for i in range(n):
            verts, faces, face_info = self._cell_geometry(cart, i, partners[i], walls)
            if verts is None:
                fvi.append([])
                fvp.append([])
                volume.append(0.0)
                radius.append(0.0)
                fareas.append([])
                continue
            try:
                vol = float(ConvexHull(verts).volume)
            except Exception:
                vol = 0.0
            fvi.append(faces)
            fvp.append([list(map(float, v)) for v in verts])
            volume.append(vol)
            radius.append(float(np.max(np.linalg.norm(verts - cart[i], axis=1))))
            fareas.append([float(a) for (_, a) in face_info])
        return fvi, fvp, volume, radius, fareas


@dataclass
class Cell:
    """Geometry of one Voronoi cell (reference voronoi.py:331-369)."""

    face_vertices: List[List[int]]
    vertices: np.ndarray
    volume: float
    cavity_radius: float
    face_areas: np.ndarray
    pos: np.ndarray


class Container:
    """List-like access to every atom's Voronoi Cell (reference voronoi.py:372).

    Accepts an (N, 3) position array or any object with a ``pos`` attribute
    (e.g. System / AtomFrame).  The cells are built on the host (scipy's
    Qhull), so it takes no device.
    """

    def __init__(self, data, box):
        pos = np.asarray(getattr(data, "pos", data), dtype=np.float64)
        assert pos.ndim == 2 and pos.shape[1] == 3
        vor = VoronoiAnalysis(pos, box, device="cpu")  # host geometry only
        fvi, fvp, volume, radius, fareas = vor.get_cell_info()
        self._data: List[Cell] = []
        for i in range(len(pos)):
            self._data.append(
                Cell(
                    fvi[i],
                    np.asarray(fvp[i], np.float64).reshape(-1, 3),
                    volume[i],
                    radius[i],
                    np.asarray(fareas[i], np.float64),
                    pos[i].copy(),
                )
            )

    def __getitem__(self, index: int):
        return self._data[index]

    def __len__(self):
        return len(self._data)

    def __iter__(self):
        return iter(self._data)
