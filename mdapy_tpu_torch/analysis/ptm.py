"""Polyhedral template matching (Larsen, Schmidt & Schiotz, MSMSE 2016).

The port of ``mdapy_tpu/analysis/ptm.py`` (:1-322): the templates
(``_template_points`` :36, ``_two_shell_template`` :71 over the port's own
``build/lattice.py``), the triangulation variants through scipy's Qhull
(``_poly_triangulations`` :111, ``_template_variants`` :124,
``_diamond_template_variants`` :168), the engine bootstrap (``_get_engine``
:198) and ``PolyhedralTemplateMatching`` (:236).  Structure codes: 0 Other,
1 FCC, 2 HCP, 3 BCC, 4 ICO, 5 SC, 6 DCUB, 7 DHEX, 8 Graphene.

The 18 nearest neighbours come from the port's ``knn_tensors`` on the
device; only their indices come back to the host.  The minimum-image
displacements are built there in float64 numpy exactly as the JAX package
writes them (``disp @ inv``, ``round``, ``@ matrix``, :289-296), so the
engine sees the same input bits whichever device found the neighbours (a
card GEMM would round differently).  The per-atom matching runs in the
native engine (``native/ptm_engine.cpp``, OpenMP through ctypes), as in
the JAX package.

Among mappings of equal RMSD the engine keeps the first it finds, so on a
perfect lattice the template order of ``ptm_indices`` follows the order in
which the kNN breaks distance ties; the set of each row does not (ROADMAP
C10).
"""

from __future__ import annotations

import ctypes
import itertools
import os

import numpy as np

from ..core.box import init_box
from ..core.device import resolve_device

__all__ = ["PolyhedralTemplateMatching"]

_S3 = np.sqrt(3.0)
_S6 = np.sqrt(6.0)

PTM_OTHER, PTM_FCC, PTM_HCP, PTM_BCC, PTM_ICO, PTM_SC = 0, 1, 2, 3, 4, 5
PTM_DCUB, PTM_DHEX, PTM_GRAPHENE = 6, 7, 8

_STRUCT_IDS = {
    "fcc": PTM_FCC, "hcp": PTM_HCP, "bcc": PTM_BCC, "ico": PTM_ICO,
    "sc": PTM_SC, "dcub": PTM_DCUB, "dhex": PTM_DHEX,
    "graphene": PTM_GRAPHENE,
}

# the neighbours PTM reads, and the thickness a periodic box is tiled to
K_NEIGHBORS = 18
REPLICATE_RC = 7.5


def _template_points(name: str) -> np.ndarray:
    """Ideal neighbour shells (central atom first), raw scale."""
    if name == "fcc":
        pts = [(sa * x, sb * y, sc * z)
               for x, y, z in [(1, 1, 0), (1, 0, 1), (0, 1, 1)]
               for sa in (-1, 1) for sb in (-1, 1) for sc in (-1, 1)]
        pts = np.unique(np.array(pts, float), axis=0)
        return np.vstack([[0, 0, 0], pts])
    if name == "hcp":
        # ideal hcp (c/a = sqrt(8/3)), nearest-neighbour distance 1
        inplane = [(1, 0, 0), (-1, 0, 0), (0.5, _S3 / 2, 0), (-0.5, _S3 / 2, 0),
                   (0.5, -_S3 / 2, 0), (-0.5, -_S3 / 2, 0)]
        tri = [(0.5, _S3 / 6), (-0.5, _S3 / 6), (0.0, -_S3 / 3)]
        out = [(x, y, s * _S6 / 3) for s in (-1, 1) for (x, y) in tri]
        return np.vstack([[0, 0, 0], np.array(inplane + out, float)])
    if name == "bcc":
        first = [(sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
        second = [(2, 0, 0), (-2, 0, 0), (0, 2, 0), (0, -2, 0), (0, 0, 2), (0, 0, -2)]
        return np.vstack([[0, 0, 0], np.array(first + second, float)])
    if name == "ico":
        phi = (1 + np.sqrt(5)) / 2
        pts = []
        for a, b in itertools.product((-1.0, 1.0), (-phi, phi)):
            pts += [(0, a, b), (a, b, 0), (b, 0, a)]
        return np.vstack([[0, 0, 0], np.array(pts, float)])
    if name == "sc":
        pts = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
        return np.vstack([[0, 0, 0], np.array(pts, float)])
    if name in ("dcub", "dhex", "graphene"):
        return _two_shell_template(name)
    raise ValueError(name)


def _two_shell_template(name: str) -> np.ndarray:
    """[central, inner shell, outer grouped per inner] generated numerically
    from the ideal lattice (cubic diamond / lonsdaleite / graphene)."""
    from ..build.lattice import build_crystal

    if name == "dcub":
        s = build_crystal("C", "diamond", 3.0, nx=3, ny=3, nz=3, device="cpu")
        ni, no = 4, 3
    elif name == "dhex":
        a = 2.0
        s = build_crystal("C", "lonsdaleite", a, nx=3, ny=3, nz=3,
                          c=a * np.sqrt(8.0 / 3.0), device="cpu")
        ni, no = 4, 3
    else:
        s = build_crystal("C", "graphene", 2.0, nx=4, ny=4, nz=1, c=20.0,
                          device="cpu")
        ni, no = 3, 2
    pos = s.pos
    box = s.box
    inv = np.linalg.inv(box.matrix)
    center = box.origin + 0.5 * np.sum(box.matrix, axis=0)
    ci = int(np.argmin(np.linalg.norm(pos - center, axis=1)))

    def bonds_of(i):
        d = pos - pos[i]
        frac = d @ inv
        frac -= np.round(frac) * box.boundary
        d = frac @ box.matrix
        r = np.linalg.norm(d, axis=1)
        r[i] = np.inf
        nn = np.argsort(r, kind="stable")[: ni]
        return d[nn], nn

    inner_d, inner_idx = bonds_of(ci)
    rows = [np.zeros(3)]
    rows += [v for v in inner_d]
    for v, j in zip(inner_d, inner_idx):
        bd, _ = bonds_of(int(j))
        outs = [v + b for b in bd if np.linalg.norm(v + b) > 1e-6]
        assert len(outs) == no, (name, len(outs))
        rows += outs
    return np.array(rows, float)


def _poly_triangulations(idx):
    """All triangulations of a convex polygon given CCW vertex ids."""
    if len(idx) == 3:
        return [[(idx[0], idx[1], idx[2])]]
    out = []
    a, b = idx[0], idx[-1]
    for k in range(1, len(idx) - 1):
        for left in _poly_triangulations(idx[: k + 1]) if k >= 2 else [[]]:
            for right in _poly_triangulations(idx[k:]) if len(idx) - k >= 3 else [[]]:
                out.append(left + right + [(a, idx[k], b)])
    return out


def _template_variants(nbr_pts: np.ndarray):
    """Enumerate outward-oriented triangulations of the template hull,
    covering every way a degenerate (coplanar) face can triangulate."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(nbr_pts)
    eqs = hull.equations
    # group coplanar facets
    groups = []
    used = np.zeros(len(eqs), bool)
    for i in range(len(eqs)):
        if used[i]:
            continue
        close = np.where(
            (np.abs(eqs[:, :3] @ eqs[i, :3] - 1.0) < 1e-6)
            & (np.abs(eqs[:, 3] - eqs[i, 3]) < 1e-6) & ~used
        )[0]
        used[close] = True
        groups.append(close)
    faces = []
    for g in groups:
        verts = np.unique(hull.simplices[g])
        n = eqs[g[0], :3]
        c = nbr_pts[verts].mean(axis=0)
        # CCW order viewed from outside (normal points outward)
        ref = nbr_pts[verts[0]] - c
        ref = ref - np.dot(ref, n) * n
        ref /= np.linalg.norm(ref)
        ref2 = np.cross(n, ref)
        ang = np.arctan2((nbr_pts[verts] - c) @ ref2, (nbr_pts[verts] - c) @ ref)
        order = verts[np.argsort(ang)]
        faces.append(list(order))
    per_face = [_poly_triangulations(f) for f in faces]
    variants = []
    for combo in itertools.product(*per_face):
        tri = [t for face_tris in combo for t in face_tris]
        variants.append(tri)
    nf = len(variants[0])
    arr = np.array(variants, dtype=np.int32)  # (n_var, nf, 3)
    return arr, nf


def _diamond_template_variants(nbr_pts: np.ndarray):
    """Variants for the 16-point diamond neighbourhood: triangulate the hull
    of the 12 outer atoms (the 4 inner atoms are interior), then apply the
    same facet surgery as the runtime matcher — each all-outer facet whose
    vertices share one inner group is replaced by 3 facets through that
    inner atom."""
    base, _ = _template_variants(nbr_pts)  # hull of all 16 -> outers only
    out = []
    for tri_list in base:
        facets = [tuple(int(v) for v in t) for t in tri_list]
        surg = []
        toadd = []
        for (a, b, c) in facets:
            if a >= 4 and b >= 4 and c >= 4 and \
                    (a - 4) // 3 == (b - 4) // 3 == (c - 4) // 3:
                toadd.append((a, b, c))
            else:
                surg.append((a, b, c))
        assert len(toadd) == 4, len(toadd)
        for (a, b, c) in toadd:
            i0 = (a - 4) // 3
            surg += [(i0, b, c), (a, i0, c), (a, b, i0)]
        out.append(surg)
    arr = np.array(out, dtype=np.int32)
    return arr, arr.shape[1]


_ENGINE = None
_TEMPLATE_IDX = {}


def _P(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _get_engine():
    """The native engine with the eight templates bootstrapped, built and
    loaded once a process (g++ at first use; a failed build raises)."""
    global _ENGINE
    if _ENGINE is not None:
        return _ENGINE
    from ..native import load_library

    lib = load_library("ptm_engine")
    lib.ptmx_create.restype = ctypes.c_void_p
    ctx = lib.ptmx_create()
    for name in ("fcc", "hcp", "bcc", "ico", "sc", "dcub", "dhex", "graphene"):
        pts = np.ascontiguousarray(_template_points(name), dtype=np.float64)
        nnb = len(pts) - 1
        colours = np.zeros(nnb, dtype=np.int32)
        if name in ("dcub", "dhex"):
            kind = 1
            colours[:4] = 1
            variants, nf = _diamond_template_variants(pts[1:])
        elif name == "graphene":
            kind = 2
            variants = np.zeros((0, 0, 3), dtype=np.int32)
            nf = 0
        else:
            kind = 0
            variants, nf = _template_variants(pts[1:])
        idx = lib.ptmx_add_template(
            ctypes.c_void_p(ctx), _STRUCT_IDS[name], nnb, _P(pts),
            len(variants), nf, _P(np.ascontiguousarray(variants)),
            1 if name == "sc" else 0, _P(colours), kind,
        )
        if idx < 0:
            raise RuntimeError(f"PTM template bootstrap failed for {name}")
        _TEMPLATE_IDX[name] = idx
    _ENGINE = (lib, ctx)
    return _ENGINE


def engine_threads() -> int:
    """The OpenMP threads the engine is given (every core, as the JAX
    package gives it)."""
    return os.cpu_count() or 1


class PolyhedralTemplateMatching:
    """PTM classifier.

    output: (N, 8) array — columns: structure type, ordering type, RMSD,
    interatomic distance, orientation quaternion (w, x, y, z).
    ptm_indices: (N, 18) template-ordered neighbour indices (-1 padded).
    ``device`` is where the neighbours are found: "cuda" (default) or
    "cpu"."""

    def __init__(self, structure: str, pos, box, rmsd_threshold: float = 0.1,
                 types=None, device="cuda"):
        valid = set(_STRUCT_IDS) | {"all", "default"}
        for s in structure.split("-"):
            if s not in valid:
                raise ValueError(
                    'Structure should be in ["fcc", "hcp", "bcc", "ico", "sc", '
                    '"dcub", "dhex", "graphene", "all", "default"].'
                )
        self.structure = structure
        self.pos = np.ascontiguousarray(pos, dtype=np.float64)
        self.box = init_box(box)
        self.rmsd_threshold = float(rmsd_threshold)
        self.types = types
        self.device = resolve_device(device, "PolyhedralTemplateMatching")
        self.output = None
        self.ptm_indices = None

    def _enabled_names(self):
        req = set()
        for s in self.structure.split("-"):
            if s == "all":
                req |= set(_STRUCT_IDS)
            elif s == "default":
                req |= {"fcc", "hcp", "bcc"}
            else:
                req.add(s)
        return req

    def neighbors(self):
        """(replicated positions, their box, kNN indices (N, k) int64 on
        the host): the tiling for thin periodic boxes, then the k nearest
        on ``self.device``."""
        from ..neighbor.knn import knn_tensors
        from ..neighbor.neighbor import replicate_for_small_box

        # replicate thin periodic boxes so 18 genuine neighbours exist
        pos, box, _ = replicate_for_small_box(self.pos, self.box, REPLICATE_RC)
        k = min(K_NEIGHBORS, len(pos) - 1)
        indices, _ = knn_tensors(pos, box, k, device=self.device)
        return pos, box, indices.cpu().numpy().astype(np.int64)

    def match(self, pos, box, indices):
        """The engine on the host over the min-image displacements of
        ``indices``: (output (N, 8), matched atoms (N, 20) int64)."""
        N, k = indices.shape
        disp = pos[indices] - pos[:, None, :]
        # min-image, in float64 numpy as the JAX package writes it
        inv = np.linalg.inv(box.matrix)
        frac = disp @ inv
        per = box.boundary.astype(float)
        frac -= np.round(frac) * per
        disp = frac @ box.matrix

        lib, ctx = _get_engine()
        enabled = np.zeros(len(_TEMPLATE_IDX), dtype=np.int32)
        for name in self._enabled_names() & set(_TEMPLATE_IDX):
            enabled[_TEMPLATE_IDX[name]] = 1
        out = np.zeros((N, 8))
        out_atoms = np.zeros((N, 20), dtype=np.int64)
        counts = np.full(N, k, dtype=np.int32)
        disp = np.ascontiguousarray(disp)
        idx64 = np.ascontiguousarray(indices, dtype=np.int64)
        lib.ptmx_compute(
            ctypes.c_void_p(ctx), ctypes.c_longlong(N), k, _P(disp), _P(idx64),
            _P(counts), _P(enabled), ctypes.c_double(self.rmsd_threshold),
            _P(out), _P(out_atoms), engine_threads(),
        )
        return out, out_atoms

    def compute(self):
        N0 = len(self.pos)
        req = self._enabled_names()
        unsupported = req - {"fcc", "hcp", "bcc", "ico", "sc"}
        if unsupported - {"dcub", "dhex", "graphene"}:
            raise ValueError(f"unknown structures {unsupported}")

        if int(np.sum(self.box.boundary)) == 0 and N0 <= K_NEIGHBORS:
            self.output = np.zeros((N0, 8))
            self.ptm_indices = np.full((N0, K_NEIGHBORS), -1, np.int32)
            return self

        out, out_atoms = self.match(*self.neighbors())
        # matched atoms (template order, central first) mod N0 for replicas
        idx_full = np.where(
            out_atoms[:, :18] >= 0, out_atoms[:, :18] % N0, -1
        ).astype(np.int32)
        self.output = out[:N0]
        self.ptm_indices = idx_full[:N0]
        return self
