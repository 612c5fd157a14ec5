"""Port parity: Voronoi cells and neighbors (``mdapy_tpu_torch/analysis/
voronoi.py``, ``System.cal_voronoi_volume``, ``build_voronoi_neighbor``,
Steinhardt's ``use_voronoi``; ROADMAP A12d).

The same seeded positions go through the JAX package (CPU, float64) and the
port (``device="cpu"``): neighbor counts and lists exact on rattled
inputs (periodic, triclinic, a free slab and a slab whose atoms leave the
box), volumes, cavity radii and face areas within 1e-10 relative, and the
Voronoi-weighted q6 within 1e-12.  On a perfect lattice the faces of one
cell tie in distance, and the two builds (``-march=native`` for the JAX
package, not for the port: ROADMAP C16) round those distances apart in
the last bits, so a row's order among the tied faces differs: there the
rows are compared as sets, and every face that only one package has must
be below 1e-10 Å² (none is, on these lattices); with the JAX flags the
port's rows are the JAX package's in order.  A failed engine build raises:
the port has no scipy fallback (C17).
"""

import numpy as np
import pytest

import mdapy_tpu as mp
from mdapy_tpu.analysis.voronoi import Container as JContainer
from mdapy_tpu.core.box import Box as JBox
import mdapy_tpu_torch as mt
import mdapy_tpu_torch.native as port_native
from mdapy_tpu_torch.analysis.voronoi import Cell, Container
from mdapy_tpu_torch.core.box import Box

from _native_flags import JAX_FLAGS, port_engine_flags, private_jax_build

RTOL = 1e-10
TINY_FACE = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _jax_engine_of_our_own(tmp_path_factory):
    undo = private_jax_build(tmp_path_factory)
    yield
    undo()


def _lattice(kind, a, cells, sigma=0.0, seed=0):
    s = mp.build_crystal("Cu", kind, a, nx=cells[0], ny=cells[1], nz=cells[2])
    pos = np.asarray(s.pos)
    if sigma:
        pos = pos + np.random.default_rng(seed).normal(0.0, sigma, pos.shape)
    return pos, np.asarray(s.box.matrix), np.array([1, 1, 1])


def _triclinic():
    pos, m, b = _lattice("fcc", 3.615, (4, 4, 4))
    shear = np.array([[1.0, 0, 0], [0.25, 1, 0], [0.1, 0.2, 1]])
    pos = pos @ shear + np.random.default_rng(3).normal(0, 0.08, pos.shape)
    return pos, m @ shear, b


def _slab():
    pos, m, _ = _lattice("fcc", 3.615, (4, 4, 4), 0.1, seed=4)
    return pos, m + np.diag([0, 0, 6.0]), np.array([1, 1, 0])


def _outlier_slab():
    """``tests/test_voronoi_api.py:115``'s slab: its bottom layer pushed
    below z = 0, out of the box on its free axis, and rattled."""
    a, nxy, nz = 3.615, 4, 2
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.mgrid[0:nxy, 0:nxy, 0:nz].reshape(3, -1).T
    pos = (frac[None] + cells[:, None]).reshape(-1, 3) * a
    pos[:, 2] -= 0.8
    pos += np.random.default_rng(7).normal(0, 0.08, pos.shape)
    return pos, np.diag([nxy * a, nxy * a, nz * a + 6.0]), np.array([1, 1, 0])


RATTLED = {
    "fcc_rattled": lambda: _lattice("fcc", 3.615, (4, 4, 4), 0.1),
    "bcc_rattled": lambda: _lattice("bcc", 2.8665, (4, 4, 4), 0.08),
    "triclinic": _triclinic,
    "free_slab": _slab,
    "outlier_slab": _outlier_slab,
}
PERFECT = {
    "fcc": lambda: _lattice("fcc", 3.615, (4, 4, 4)),
    "bcc": lambda: _lattice("bcc", 2.8665, (4, 4, 4)),
    "hcp": lambda: _lattice("hcp", 2.5, (4, 4, 4)),
}


def _neighbors(make, **kw):
    pos, m, b = make()
    j = mp.VoronoiAnalysis(pos, JBox(m, b)).compute_neighbors(**kw)
    t = mt.VoronoiAnalysis(pos, Box(m, b), device="cpu").compute_neighbors(**kw)
    return j, t


def _close(got, want, what):
    scale = np.maximum(np.abs(want), 1e-300)
    err = float((np.abs(got - want) / scale).max()) if want.size else 0.0
    assert err <= RTOL, (what, err)


def _same_cells(j, t):
    _close(t.volume, j.volume, "volume")
    _close(t.cavity_radius, j.cavity_radius, "cavity radius")


@pytest.mark.parametrize("name", sorted(RATTLED))
def test_rattled_lists_are_exact(name):
    j, t = _neighbors(RATTLED[name])
    np.testing.assert_array_equal(t.neighbor_number, j.neighbor_number)
    assert t.verlet_list.dtype == j.verlet_list.dtype
    np.testing.assert_array_equal(t.verlet_list, j.verlet_list)
    live = j.verlet_list >= 0
    _close(t.distance_list[live], j.distance_list[live], "distance")
    _close(t.face_areas[live], j.face_areas[live], "face area")
    assert (t.face_areas[~live] == 0).all() and (t.distance_list[~live] == 0).all()
    _same_cells(j, t)


def _as_sets(v):
    return [dict(zip(v.verlet_list[i][v.verlet_list[i] >= 0].tolist(),
                     v.face_areas[i][v.verlet_list[i] >= 0].tolist()))
            for i in range(len(v.verlet_list))]


@pytest.mark.parametrize("name", sorted(PERFECT))
def test_perfect_lattices_equal_as_sets(name):
    j, t = _neighbors(PERFECT[name])
    one_sided = {}
    for i, (a, b) in enumerate(zip(_as_sets(j), _as_sets(t))):
        only = {k: a.get(k, b.get(k)) for k in set(a) ^ set(b)}
        if only:
            one_sided[i] = only
        for k in set(a) & set(b):
            assert abs(a[k] - b[k]) <= RTOL * a[k]
    # a face in one package only would have to be a sliver; none exists here
    assert all(area < TINY_FACE for f in one_sided.values() for area in f.values())
    assert one_sided == {}
    np.testing.assert_array_equal(t.neighbor_number, j.neighbor_number)
    _same_cells(j, t)


@pytest.mark.parametrize("name", sorted(PERFECT))
def test_perfect_rows_keep_jax_order_with_the_jax_build_flags(name):
    """C16's cause: the port's engine built with the JAX package's flags
    gives its rows in the JAX package's order, and its bits."""
    pos, m, b = PERFECT[name]()
    j = mp.VoronoiAnalysis(pos, JBox(m, b)).compute_neighbors()
    with port_engine_flags(JAX_FLAGS):
        t = mt.VoronoiAnalysis(pos, Box(m, b), device="cpu").compute_neighbors()
    for attr in ("verlet_list", "distance_list", "face_areas", "neighbor_number",
                 "volume", "cavity_radius"):
        assert getattr(t, attr).tobytes() == getattr(j, attr).tobytes(), attr


@pytest.mark.parametrize("kw", [
    {"a_face_area_threshold": 0.5}, {"r_face_area_threshold": 0.02},
    {"a_face_area_threshold": 0.3, "r_face_area_threshold": 0.05},
])
def test_face_area_thresholds_match_jax(kw):
    j, t = _neighbors(RATTLED["bcc_rattled"], **kw)
    np.testing.assert_array_equal(t.neighbor_number, j.neighbor_number)
    np.testing.assert_array_equal(t.verlet_list, j.verlet_list)
    live = j.verlet_list >= 0
    _close(t.face_areas[live], j.face_areas[live], "face area")
    assert j.neighbor_number.sum() < _neighbors(RATTLED["bcc_rattled"])[0]\
        .neighbor_number.sum()


@pytest.mark.parametrize("backend", ["native", "qhull"])
def test_volumes_match_jax(backend):
    pos, m, b = RATTLED["triclinic"]() if backend == "native" else \
        _lattice("fcc", 3.615, (2, 2, 2), 0.1)
    j = mp.VoronoiAnalysis(pos, JBox(m, b)).compute(backend=backend)
    t = mt.VoronoiAnalysis(pos, Box(m, b), device="cpu").compute(backend=backend)
    np.testing.assert_array_equal(t.neighbor_number, j.neighbor_number)
    _same_cells(j, t)
    assert abs(t.volume.sum() / abs(np.linalg.det(m)) - 1) < 1e-12


def test_system_methods_match_jax():
    pos, m, b = RATTLED["fcc_rattled"]()
    js = mp.System(pos=pos, box=JBox(m, b))
    ts = mt.System(pos=pos, box=m, boundary=b, device="cpu")
    jc, tc = js.cal_voronoi_volume(), ts.cal_voronoi_volume()
    for col in ("volume", "neighbor_number", "cavity_radius"):
        assert col in ts.data
    np.testing.assert_array_equal(ts.data["neighbor_number"],
                                  js.data["neighbor_number"])
    _same_cells(jc, tc)
    js.build_voronoi_neighbor(r_face_area_threshold=0.01)
    ts.build_voronoi_neighbor(r_face_area_threshold=0.01)
    np.testing.assert_array_equal(ts.voro_verlet_list, js.voro_verlet_list)
    np.testing.assert_array_equal(ts.voro_neighbor_number, js.voro_neighbor_number)
    live = js.voro_verlet_list >= 0
    _close(ts.voro_face_area[live], js.voro_face_area[live], "face area")
    _close(ts.voro_distance_list[live], js.voro_distance_list[live], "distance")


@pytest.mark.parametrize("name,weight", [("fcc_rattled", True),
                                         ("fcc_rattled", False),
                                         ("triclinic", True)])
def test_steinhardt_voronoi_weighted_q6_matches_jax(name, weight):
    pos, m, b = RATTLED[name]()
    kw = dict(llist=(4, 6), use_voronoi=True, use_weight=weight, wlhat=True)
    want = mp.SteinhardtBondOrientation(pos, JBox(m, b), **kw).compute().qnarray
    got = mt.SteinhardtBondOrientation(pos, Box(m, b), device="cpu",
                                       **kw).compute().qnarray
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_steinhardt_voronoi_on_a_perfect_lattice():
    pos, m, b = PERFECT["fcc"]()
    t = mt.System(pos=pos, box=m, device="cpu")
    q = t.cal_steinhardt_bond_orientation(llist=(6,), use_voronoi=True,
                                          use_weight=True)
    j = mp.System(pos=pos, box=m).cal_steinhardt_bond_orientation(
        llist=(6,), use_voronoi=True, use_weight=True)
    np.testing.assert_allclose(q, j, rtol=0, atol=1e-12)
    assert np.allclose(q[:, 0], 0.57452416, atol=1e-4)


def test_cell_info_and_container_match_jax():
    pos, m, b = _lattice("bcc", 2.86, (2, 2, 2), 0.05)
    jv = mp.VoronoiAnalysis(pos, JBox(m)).get_cell_info()
    tv = mt.VoronoiAnalysis(pos, Box(m), device="cpu").get_cell_info()
    for a, b_ in zip(jv, tv):
        assert len(a) == len(b_)
    assert tv[0] == jv[0]                      # faces as vertex-index lists
    np.testing.assert_allclose(np.concatenate([np.ravel(x) for x in tv[1]]),
                               np.concatenate([np.ravel(x) for x in jv[1]]),
                               rtol=0, atol=1e-12)
    for k in (2, 3):
        np.testing.assert_allclose(tv[k], jv[k], rtol=RTOL)
    for x, y in zip(tv[4], jv[4]):
        np.testing.assert_allclose(x, y, rtol=RTOL)
    jc = JContainer(pos, JBox(m))
    tc = Container(pos, Box(m))
    assert len(tc) == len(jc) and isinstance(tc[0], Cell)
    for x, y in zip(tc, jc):
        assert x.face_vertices == y.face_vertices
        np.testing.assert_allclose(x.vertices, y.vertices, rtol=0, atol=1e-12)
        np.testing.assert_allclose([x.volume, x.cavity_radius],
                                   [y.volume, y.cavity_radius], rtol=RTOL)
        np.testing.assert_allclose(x.face_areas, y.face_areas, rtol=RTOL)
        assert np.array_equal(x.pos, y.pos)


def test_a_failed_engine_build_raises(monkeypatch):
    """No fallback: where the JAX package warns and takes scipy, the port's
    ``compute`` and ``compute_neighbors`` raise the compiler's failure."""
    monkeypatch.setattr(port_native, "_cache", {})
    monkeypatch.setattr(port_native, "GXX_FLAGS",
                        port_native.GXX_FLAGS + ["-fno-such-flag"])
    pos, m, b = _lattice("fcc", 3.615, (2, 2, 2), 0.1)
    v = mt.VoronoiAnalysis(pos, Box(m, b), device="cpu")
    for call in (v.compute, v.compute_neighbors):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            call()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        mt.SteinhardtBondOrientation(pos, Box(m, b), use_voronoi=True,
                                     device="cpu").compute()
    assert v.volume is None and v.verlet_list is None
