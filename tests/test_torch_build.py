"""The port's crystal builders (ROADMAP A12b) against the JAX package's, on
the CPU: ``build_crystal`` for every structure of
``tests/test_build_crystal.py`` (plain and Miller-oriented), ``build_hea``,
each case of ``tests/test_orthogonal_cell.py`` and ``CreatePolycrystal`` on
small seeded boxes.  The builders are host copies, so positions, types,
elements and boxes must be equal bit for bit; the overlap filter runs on the
port's neighbor list, and its keep mask must equal the JAX one.  Nothing
here reads the reference package's input files (ROADMAP C2)."""

import numpy as np
import pytest

import mdapy_tpu as mp
import mdapy_tpu_torch as mt
from mdapy_tpu.build.polycrystal import voronoi_container as jax_voronoi
from mdapy_tpu_torch.build.polycrystal import voronoi_container as port_voronoi
from test_build_crystal import MILLER_CASES, PLAIN_CASES

CPU = "cpu"


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _assert_same_system(j, t):
    """Positions, box, every column (floats and ints bit for bit, element
    names by value)."""
    assert t.N == j.N
    assert _same_bits(t.pos, j.pos)
    assert _same_bits(t.box.matrix, j.box.matrix)
    assert _same_bits(t.box.origin, j.box.origin)
    assert np.array_equal(t.box.boundary, j.box.boundary)
    assert list(t.data.columns) == list(j.data.columns)
    for c in j.data.columns:
        a, b = np.asarray(j.data[c]), np.asarray(t.data[c])
        if a.dtype.kind in "OUS":
            assert b.dtype == a.dtype and b.tolist() == a.tolist(), c
        else:
            assert _same_bits(b, a), c


CASES = PLAIN_CASES + MILLER_CASES


@pytest.mark.parametrize("name,elements,kwargs", CASES, ids=[c[0] for c in CASES])
def test_build_crystal_matches_jax(name, elements, kwargs):
    _assert_same_system(mp.build_crystal(elements, **kwargs),
                        mt.build_crystal(elements, **kwargs, device=CPU))


@pytest.mark.parametrize("structure,a,reps", [("fcc", 3.615, (3, 2, 2)),
                                              ("hcp", 3.21, (2, 3, 2)),
                                              ("graphene", 2.46, (4, 3, 1))])
def test_build_crystal_replicated_matches_jax(structure, a, reps):
    kw = dict(nx=reps[0], ny=reps[1], nz=reps[2])
    if structure == "graphene":
        kw["c"] = 3.35
    _assert_same_system(mp.build_crystal("C", structure, a, **kw),
                        mt.build_crystal("C", structure, a, **kw, device=CPU))


def test_build_crystal_errors_and_registry():
    assert sorted(mt.LatticeRegistry) == sorted(mp.LatticeRegistry)
    for args, match in ((("Cu", "nope", 3.6), "Unsupported structure"),
                        (("Qq", "fcc", 3.6), "Unknown element"),
                        (("C", "graphene", 2.46), "requires an explicit c"),
                        (("Cu", "fcc", 3.6, (1, 1, 0), (1, 0, 0), (0, 0, 1)),
                         "orthogonal")):
        with pytest.raises(ValueError, match=match):
            mp.build_crystal(*args)
        with pytest.raises(ValueError, match=match):
            mt.build_crystal(*args, device=CPU)


@pytest.mark.parametrize("seed", [1, 7])
def test_build_hea_matches_jax(seed):
    args = (("Co", "Ni", "Cr", "Fe", "Mn"), (0.2,) * 5, "fcc", 3.59)
    j = mp.build_hea(*args, nx=4, ny=4, nz=3, random_seed=seed)
    t = mt.build_hea(*args, nx=4, ny=4, nz=3, random_seed=seed, device=CPU)
    _assert_same_system(j, t)
    counts = np.unique(np.asarray(t.data["element"]).astype(str),
                       return_counts=True)[1]
    assert sorted(counts.tolist()) == [38, 38, 38, 38, 40]


def test_build_hea_global_stream_without_seed():
    args = (("Al", "Cu"), (0.3, 0.7), "bcc", 2.9)
    np.random.seed(5)
    j = mp.build_hea(*args, nx=3, ny=3, nz=3)
    np.random.seed(5)
    t = mt.build_hea(*args, nx=3, ny=3, nz=3, device=CPU)
    _assert_same_system(j, t)


def _hcp(pkg, **kw):
    extra = {} if pkg is mp else {"device": CPU}
    return pkg.build_crystal("Mg", "hcp", a=3.21, c=5.21, **kw, **extra)


ORTHO = {
    "hcp": lambda pkg: (_hcp(pkg), {}),
    "cubic_passthrough": lambda pkg: (pkg.build_crystal(
        "Cu", "fcc", 3.615, nx=2, ny=2, nz=2,
        **({} if pkg is mp else {"device": CPU})), {}),
    "wurtzite": lambda pkg: (pkg.build_crystal(
        ("Ga", "N"), "wurtzite", a=3.19, c=5.18,
        **({} if pkg is mp else {"device": CPU})), {}),
    "find_minimal_replicated": lambda pkg: (_hcp(pkg, nx=2, ny=2, nz=1),
                                            {"find_minimal": True}),
    "find_minimal_already_minimal": lambda pkg: (_hcp(pkg),
                                                 {"find_minimal": True}),
    "density": lambda pkg: (_hcp(pkg, nx=3, ny=3, nz=2), {}),
    "miller_hcp": lambda pkg: (pkg.build_crystal(
        "Co", "hcp", a=3.52, c=1.63, miller1=(1, 0, -1, 0),
        miller2=(1, 1, -2, 0), miller3=(0, 0, 0, 1),
        **({} if pkg is mp else {"device": CPU})), {}),
}


@pytest.mark.parametrize("case", sorted(ORTHO))
def test_orthogonal_cell_matches_jax(case):
    sj, kw = ORTHO[case](mp)
    st, _ = ORTHO[case](mt)
    oj = mp.orthogonal_cell(sj, **kw)
    ot = mt.orthogonal_cell(st, **kw, device=CPU)
    _assert_same_system(oj, ot)
    assert np.allclose(ot.box.matrix, np.diag(np.diag(ot.box.matrix)))


def test_orthogonal_cell_extra_columns_and_open_boundary():
    vel = np.random.default_rng(0).normal(size=(4, 3))
    systems = []
    for pkg in (mp, mt):
        s = _hcp(pkg, nx=2)
        cols = {c: np.asarray(s.data[c]) for c in s.data.columns}
        cols["vx"], cols["vy"], cols["vz"] = vel[:, 0], vel[:, 1], vel[:, 2]
        s.update_data(cols)
        systems.append(s)
    _assert_same_system(mp.orthogonal_cell(systems[0]),
                        mt.orthogonal_cell(systems[1], device=CPU))
    open_box = mt.System(pos=np.zeros((1, 3)),
                         box=mt.Box(np.eye(3) * 5.0, boundary=[1, 1, 0]),
                         device=CPU)
    with pytest.raises(ValueError, match="periodic"):
        mt.orthogonal_cell(open_box, device=CPU)


def test_voronoi_container_matches_jax():
    seeds = np.random.default_rng(0).random((8, 3)) * 40.0
    cj = jax_voronoi(seeds, mp.Box(np.eye(3) * 40.0))
    ct = port_voronoi(seeds, mt.Box(np.eye(3) * 40.0))
    assert len(ct) == len(cj) == 8
    for a, b in zip(cj, ct):
        assert _same_bits(b.vertices, a.vertices)
        assert b.face_vertices == a.face_vertices
        assert b.volume == a.volume and b.cavity_radius == a.cavity_radius
        assert _same_bits(b.face_areas, a.face_areas)
    np.testing.assert_allclose(sum(c.volume for c in ct), 40.0 ** 3, rtol=1e-8)


POLY = {
    "plain": dict(box=40.0, seed_number=4, randomseed=3),
    "overlap": dict(box=40.0, seed_number=4, randomseed=3, metal_overlap_dis=2.0),
    "graphene": dict(box=40.0, seed_number=4, randomseed=5, metal_overlap_dis=2.0,
                     add_graphene=True, face_threshold=5.0),
    "no_rotation": dict(box=40.0, seed_number=2, randomseed=0,
                        seed_position=np.array([[10.0, 10, 10], [30, 30, 30]]),
                        need_rotation=False, metal_overlap_dis=2.0),
}


@pytest.mark.parametrize("case", sorted(POLY))
def test_create_polycrystal_matches_jax(case, capsys):
    kw = POLY[case]
    pj = mp.CreatePolycrystal(mp.build_crystal("Cu", "fcc", 3.615), **kw)
    pt = mt.CreatePolycrystal(mt.build_crystal("Cu", "fcc", 3.615, device=CPU),
                              **kw, device=CPU)
    sj = pj.compute(verbose=False)
    st = pt.compute(verbose=True)
    log = capsys.readouterr().out
    assert "POLYCRYSTAL GENERATION" in log and f"{st.N:,} atoms" in log
    _assert_same_system(sj, st)
    assert set(np.unique(st.data["grain_id"]).tolist()) == set(
        range(1, kw["seed_number"] + 1))
    if case == "graphene":
        assert (np.asarray(st.data["type"]) == 2).sum() > 100
    if kw.get("metal_overlap_dis") or kw.get("add_graphene"):
        # the keep mask on the unfiltered, wrapped atoms, each package's own
        L = np.diag(pt.box.matrix)
        rng = np.random.default_rng(1)
        pos = rng.random((3000, 3)) * L
        types = np.where(rng.random(3000) < 0.8, 1, 2).astype(np.int32)
        grain = rng.integers(1, 5, 3000).astype(np.int32)
        keep_j = pj._filter_overlaps(pos, types, grain)
        keep_t = pt._filter_overlaps(pos, types, grain)
        assert keep_t.dtype == bool and np.array_equal(keep_t, keep_j)
        assert 0 < int((~keep_t).sum()) < 3000


def test_create_polycrystal_rejects_bad_input_and_needs_the_card():
    unit = mt.build_crystal("Al", "fcc", 4.05, device=CPU)
    for kw, match in ((dict(box=mt.Box(np.eye(3) * 50.0, boundary=[1, 1, 0]),
                            seed_number=2), "Free boundary"),
                      (dict(box=50.0, seed_number=3,
                            seed_position=np.zeros((2, 3))), "seed_position shape"),
                      (dict(box=50.0, seed_number=3,
                            theta_list=np.zeros((2, 3))), "theta_list shape"),
                      (dict(box=np.diag([50.0, 50, 50]) + np.eye(3, k=1) * 5,
                            seed_number=2), "Triclinic")):
        with pytest.raises(ValueError, match=match):
            mt.CreatePolycrystal(unit, device=CPU, **kw)
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mt.build_crystal("Cu", "fcc", 3.615)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mt.CreatePolycrystal(unit, 50.0, 2)
