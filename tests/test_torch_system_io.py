"""Port parity: ``System``, its file I/O and trajectories
(``mdapy_tpu_torch/core/system.py``, ``core/frame.py``, ``io/load_save.py``,
``io/_fast_table.py`` with ``native/table_parser.cpp``, ``io/trajectory.py``;
ROADMAP A12a).

Files written by the JAX package are read by the port, and the other way
round: dump, ``.dump.gz``, extended and classical XYZ, POSCAR direct and
Cartesian, LAMMPS data atomic and charge, and mp, with triclinic boxes
among them; every column and the box are equal.  The JAX package's native
table parser counts leading zeros as mantissa digits, so a value such as
0.0010992856888165524 reads back a unit or two in the last place off, and
pandas' default float parser, which it takes for data files and XYZ
trajectories, keeps 17 digits (ROADMAP C13): there the JAX reading is the
value cut to those digits, and the port's equals the value written.
Uniform bodies take the native route and a mixed one the numpy fallback,
whose columns equal the JAX package's pandas parse.  Trajectories,
``unwrap_trajectory``, the ``System`` state methods and every ``cal_*``
(equal to the direct class call) run on the CPU; PTM with its planar
faults, the Voronoi methods and ``set_pka`` equal the JAX package's
``System``.  Every
file here is written by the tests; none comes from the reference's input
files (ROADMAP C2).  ``chip_smoke.py`` [IO1] and [SY1] run the same path on
1,000,188 atoms on the card.
"""

import numpy as np
import pytest

import mdapy_tpu as mp
from mdapy_tpu.io import _fast_table as jft
import mdapy_tpu_torch as mt
from mdapy_tpu_torch.io import _fast_table as tft

PKGS = {"jax": mp, "port": mt}


def make(pkg, tri=True, n=60, seed=0, extra=True):
    """A seeded Cu-Ni system of ``pkg`` with float, int and charge columns;
    positions in [0, 1) and beyond, so that short and long reprs occur."""
    rng = np.random.default_rng(seed)
    m = np.diag([9.5, 10.25, 11.0])
    if tri:
        m = m + np.array([[0, 0, 0], [1.5, 0, 0], [-0.75, 2.0, 0]])
    pos = rng.random((n, 3)) @ m + rng.normal(0, 1e-3, (n, 3))
    pos[:4] = [[0.0010992856888165524, 1.0, 2.0], [3.0, 1e-5, 0.1],
               [1234.5678, -0.0, 5.0], [0.25, 0.5, 0.75]]
    el = np.where(rng.random(n) < 0.4, "Ni", "Cu").astype(object)
    kw = {} if pkg is mp else {"device": "cpu"}
    s = pkg.System(pos=pos, box=m, element_list=el, **kw)
    s.set_type_by_element(["Cu", "Ni"])
    if extra:
        s.data["q"] = rng.normal(0, 0.3, n)
        s.data["c_pe"] = rng.normal(-3.5, 0.2, n)
        v = rng.normal(0, 0.01, (n, 3))
        s.data["vx"], s.data["vy"], s.data["vz"] = v[:, 0], v[:, 1], v[:, 2]
    return s


def truncated(v: float, digits: int) -> float:
    """repr(v) with the mantissa's digits past the first ``digits`` dropped,
    leading zeros counted, read back."""
    mant, _, exp = repr(float(v)).partition("e")
    out, k = [], 0
    for ch in mant:
        if ch.isdigit():
            if k >= digits:
                continue
            k += 1
        out.append(ch)
    return float("".join(out) + ("e" + exp if exp else ""))


def assert_same_frames(jread, tread, written, jax_route="exact"):
    """The JAX and the port's readings of one file: the same columns and
    box, the port's floats equal to what was written bit for bit, and the
    JAX package's equal to the port's where its route reads floats exactly.
    Where it does not (ROADMAP C13), its reading is the port's value
    written out and cut: its native parser keeps 19 mantissa digits,
    leading zeros counted (exactly that), and pandas' default float parser
    17 (within 2 ulp of that)."""
    assert set(jread.data.columns) == set(tread.data.columns)
    for c in tread.data.columns:
        j, t = np.asarray(jread.data[c]), np.asarray(tread.data[c])
        assert j.shape == t.shape, c
        if t.dtype.kind == "f":
            if c in written.data.columns and written.data[c].dtype.kind == "f":
                w = np.asarray(written.data[c])
                assert w.tobytes() == t.tobytes(), c
            if jax_route == "exact":
                np.testing.assert_array_equal(j, t, err_msg=c)
            else:
                cut = np.array([truncated(v, 19 if jax_route == "native" else 17)
                                for v in t])
                np.testing.assert_array_max_ulp(
                    j, cut, maxulp=0 if jax_route == "native" else 2)
        else:
            assert j.astype(str).tolist() == t.astype(str).tolist(), c
    for attr in ("matrix", "origin", "boundary"):
        np.testing.assert_array_equal(getattr(tread.box, attr),
                                      getattr(jread.box, attr), err_msg=attr)


# case -> (file name, writer, its arguments, the JAX package's float route)
CASES = {
    "dump": ("a.dump", "write_dump", {}, "native"),
    "dump_gz": ("a.dump.gz", "write_dump", {}, "native"),
    "xyz": ("a.xyz", "write_xyz", {}, "native"),
    "xyz_classical": ("c.xyz", "write_xyz", {"classical": True}, "native"),
    "poscar_direct": ("a.POSCAR", "write_poscar", {"direct": True}, "exact"),
    "poscar_cartesian": ("c.POSCAR", "write_poscar", {"direct": False}, "exact"),
    "data_atomic": ("a.data", "write_data", {}, "pandas"),
    "data_charge": ("q.data", "write_data", {"data_format": "charge"}, "pandas"),
    "mp": ("a.mp", "write_mp", {}, "exact"),
}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_files_cross_read(tmp_path, case, writer):
    name, method, kw, route = CASES[case]
    tri = case not in ("poscar_cartesian", "xyz_classical")
    written = make(PKGS[writer], tri=tri)
    path = str(tmp_path / name)
    getattr(written, method)(path, **kw)
    jread = mp.System(path)
    tft.reset_routes()
    tread = mt.System(path, device="cpu")
    if case.startswith(("dump", "xyz", "data")):
        # a data file's Atoms and Velocities sections are two tables
        native = 2 if case.startswith("data") else 1
        assert tft.routes == {"native": native, "numpy": 0}
    assert_same_frames(jread, tread,
                       tread if case.startswith("poscar") else written, route)
    if case.startswith("poscar"):
        # POSCAR groups the atoms by element, in the order they first occur
        # (here Cu, the first atom's), with 16 decimals
        order = np.argsort(np.asarray(written.data["element"]) != "Cu",
                           kind="stable")
        np.testing.assert_allclose(tread.pos, written.pos[order], atol=1e-9)


def test_writers_write_the_same_text(tmp_path):
    """numpy's formatting in place of pandas' ``to_csv``: byte-equal files."""
    for case in ("dump", "xyz", "xyz_classical", "data_atomic", "data_charge",
                 "poscar_direct"):
        name, method, kw, _ = CASES[case]
        texts = []
        for key, pkg in PKGS.items():
            path = str(tmp_path / f"{key}_{name}")
            getattr(make(pkg), method)(path, **kw)
            texts.append(open(path).read())
        assert texts[0] == texts[1], case


def test_gzip_content_equal(tmp_path):
    import gzip

    texts = []
    for key, pkg in PKGS.items():
        path = str(tmp_path / f"{key}.dump.gz")
        make(pkg).write_dump(path)
        with gzip.open(path, "rt") as f:
            texts.append(f.read())
    assert texts[0] == texts[1]


MIXED = ("ITEM: TIMESTEP\n7\nITEM: NUMBER OF ATOMS\n4\n"
         "ITEM: BOX BOUNDS pp pp pp\n0 10\n0 10\n0 10\n"
         "ITEM: ATOMS id type phase x y z\n"
         "1 1 liquid 1.0 2.0 3.0\n2 2 solid 4e-1 5.0E+1 6.25\n"
         "3 1 solid 7 8 9\n4 2 glass 0.1 0.2 0.3\n")


@pytest.mark.parametrize("body", ["mixed", "wide_token", "integers"])
def test_fallback_matches_pandas(tmp_path, body):
    text = {"mixed": MIXED,
            "wide_token": MIXED.replace("phase", "element").replace(
                "glass", "Averyveryverylongname"),
            "integers": MIXED.replace("phase", "c_n").replace(
                "liquid", "3").replace("solid", "4").replace("glass", "-5")}[body]
    p = tmp_path / f"{body}.dump"
    p.write_text(text)
    tft.reset_routes()
    t = mt.System(str(p), device="cpu")
    j = mp.System(str(p))
    expect = ({"native": 1, "numpy": 0} if body == "integers"
              else {"native": 0, "numpy": 1})
    assert tft.routes == expect
    assert t.data.columns == j.data.columns
    for c in t.data.columns:
        a, b = np.asarray(t.data[c]), np.asarray(j.data[c])
        if body == "integers" and c == "c_n":
            assert a.dtype == np.float64  # the native route, as the JAX one
        if body != "integers":
            kinds = {a.dtype.kind, b.dtype.kind}
            assert len(kinds) == 1 or kinds <= {"U", "O"}, c
        assert a.astype(str).tolist() == b.astype(str).tolist(), c
    assert t.global_info == j.global_info == {"timestep": 7}


def test_parse_block_bit_exact_and_c13():
    toks = ["0.1", "-0.1", "1e300", "-1e-300", "3.141592653589793",
            "2.2250738585072014e-308", "123456789012345678901234567890.5",
            "1.7976931348623157e308", "0.000001", "42", "-0", "6.02e23",
            "0.0010992856888165524", "000123.4500", "0.000", "1e-5"]
    raw = ("\n".join(" ".join(toks) for _ in range(3)) + "\n").encode()
    names = [f"c{i}" for i in range(len(toks))]
    cols = tft.parse_block(raw, 0, names, 3)
    jcols = jft.parse_block(raw, 0, names, 3)
    for i, t in enumerate(toks):
        assert np.all(cols[f"c{i}"] == float(t)), t
    # the JAX parser's C13: a 17-digit value after leading zeros loses its
    # last digit
    assert jcols["c12"][0] != float(toks[12])
    assert jcols["c12"][0] == float("0.001099285688816552")


def test_parse_block_declines_and_skips():
    assert tft.parse_block(b"1 2\n1 2 3\n", 0, ["a", "b", "c"], 2) is None
    assert tft.parse_block(b"1 x 3\n", 0, ["a", "b", "c"], 1) is None
    assert tft.parse_block(b"1 2 3 4\n", 0, ["a", "b", "c"], 1) is None
    assert tft.parse_block(b"1.5x 2 3\n", 0, ["a", "b", "c"], 1) is None
    assert tft.parse_block(b"1 2 3\n", 0, ["a", "b", "c"], 2) is None
    cols = tft.parse_block(b"1 2\n3 4\nITEM: TIMESTEP\n", 0, ["a", "b"], 2)
    np.testing.assert_array_equal(cols["a"], [1.0, 3.0])
    raw = b"a 1\nb 2\n\n   \nc 3\nrest"
    assert raw[tft.skip_rows(raw, 0, 3):] == b"rest"
    assert tft.skip_rows(raw, 0, 5) == -1


def test_native_build_lands_in_the_package(tmp_path):
    from mdapy_tpu_torch import native

    lib = native.load_library("table_parser")
    assert lib.path.parent.name == "_build"
    assert lib.path.parent.parent.name == "mdapy_tpu_torch"


# ------------------------------------------------------------- trajectories

def _frames(pkg, n_frames=3):
    out = []
    for k in range(n_frames):
        s = make(pkg, n=20, seed=k, extra=False)
        s.global_info["timestep"] = 100 * k
        out.append(s)
    return out


@pytest.mark.parametrize("ext", ["dump", "dump.gz", "xyz"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trajectory_cross_read(tmp_path, ext, writer):
    path = str(tmp_path / f"traj.{ext}")
    PKGS[writer].Trajectory(systems=_frames(PKGS[writer])).save(path)
    j = mp.Trajectory(path, verbose=False)
    tft.reset_routes()
    t = mt.Trajectory(path, verbose=False, device="cpu")
    assert len(t) == len(j) == 3
    assert tft.routes["numpy"] == 0 and tft.routes["native"] == 3
    # the JAX package reads a dump trajectory natively, an XYZ one through
    # pandas
    route = "pandas" if ext == "xyz" else "native"
    for a, b, w in zip(j, t, _frames(mt)):
        assert_same_frames(a, b, w, route)
        assert a.global_info == b.global_info


def test_xyz_trajectory_fast_mode_and_list_api(tmp_path):
    path = str(tmp_path / "traj.xyz")
    mt.Trajectory(systems=_frames(mt)).save(path)
    fast = mt.XYZTrajectory(path, fast_mode=True, verbose=False, device="cpu")
    jfast = mp.XYZTrajectory(path, fast_mode=True, verbose=False)
    for a, b in zip(jfast, fast):
        assert_same_frames(a, b, b, "pandas")
    t = mt.Trajectory(path, verbose=False, device="cpu")
    assert len(t[1:]) == 2 and len(t[np.array([True, False, True])]) == 2
    assert len(t[np.array([0, -1])]) == 2 and t[0].N == 20
    t.append(t[0])
    assert len(t) == 4 and t.pop().N == 20
    assert list(t.get_atoms_count()) == [20, 20, 20]
    with pytest.raises(IndexError):
        t[np.array([5])]
    with pytest.raises(ValueError, match="fast_mode"):
        mt.Trajectory(str(tmp_path / "x.dump"), fast_mode=True)
    with pytest.raises(ValueError, match="only reads xyz"):
        mt.XYZTrajectory(str(tmp_path / "x.dump"), format="dump")


def _unwrap_cases(pkg):
    Box = mp.core.box.Box if pkg is mp else mt.Box
    kw = {} if pkg is mp else {"device": "cpu"}

    def frame(xyz, **cols):
        xyz = np.asarray(xyz, float)
        data = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
        data.update({k: np.asarray(v) for k, v in cols.items()})
        return pkg.System(data=data, box=Box(np.eye(3) * 10.0), **kw)

    return {
        "unwrapped": [frame([[5, 0, 0]], **{"xu": [5.0], "yu": [0.0], "zu": [0.0]}),
                      frame([[1, 0, 0]], **{"xu": [11.0], "yu": [0.0], "zu": [0.0]})],
        "image": [frame([[2, 0, 0], [4, 0, 0]], id=np.array([1, 2], np.int32),
                        element=np.array(["Cu", "Ni"], object),
                        **{"ix": [0, 0], "iy": [0, 0], "iz": [0, 0]}),
                  frame([[3, 0, 0], [5, 0, 0]], id=np.array([1, 2], np.int32),
                        element=np.array(["Cu", "Ni"], object),
                        **{"ix": [1, 0], "iy": [0, 0], "iz": [0, 0]})],
        "min_image": [frame([[8, 0, 0], [2, 0, 0]], id=np.array([1, 2], np.int32)),
                      frame([[2.5, 0, 0], [1, 0, 0]], id=np.array([2, 1], np.int32)),
                      frame([[3.5, 9, 0], [9.5, 0, 0]], id=np.array([2, 1], np.int32))],
    }


@pytest.mark.parametrize("method", ["unwrapped", "image", "min_image"])
def test_unwrap_trajectory_matches_jax(method):
    j = mp.unwrap_trajectory(mp.Trajectory(systems=_unwrap_cases(mp)[method]))
    t = mt.unwrap_trajectory(mt.Trajectory(systems=_unwrap_cases(mt)[method]))
    assert t._unwrap_method == j._unwrap_method == method
    for a, b in zip(j, t):
        assert b.device.type == "cpu"
        assert_same_frames(a, b, b)


# ---------------------------------------------------------- the System

def test_system_state_methods_match_jax():
    j, t = make(mp), make(mt)
    for s in (j, t):
        s.replicate(2, 1, 2)
        s.wrap_pos()
        s.update_box(s.box.matrix * 1.01, scale_pos=True)
    assert_same_frames(j, t, t)
    jb, tb = make(mp), make(mt)
    jb.update_box(jb.box.matrix.T.copy())  # a general (upper) cell
    tb.update_box(tb.box.matrix.T.copy())
    jb.align_to_lammps()
    tb.align_to_lammps()
    assert_same_frames(jb, tb, tb)
    for s in (j, t):
        s.update_pos(s.pos[::-1])
    np.testing.assert_array_equal(j.pos, t.pos)
    assert len(t) == t.N == 240 and "atoms" in repr(t)


def test_neighbors_bonds_and_overlaps_match_jax():
    j, t = make(mp, n=120), make(mt, n=120)
    for rc in (2.5, 4.0):
        jv, jd, jn = j.build_neighbor(rc=rc)
        tv, td, tn = t.build_neighbor(rc=rc)
        np.testing.assert_array_equal(jn, tn)
        for i in range(t.N):
            assert sorted(jv[i, :jn[i]]) == sorted(tv[i, :tn[i]])
        for i in range(t.N):
            np.testing.assert_allclose(np.sort(jd[i, :jn[i]]),
                                       np.sort(td[i, :tn[i]]), atol=1e-12)
    jv, jd = j.build_nearest_neighbor(k=6)
    tv, td = t.build_nearest_neighbor(k=6)
    np.testing.assert_allclose(jd, td, atol=1e-12)
    np.testing.assert_array_equal(j.create_bonds(rc={"Cu-Cu": 2.6, "Cu-Ni": 2.4,
                                                     "Ni-Ni": 2.3}),
                                  t.create_bonds(rc={"Cu-Cu": 2.6, "Cu-Ni": 2.4,
                                                     "Ni-Ni": 2.3}))
    np.testing.assert_allclose(j.average_by_neighbor(3.0, "c_pe"),
                               t.average_by_neighbor(3.0, "c_pe"), atol=1e-12)
    assert j.delete_overlap(1.2) == t.delete_overlap(1.2)
    assert_same_frames(j, t, t)


def test_system_api_parity():
    t = make(mt, extra=False)
    t.set_element("Al")
    assert set(np.asarray(t.data["element"]).astype(str)) == {"Al"}
    with pytest.raises(AssertionError):
        t.set_element(["Cu"] * (t.N - 1))
    with pytest.raises(AssertionError):
        t.get_velocities()
    with pytest.raises(TypeError):
        t.calc = object()
    with pytest.raises(RuntimeError, match="calculator"):
        t.get_energy()
    with pytest.raises(ValueError):
        mt.System(pos=np.zeros((2, 3)), device="cpu")
    with pytest.raises(ValueError, match="Cannot infer"):
        mt.System("a.unknown", device="cpu")
    f = mt.AtomFrame({"x": np.arange(3.0), "id": np.arange(3)})
    assert f.filter(f["x"] > 0).nrows == 2 and f.tile(2).nrows == 6
    with pytest.raises(ValueError):
        f["y"] = np.zeros(4)
    assert mt.element_data.symbols_to_numbers(["Cu", "ni"]).tolist() == [29, 28]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_optional_converters_raise_without_their_packages(pkg, monkeypatch):
    """``from_ovito``, ``to_ovito`` and ``to_ase`` import their packages
    lazily and raise ImportError without them, in both packages."""
    import sys

    for name in ("ovito", "ovito.data", "ase"):
        monkeypatch.setitem(sys.modules, name, None)
    s = make(PKGS[pkg], extra=False)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    with pytest.raises(ImportError, match="ovito"):
        PKGS[pkg].System(ovito_atom=object(), **kw)
    for convert in (s.to_ovito, s.to_ase):
        with pytest.raises(ImportError):
            convert()


def test_card_default_and_load_save(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.System(pos=np.zeros((1, 3)), box=np.eye(3))
    s = make(mt)
    path = str(tmp_path / "s.dump")
    mt.save(path, s)
    r = mt.load(path, device="cpu")
    assert r.device.type == "cpu" and r.N == s.N
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.load(path)


def test_calculators_and_renderer_take_the_system(tmp_path):
    from _torch_system import StandInSystem

    g = mt.EAMGenerator(["Cu"], output_filename=str(tmp_path / "Cu.eam.alloy"))
    crystal = mp.build_crystal("Cu", "fcc", 3.615, nx=3, ny=3, nz=3)
    pos = np.asarray(crystal.pos) + np.random.default_rng(2).normal(
        0, 0.05, (crystal.N, 3))
    m = np.asarray(crystal.box.matrix)
    s = mt.System(pos=pos, box=m, element_list=["Cu"] * len(pos), device="cpu")
    s.calc = mt.EAM(g.output_filename, device="cpu")
    ref = StandInSystem(pos, m, "Cu")
    ref.calc = mt.EAM(g.output_filename, device="cpu")
    np.testing.assert_array_equal(s.get_force(), ref.get_force())
    e0 = s.get_energy()
    mt.FIRE(s).run(2)
    assert s.get_energy() < e0
    img = mt.TachyonRender(backend="cpu", ao=False).render_system(
        s, width=48, height=32)
    assert img.shape == (32, 48, 4) and img.std() > 1


# -------------------------------------------------------- the analyses

def _lattice(device="cpu"):
    s = mp.build_crystal("Cu", "fcc", 3.615, nx=3, ny=3, nz=3)
    pos = np.asarray(s.pos) + np.random.default_rng(7).normal(0, 0.05, (s.N, 3))
    return mt.System(pos=pos, box=np.asarray(s.box.matrix),
                     element_list=["Cu"] * s.N, device=device)


def _direct(name, s):
    pos, box = s.pos, s.box
    kw = dict(device="cpu")
    if name == "csp":
        return mt.CentroSymmetryParameter(pos, box, 12, **kw).compute().csp
    if name == "cna":
        return mt.CommonNeighborAnalysis(pos, box, **kw).compute().cna
    if name == "cna_rc":
        return mt.CommonNeighborAnalysis(pos, box, 3.0, **kw).compute().cna
    if name == "aja":
        return mt.AcklandJonesAnalysis(pos, box, **kw).compute().aja
    if name == "cnp":
        lists = mt.Neighbor(pos, box, 3.0, **kw).compute()
        return mt.CommonNeighborParameter(
            pos, box, 3.0, lists.verlet_list, lists.distance_list,
            lists.neighbor_number, **kw).compute().cnp
    if name == "ids":
        return mt.IdentifyDiamondStructure(pos, box, **kw).compute().ids
    if name == "steinhardt":
        return mt.SteinhardtBondOrientation(pos, box, wlhat=True,
                                            identify_liquid=True,
                                            **kw).compute().qnarray
    if name == "entropy":
        lists = mt.Neighbor(pos, box, 5.0, **kw).compute()
        return mt.StructureEntropy(pos, box, 5.0, 0.2, False, lists.verlet_list,
                                   lists.distance_list, lists.neighbor_number,
                                   **kw).compute().entropy
    if name == "chill_plus":
        return mt.ChillPlus(pos, box, 3.5, **kw).compute().chill_plus
    if name == "cluster":
        return mt.ClusterAnalysis(pos, box, 3.0, types=s.data["type"],
                                  **kw).compute().particleClusters
    if name == "rdf":
        return mt.RadialDistributionFunction(pos, box, 5.0, 50,
                                             types=s.data["type"], **kw
                                             ).compute().g_total
    if name == "adf":
        return mt.AngularDistributionFunction(
            pos, box, {"Cu-Cu-Cu": [0, 3.0, 0, 3.0]}, 60, types=s.data["type"],
            elements=np.asarray(s.data["element"]).astype(str), **kw
        ).compute().bond_angle_distribution
    if name == "bond":
        lists = mt.Neighbor(pos, box, 3.0, **kw).compute()
        return mt.BondAnalysis(pos, box, 3.0, 60, lists.verlet_list,
                               lists.distance_list, lists.neighbor_number,
                               **kw).compute().bond_angle_distribution


def _via_system(name, s):
    if name == "csp":
        return s.cal_centro_symmetry_parameter()
    if name == "cna":
        return s.cal_common_neighbor_analysis()
    if name == "cna_rc":
        return s.cal_common_neighbor_analysis(3.0)
    if name == "aja":
        return s.cal_ackland_jones_analysis()
    if name == "cnp":
        return s.cal_common_neighbor_parameter(3.0)
    if name == "ids":
        return s.cal_identify_diamond_structure()
    if name == "steinhardt":
        return s.cal_steinhardt_bond_orientation(wlhat=True, identify_liquid=True)
    if name == "entropy":
        return s.cal_structure_entropy(5.0, 0.2)
    if name == "chill_plus":
        return s.cal_chill_plus(3.5)
    if name == "cluster":
        s.cal_cluster_analysis(3.0)
        return s.data["cluster_id"]
    if name == "rdf":
        return s.cal_radial_distribution_function(5.0, 50).g_total
    if name == "adf":
        return s.cal_angular_distribution_function(
            {"Cu-Cu-Cu": [0, 3.0, 0, 3.0]}, 60).bond_angle_distribution
    if name == "bond":
        return s.cal_bond_analysis(3.0, 60).bond_angle_distribution


COLUMNS = {"csp": "csp", "cna": "cna", "cna_rc": "cna", "aja": "aja",
           "cnp": "cnp", "ids": "ids", "entropy": "entropy",
           "chill_plus": "chill_plus", "cluster": "cluster_id",
           "steinhardt": "ql6"}


@pytest.mark.parametrize("name", ["csp", "cna", "cna_rc", "aja", "cnp", "ids",
                                  "steinhardt", "entropy", "chill_plus",
                                  "cluster", "rdf", "adf", "bond"])
def test_cal_equals_the_direct_call(name):
    s = _lattice()
    got = np.asarray(_via_system(name, s))
    want = np.asarray(_direct(name, s))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    if name in COLUMNS:
        assert COLUMNS[name] in s.data


def test_cal_atomic_strain_equals_the_direct_call():
    ref, cur = _lattice(), _lattice()
    cur.update_box(ref.box.matrix @ np.array([[1, 0.01, 0], [0, 1, 0], [0, 0, 1]]),
                   scale_pos=True)
    cur.cal_atomic_strain(ref, rc=5.0)
    direct = mt.AtomicStrain(5.0, _lattice(), device="cpu").compute(
        mt.System(data=cur.data.copy(), box=cur.box, device="cpu"))
    np.testing.assert_array_equal(cur.data["shear_strain"], direct.shear_strain)
    assert float(np.mean(cur.data["shear_strain"])) > 1e-3


@pytest.fixture(scope="module")
def _jax_engines_of_our_own(tmp_path_factory):
    from _native_flags import private_jax_build

    undo = private_jax_build(tmp_path_factory)
    yield
    undo()


def _pka_ready(s):
    rng = np.random.default_rng(11)
    for c in ("vx", "vy", "vz"):
        s.data[c] = rng.normal(0.0, 0.01, s.N)
    s.set_pka(1000.0, np.array([1.0, 0, 0]))
    return np.column_stack([s.data[c] for c in ("vx", "vy", "vz")])


# the System methods of the native engines and the tool functions (ROADMAP
# A12d, A12e): each on the port against the JAX package's System
FORMERLY_UNPORTED = {
    "cal_polyhedral_template_matching": lambda s: np.asarray(
        s.cal_polyhedral_template_matching(identify_fcc_planar_faults=True)),
    "cal_voronoi_volume": lambda s: s.cal_voronoi_volume().volume,
    "build_voronoi_neighbor": lambda s: (s.build_voronoi_neighbor(),
                                         s.voro_verlet_list)[1],
    "set_pka": _pka_ready,
}


@pytest.mark.parametrize("method", sorted(FORMERLY_UNPORTED))
def test_native_and_tool_methods_equal_jax(method, _jax_engines_of_our_own):
    t = _lattice()
    j = mp.System(pos=t.pos, box=t.box.matrix, element_list=["Cu"] * t.N)
    got, want = FORMERLY_UNPORTED[method](t), FORMERLY_UNPORTED[method](j)
    assert got.shape == want.shape and got.dtype == want.dtype
    if method == "cal_voronoi_volume":
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
        assert abs(got.sum() / t.box.volume - 1) < 1e-12
    else:
        assert got.tobytes() == want.tobytes()
    if method == "cal_polyhedral_template_matching":
        np.testing.assert_array_equal(t.data["pft"], j.data["pft"])
        assert (got == 1).all()
