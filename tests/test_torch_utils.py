"""Port parity: the rest of the public surface (``mdapy_tpu_torch/utils/
tool_function.py``, ``potential_tool.py``, ``pigz.py``, ``plotset.py``,
``analysis/phonon.py``, ``render/visualize.py``, ``System.set_pka``;
ROADMAP A12e).

The same seeded inputs and the same small files, written here, go through
the JAX package and the port: ``set_pka`` and ``generate_velocity`` (with a
seed) bit for bit, ``average_by_neighbor`` within 1e-12, ``replicate``,
``wrap_pos`` and ``split_xyz`` byte for byte, the thermo, OUTCAR and MTP
readers and converters equal, ``PCA`` and ``fps_sample`` exact, ``get_eos``
and ``get_sfe_fcc`` with an ``EAMGenerator`` potential within 1e-10
relative, and the import errors of ``Phonon`` and ``View`` (phonopy and k3d
are on neither machine) word for word.
"""

import gzip
import os

import numpy as np
import pytest

import mdapy_tpu as mp
from mdapy_tpu.core.box import Box as JBox
from mdapy_tpu.utils import tool_function as jtf
import mdapy_tpu_torch as mt
from mdapy_tpu_torch.core.box import Box
from mdapy_tpu_torch.utils import tool_function as ttf

RTOL = 1e-10


def _fcc(pkg, cells=3, sigma=0.05, seed=0, **kw):
    s = pkg.build_crystal("Cu", "fcc", 3.615, nx=cells, ny=cells, nz=cells, **kw)
    pos = np.asarray(s.pos) + np.random.default_rng(seed).normal(
        0.0, sigma, (s.N, 3))
    return pos, np.asarray(s.box.matrix)


def _with_velocities(pkg, elements, **kw):
    pos, m = _fcc(mp)
    vel = np.random.default_rng(1).normal(0.0, 0.01, (len(pos), 3))
    box = JBox(m) if pkg is mp else m
    s = pkg.System(pos=pos, box=box, element_list=elements, **kw)
    for i, c in enumerate(("vx", "vy", "vz")):
        s.data[c] = vel[:, i].copy()
    return s


def _velocities(s):
    return np.column_stack([np.asarray(s.data[c]) for c in ("vx", "vy", "vz")])


@pytest.mark.parametrize("kw", [
    {}, {"index": 17}, {"element": "Ni"}, {"factor": 10.0},
])
def test_system_set_pka_is_jax_bit_for_bit(kw):
    elems = np.array(["Cu", "Ni"] * 54, dtype=object)
    j = _with_velocities(mp, elems)
    t = _with_velocities(mt, elems, device="cpu")
    j.set_pka(25.0, np.array([1.0, 2.0, 0.5]), **kw)
    t.set_pka(25.0, np.array([1.0, 2.0, 0.5]), **kw)
    assert _velocities(t).tobytes() == _velocities(j).tobytes()
    mass = np.where(elems == "Cu", 63.546, 58.6934)
    assert np.abs((mass[:, None] * _velocities(t)).sum(0)).max() < 1e-12


def test_set_pka_function_and_its_errors_match_jax():
    elems = np.array(["Cu"] * 108, dtype=object)
    j = _with_velocities(mp, elems)
    t = _with_velocities(mt, elems, device="cpu")
    assert ttf.set_pka(t, 5.0, [0, 0, 1]) == jtf.set_pka(j, 5.0, [0, 0, 1])
    assert _velocities(t).tobytes() == _velocities(j).tobytes()
    for args, kw in (((5.0, [1, 0]), {}), ((5.0, [1, 0, 0]), {"index": 999}),
                     ((5.0, [1, 0, 0]), {"element": "Fe"})):
        with pytest.raises(ValueError) as je:
            jtf.set_pka(j, *args, **kw)
        with pytest.raises(ValueError) as te:
            ttf.set_pka(t, *args, **kw)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("mass", [63.546, "per_atom"])
def test_generate_velocity_is_jax_bit_for_bit(mass):
    if mass == "per_atom":
        mass = np.random.default_rng(3).uniform(1.0, 200.0, 500)
    state = np.random.get_state()
    got = mt.generate_velocity(500, mass, 300.0, seed=7)
    after = np.random.get_state()
    assert all(np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
               for a, b in zip(state, after)), "the global generator moved"
    want = mp.generate_velocity(500, mass, 300.0, seed=7)
    assert got.tobytes() == want.tobytes()
    kept = mt.generate_velocity(500, mass, 300.0, remove_com=False, seed=7)
    assert kept.tobytes() == mp.generate_velocity(500, mass, 300.0,
                                                  remove_com=False,
                                                  seed=7).tobytes()
    fresh = mt.generate_velocity(500, mass, 300.0)
    assert fresh.shape == (500, 3) and not np.array_equal(fresh, got)
    with pytest.raises(ValueError, match="doesn't match"):
        mt.generate_velocity(5, np.ones(4), 300.0)


@pytest.mark.parametrize("include_self", [True, False])
def test_average_by_neighbor_matches_jax(include_self):
    pos, m = _fcc(mp, sigma=0.1)
    prop = np.random.default_rng(4).normal(size=len(pos))
    want = jtf.average_by_neighbor(pos, JBox(m), prop, 5.0, include_self)
    got = ttf.average_by_neighbor(pos, Box(m), prop, 5.0, include_self,
                                  device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_sort_neighbor_wrap_and_replicate_are_jax_byte_for_byte():
    pos, m = _fcc(mp, sigma=0.3)
    pos = pos + np.array([5.0, -3.0, 12.0])
    for b in ([1, 1, 1], [1, 0, 1]):
        assert ttf.wrap_pos(pos, Box(m, b)).tobytes() == \
            jtf.wrap_pos(pos, JBox(m, b)).tobytes()
    tp, tb = ttf.replicate(pos, Box(m), 2, 1, 3)
    jp, jb = jtf.replicate(pos, JBox(m), 2, 1, 3)
    assert tp.tobytes() == jp.tobytes()
    assert tb.matrix.tobytes() == jb.matrix.tobytes()
    nb = mt.Neighbor(pos, Box(m), 4.0, device="cpu").compute()
    dist = nb.distance_list[:, ::-1].copy()
    verlet = nb.verlet_list[:, ::-1].copy()
    vj, dj = verlet.copy(), dist.copy()
    k = int(nb.neighbor_number.min())
    ttf.sort_neighbor(verlet, dist, nb.neighbor_number, k)
    jtf.sort_neighbor(vj, dj, nb.neighbor_number, k)
    assert verlet.tobytes() == vj.tobytes() and dist.tobytes() == dj.tobytes()
    assert (np.diff(dist[:, :k], axis=1) >= 0).all()


@pytest.mark.parametrize("in_memory", [True, False])
def test_split_xyz_files_are_jax_byte_for_byte(tmp_path, in_memory):
    src = tmp_path / "traj.xyz"
    rng = np.random.default_rng(6)
    with open(src, "w") as f:
        for frame in range(3):
            n = 2 + frame
            f.write(f"{n}\nframe={frame}\n")
            for row in rng.normal(size=(n, 3)):
                f.write("Cu " + " ".join(repr(float(x)) for x in row) + "\n")
            if frame == 1:
                f.write("\n")
    out = {}
    for name, fn in (("jax", mp.split_xyz), ("port", mt.split_xyz)):
        d = tmp_path / name
        fn(str(src), str(d), in_memory=in_memory)
        out[name] = {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}
    assert list(out["port"]) == ["traj.000000.xyz", "traj.000001.xyz",
                                 "traj.000002.xyz"]
    assert out["port"] == out["jax"]


def test_read_thermo_gives_the_columns_without_pandas(tmp_path):
    rows = np.random.default_rng(8).random((5, 18))
    np.savetxt(tmp_path / "thermo.out", rows)
    got = mt.read_thermo(str(tmp_path))
    want = mp.read_thermo(str(tmp_path))
    assert isinstance(got, mt.AtomFrame) and got.columns == list(want.columns)
    for c in want.columns:
        assert np.asarray(got[c]).tobytes() == want[c].to_numpy().tobytes()
    np.savetxt(tmp_path / "thermo.out", rows[:1])
    assert len(mt.read_thermo(str(tmp_path))) == 1
    assert mt.rmse(rows[0], rows[1]) == mp.rmse(rows[0], rows[1])


OUTCAR = (
    "POTCAR: PAW_PBE Cu 22Jun2005\n"
    "   number of ions     NIONS =      2\n"
    "   ions per type =   2\n"
    "   ISIF   =      {isif}\n"
    "aborting loop because EDIFF is reached\n"
    " VOLUME and BASIS-vectors are now:\n"
    " dummy\n dummy\n dummy\n dummy\n"
    "     3.6 0.0 0.0\n     0.0 3.6-0.1\n     0.0 0.0 3.6\n"
    " FORCE on cell =-STRESS in cart. coord.  units (eV):\n"
    "  Total   1.0 1.5 2.0 0.25 -0.5 0.75\n"
    " TOTAL-FORCE (eV/Angst)\n"
    " -----\n"
    " 0.0 0.0 0.0 0.1 0.2 0.3\n"
    " 1.8 1.8 1.8 -0.1 -0.2 -0.3\n"
    " -----\n"
    "  free  energy   TOTEN  =      -7.123456 eV\n"
)
CFG = (
    "BEGIN_CFG\n Size\n    2\n Supercell\n"
    "  3.6 0 0\n  0 3.6 0\n  0 0 3.6\n"
    " AtomData:  id type cartes_x cartes_y cartes_z fx fy fz\n"
    "  1 0 0.0 0.0 0.0 0.1 0.2 0.3\n"
    "  2 1 1.8 1.8 1.8 -0.1 -0.2 -0.3\n"
    " Energy\n  -7.0\n PlusStress:  xx yy zz yz xz xy\n"
    "  1.0 1.0 1.0 0.0 0.0 0.0\nEND_CFG\n"
)


def test_outcar_and_cfg_converters_match_jax(tmp_path, capsys):
    paths = []
    for isif in (2, 0):
        p = tmp_path / f"OUTCAR{isif}"
        p.write_text(OUTCAR.format(isif=isif))
        paths.append(str(p))
    bad = tmp_path / "OUTCAR_bad"
    bad.write_text(OUTCAR.format(isif=2).replace("aborting loop", "stopped"))
    for p in paths:
        assert mt.read_OUTCAR(p) == mp.read_OUTCAR(p)
    assert mt.read_OUTCAR(str(bad)) is False and mp.read_OUTCAR(str(bad)) is False
    cfg = tmp_path / "a.cfg"
    cfg.write_text(CFG + CFG.replace("0.3\n", "30.0\n", 1))
    files = {}
    for name, pkg in (("jax", mp), ("port", mt)):
        pkg.outcar2xyz(paths + [str(bad)], str(tmp_path / f"{name}_o.xyz"))
        pkg.outcars2xyz(paths[0], str(tmp_path / f"{name}_o.xyz"), mode="a")
        pkg.cfg2xyz(str(cfg), {0: "Cu", 1: "Ni"}, str(tmp_path / f"{name}_c.xyz"))
        files[name] = [(tmp_path / f"{name}_{k}.xyz").read_bytes() for k in "oc"]
    assert files["port"] == files["jax"]
    assert files["port"][1].count(b"Lattice=") == 1   # the f_max filter
    assert capsys.readouterr().out.count("is not converged!") == 2


def test_pca_and_fps_are_exact():
    X = np.random.default_rng(9).normal(size=(60, 7)) @ np.diag(
        [5, 4, 3, 2, 1, 0.5, 0.1])
    tp, jp = mt.PCA(3), mp.PCA(3)
    assert tp.fit_transform(X).tobytes() == jp.fit_transform(X).tobytes()
    assert tp.explained_variance.tobytes() == jp.explained_variance.tobytes()
    assert tp.explained_variance_ratio.tobytes() == \
        jp.explained_variance_ratio.tobytes()
    for start in (0, 17):
        got = mt.fps_sample(12, X, start)
        assert got.tobytes() == mp.fps_sample(12, X, start).tobytes()
        assert got[0] == start and len(set(got.tolist())) == 12


@pytest.fixture(scope="module")
def eam_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("eam")
    mp.EAMGenerator(["Cu"], str(d / "jax.eam.alloy"))
    mt.EAMGenerator(["Cu"], output_filename=str(d / "port.eam.alloy"))
    assert (d / "jax.eam.alloy").read_bytes() == (d / "port.eam.alloy").read_bytes()
    return (mp.EAM(str(d / "jax.eam.alloy")),
            mt.EAM(str(d / "port.eam.alloy"), device="cpu"))


def test_get_eos_matches_jax(eam_pair):
    jcalc, tcalc = eam_pair
    j = mp.build_crystal("Cu", "fcc", 3.615, nx=3, ny=3, nz=3)
    t = mt.build_crystal("Cu", "fcc", 3.615, nx=3, ny=3, nz=3, device="cpu")
    j.calc, t.calc = jcalc, tcalc
    want = mp.get_eos(j, 0.97, 1.03, 4)
    got = mt.get_eos(t, 0.97, 1.03, 4)
    assert got.shape == (4, 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert got[:, 1].argmin() in (1, 2)


def test_get_sfe_fcc_matches_jax(eam_pair):
    jcalc, tcalc = eam_pair
    want = mp.get_sfe_fcc("Cu", 3.615, jcalc)
    got = mt.get_sfe_fcc("Cu", 3.615, tcalc)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert 20 < got < 80


def test_compress_file_round_trips_and_raises_as_jax(tmp_path):
    src = tmp_path / "a.txt"
    src.write_bytes(b"mdapy " * 5000)
    out = mt.compress_file(str(src))
    assert out == str(src) + ".gz"
    assert gzip.open(out, "rb").read() == src.read_bytes()
    for bad, err in ((str(tmp_path / "missing"), FileNotFoundError), (out, ValueError)):
        with pytest.raises(err) as je:
            mp.compress_file(bad)
        with pytest.raises(err) as te:
            mt.compress_file(bad)
        assert str(te.value) == str(je.value)


def test_plot_settings_match_jax(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mp.pltset()
    want = dict(plt.rcParams)
    mt.pltset()
    assert dict(plt.rcParams) == want
    fig, ax = mt.set_figure(figsize=(8, 6), nrow=1, ncol=2)
    assert isinstance(ax, list) and len(ax) == 2
    mt.save_figure(fig, str(tmp_path / "f.png"))
    assert (tmp_path / "f.png").stat().st_size > 0
    plt.close("all")


def test_phonon_and_view_raise_as_jax():
    for pkg_mod, port_mod, make in (
            ("mdapy_tpu.analysis.phonon", "mdapy_tpu_torch.analysis.phonon",
             lambda cls, s: cls("0 0 0 0.5 0.5 0.5", "G X", s)),
            ("mdapy_tpu.render.visualize", "mdapy_tpu_torch.render.visualize",
             lambda cls, s: cls(s))):
        import importlib

        j = importlib.import_module(pkg_mod)
        t = importlib.import_module(port_mod)
        name = "Phonon" if "phonon" in pkg_mod else "View"
        with pytest.raises(ImportError) as je:
            make(getattr(j, name), mp.build_crystal("Cu", "fcc", 3.615))
        with pytest.raises(ImportError) as te:
            make(getattr(t, name), mt.build_crystal("Cu", "fcc", 3.615,
                                                   device="cpu"))
        assert str(te.value) == str(je.value)
    assert mt.View._STRUCTURE_SCHEMES == mp.View._STRUCTURE_SCHEMES
    assert mt.IdentifyFCCPlanarFaults is mt.IdentifyFccPlanarFaults


def test_run_gpumd_without_the_binary_raises_as_jax(tmp_path):
    for pkg in (mp, mt):
        with pytest.raises(FileNotFoundError):
            pkg.run_gpumd(str(tmp_path), gpumd_exe=str(tmp_path / "no_gpumd"))
