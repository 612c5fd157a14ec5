"""The port's host analyses (ROADMAP A12c) against the JAX package's, on the
CPU, in float64: the structure factor (Debye and direct, partials, window,
a triclinic box, the weighted totals, ``get_pdf_from_sk``), Warren-Cowley,
atomic temperature, MSD, Lindemann, spatial binning, voids and the chemical
species, and the five ``System.cal_*`` that reach them.

Tolerances: 1e-12 relative to the largest value unless stated.  The
Warren-Cowley matrix, the void labels, the species counts and ``mol_id``
must be equal.  Direct-mode S(k) sums cosines and sines of phases up to
k_max |r| ~ 10^2 rad whose last bits differ between numpy's and torch's
products and trigonometry, so it is held at 1e-10 of its largest value;
window-mode MSD goes through two FFTs that round differently, so it is held
at 1e-10 of max |pos|^2."""

import numpy as np
import pytest
import torch

import mdapy_tpu as mp
import mdapy_tpu_torch as mt
from mdapy_tpu.analysis.spatial_binning import SpatialBinning as JaxBinning

CPU = "cpu"
RTOL = 1e-12
RTOL_DIRECT = 1e-10
RTOL_FFT = 1e-10


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    scale = max(1.0, float(np.abs(want[fin]).max())) if fin.any() else 1.0
    err = float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0
    assert err <= rtol * scale, (err, scale)


def _hea(triclinic=False, seed=1):
    """256 atoms of a rattled Al-Cu-Ni FCC HEA, as (pos, matrix, elements)."""
    s = mp.build_hea(("Al", "Cu", "Ni"), (0.3, 0.3, 0.4), "fcc", 3.6, nx=4,
                     ny=4, nz=4, random_seed=seed)
    m = np.asarray(s.box.matrix, dtype=float)
    pos = s.pos + np.random.default_rng(seed).normal(0.0, 0.05, s.pos.shape)
    if triclinic:
        shear = np.eye(3)
        shear[1, 0] = 0.2
        m, pos = m @ shear, pos @ shear
    return pos, m, np.asarray(s.data["element"]).astype(str)


SK = {
    "debye": dict(mode="debye"),
    "debye_partial_window": dict(mode="debye", cal_partial=True, window=True),
    "debye_rc_partial": dict(mode="debye", cal_partial=True, rc=6.0, nbin_rdf=120,
                             k_min=0.0),
    "direct": dict(mode="direct"),
    "direct_partial": dict(mode="direct", cal_partial=True, k_max=8.0, nbins=60),
    "triclinic_debye_partial": dict(mode="debye", cal_partial=True, tri=True),
    "triclinic_direct_partial": dict(mode="direct", cal_partial=True, k_max=7.0,
                                     nbins=50, tri=True),
    "form_factors": dict(mode="debye", atomic_form_factors=True, nbins=80),
}


@pytest.mark.parametrize("case", sorted(SK))
def test_structure_factor_matches_jax(case):
    kw = dict(SK[case])
    pos, m, el = _hea(triclinic=kw.pop("tri", False))
    j = mp.StructureFactor(pos, m, elements=el, **kw).compute()
    t = mt.StructureFactor(pos, m, elements=el, **kw, device=CPU).compute()
    rtol = RTOL_DIRECT if kw["mode"] == "direct" else RTOL
    _close(t.k, j.k, 0.0)
    _close(t.Sk, j.Sk, rtol)
    assert t.density == j.density
    if kw.get("cal_partial") or kw.get("atomic_form_factors"):
        assert sorted(map(str, t.Sk_partial)) == sorted(map(str, j.Sk_partial))
        for key in j.Sk_partial:
            _close(t.Sk_partial[key], j.Sk_partial[key], rtol)
        for name in ("get_xray_structure_factor", "get_neutron_structure_factor",
                     "get_electron_structure_factor"):
            _close(getattr(t, name)(), getattr(j, name)(), rtol)
    if kw.get("atomic_form_factors"):
        _close(t.Sk_xray, j.Sk_xray)
    r = np.linspace(0.5, 8.0, 50)
    _close(t.get_pdf_from_sk(r)[1], j.get_pdf_from_sk(r)[1], rtol)
    if kw["mode"] == "direct":
        assert t.k_point_number > 0 and t.chunk_rows > 0


def test_structure_factor_small_box_replicates_and_chunks(monkeypatch):
    """A 4-atom cell is replicated to at least 200 atoms as the JAX class
    does; chunking the k-points does not change a bit."""
    from mdapy_tpu_torch.analysis import common

    s = mp.build_crystal("Cu", "fcc", 3.615)
    kw = dict(mode="direct", k_max=9.0, nbins=40)
    j = mp.StructureFactor(s.pos, s.box.matrix, **kw).compute()
    t = mt.StructureFactor(s.pos, s.box.matrix, **kw, device=CPU).compute()
    _close(t.Sk, j.Sk, RTOL_DIRECT)
    monkeypatch.setattr(common, "CHUNK_BYTES", 8 * 256 * 3 * 7)
    t2 = mt.StructureFactor(s.pos, s.box.matrix, **kw, device=CPU).compute()
    assert t2.chunk_rows == 7 and t2.Sk.tobytes() == t.Sk.tobytes()


def test_structure_factor_invariants_on_the_port():
    """``tests/test_misc_fixtures.py``'s two S(k) invariants, on the port."""
    r0, L = 2.0, 20.0
    two = mt.System(pos=np.array([[0.0, 0, 0], [r0, 0, 0]]), box=[L, L, L],
                    element_list=["Cu", "Cu"], device=CPU)
    sfc = two.cal_structure_factor(0.5, 6.0, 50, mode="rdf", nbin_rdf=4000)
    np.testing.assert_allclose(sfc.Sk, 1.0 + np.sin(sfc.k * r0) / (sfc.k * r0),
                               atol=0.1)
    hea = mt.build_hea(("Al", "Cu"), (0.5, 0.5), "fcc", a=3.7, nx=4, ny=4, nz=4,
                       random_seed=1, device=CPU)
    sfc = hea.cal_structure_factor(0.5, 8.0, 60, cal_partial=True, mode="debye",
                                   nbin_rdf=200)
    assert set(sfc.Sk_partial) == {("Al", "Al"), ("Al", "Cu"), ("Cu", "Cu")}
    expected = (0.25 * sfc.Sk_partial[("Al", "Al")]
                + 0.5 * sfc.Sk_partial[("Al", "Cu")]
                + 0.25 * sfc.Sk_partial[("Cu", "Cu")])
    np.testing.assert_allclose(sfc.Sk, expected, atol=1e-12)


def _shell_bounds(pos, cells, a, nbin):
    """Per bin of the RDF at rc = L/2 on a perfect FCC block of ``cells``^3
    cells: the pairs certainly in the bin (exact integer distances) and the
    pairs whose exact distance lies on one of its edges, which rounding may
    put on either side.  Positions are multiples of a/2, so with q = pos /
    (a/2) a pair's r/dr = nbin * sqrt(n2) / cells for an integer n2."""
    q = np.rint(pos / (a / 2)).astype(np.int64)
    d = q[None] - q[:, None]
    d -= np.rint(d / (2 * cells)).astype(np.int64) * 2 * cells
    n2 = (d * d).sum(-1)[~np.eye(len(q), dtype=bool)]
    x = nbin * nbin * n2                  # (r / dr)^2 * cells^2
    flo = x // cells**2
    k = np.floor(np.sqrt(flo)).astype(np.int64)
    k += (k + 1) ** 2 <= flo
    k -= k * k > flo
    edge = (x % cells**2 == 0) & (k * k == flo)
    sure = np.bincount(k[(n2 < cells**2) & ~edge], minlength=nbin)
    m = k[edge & (k <= nbin)]
    slack = (np.bincount(m[m >= 1] - 1, minlength=nbin)[:nbin]
             + np.bincount(m[m < nbin], minlength=nbin))
    return sure, slack


def test_debye_default_rc_on_a_perfect_lattice_moves_only_shell_pairs():
    """ROADMAP C15: at Debye S(k)'s default rc = L/2 a perfect crystal puts
    pairs at exactly rc and on RDF bin edges.  The port sums each squared
    norm in its written order ((x*x + y*y) + z*z, the card alike); the JAX
    package's jit fuses it into FMAs.  Each package's counts hold every
    pair off an edge in its exact bin, and differ from it only by pairs on
    an edge; the port's equal numpy's evaluation of the written order."""
    cells, a, nbin = 6, 3.59, 200
    s = mp.build_hea(("Co", "Ni", "Cr"), (0.3, 0.3, 0.4), "fcc", a, nx=cells,
                     ny=cells, nz=cells, random_seed=2)
    pos, m = np.asarray(s.pos), np.asarray(s.box.matrix)
    el = np.asarray(s.data["element"]).astype(str)
    rc = m[0, 0] / 2
    j = mp.RadialDistributionFunction(pos, m, rc, nbin, elements=el)
    t = mt.RadialDistributionFunction(pos, m, rc, nbin, elements=el, device=CPU)
    assert t._auto_streaming() and j._auto_streaming()
    jc = np.asarray(j._stream_counts()).sum(axis=(0, 1)).astype(np.int64)
    tc = t._stream_counts(torch.as_tensor(t.type_idx)).numpy().sum(axis=(0, 1))
    sure, slack = _shell_bounds(pos, cells, a, nbin)
    assert slack.sum() > 0 and slack[-1] > 0      # shells at rc and on edges
    for got in (tc, jc):
        assert (got >= sure).all() and (got <= sure + slack).all()
    assert np.array_equal(tc[slack == 0], jc[slack == 0])
    disp = pos[None] - pos[:, None]
    frac = disp @ np.asarray(s.box.inverse_box)
    disp = (frac - np.round(frac)) @ m
    r = np.sqrt((disp[..., 0] ** 2 + disp[..., 1] ** 2) + disp[..., 2] ** 2)
    ok = (r < rc) & (r > 0.0)
    want = np.bincount(np.minimum((r[ok] / (rc / nbin)).astype(np.int64),
                                  nbin - 1), minlength=nbin)
    assert np.array_equal(tc, want)


@pytest.mark.parametrize("labels", ["elements", "types"])
def test_warren_cowley_matches_jax_exactly(labels):
    s = mp.build_hea(("Al", "Cu", "Ni"), (0.3, 0.3, 0.4), "fcc", 3.6, nx=5, ny=5,
                     nz=5, random_seed=2)
    v, d, n = s.build_neighbor(3.0)
    el = np.asarray(s.data["element"]).astype(str) if labels == "elements" else None
    j = mp.WarrenCowleyParameter(s.data["type"], v, n, elements=el).compute()
    t = mt.WarrenCowleyParameter(s.data["type"], v, n, elements=el,
                                 device=CPU).compute()
    assert t.WCP.tobytes() == j.WCP.tobytes() and t.wcp is t.WCP
    assert t.elements == j.elements and t.Ntype == j.Ntype == 3
    assert np.abs(t.WCP).max() < 0.2


def _maxwell(n, mass, temp, seed):
    """Maxwell velocities (A/fs) at ``temp`` K, no net momentum."""
    kb, amu = 1.380649e-23, 1.0 / 6.022140857e23 / 1000.0
    sigma = np.sqrt(kb * temp / (mass * amu)) * 1e-5   # m/s -> A/fs
    vel = np.random.default_rng(seed).normal(0.0, sigma, (n, 3))
    return vel - vel.mean(axis=0)


def test_atomic_temperature_matches_jax():
    s = mp.build_crystal("Cu", "fcc", 3.615, nx=5, ny=5, nz=5)
    v, d, n = s.build_neighbor(5.0)
    rng = np.random.default_rng(3)
    vel = rng.normal(0.0, 5.0, (s.N, 3))
    mass = 60.0 + rng.random(s.N)
    for kw in ({}, {"rc": 4.0, "distance_list": d}):
        j = mp.AtomicTemperature(mass, vel, v, n, **kw).compute()
        t = mt.AtomicTemperature(mass, vel, v, n, **kw, device=CPU).compute()
        _close(t.T, j.T)


def test_atomic_temperature_maxwell_on_the_port():
    """``tests/test_misc_fixtures.py:207-222``, on the port's System."""
    s = mt.build_crystal("Cu", "fcc", 3.615, nx=6, ny=6, nz=6, device=CPU)
    vel = _maxwell(s.N, 63.546, 300.0, 1)
    s.update_data(s.data.with_columns(vx=vel[:, 0], vy=vel[:, 1], vz=vel[:, 2]))
    temp = s.cal_atomic_temperature(6.0)
    assert np.array_equal(temp, s.data["atomic_temp"])
    assert abs(temp.mean() - 300.0) / 300.0 < 0.05 and (temp > 0).all()


def _walk(frames=40, atoms=30, seed=4):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.normal(0.0, 0.3, (frames, atoms, 3)), axis=0)
            + rng.random((1, atoms, 3)) * 20.0)


@pytest.mark.parametrize("mode", ["window", "direct"])
def test_msd_matches_jax(mode):
    p = _walk()
    j = mp.MeanSquaredDisplacement(p, mode=mode).compute()
    t = mt.MeanSquaredDisplacement(p, mode=mode, device=CPU).compute()
    scale = float(np.abs(p).max()) ** 2
    tol = RTOL_FFT * scale if mode == "window" else 0.0
    assert np.abs(t.particle_msd - j.particle_msd).max() <= tol
    assert np.abs(t.msd - j.msd).max() <= tol
    with pytest.raises(ValueError, match="mode"):
        mt.MeanSquaredDisplacement(p, mode="fft", device=CPU)


def test_msd_modes_agree_on_the_port():
    p = _walk(64, 20, 5)
    w = mt.MeanSquaredDisplacement(p, mode="window", device=CPU).compute()
    d = mt.MeanSquaredDisplacement(p, mode="direct", device=CPU).compute()
    assert w.msd[0] == pytest.approx(0.0, abs=1e-9)
    assert np.all(d.msd[1:] > 0)


@pytest.mark.parametrize("only_global", [True, False])
def test_lindemann_matches_jax(only_global):
    p = _walk(25, 40, 6)
    j = mp.LindemannParameter(p, only_global=only_global).compute()
    t = mt.LindemannParameter(p, only_global=only_global, device=CPU).compute()
    assert abs(t.lindemann_trj - j.lindemann_trj) <= RTOL * j.lindemann_trj
    _close(t.lindemann_frame, j.lindemann_frame)
    if only_global:
        assert t.lindemann_atom is None
    else:
        _close(t.lindemann_atom, j.lindemann_atom)
    g = mt.LindemannParameter(p, only_global=True, device=CPU).compute()
    assert g.lindemann_trj == t.lindemann_trj


OPS = ["mean", "sum", "count", "min", "max", "sum/binvol"]


@pytest.mark.parametrize("direction", ["x", "y", "z", "xy", "xz", "yz", "xyz"])
def test_spatial_binning_matches_jax(direction):
    s = mp.build_crystal("Cu", "fcc", 3.615, nx=5, ny=4, nz=3)
    rng = np.random.default_rng(7)
    pos = s.pos + rng.normal(0.0, 0.1, s.pos.shape)
    data = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
            "q": rng.normal(size=s.N)}
    j = JaxBinning(data, s.box, direction, 2.5).compute(["q"] * 6, OPS)
    t = mt.SpatialBinning(data, mt.Box(s.box.matrix), direction, 2.5,
                          device=CPU).compute(["q"] * 6, OPS)
    assert sorted(t.result) == sorted(j.result)
    for key in j.result:
        assert t.result[key].shape == j.result[key].shape
        _close(t.result[key], j.result[key],
               0.0 if key.endswith(("count", "min", "max")) else RTOL)
    for a, b in zip(t.coor, j.coor):
        assert a.tobytes() == b.tobytes()


def test_spatial_binning_analytic_on_the_port():
    """``tests/test_misc_fixtures.py:293-327``, on the port."""
    data = {"x": np.array([1.0, 6.0, 11.0, 16.0]), "y": np.full(4, 2.0),
            "z": np.full(4, 2.0), "mass": np.array([1.0, 2.0, 3.0, 4.0])}
    sb = mt.SpatialBinning(data, mt.Box([20.0, 4.0, 4.0]), "x", bin_width=5.0,
                           device=CPU)
    sb.compute(["mass", "mass"], ["sum", "count"])
    np.testing.assert_allclose(sb.result["mass_sum"], [1, 2, 3, 4])
    np.testing.assert_allclose(sb.result["mass_count"], [1, 1, 1, 1])
    rng = np.random.default_rng(5)
    d2 = {"x": rng.uniform(0, 10, 400), "y": rng.uniform(0, 10, 400),
          "z": rng.uniform(0, 10, 400)}
    d2["q"] = np.where(d2["x"] < 5, 1.0, 2.0) * np.where(d2["y"] < 5, 1.0, 3.0)
    sb2 = mt.SpatialBinning(d2, mt.Box([10.0, 10.0, 10.0]), "xy", bin_width=5.0,
                            device=CPU)
    sb2.compute("q", "mean")
    np.testing.assert_allclose(sb2.result["q_mean"], [[1.0, 3.0], [2.0, 6.0]])
    with pytest.raises(ValueError, match="Unknown operation"):
        sb2.compute("q", "median")
    with pytest.raises(ValueError, match="orthogonal"):
        mt.SpatialBinning(d2, mt.Box(np.eye(3) * 10 + np.eye(3, k=1)), "x",
                          device=CPU)


def _holed_block(pkg, boundary=(1, 1, 1)):
    kw = {} if pkg is mp else {"device": CPU}
    fcc = pkg.build_crystal("Al", "fcc", 4.05, nx=12, ny=12, nz=12, **kw)
    d = fcc.data
    x, y, z = d["x"], d["y"], d["z"]
    keep = (((x - 10) ** 2 + (y - 10) ** 2 + (z - 10) ** 2 > 36)
            & ((x - 30) ** 2 + (y - 30) ** 2 + (z - 30) ** 2 > 30)
            & ((x - 40) ** 2 + (y - 8) ** 2 + (z - 1) ** 2 > 40))
    pos = fcc.pos[keep]
    return pkg.System(pos=pos, box=pkg.Box(fcc.box.matrix, boundary=list(boundary)),
                      **kw)


@pytest.mark.parametrize("boundary", [(1, 1, 1), (1, 0, 1)])
def test_void_analysis_matches_scipy(boundary):
    j = mp.VoidAnalysis(_holed_block(mp, boundary), 4.1).compute()
    t = mt.VoidAnalysis(_holed_block(mt, boundary), 4.1, device=CPU).compute()
    assert t.void_number == j.void_number >= 3
    assert t.void_volume == j.void_volume
    assert t.void_labels.dtype == j.void_labels.dtype
    assert np.array_equal(t.void_labels, j.void_labels)
    full = mt.VoidAnalysis(mt.build_crystal("Al", "fcc", 4.05, nx=6, ny=6, nz=6,
                                            device=CPU), 4.1, device=CPU).compute()
    assert full.void_number == 0 and full.void_volume == 0.0


def _water(n_side, spacing=3.1, seed=0):
    """A box of n_side^3 water molecules on a grid, seeded orientations; the
    same builder as ``chip_smoke.py`` [S5]."""
    from _water_box import water_box

    return water_box(n_side, spacing, seed)


def _fragmented_water():
    pos, el, L = _water(6)
    drop = [3 * 3 + 2, 7 * 3 + 2, 11 * 3]          # two OH, one lone H pair
    keep = np.setdiff1d(np.arange(len(pos)), drop)
    pos = np.r_[pos[keep], [[1.55, 1.55, 1.55], [1.55, 1.55, 2.29]]]   # H2
    return pos, np.r_[el[keep], ["H", "H"]], L


@pytest.mark.parametrize("kw", [{}, {"check_most": 2},
                                {"search_species": ["H2O", "OH", "HO", "H2", "O"],
                                 "add_mol_id": True},
                                {"search_species": ["OH2"], "add_mol_id": True}],
                         ids=["most_common", "check_most", "search", "canonical"])
def test_chemical_species_matches_jax(kw):
    pos, el, L = _fragmented_water()
    j = mp.System(pos=pos, box=np.eye(3) * L, element_list=el)
    t = mt.System(pos=pos, box=np.eye(3) * L, element_list=el, device=CPU)
    got = t.cal_chemical_species(scale=0.4, **kw)
    want = j.cal_chemical_species(scale=0.4, **kw)
    assert list(got.items()) == list(want.items())
    if kw.get("add_mol_id"):
        assert t.data["mol_id"].dtype == np.int32
        assert np.array_equal(t.data["mol_id"], j.data["mol_id"])
    if not kw:
        assert got == {"H2O": 213, "HO": 2, "H": 2, "H2": 1}


def test_water_box_is_all_water():
    pos, el, L = _water(5, seed=3)
    t = mt.System(pos=pos, box=np.eye(3) * L, element_list=el, device=CPU)
    res = t.cal_chemical_species(["H2O"], scale=0.4, add_mol_id=True)
    assert res["H2O"] * 3 == t.N and (t.data["mol_id"] == 0).all()


def _system_with_velocities():
    s = mt.build_hea(("Cu", "Ni"), (0.5, 0.5), "fcc", 3.6, nx=4, ny=4, nz=4,
                     random_seed=3, device=CPU)
    vel = _maxwell(s.N, 60.0, 300.0, 2)
    s.update_data(s.data.with_columns(vx=vel[:, 0], vy=vel[:, 1], vz=vel[:, 2]))
    return s


def _direct(name, s):
    pos, box = s.pos, s.box
    el = np.asarray(s.data["element"]).astype(str)
    if name == "structure_factor":
        return mt.StructureFactor(pos, box, cal_partial=True, types=s.data["type"],
                                  elements=el, device=CPU).compute().Sk
    if name == "void":
        return mt.VoidAnalysis(s, 3.0, device=CPU).compute().void_labels
    rc = 3.0 if name == "warren_cowley" else 5.0
    nb = mt.Neighbor(pos, box, rc, device=CPU).compute()
    v, n = nb.verlet_list, nb.neighbor_number
    if name == "warren_cowley":
        return mt.WarrenCowleyParameter(s.data["type"], v, n, elements=el,
                                        device=CPU).compute().WCP
    amass = np.where(el == "Cu", 63.546, 58.6934)
    return mt.AtomicTemperature(amass, s.vel * 1e3, v, n, device=CPU).compute().T


def _via_system(name, s):
    if name == "structure_factor":
        return s.cal_structure_factor(cal_partial=True).Sk
    if name == "warren_cowley":
        return s.cal_warren_cowley_parameter(3.0).WCP
    if name == "atomic_temperature":
        return s.cal_atomic_temperature(5.0)
    if name == "void":
        return s.cal_void_analysis(3.0).void_labels
    raise KeyError(name)


@pytest.mark.parametrize("name", ["structure_factor", "warren_cowley",
                                  "atomic_temperature", "void"])
def test_system_cal_equals_the_direct_call(name):
    s = _system_with_velocities()
    if name == "void":
        s.update_data(s.data.filter(s.pos[:, 0] > 5.0))   # a slab of empty cells
    got = np.asarray(_via_system(name, s))
    want = np.asarray(_direct(name, s))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    if name == "atomic_temperature":
        assert np.array_equal(s.data["atomic_temp"], got)


def test_system_cal_chemical_species_equals_the_grouped_count():
    pos, el, L = _fragmented_water()
    s = mt.System(pos=pos, box=np.eye(3) * L, element_list=el, device=CPU)
    res = s.cal_chemical_species(["H2O", "HO"], scale=0.4, add_mol_id=True)
    assert res == {"H2O": 213, "HO": 2}
    mid = s.data["mol_id"]
    assert (mid == 0).sum() == 3 * 213 and (mid == 1).sum() == 4
    assert (mid == -1).sum() == 4


@pytest.mark.parametrize("cls,args", [
    ("StructureFactor", (np.zeros((2, 3)), np.eye(3) * 5)),
    ("WarrenCowleyParameter", (np.ones(2), np.zeros((2, 1)), np.ones(2))),
    ("AtomicTemperature", (np.ones(2), np.zeros((2, 3)), np.zeros((2, 1)),
                           np.ones(2))),
    ("MeanSquaredDisplacement", (np.zeros((3, 2, 3)),)),
    ("LindemannParameter", (np.zeros((3, 2, 3)),)),
    ("VoidAnalysis", (None,)),
])
def test_the_card_is_the_default(cls, args):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(mt, cls)(*args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.SpatialBinning({"x": np.zeros(1)}, mt.Box([5.0, 5.0, 5.0]))
