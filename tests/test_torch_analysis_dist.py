"""Port parity: the distributions, graphs and displacements
(``mdapy_tpu_torch/analysis/``, ROADMAP A10, modules 10-16: structure
entropy, RDF (the Verlet and the streaming routes), ADF, bond analysis,
clusters, atomic strain, Wigner-Seitz).

The same seeded positions go through the JAX package's class (on the CPU,
float64, as ``tests/conftest.py`` sets it) and the port's
(``device="cpu"``): histogram counts, labels and ids equal, floats within
1e-10, g(r) within 1e-12 relative.  In a perfect crystal, bond angles sit
exactly on ADF's and bond analysis's bin edges (60, 90 and 120 degrees at
nbin 180): there the JAX package's neighbor distances and XLA's ``arccos``
round differently from the port's in the last place and move a count by
one bin (ROADMAP C10), so on perfect crystals the two edge bins are
compared together.  ``chip_smoke.py`` [S3]-[S4] run the classes on the
card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdapy_tpu as mp
from mdapy_tpu.analysis.cluster_analysis import (
    connected_components as scipy_components, connected_components_jax)
from mdapy_tpu.neighbor.neighbor import neighbor_search as jsearch
import mdapy_tpu_torch as mt
from mdapy_tpu_torch.analysis import common
from mdapy_tpu_torch.analysis.cluster_analysis import connected_components
from mdapy_tpu_torch.core.box import Box
from mdapy_tpu_torch.neighbor.neighbor import neighbor_search

from _torch_system import StandInSystem

TOL = 1e-10


def crystal(kind="fcc", a=3.615, cells=(4, 4, 4), sigma=0.05, seed=0):
    s = mp.build_crystal("Cu", kind, a, nx=cells[0], ny=cells[1], nz=cells[2])
    pos = np.asarray(s.pos)
    if sigma:
        pos = pos + np.random.default_rng(seed).normal(0.0, sigma, pos.shape)
    return pos, np.asarray(s.box.matrix)


def tilted(sigma=0.05):
    """The 4x4x4 FCC block in a sheared (triclinic) periodic cell."""
    pos, m = crystal(sigma=sigma)
    t = np.array([[1.0, 0, 0], [0.15, 1, 0], [-0.1, 0.05, 1]])
    return pos @ t, m @ t


def types_of(n, seed=1):
    return np.random.default_rng(seed).integers(1, 3, n)


def lists(pos, m, rc):
    """Each package's own Verlet list of the same positions."""
    return jsearch(pos, mp.Box(m), rc), neighbor_search(pos, Box(m), rc,
                                                        device="cpu")


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("cell", ["cubic", "triclinic"])
def test_structure_entropy_matches_jax(local, cell):
    pos, m = crystal() if cell == "cubic" else tilted()
    jl, tl = lists(pos, m, 5.0)
    j = mp.StructureEntropy(pos, mp.Box(m), 5.0, 0.2, local, *jl).compute()
    t = mt.StructureEntropy(pos, Box(m), 5.0, 0.2, local, *tl,
                            device="cpu").compute()
    np.testing.assert_allclose(t.entropy, j.entropy, rtol=0, atol=TOL)


def assert_rdf(t, j):
    np.testing.assert_array_equal(t.r, j.r)
    np.testing.assert_allclose(t.g_total, j.g_total, rtol=1e-12, atol=0)
    assert t.g_partial.keys() == j.g_partial.keys()
    for k in j.g_partial:
        np.testing.assert_allclose(t.g_partial[k], j.g_partial[k],
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("route", ["verlet", "streaming", "auto", "given",
                                   "elements"])
def test_rdf_matches_jax(route):
    pos, m = crystal()
    labels = types_of(len(pos))
    kw = {"types": labels}
    if route == "verlet":
        kw["streaming"] = False
    elif route == "streaming":
        kw["streaming"] = True
    elif route == "given":
        jl, tl = lists(pos, m, 5.0)
    elif route == "elements":
        kw = {"elements": np.where(labels == 1, "Cu", "Ni")}
    if route == "auto":
        # 14.46 A thick: the auto rule streams at rc 5 (>= 14.46 / 3)
        assert mt.RadialDistributionFunction(pos, Box(m), 5.0, device="cpu"
                                             )._auto_streaming()
    if route == "given":
        j = mp.RadialDistributionFunction(pos, mp.Box(m), 5.0, 60, **kw,
                                          verlet_list=jl[0],
                                          distance_list=jl[1],
                                          neighbor_number=jl[2]).compute()
        t = mt.RadialDistributionFunction(pos, Box(m), 5.0, 60, **kw,
                                          verlet_list=tl[0],
                                          distance_list=tl[1],
                                          neighbor_number=tl[2],
                                          device="cpu").compute()
    else:
        j = mp.RadialDistributionFunction(pos, mp.Box(m), 5.0, 60, **kw).compute()
        t = mt.RadialDistributionFunction(pos, Box(m), 5.0, 60, **kw,
                                          device="cpu").compute()
    assert_rdf(t, j)


def test_rdf_streaming_equals_verlet_route_on_a_small_box():
    """A 2x2x2 block at rc 6: both routes replicate it and count the
    periodic self-images within rc."""
    pos, m = crystal(cells=(2, 2, 2))
    a, b = (mt.RadialDistributionFunction(pos, Box(m), 6.0, 40, streaming=s,
                                          device="cpu").compute()
            for s in (True, False))
    np.testing.assert_array_equal(a.g_total, b.g_total)
    j = mp.RadialDistributionFunction(pos, mp.Box(m), 6.0, 40,
                                      streaming=True).compute()
    assert_rdf(a, j)


RC_ADF = {"1-1-2": [0.0, 3.0, 0.0, 3.0], "2-1-1": [0.0, 3.0, 2.0, 2.8],
          "1-2-2": [2.2, 3.0, 0.0, 3.0]}


@pytest.mark.parametrize("cell", ["cubic", "triclinic"])
def test_adf_matches_jax(cell):
    pos, m = crystal() if cell == "cubic" else tilted()
    labels = types_of(len(pos))
    j = mp.AngularDistributionFunction(pos, mp.Box(m), RC_ADF, nbin=90,
                                       types=labels).compute()
    t = mt.AngularDistributionFunction(pos, Box(m), RC_ADF, nbin=90,
                                       types=labels, device="cpu").compute()
    np.testing.assert_array_equal(t.bond_angle_distribution,
                                  j.bond_angle_distribution)
    np.testing.assert_array_equal(t.r_angle, j.r_angle)
    assert t.bond_angle_distribution.sum() > 1000


@pytest.mark.parametrize("cell", ["cubic", "triclinic"])
def test_bond_analysis_matches_jax(cell):
    pos, m = crystal() if cell == "cubic" else tilted()
    jl, tl = lists(pos, m, 3.0)
    j = mp.BondAnalysis(pos, mp.Box(m), 3.0, 90, *jl).compute()
    t = mt.BondAnalysis(pos, Box(m), 3.0, 90, *tl, device="cpu").compute()
    np.testing.assert_array_equal(t.bond_length_distribution,
                                  j.bond_length_distribution)
    np.testing.assert_array_equal(t.bond_angle_distribution,
                                  j.bond_angle_distribution)
    np.testing.assert_array_equal(t.r_angle, j.r_angle)


def edge_merged(hist, edges):
    """The histogram with bins e - 1 and e summed for each edge e."""
    h = np.array(hist, dtype=np.int64)
    for e in edges:
        h[e - 1] += h[e]
        h[e] = 0
    return h


@pytest.mark.parametrize("kind,a", [("fcc", 3.615), ("hcp", 2.5)])
def test_perfect_crystal_angles_differ_only_across_bin_edges(kind, a):
    """ROADMAP C10: on a perfect crystal the two packages may put an angle
    of exactly 60, 90 or 120 degrees on either side of its bin edge; the
    counts agree once the two bins at each edge are summed, and the
    lengths agree bin for bin."""
    pos, m = crystal(kind, a, (3, 3, 3), sigma=0.0)
    jl, tl = lists(pos, m, 3.0)
    j = mp.BondAnalysis(pos, mp.Box(m), 3.0, 180, *jl).compute()
    t = mt.BondAnalysis(pos, Box(m), 3.0, 180, *tl, device="cpu").compute()
    np.testing.assert_array_equal(t.bond_length_distribution,
                                  j.bond_length_distribution)
    np.testing.assert_array_equal(
        edge_merged(t.bond_angle_distribution, (60, 90, 120)),
        edge_merged(j.bond_angle_distribution, (60, 90, 120)))
    ones = np.ones(len(pos), int)
    rc = {"1-1-1": [0.0, 3.0, 0.0, 3.0]}
    j = mp.AngularDistributionFunction(pos, mp.Box(m), rc, nbin=180,
                                       types=ones).compute()
    t = mt.AngularDistributionFunction(pos, Box(m), rc, nbin=180,
                                       types=ones, device="cpu").compute()
    np.testing.assert_array_equal(
        edge_merged(t.bond_angle_distribution[0], (60, 90, 120)),
        edge_merged(j.bond_angle_distribution[0], (60, 90, 120)))


@pytest.mark.parametrize("rc", ["scalar", "per_type"])
def test_cluster_ids_match_jax(rc):
    pos, m = crystal(cells=(5, 5, 5))
    keep = np.random.default_rng(3).random(len(pos)) > 0.85   # below percolation
    pos, types = pos[keep], types_of(len(pos))[keep]
    cut = 2.9 if rc == "scalar" else {"1-1": 2.9, "1-2": 2.7, "2-2": 2.5}
    j = mp.ClusterAnalysis(pos, mp.Box(m), cut, types=types).compute()
    t = mt.ClusterAnalysis(pos, Box(m), cut, types=types,
                           device="cpu").compute()
    assert t.cluster_number == j.cluster_number > 20
    np.testing.assert_array_equal(t.particleClusters, j.particleClusters)
    assert t.get_size_of_cluster(1) == j.get_size_of_cluster(1)


def test_device_components_match_scipy_and_jax():
    """Min-label propagation with pointer jumping against the JAX package's
    scipy route and its ``connected_components_jax`` on a random graph."""
    rng = np.random.default_rng(5)
    n, M = 3000, 6
    verlet = rng.integers(-1, n, (n, M)).astype(np.int32)
    verlet[np.arange(0, n, 3)] = -1
    bonded = verlet >= 0
    # symmetrise: j in row i <=> i in a slot of row j (extra columns)
    ii, ss = np.nonzero(bonded)
    jj = verlet[ii, ss]
    back = np.full((n, 64), -1, np.int32)
    fill = np.zeros(n, int)
    for i, j in zip(ii, jj):
        back[j, fill[j]] = i
        fill[j] += 1
    verlet = np.concatenate([verlet, back[:, :fill.max()]], axis=1)
    bonded = verlet >= 0
    got = connected_components(torch.tensor(verlet), torch.tensor(bonded))
    want = scipy_components(verlet, bonded)
    ids = torch.unique(got, return_inverse=True)[1].numpy()
    _, first = np.unique(want, return_index=True)
    order = np.argsort(np.argsort(first))
    np.testing.assert_array_equal(ids, order[want])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(connected_components_jax(
            jnp.asarray(verlet), jnp.asarray(bonded))))


def sheared(pos, m, gamma=0.01, sigma=0.02, seed=5):
    t = np.eye(3)
    t[0, 1] = gamma
    rng = np.random.default_rng(seed)
    return pos @ t + rng.normal(0.0, sigma, pos.shape), m @ t


@pytest.mark.parametrize("affine", [False, True])
def test_atomic_strain_matches_jax(affine):
    pos, m = crystal()
    cur_pos, cur_m = sheared(pos, m)
    j = mp.AtomicStrain(5.0, mp.System(pos=pos, box=m), affine=affine).compute(
        mp.System(pos=cur_pos, box=cur_m))
    cur = StandInSystem(cur_pos, cur_m, "Cu")
    t = mt.AtomicStrain(5.0, StandInSystem(pos, m, "Cu"), affine=affine,
                        device="cpu").compute(cur)
    np.testing.assert_allclose(t.shear_strain, j.shear_strain, rtol=0, atol=TOL)
    np.testing.assert_allclose(t.volumetric_strain, j.volumetric_strain,
                               rtol=0, atol=TOL)
    assert cur.data["shear_strain"] is t.shear_strain
    assert t.shear_strain.mean() > 1e-3


def test_atomic_strain_singular_v_is_not_finite_as_in_jax():
    """An atom without neighbors (V = 0) and one whose neighbors lie in a
    plane (a singular V) give what JAX gives, inf or nan, not an error."""
    pos, m = crystal(sigma=0.0)
    m = m.copy()
    m[2, 2] = 40.0                        # one layer of atoms, far apart in z
    pos = pos[pos[:, 2] < 0.1]
    pos = np.vstack([pos, [[3.0, 3.0, 20.0]]])
    cur_pos, cur_m = sheared(pos, m, sigma=0.0)
    j = mp.AtomicStrain(3.0, mp.System(pos=pos, box=m)).compute(
        mp.System(pos=cur_pos, box=cur_m))
    t = mt.AtomicStrain(3.0, StandInSystem(pos, m, "Cu"),
                        device="cpu").compute(StandInSystem(cur_pos, cur_m, "Cu"))
    assert not np.isfinite(j.shear_strain).any()
    for got, want in ((t.shear_strain, j.shear_strain),
                      (t.volumetric_strain, j.volumetric_strain)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))


@pytest.mark.parametrize("affine", [False, True])
def test_wigner_seitz_matches_jax(affine):
    ref, m = crystal(sigma=0.0)
    rng = np.random.default_rng(7)
    cur = ref + rng.normal(0.0, 0.05, ref.shape)
    moved = rng.choice(len(ref), 12, replace=False)
    # onto octahedral sites (a/2 along x), off their centre by the rattle
    cur[moved] += np.array([3.615 / 2, 0.0, 0.0])
    cur_m = m
    if affine:
        cur, cur_m = sheared(cur, m, gamma=0.03, sigma=0.0)
    j = mp.WignerSeitzAnalysis((ref, mp.Box(m)), affine=affine).compute(
        (cur, mp.Box(cur_m)))
    stand = StandInSystem(cur, cur_m, "Cu")
    t = mt.WignerSeitzAnalysis(StandInSystem(ref, m, "Cu"), affine=affine,
                               device="cpu").compute(stand)
    np.testing.assert_array_equal(t.occupancy, j.occupancy)
    assert (t.vacancy_number, t.interstitial_number) == (
        j.vacancy_number, j.interstitial_number)
    assert t.vacancy_number > 0
    assert stand.data["site_index"].shape == (len(ref),)


def test_chunked_rows_repeat_the_whole(monkeypatch):
    """Results are per row (sums) or integer counts: chunks of a few rows
    give the same bits."""
    pos, m = crystal()
    labels = types_of(len(pos))
    tl = neighbor_search(pos, Box(m), 5.0, device="cpu")

    def run():
        return (mt.StructureEntropy(pos, Box(m), 5.0, 0.2, True, *tl,
                                    device="cpu").compute().entropy,
                mt.RadialDistributionFunction(pos, Box(m), 5.0, 60,
                                              types=labels, streaming=True,
                                              device="cpu").compute().g_total,
                mt.RadialDistributionFunction(pos, Box(m), 5.0, 60,
                                              types=labels, streaming=False,
                                              device="cpu").compute().g_total,
                mt.AngularDistributionFunction(
                    pos, Box(m), RC_ADF, types=labels,
                    device="cpu").compute().bond_angle_distribution,
                mt.BondAnalysis(pos, Box(m), 3.0, 90, *tl,
                                device="cpu").compute().bond_angle_distribution)

    whole = run()
    monkeypatch.setattr(common, "CHUNK_BYTES", 200_000)
    for got, want in zip(run(), whole):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cls", ["CommonNeighborParameter", "StructureEntropy",
                                 "RadialDistributionFunction",
                                 "AngularDistributionFunction", "BondAnalysis",
                                 "ClusterAnalysis", "WignerSeitzAnalysis",
                                 "AtomicStrain"])
def test_card_is_the_default(cls):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default does not raise")
    pos, m = crystal(cells=(2, 2, 2))
    box = Box(m)
    args = {
        "CommonNeighborParameter": (pos, box, 3.0, None, None, None),
        "StructureEntropy": (pos, box, 5.0, 0.2, False, None, None, None),
        "RadialDistributionFunction": (pos, box),
        "AngularDistributionFunction": (pos, box, RC_ADF, 90,
                                        types_of(len(pos))),
        "BondAnalysis": (pos, box, 3.0, 90, None, None, None),
        "ClusterAnalysis": (pos, box),
        "WignerSeitzAnalysis": ((pos, box),),
        "AtomicStrain": (3.0, StandInSystem(pos, m, "Cu")),
    }[cls]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(mt, cls)(*args)
