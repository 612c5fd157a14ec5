"""Port parity: the structure classifiers (``mdapy_tpu_torch/analysis/``,
ROADMAP A10, modules 1-9: ``common``, ``cna_core``, CSP, CNA, Ackland-Jones,
diamond, CNP, Steinhardt, Chill+).

The same seeded positions go through the JAX package's class (on the CPU,
float64, as ``tests/conftest.py`` sets it) and the port's
(``device="cpu"``): labels equal, floats within 1e-10.  Inputs are perfect
and rattled FCC, BCC, HCP (a hexagonal, so triclinic, cell), cubic and
hexagonal diamond, FCC in its triclinic primitive cell, and an FCC box one
cell thick, which the neighbor searches must replicate.  kNN picks k past
a shell boundary in some perfect crystals (14 in FCC, 12 in BCC): the
port's list equals the JAX package's as a set but not in order among equal
distances, so floats are compared on rattled inputs and on perfect ones
only where k closes a shell.  ``chip_smoke.py`` [S1]-[S2] run the classes
on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdapy_tpu as mp
from mdapy_tpu.analysis import cna_core as jcna
from mdapy_tpu.analysis.common import min_image_jnp, neighbor_disp as jdisp
from mdapy_tpu.analysis.steinhardt_bond_orientation import (
    clebsch_gordan_list as jcg)
from mdapy_tpu.neighbor.knn import knn_search as jknn
from mdapy_tpu.neighbor.neighbor import neighbor_search as jsearch
import mdapy_tpu_torch as mt
from mdapy_tpu_torch.analysis import cna_core, common
from mdapy_tpu_torch.analysis.steinhardt_bond_orientation import (
    clebsch_gordan_list)
from mdapy_tpu_torch.core.box import Box
from mdapy_tpu_torch.neighbor.neighbor import neighbor_search

TOL = 1e-10


def _fcc_primitive(cells, a=3.615):
    """FCC in its rhombohedral primitive cell, one atom a cell: a triclinic
    box."""
    m = 0.5 * a * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]])
    ijk = np.mgrid[tuple(slice(0, c) for c in cells)].reshape(3, -1).T
    return ijk @ m, m * np.array(cells, dtype=float)[:, None]


# name -> (structure, a, cells, rattle); 108, 128 or 216 atoms, so that the
# JAX package compiles each of its functions for three shapes only
LATTICES = {
    "fcc": ("fcc", 3.615, (3, 3, 3), 0.0),
    "fcc_rattled": ("fcc", 3.615, (3, 3, 3), 0.05),
    "small_box_rattled": ("fcc", 3.615, (1, 3, 9), 0.05),
    "bcc_rattled": ("bcc", 2.8665, (4, 4, 4), 0.05),
    "hcp": ("hcp", 2.5, (4, 4, 4), 0.0),
    "hcp_rattled": ("hcp", 2.5, (4, 4, 4), 0.05),
    "triclinic_rattled": ("primitive", 3.615, (4, 4, 8), 0.05),
    "hex_diamond": ("wurtzite", 2.52, (4, 4, 2), 0.0),
    "diamond": ("diamond", 5.431, (3, 3, 3), 0.0),
    "diamond_rattled": ("diamond", 5.431, (3, 3, 3), 0.05),
    "ice": ("diamond", 6.35, (3, 3, 3), 0.0),
    "ice_rattled": ("diamond", 6.35, (3, 3, 3), 0.1),
}
# inputs whose kNN lists and rc lists hold no order-dependent tie
GENERAL = ["fcc", "fcc_rattled", "bcc_rattled", "hcp", "hcp_rattled",
           "triclinic_rattled", "small_box_rattled", "diamond_rattled"]


def lattice(name, seed=0):
    kind, a, cells, sigma = LATTICES[name]
    if kind == "primitive":
        pos, m = _fcc_primitive(cells, a)
    else:
        nx, ny, nz = cells
        s = mp.build_crystal("C" if kind == "wurtzite" else "Cu", kind, a,
                             nx=nx, ny=ny, nz=nz)
        pos, m = np.asarray(s.pos), np.asarray(s.box.matrix)
    if sigma:
        pos = pos + np.random.default_rng(seed).normal(0.0, sigma, pos.shape)
    return pos, m


@pytest.fixture(scope="module")
def both():
    """(jax result, port result) of a class on a lattice, computed once."""
    cache = {}

    def run(cls, name, **kw):
        key = (cls, name, tuple(sorted(kw.items())))
        if key not in cache:
            pos, m = lattice(name)
            cache[key] = (getattr(mp, cls)(pos, mp.Box(m), **kw).compute(),
                          getattr(mt, cls)(pos, Box(m), device="cpu",
                                           **kw).compute())
        return cache[key]

    return run


def test_min_image_and_neighbor_disp_match_jax():
    rng = np.random.default_rng(1)
    m = np.array([[9.0, 0, 0], [2.5, 8.0, 0], [-1.5, 1.0, 7.0]])
    for boundary in ([1, 1, 1], [1, 0, 1]):
        box = Box(m, boundary)
        disp = rng.uniform(-12, 12, (50, 7, 3))
        want = np.asarray(min_image_jnp(jnp.asarray(disp), *mp_box_arrays(box)))
        got = common.min_image(torch.tensor(disp),
                               *common.box_tensors(box, "cpu")).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    pos, m = lattice("triclinic_rattled")
    verlet = np.array(jknn(pos, mp.Box(m), 12)[0])
    verlet[::7, 5] = -1
    want = np.asarray(jdisp(jnp.asarray(pos), jnp.asarray(verlet),
                            *mp_box_arrays(Box(m))))
    args = common.box_tensors(Box(m), "cpu")
    got = common.neighbor_disp(torch.tensor(pos), torch.tensor(verlet), *args)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    part = common.neighbor_disp(torch.tensor(pos), torch.tensor(verlet[40:70]),
                                *args, start=40)
    np.testing.assert_array_equal(part.numpy(), got.numpy()[40:70])


def mp_box_arrays(box):
    return (jnp.asarray(box.matrix), jnp.asarray(box.inverse_box),
            jnp.asarray(box.boundary, jnp.float64))


@pytest.mark.parametrize("name,nn", [("fcc_rattled", 12), ("bcc_rattled", 14),
                                     ("hcp_rattled", 12),
                                     ("diamond_rattled", 14)])
def test_bond_matrix_and_signatures_match_jax(name, nn):
    """Both packages' ``bond_matrix`` and ``cna_signatures`` on one list."""
    pos, m = lattice(name)
    verlet, dist = jknn(pos, mp.Box(m), nn)
    cut = (np.mean(dist, axis=1) * 1.2071068) ** 2
    jargs = mp_box_arrays(Box(m))
    jb = jcna.bond_matrix(jnp.asarray(pos), jnp.asarray(verlet), nn, *jargs,
                          jnp.asarray(cut))
    tb = cna_core.bond_matrix(torch.tensor(pos), torch.tensor(verlet), nn,
                              *common.box_tensors(Box(m), "cpu"),
                              torch.tensor(cut))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for got, want in zip(cna_core.cna_signatures(tb, nn),
                         jcna.cna_signatures(jb, nn)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nn", [5, 12, 14])
def test_max_chain_length_matches_jax_on_random_graphs(nn):
    """The degree-sum bond count per piece against JAX's one-hot count, on
    random symmetric graphs with isolated and masked nodes."""
    rng = np.random.default_rng(nn)
    B = rng.random((400, nn, nn)) < rng.uniform(0.05, 0.5, (400, 1, 1))
    B = np.triu(B, 1)
    B = B | B.transpose(0, 2, 1)
    cn = rng.random((400, nn)) < 0.8
    B = B & cn[:, :, None] & cn[:, None, :]
    want = np.asarray(jcna._max_chain_length(jnp.asarray(B), jnp.asarray(cn)))
    got = cna_core._max_chain_length(torch.tensor(B), torch.tensor(cn))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", GENERAL)
def test_csp_matches_jax(both, name):
    j, t = both("CentroSymmetryParameter", name)
    np.testing.assert_allclose(t.csp, j.csp, rtol=0, atol=TOL)
    if name == "fcc":
        assert t.csp.max() < 1e-20


@pytest.mark.parametrize("name", GENERAL + ["diamond", "hex_diamond"])
def test_cna_adaptive_matches_jax(both, name):
    j, t = both("CommonNeighborAnalysis", name)
    np.testing.assert_array_equal(t.cna, j.cna)
    want = {"fcc": 1, "hcp": 2, "fcc_rattled": 1, "bcc_rattled": 3}
    if name in want:
        assert (t.cna == want[name]).all()


@pytest.mark.parametrize("name", GENERAL)
def test_cna_fixed_matches_jax(both, name):
    j, t = both("CommonNeighborAnalysis", name, rc=3.0)
    np.testing.assert_array_equal(t.cna, j.cna)


@pytest.mark.parametrize("name", GENERAL)
def test_ackland_jones_matches_jax(both, name):
    j, t = both("AcklandJonesAnalysis", name)
    np.testing.assert_array_equal(t.aja, j.aja)


@pytest.mark.parametrize("name", ["diamond", "diamond_rattled", "hex_diamond",
                                  "fcc_rattled", "small_box_rattled"])
def test_identify_diamond_matches_jax(both, name):
    j, t = both("IdentifyDiamondStructure", name)
    np.testing.assert_array_equal(t.ids, j.ids)
    want = {"diamond": 1, "diamond_rattled": 1, "hex_diamond": 4}
    if name in want:
        assert (t.ids == want[name]).all()


@pytest.mark.parametrize("name", ["fcc", "fcc_rattled", "bcc_rattled",
                                  "triclinic_rattled", "small_box_rattled"])
def test_cnp_matches_jax(name):
    """Each package's class on its own package's Verlet list at rc 3."""
    pos, m = lattice(name)
    j = mp.CommonNeighborParameter(pos, mp.Box(m), 3.0,
                                   *jsearch(pos, mp.Box(m), 3.0)).compute()
    lists = neighbor_search(pos, Box(m), 3.0, device="cpu")
    t = mt.CommonNeighborParameter(pos, Box(m), 3.0, *lists,
                                   device="cpu").compute()
    np.testing.assert_allclose(t.cnp, j.cnp, rtol=0, atol=TOL)
    as_tensors = mt.CommonNeighborParameter(
        pos, Box(m), 3.0, *(torch.as_tensor(a) for a in lists),
        device="cpu").compute()
    np.testing.assert_array_equal(as_tensors.cnp, t.cnp)


STEINHARDT = {
    "default": ("fcc_rattled", {}),
    "hcp": ("hcp", dict(wl=True, wlhat=True)),
    "full": ("fcc_rattled", dict(llist=(4, 6, 8), wl=True, wlhat=True,
                                 average=True, identify_liquid=True)),
    "bcc_liquid": ("bcc_rattled", dict(nnn=14, wlhat=True,
                                       identify_liquid=True, threshold=0.5,
                                       n_bond=5)),
    "rc": ("triclinic_rattled", dict(nnn=0, rc=3.0, llist=(2, 4, 6), wl=True,
                                     average=True, identify_liquid=True)),
}


@pytest.mark.parametrize("case", sorted(STEINHARDT))
def test_steinhardt_matches_jax(both, case):
    name, kw = STEINHARDT[case]
    j, t = both("SteinhardtBondOrientation", name, **kw)
    assert t.out_names == j.out_names
    np.testing.assert_allclose(t.qnarray, j.qnarray, rtol=0, atol=TOL)
    if kw.get("identify_liquid"):
        np.testing.assert_array_equal(t.solidliquid, j.solidliquid)
        np.testing.assert_array_equal(t.nbond, j.nbond)


def test_steinhardt_weights_and_given_lists_match_jax():
    pos, m = lattice("fcc_rattled")
    verlet, dist, nn = jsearch(pos, mp.Box(m), 3.0)
    weight = np.random.default_rng(4).uniform(0.5, 1.5, verlet.shape)
    kw = dict(nnn=0, rc=3.0, use_weight=True, weight=weight, wl=True,
              verlet_list=verlet, distance_list=dist, neighbor_number=nn)
    j = mp.SteinhardtBondOrientation(pos, mp.Box(m), **kw).compute()
    t = mt.SteinhardtBondOrientation(pos, Box(m), device="cpu", **kw).compute()
    np.testing.assert_allclose(t.qnarray, j.qnarray, rtol=0, atol=TOL)


@pytest.mark.parametrize("boundary", [(1, 1, 0), (0, 0, 0)])
def test_free_boundaries_and_an_origin_match_jax(boundary):
    pos, m = lattice("fcc_rattled")
    origin = np.array([10.0, -5.0, 2.5])
    pos = pos + origin
    jbox, tbox = mp.Box(m, boundary=boundary, origin=origin), Box(
        m, boundary, origin)
    for cls, attr in (("CentroSymmetryParameter", "csp"),
                      ("CommonNeighborAnalysis", "cna"),
                      ("AcklandJonesAnalysis", "aja"),
                      ("SteinhardtBondOrientation", "qnarray")):
        want = getattr(getattr(mp, cls)(pos, jbox).compute(), attr)
        got = getattr(getattr(mt, cls)(pos, tbox, device="cpu").compute(), attr)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.fixture
def _jax_engine_of_our_own(tmp_path_factory):
    from _native_flags import private_jax_build

    undo = private_jax_build(tmp_path_factory)
    yield
    undo()


def test_steinhardt_voronoi_matches_jax(_jax_engine_of_our_own):
    """Voronoi neighbors (ROADMAP A12d), face-weighted, with the averaged
    and w_l-hat variants and the liquid classifier."""
    pos, m = lattice("fcc_rattled")
    kw = dict(llist=(4, 6), use_voronoi=True, use_weight=True, average=True,
              wlhat=True, identify_liquid=True)
    j = mp.SteinhardtBondOrientation(pos, mp.Box(m), **kw).compute()
    t = mt.SteinhardtBondOrientation(pos, Box(m), device="cpu", **kw).compute()
    np.testing.assert_allclose(t.qnarray, j.qnarray, rtol=0, atol=TOL)
    np.testing.assert_array_equal(t.solidliquid, j.solidliquid)
    np.testing.assert_array_equal(t.nbond, j.nbond)


@pytest.mark.parametrize("l", [2, 4, 6, 8, 10])
def test_clebsch_gordan_copy_is_jax(l):
    np.testing.assert_array_equal(clebsch_gordan_list(l), jcg(l))


@pytest.mark.parametrize("name", ["ice", "ice_rattled"])
def test_chill_plus_matches_jax(both, name):
    j, t = both("ChillPlus", name)
    np.testing.assert_array_equal(t.chill_plus, j.chill_plus)
    if name == "ice":
        assert (t.chill_plus == 2).all()   # cubic ice


def test_chunked_rows_repeat_the_whole(monkeypatch):
    """Results are per row: chunks of a few rows give the same bits."""
    pos, m = lattice("diamond_rattled")
    box = Box(m)
    calls = [("CentroSymmetryParameter", {}, "csp"),
             ("CommonNeighborAnalysis", {}, "cna"),
             ("CommonNeighborAnalysis", {"rc": 3.0}, "cna"),
             ("AcklandJonesAnalysis", {}, "aja"),
             ("IdentifyDiamondStructure", {}, "ids"),
             ("SteinhardtBondOrientation", {"average": True}, "qnarray")]
    whole = [getattr(getattr(mt, c)(pos, box, device="cpu", **kw).compute(), a)
             for c, kw, a in calls]
    monkeypatch.setattr(common, "CHUNK_BYTES", 100_000)
    for (c, kw, a), want in zip(calls, whole):
        got = getattr(getattr(mt, c)(pos, box, device="cpu", **kw).compute(), a)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cls", ["CentroSymmetryParameter",
                                 "CommonNeighborAnalysis",
                                 "AcklandJonesAnalysis",
                                 "IdentifyDiamondStructure",
                                 "SteinhardtBondOrientation", "ChillPlus"])
def test_card_is_the_default(cls):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default does not raise")
    pos, m = lattice("fcc")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(mt, cls)(pos, Box(m))
