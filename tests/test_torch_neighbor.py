"""Port parity: the neighbor engine (``mdapy_tpu_torch/neighbor/``, ROADMAP
A8).

The same seeded positions go through the JAX package's ``neighbor_search``
and ``knn_search`` (on the CPU, float64) and the port's (``device="cpu"``):
equal neighbor sets and counts per row, distances within 1e-12 A, on
orthogonal and triclinic cells, periodic, mixed and free boundaries, and a
box small enough to need replication.  Also the overflow contract, the
class surfaces, the card default, and the symmetry of every radius builder
(ROADMAP C4: j in N(i) if and only if i in N(j)).  ``chip_smoke.py`` [N1]
runs the engine on the card.
"""

import numpy as np
import pytest
import torch

import mdapy_tpu as mp
from mdapy_tpu.core.box import Box as JBox
from mdapy_tpu.neighbor.knn import knn_search as jknn
from mdapy_tpu.neighbor.neighbor import neighbor_search as jsearch
from mdapy_tpu_torch.core.box import Box
from mdapy_tpu_torch.neighbor.knn import NearestNeighbor, knn_search
from mdapy_tpu_torch.neighbor.neighbor import (
    Neighbor, neighbor_search, neighbor_search_device)
from mdapy_tpu_torch.potentials.pairops import (
    reverse_permutation, reverse_permutation_device)

TOL_DIST = 1e-12


def random_system(n=200, L=12.0, seed=0, triclinic=False, boundary=(1, 1, 1)):
    rng = np.random.default_rng(seed)
    if triclinic:
        m = np.array([[L, 0, 0], [0.3 * L, L, 0], [0.2 * L, -0.1 * L, L]])
    else:
        m = np.eye(3) * L
    return rng.uniform(0, 1, (n, 3)) @ m, m


def rattled(kind, n, a, seed, sigma=0.05):
    s = mp.build_crystal("Cu" if kind == "fcc" else "Fe", kind, a, nx=n, ny=n, nz=n)
    rng = np.random.default_rng(seed)
    return s.pos + rng.normal(0.0, sigma, s.pos.shape), s.box


def pairs(verlet, dist, cnt):
    """Each row's (index, distance) pairs, sorted: a multiset per row."""
    return [sorted(zip(verlet[i, :cnt[i]].tolist(), dist[i, :cnt[i]].tolist()))
            for i in range(len(cnt))]


def assert_same_rows(got, want):
    (vg, dg, cg), (vw, dw, cw) = got, want
    np.testing.assert_array_equal(cg, cw)
    for i, (pg, pw) in enumerate(zip(pairs(vg, dg, cg), pairs(vw, dw, cw))):
        assert [j for j, _ in pg] == [j for j, _ in pw], f"row {i}"
        np.testing.assert_allclose([d for _, d in pg], [d for _, d in pw],
                                   rtol=0, atol=TOL_DIST)
    # rows are in ascending distance, padded with -1
    for i in range(len(cg)):
        assert np.all(np.diff(dg[i, :cg[i]]) >= 0)
        assert np.all(vg[i, cg[i]:] == -1)


@pytest.mark.parametrize("triclinic", [False, True])
@pytest.mark.parametrize("boundary", [(1, 1, 1), (1, 1, 0), (0, 0, 0)])
def test_neighbor_search_matches_jax(triclinic, boundary):
    pos, m = random_system(150, 11.0, seed=3, triclinic=triclinic)
    got = neighbor_search(pos, Box(m, boundary), 3.2, device="cpu")
    assert got[0].dtype == np.int32
    assert_same_rows(got, jsearch(pos, JBox(m, boundary), 3.2))


def test_small_box_replication_matches_jax():
    """A rattled 2x2x2 FCC cell at rc 5 A: every axis is replicated, so a
    row holds several images of one atom (indices taken modulo N)."""
    pos, box = rattled("fcc", 2, 3.615, seed=1)
    got = neighbor_search(pos, box, 5.0, device="cpu")
    want = jsearch(pos, box, 5.0)
    assert got[2].min() > len(pos)  # more neighbors than atoms: images
    assert_same_rows(got, want)


def test_overflow_contract():
    pos, m = random_system(120, 9.0, seed=5)
    box = Box(m)
    _, _, cnt = neighbor_search(pos, box, 3.0, device="cpu")
    true_max = int(cnt.max())
    for fn, b in ((neighbor_search, box), (jsearch, JBox(m))):
        kw = {"device": "cpu"} if fn is neighbor_search else {}
        with pytest.raises(ValueError, match=f"an atom has {true_max} neighbors"):
            fn(pos, b, 3.0, max_neigh=true_max - 1, **kw)
    v, d, c = neighbor_search(pos, box, 3.0, max_neigh=true_max, device="cpu")
    assert v.shape[1] <= true_max and np.array_equal(c, cnt)
    assert_same_rows((v, d, c), jsearch(pos, JBox(m), 3.0, max_neigh=true_max))


@pytest.mark.parametrize("kind,n,a,k", [("fcc", 4, 3.615, 12), ("bcc", 4, 2.8665, 8),
                                        ("fcc", 2, 3.615, 18)])
def test_knn_matches_jax_on_rattled_lattices(kind, n, a, k):
    pos, box = rattled(kind, n, a, seed=2)
    idx, dist = knn_search(pos, box, k, device="cpu")
    jidx, jdist = jknn(pos, box, k)
    assert idx.shape == (len(pos), k) and idx.dtype == np.int32
    np.testing.assert_allclose(dist, jdist, rtol=0, atol=TOL_DIST)
    assert [sorted(r) for r in idx.tolist()] == [sorted(r) for r in jidx.tolist()]


def test_knn_pathological_aspect_ratio_box():
    """The slab of tests/test_neighbor.py: dense in-plane, one thin axis,
    half the atoms clumped."""
    rng = np.random.default_rng(11)
    m = np.array([[60.0, 0, 0], [0, 60.0, 0], [0, 0, 2.2]])
    pos = rng.uniform(0, 1, (500, 3)) @ m
    pos[:250, :2] *= 0.15
    idx, dist = knn_search(pos, Box(m), 12, device="cpu")
    jidx, jdist = jknn(pos, JBox(m, (1, 1, 1)), 12)
    np.testing.assert_allclose(dist, jdist, rtol=0, atol=TOL_DIST)
    assert [sorted(r) for r in idx.tolist()] == [sorted(r) for r in jidx.tolist()]


def test_knn_needle_box():
    """A needle cell (two short periodic axes): the radius escalates past
    many periodic images; indices repeat across images."""
    rng = np.random.default_rng(12)
    m = np.diag([3.1, 3.3, 90.0])
    pos = rng.uniform(0, 1, (160, 3)) @ m
    idx, dist = knn_search(pos, Box(m), 10, device="cpu")
    jidx, jdist = jknn(pos, JBox(m, (1, 1, 1)), 10)
    np.testing.assert_allclose(dist, jdist, rtol=0, atol=TOL_DIST)
    assert [sorted(r) for r in idx.tolist()] == [sorted(r) for r in jidx.tolist()]


def test_class_surfaces_and_card_default():
    pos, box = rattled("fcc", 3, 3.615, seed=4)
    nb = Neighbor(pos, box, 3.0, device="cpu").compute()
    jnb = mp.Neighbor(pos, box, 3.0).compute()
    assert_same_rows((nb.verlet_list, nb.distance_list, nb.neighbor_number),
                     (jnb.verlet_list, jnb.distance_list, jnb.neighbor_number))
    knn = NearestNeighbor(pos, box, 12, device="cpu").compute()
    jknn_ = mp.NearestNeighbor(pos, box, 12).compute()
    np.testing.assert_array_equal(knn.neighbor_number, jknn_.neighbor_number)
    np.testing.assert_allclose(knn.distance_list, jknn_.distance_list,
                               rtol=0, atol=TOL_DIST)
    # a frame with x/y/z columns works as the positions
    cols = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2]}

    class Frame(dict):
        columns = ["x", "y", "z"]

    assert np.array_equal(Neighbor(Frame(cols), box, 3.0, device="cpu").pos, pos)
    # the card unless the caller asks for the CPU: no silent fallback
    for make in (lambda: Neighbor(pos, box, 3.0), lambda: NearestNeighbor(pos, box, 4),
                 lambda: neighbor_search(pos, box, 3.0),
                 lambda: knn_search(pos, box, 4),
                 lambda: neighbor_search_device(pos, box, 3.0)):
        if torch.cuda.is_available():
            make()
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()


@pytest.mark.parametrize("case", ["ortho", "triclinic_free_z", "replicated"])
def test_every_builder_is_symmetric(case):
    """ROADMAP C4: j in N(i) if and only if i in N(j), for the host search,
    the device search and the reverse permutation built on it (on the
    device by sort ranks, on the host by search, equal)."""
    if case == "replicated":
        pos, box = rattled("fcc", 2, 3.615, seed=6)
        rc = 4.0
    else:
        tri = case != "ortho"
        p, m = random_system(180, 11.0, seed=7, triclinic=tri)
        pos, box, rc = p, Box(m, (1, 1, 0) if tri else (1, 1, 1)), 3.3
    v, _, c = neighbor_search(pos, box, rc, device="cpu")
    for i in range(len(c)):
        for j in v[i, :c[i]]:
            assert np.sum(v[j, :c[j]] == i) == np.sum(v[i, :c[i]] == j)
    _, vd, cd, _ = neighbor_search_device(pos, box, rc, device="cpu")
    vd, cd = vd.numpy(), cd.numpy()
    fwd = {(i, int(j)) for i in range(len(cd)) for j in vd[i, :cd[i]]}
    assert fwd == {(j, i) for i, j in fwd}
    rev, bad = reverse_permutation_device(torch.as_tensor(vd))
    assert int(bad) == 0
    rev = rev.numpy()
    np.testing.assert_array_equal(rev, reverse_permutation(vd))
    for i in range(len(cd)):
        for m_ in range(cd[i]):
            assert vd[vd[i, m_], rev[i, m_]] == i
