"""Port parity: polyhedral template matching and the FCC planar faults
(``mdapy_tpu_torch/analysis/ptm.py``, ``identify_fcc_planar_faults.py``,
``System.cal_polyhedral_template_matching``; ROADMAP A12d).

The same seeded positions go through the JAX package (CPU, float64) and the
port (``device="cpu"``).  Two divergences are recorded here, never met by a
tolerance:

* C16, the build flags.  The JAX package builds ``ptm_engine.cpp`` with
  ``-march=native``, which lets g++ contract ``a*b + c`` into FMAs on a
  host with FMA; the port builds without it.  The engine keeps the first mapping of
  strictly lower RMSD, and the symmetric mappings of a template tie up to
  rounding, so the last bits decide which wins.  Where they differ the
  structure types agree, RMSD and distance within 1e-12, the two
  orientations differ by a rotation that maps the template onto itself,
  and ``ptm_indices`` are the JAX package's permuted by that rotation.
  With ``-march=native`` added to the port's build, every output and every
  index is the JAX package's bit for bit.
* C10, kNN ties.  On a perfect lattice the 18 neighbours hold equal
  distances, the two kNN searches may order them differently, and the
  engine reads them in that order: there ``ptm_indices`` are compared as
  sorted rows, and the RMSD, the root of a rounding residue (~1e-8), as
  below 1e-6 in both.

Inputs stay at 128-576 atoms in few shapes: the JAX kNN compiles for each.
"""

import numpy as np
import pytest

import mdapy_tpu as mp
from mdapy_tpu.core.box import Box as JBox
import mdapy_tpu_torch as mt
from mdapy_tpu_torch.analysis import ptm as tptm
from mdapy_tpu_torch.analysis.ptm import _template_points
from mdapy_tpu_torch.core.box import Box

from _native_flags import JAX_FLAGS, port_engine_flags, private_jax_build

TOL = 1e-12
NAMES = {1: "fcc", 2: "hcp", 3: "bcc", 4: "ico", 5: "sc", 6: "dcub",
         7: "dhex", 8: "graphene"}


@pytest.fixture(scope="module", autouse=True)
def _jax_engine_of_our_own(tmp_path_factory):
    undo = private_jax_build(tmp_path_factory)
    yield
    undo()


def _crystal(kind, a, cells, sigma=0.0, seed=0, **kw):
    s = mp.build_crystal("C" if kind in ("diamond", "lonsdaleite", "graphene")
                         else "Cu", kind, a, nx=cells[0], ny=cells[1],
                         nz=cells[2], **kw)
    pos = np.asarray(s.pos)
    if sigma:
        pos = pos + np.random.default_rng(seed).normal(0.0, sigma, pos.shape)
    return pos, np.asarray(s.box.matrix), np.asarray(s.box.boundary)


def _triclinic(sigma=0.05, seed=1):
    """FCC in a sheared 500-atom cell (the same lattice, a triclinic box)."""
    pos, m, _ = _crystal("fcc", 3.615, (5, 5, 5))
    shear = np.array([[1.0, 0, 0], [0.2, 1, 0], [0.1, 0.15, 1]])
    pos = pos @ shear
    pos = pos + np.random.default_rng(seed).normal(0.0, sigma, pos.shape)
    return pos, m @ shear, np.array([1, 1, 1])


# name -> (positions, box, boundary), structure
INPUTS = {
    "fcc_rattled": (lambda: _crystal("fcc", 3.615, (5, 5, 5), 0.1), "all"),
    "fcc_triclinic": (_triclinic, "all"),
    "bcc_rattled": (lambda: _crystal("bcc", 2.8665, (4, 4, 4), 0.08),
                    "default"),
    "fcc": (lambda: _crystal("fcc", 3.615, (5, 5, 5)), "all"),
    "bcc": (lambda: _crystal("bcc", 2.8665, (4, 4, 4)), "default"),
    "hcp": (lambda: _crystal("hcp", 2.5, (4, 4, 4)), "default"),
    "diamond": (lambda: _crystal("diamond", 3.567, (3, 3, 3)), "all"),
}
RATTLED = ["fcc_rattled", "fcc_triclinic", "bcc_rattled"]
PERFECT = ["fcc", "bcc", "hcp", "diamond"]


def _both(name):
    make, structure = INPUTS[name]
    pos, m, bnd = make()
    j = mp.PolyhedralTemplateMatching(structure, pos, JBox(m, bnd)).compute()
    t = mt.PolyhedralTemplateMatching(structure, pos, Box(m, bnd),
                                      device="cpu").compute()
    return pos, m, bnd, structure, j, t


def _rot(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _same_up_to_symmetry(j, t, sorted_rows=False):
    """Types equal; RMSD and distance within TOL; each orientation the
    other's times a rotation of the template onto itself; ``ptm_indices``
    the JAX package's permuted by that rotation (or, on a perfect lattice,
    equal as sorted rows); returns the rows whose orientation differs."""
    np.testing.assert_array_equal(t.output[:, :2], j.output[:, :2])
    if sorted_rows:
        # C10: the engine reads the tied neighbours in another order, and a
        # perfect lattice's RMSD is the root of a rounding residue (~1e-8)
        assert max(t.output[:, 2].max(), j.output[:, 2].max()) < 1e-6
    else:
        np.testing.assert_allclose(t.output[:, 2], j.output[:, 2], rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(t.output[:, 3], j.output[:, 3], rtol=0, atol=TOL)
    differ = np.nonzero(np.abs(t.output[:, 4:] - j.output[:, 4:]).max(1)
                        > TOL)[0]
    for i in differ:
        T = _template_points(NAMES[int(j.output[i, 0])])[1:]
        S = _rot(j.output[i, 4:]).T @ _rot(t.output[i, 4:])
        d = np.linalg.norm((T @ S.T)[:, None] - T[None], axis=2)
        assert d.min(axis=1).max() < TOL, (i, d.min(axis=1).max())
        perm = d.argmin(axis=1)
        assert sorted(perm.tolist()) == list(range(len(T)))
        jrow, trow = j.ptm_indices[i], t.ptm_indices[i]
        assert trow[0] == jrow[0]
        if not sorted_rows:
            np.testing.assert_array_equal(trow[1:1 + len(T)],
                                          jrow[1:1 + len(T)][perm])
    same = np.setdiff1d(np.arange(len(j.output)), differ)
    if sorted_rows:
        np.testing.assert_array_equal(np.sort(t.ptm_indices, axis=1),
                                      np.sort(j.ptm_indices, axis=1))
    else:
        np.testing.assert_array_equal(t.ptm_indices[same], j.ptm_indices[same])
    return differ


@pytest.mark.parametrize("name", RATTLED)
def test_rattled_and_triclinic_match_jax_up_to_the_template_symmetry(name):
    *_, j, t = _both(name)
    assert np.unique(j.output[:, 0]).size >= 1
    differ = _same_up_to_symmetry(j, t)
    # C16: the port's flags pick other symmetric mappings for some atoms
    assert len(differ) < len(j.output)


@pytest.mark.parametrize("name", PERFECT)
def test_perfect_lattices_match_jax_as_sorted_rows(name):
    *_, j, t = _both(name)
    want = {"fcc": 1, "bcc": 3, "hcp": 2, "diamond": 6}[name]
    assert (t.output[:, 0] == want).all()
    assert t.output[:, 2].max() < 1e-6
    _same_up_to_symmetry(j, t, sorted_rows=True)


@pytest.mark.parametrize("name", RATTLED)
def test_with_the_jax_build_flags_every_bit_is_jax(name):
    """C16's cause: the port's engine copy built as the JAX package builds
    its own gives the JAX package's outputs and indices bit for bit.  (On a
    perfect lattice the engine's inputs differ already, by C10's order.)"""
    make, structure = INPUTS[name]
    pos, m, bnd = make()
    j = mp.PolyhedralTemplateMatching(structure, pos, JBox(m, bnd)).compute()
    with port_engine_flags(JAX_FLAGS, tptm, _ENGINE=None, _TEMPLATE_IDX={}):
        t = mt.PolyhedralTemplateMatching(structure, pos, Box(m, bnd),
                                          device="cpu").compute()
    assert t.output.tobytes() == j.output.tobytes()
    np.testing.assert_array_equal(t.ptm_indices, j.ptm_indices)


def test_free_box_of_few_atoms_and_random_atoms():
    pos = np.random.default_rng(2).uniform(0, 6, (12, 3))
    for b in (JBox(np.eye(3) * 6, [0, 0, 0]), Box(np.eye(3) * 6, [0, 0, 0])):
        cls = mp if isinstance(b, JBox) else mt
        kw = {} if cls is mp else {"device": "cpu"}
        p = cls.PolyhedralTemplateMatching("fcc", pos, b, **kw).compute()
        assert (p.output == 0).all() and (p.ptm_indices == -1).all()
        assert p.ptm_indices.shape == (12, 18)
    rnd = np.random.default_rng(0).uniform(0, 15, (200, 3))
    j = mp.PolyhedralTemplateMatching("all", rnd, JBox(np.eye(3) * 15)).compute()
    t = mt.PolyhedralTemplateMatching("all", rnd, Box(np.eye(3) * 15),
                                      device="cpu").compute()
    _same_up_to_symmetry(j, t)
    assert (t.output[:, 0] == 0).mean() > 0.95


def test_invalid_structure_raises_as_jax():
    pos, m, _ = _crystal("fcc", 4.05, (1, 1, 1))
    with pytest.raises(ValueError) as je:
        mp.build_crystal("Al", "fcc", 4.05).cal_polyhedral_template_matching(
            structure="fcc-xyz")
    with pytest.raises(ValueError) as te:
        mt.build_crystal("Al", "fcc", 4.05, device="cpu")\
            .cal_polyhedral_template_matching(structure="fcc-xyz")
    assert str(te.value) == str(je.value)
    assert "Structure should be" in str(te.value)


def _stack(pkg, seq, a=1.0, nxy=6, sigma=0.0, **kw):
    """``tests/test_ptm.py:_stack``: close-packed layers in ``seq`` order,
    periodic in x and y, free in z."""
    dz = a * np.sqrt(2.0 / 3.0)
    offs = {"A": (0.0, 0.0), "B": (0.5, np.sqrt(3) / 6), "C": (1.0, np.sqrt(3) / 3)}
    pos = []
    for k, ch in enumerate(seq):
        ox, oy = offs[ch]
        for i in range(nxy):
            for j in range(nxy):
                pos.append(((i + j * 0.5 + ox) * a,
                            (j * np.sqrt(3) / 2 + oy) * a, k * dz))
    pos = np.array(pos)
    if sigma:
        pos = pos + np.random.default_rng(5).normal(0.0, sigma, pos.shape)
    m = np.array([[nxy * a, 0, 0], [nxy * a * 0.5, nxy * a * np.sqrt(3) / 2, 0],
                  [0, 0, len(seq) * dz]])
    box = (JBox if pkg is mp else Box)(m, [1, 1, 0])
    return pkg.System(pos=pos, box=box, **kw)


STACKS = {
    "isf": "ABCABCABABCABCA",
    "twin": "ABCABCABACBACBA",
    "esf": "ABCABCABACABCABC",
    "multilayer": "ABCABCABABABCABC",
}


@pytest.mark.parametrize("esf", [True, False])
@pytest.mark.parametrize("name", sorted(STACKS))
def test_planar_faults_match_jax(name, esf):
    seq = STACKS[name]
    j = _stack(mp, seq)
    t = _stack(mt, seq, device="cpu")
    kw = dict(identify_fcc_planar_faults=True, identify_esf=esf)
    j.cal_polyhedral_template_matching(**kw)
    t.cal_polyhedral_template_matching(**kw)
    np.testing.assert_array_equal(t.data["ptm"], j.data["ptm"])
    np.testing.assert_array_equal(t.data["pft"], j.data["pft"])
    lay = np.round(t.pos[:, 2] / np.sqrt(2.0 / 3.0)).astype(int)
    pft = np.asarray(t.data["pft"])
    per_layer = [sorted(set(pft[lay == L].tolist())) for L in range(len(seq))]
    known = {"isf": {7: [2], 8: [2]}, "twin": {7: [3]},
             "esf": {7: [5 if esf else 3], 9: [5 if esf else 3]}}
    for layer, codes in known.get(name, {}).items():
        assert per_layer[layer] == codes
    if name == "multilayer":
        assert any(x == [4] for x in per_layer[7:11])


def test_planar_faults_on_a_rattled_stack_match_jax():
    seq = "ABCABCABABCABCA"
    j = _stack(mp, seq, a=2.556, sigma=0.04)
    t = _stack(mt, seq, a=2.556, sigma=0.04, device="cpu")
    for s in (j, t):
        s.cal_polyhedral_template_matching(identify_fcc_planar_faults=True)
    np.testing.assert_array_equal(t.data["pft"], j.data["pft"])
    assert (np.asarray(t.data["pft"]) == 2).sum() > 0


def test_identify_fcc_planar_faults_class_is_jax_on_the_same_input():
    """The host copy on the JAX package's own PTM output: equal."""
    j = _stack(mp, STACKS["esf"])
    p = mp.PolyhedralTemplateMatching("fcc-hcp-bcc", j.pos, j.box).compute()
    types = p.output[:, 0].astype(np.int32)
    idx = np.ascontiguousarray(p.ptm_indices[:, 1:13])
    for esf in (True, False):
        want = mp.IdentifyFccPlanarFaults(types, idx, esf).compute().fault_types
        got = mt.IdentifyFCCPlanarFaults(types, idx, esf).compute().fault_types
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_system_columns_match_jax():
    pos, m, bnd = _crystal("fcc", 3.615, (5, 5, 5), 0.1)
    j = mp.System(pos=pos, box=JBox(m, bnd))
    t = mt.System(pos=pos, box=m, boundary=bnd, device="cpu")
    kw = dict(structure="all", return_ordering=True, return_rmsd=True,
              return_atomic_distance=True, return_orientation=True,
              identify_fcc_planar_faults=True)
    want = j.cal_polyhedral_template_matching(**kw)
    got = t.cal_polyhedral_template_matching(**kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for col in ("ordering", "rmsd", "interatomic_distance", "pft"):
        np.testing.assert_allclose(t.data[col], j.data[col], rtol=0, atol=TOL)
    q = np.column_stack([np.asarray(t.data[c]) for c in ("qw", "qx", "qy", "qz")])
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, rtol=0, atol=1e-12)


def test_the_smoke_runs_fault_stack_gives_its_known_codes():
    """``tests/_fault_stack.py`` (``chip_smoke.py`` [S6]'s stack, cut to 36
    atoms a layer): both packages give every inner layer its known code."""
    from _fault_stack import fault_stack

    pos, m, bnd, layer, expect = fault_stack(6, 41)
    assert sorted(set(expect.tolist())) == [-1, 0, 2, 3, 5]
    j = mp.System(pos=pos, box=JBox(m, bnd))
    t = mt.System(pos=pos, box=m, boundary=bnd, device="cpu")
    for s in (j, t):
        s.cal_polyhedral_template_matching(identify_fcc_planar_faults=True)
    np.testing.assert_array_equal(t.data["pft"], j.data["pft"])
    pft = np.asarray(t.data["pft"])
    for k, code in enumerate(expect):
        if code >= 0:
            assert set(pft[layer == k].tolist()) == {code}, (k, code)
