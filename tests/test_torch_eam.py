"""Port parity: EAM (``mdapy_tpu_torch/potentials/eam.py``, ROADMAP A9).

The JAX package's ``EAMGenerator(["Cu", "Ni"])`` writes the tables; the
port's generator writes the same file byte for byte, and the port's parser
reads the same tables from it.  A seeded, rattled Cu-Ni alloy (orthogonal,
triclinic, and a box that needs replication) goes through the JAX ``EAM``
(CPU, float64) on a JAX ``System`` and through the port's
(``device="cpu"``) on ``tests/_torch_system.py``: energies, forces, virials
and stress at rtol = atol = 1e-10.  Also ``EAMAverage``, ``spline_eval``,
``write_eam_alloy``, the card default, and the C3 repair (an in-place
species edit at an index that JAX's fingerprint does not sample re-types
the atoms).  ``chip_smoke.py`` [E1] runs the force call on the card.
"""

import datetime

import numpy as np
import pytest
import torch

import mdapy_tpu as mp
from _torch_system import StandInSystem
from mdapy_tpu.potentials import eam as jeam
from mdapy_tpu_torch.potentials import eam as team

TOL = 1e-10


class _FixedClock(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """The JAX and the port's generated files, written under one frozen
    clock (the generator stamps the time into its second line)."""
    d = tmp_path_factory.mktemp("eam")
    saved = datetime.datetime
    datetime.datetime = _FixedClock
    try:
        jeam.EAMGenerator(["Cu", "Ni"], output_filename=str(d / "jax.eam.alloy"))
        team.EAMGenerator(["Cu", "Ni"], output_filename=str(d / "port.eam.alloy"))
    finally:
        datetime.datetime = saved
    return d / "jax.eam.alloy", d / "port.eam.alloy"


def alloy(n, seed, sigma=0.1, triclinic=False):
    s = mp.build_crystal("Cu", "fcc", 3.615, nx=n, ny=n, nz=n)
    rng = np.random.default_rng(seed)
    s.set_element(np.where(rng.random(s.N) < 0.35, "Ni", "Cu").astype(object))
    if triclinic:
        L = n * 3.615
        s.update_box(np.array([[L, 0, 0], [0.25 * L, L, 0], [-0.15 * L, 0.1 * L, L]]),
                     scale_pos=True)
    s.update_pos(s.pos + rng.normal(0.0, sigma, s.pos.shape))
    return s


def both(s, jpot, tpot):
    s.calc = jpot
    want = (s.get_energies(), s.get_force(), s.get_virials(), s.get_stress())
    t = StandInSystem(s.pos, s.box, np.asarray(s.data["element"]))
    t.calc = tpot
    got = (t.get_energies(), t.get_force(), t.get_virials(), t.get_stress())
    return got, want


def test_generator_writes_the_same_file(tables):
    jpath, tpath = tables
    assert jpath.read_bytes() == tpath.read_bytes()


def test_parsed_tables_equal(tables):
    j, t = jeam.EAM(str(tables[0])), team.EAM(str(tables[0]), device="cpu")
    assert t.elements_list == j.elements_list == ["Cu", "Ni"]
    for name in ("F_rho", "rho_r", "_rphi_r", "phi_r", "_F_fp", "_rho_fp", "_z2r_fp"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    for name in ("drho", "dr", "rc", "nr", "nrho", "Nelements"):
        assert getattr(t, name) == getattr(j, name), name


def test_write_eam_alloy_matches_jax(tables, tmp_path):
    j, t = jeam.EAM(str(tables[0])), team.EAM(str(tables[0]), device="cpu")
    jout = j.write_eam_alloy(str(tmp_path / "j.eam.alloy"))
    tout = t.write_eam_alloy(str(tmp_path / "t.eam.alloy"))
    assert open(jout, "rb").read() == open(tout, "rb").read()
    again = team.EAM(tout, device="cpu")
    np.testing.assert_array_equal(again._rphi_r, t._rphi_r)


def test_spline_eval_matches_jax(tables):
    j = jeam.EAM(str(tables[0]))
    x = np.random.default_rng(0).uniform(-0.5, j.rc + 0.5, (7, 9))
    e = np.random.default_rng(1).integers(0, 2, (7, 9))
    want = jeam.spline_eval(j.rho_r, j._rho_fp, j.dr, x, (e,))
    got = team.spline_eval(torch.as_tensor(j.rho_r), torch.as_tensor(j._rho_fp),
                           j.dr, torch.as_tensor(x), (torch.as_tensor(e),))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("case", ["orthogonal", "triclinic", "small_box"])
def test_eam_matches_jax(tables, case):
    s = {"orthogonal": lambda: alloy(4, 1),
         "triclinic": lambda: alloy(4, 2, triclinic=True),
         "small_box": lambda: alloy(2, 3)}[case]()
    got, want = both(s, jeam.EAM(str(tables[0])),
                     team.EAM(str(tables[1]), device="cpu"))
    for name, g, w in zip(("energies", "forces", "virials", "stress"), got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)
    # the sum of the per-atom virials is the stress's virial
    vol = abs(s.box.volume)
    np.testing.assert_allclose(team.EAM.stress_from_virials(got[2], vol), got[3],
                               rtol=TOL, atol=TOL)


def test_eam_average_matches_jax(tables):
    conc = [0.6, 0.4]
    j = jeam.EAMAverage(str(tables[0]), conc)
    t = team.EAMAverage(str(tables[0]), conc, device="cpu")
    assert t.elements_list == j.elements_list == ["Cu", "Ni", "A"]
    for name in ("F_rho", "rho_r", "_rphi_r", "phi_r", "_z2r_fp"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    s = alloy(4, 5)
    elems = np.asarray(s.data["element"]).copy()
    elems[::3] = "A"
    s.set_element(elems)
    got, want = both(s, j, t)
    for name, g, w in zip(("energies", "forces", "virials", "stress"), got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)


def test_species_edit_retypes_c3(tables):
    """ROADMAP C3: JAX's type cache samples the element column (its head,
    tail and every stride-th entry; the stride is 2 at 16,384 atoms), so
    editing index 65 in place leaves it stale.  The port keys its cache by
    the whole column: the edit re-types the atoms."""
    base = mp.build_crystal("Cu", "fcc", 3.615, nx=16, ny=16, nz=16)
    assert base.N == 16384 and max(1, base.N // 8192) == 2
    elems = np.full(base.N, "Cu", dtype=object)
    s = StandInSystem(base.pos, base.box, elems)
    pot = team.EAM(str(tables[1]), device="cpu")
    s.calc = pot
    e_cu = s.get_energies().copy()
    s.data["element"][65] = "Ni"          # in place, same column object
    pot.results = {}                     # positions unchanged: recalculate
    e_edit = s.get_energies()
    fresh = StandInSystem(base.pos, base.box, s.data["element"].copy())
    fresh.calc = team.EAM(str(tables[1]), device="cpu")
    np.testing.assert_array_equal(e_edit, fresh.get_energies())
    assert e_edit[65] != e_cu[65]


def test_card_default(tables):
    if torch.cuda.is_available():
        assert team.EAM(str(tables[1])).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            team.EAM(str(tables[1]))
