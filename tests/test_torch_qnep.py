"""Port parity: qNEP and ``Spline`` (``mdapy_tpu_torch/potentials/nep.py``'s
charge models, ``mdapy_tpu_torch/utils/spline.py``; ROADMAP A9q).

Seeded ``nep4_charge1``, ``nep4_charge2`` and ``nep4_zbl_charge3`` models
(Na and Cl, narrow widths) are written in ``tmp_path`` by
``tests/_nep_file.py``.  The parsed weights must be equal, and a seeded,
rattled 64-atom rock-salt box, cubic and triclinic, gives the same
energies, forces, stress, virials, zero-mean charges and Born effective
charges from the JAX ``NEP`` (the ``_qnep_compute`` route, CPU, float64)
and the port's (``device="cpu"``) within 1e-9.  The port's net force
vanishes.
``Spline.evaluate_torch`` is held against ``evaluate_jax`` and scipy's
``CubicSpline`` for orders 0-2 and each ``bc_type``.  ``chip_smoke.py``
[Q1] runs the models at GPUMD's default widths on the card.
"""

import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline as SciSpline

import jax.numpy as jnp
import mdapy_tpu as mp
from _nep_file import rock_salt, write_nep
from mdapy_tpu.potentials.nep import NEP as JNEP
from mdapy_tpu.utils.spline import Spline as JSpline
import mdapy_tpu_torch as mt
from mdapy_tpu_torch.potentials.nep import NEP

TOL = 1e-9
SMALL = dict(version=4, elements=("Na", "Cl"), cutoff=(5.0, 4.0), n_max=(3, 3),
             basis_size=(4, 4), l_max=(4, 2, 0), neurons=8)
# charge mode 3 with ZBL inside the first shell (Na-Cl at 2.82 A)
MODELS = {1: dict(seed=1), 2: dict(seed=2), 3: dict(seed=3, zbl=(2.0, 3.0))}
KEYS = ("energies", "forces", "stress", "virials", "charges", "bec")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("qnep")
    return {m: write_nep(d / f"charge{m}.txt", charge_mode=m, **SMALL, **kw)
            for m, kw in MODELS.items()}


TILT = np.array([[0, 0, 0], [1.2, 0, 0], [0.7, -0.9, 0]])


def nacl(tri: bool, seed: int = 0):
    """64 atoms of rock salt, rattled by 0.1 A; ``tri`` tilts the cell."""
    return rock_salt(2, rattle=0.1, seed=seed, tilt=TILT if tri else None)


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_parsed_weights_equal(models, mode):
    j, t = JNEP(models[mode]), NEP(models[mode], device="cpu")
    for attr in ("charge_mode", "zbl_enabled", "sqrt_epsilon_inf", "alpha_q",
                 "two_alpha_over_sqrt_pi", "charge_A", "charge_B", "b1", "dim"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for attr in ("w0", "b0", "w1", "w1c", "q_scaler", "c_radial", "c_angular"):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr), err_msg=attr)


@pytest.mark.parametrize("tri", [False, True], ids=["cubic", "triclinic"])
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_qnep_matches_jax(models, mode, tri):
    pos, m, el = nacl(tri)
    jpot = JNEP(models[mode])
    jpot.calculate(mp.System(pos=pos, box=m, element_list=el))
    s = mt.System(pos=pos, box=m, element_list=el, device="cpu")
    s.calc = NEP(models[mode], device="cpu")
    got = (s.get_energies(), s.get_force(), s.get_stress(), s.get_virials(),
           s.calc.get_charges(s), s.calc.get_bec(s))
    for k, g in zip(KEYS, got):
        w = np.asarray(jpot.results[k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=k)
    assert np.abs(got[1]).max() > 1e-3 and np.abs(got[4]).max() > 1e-3
    assert abs(got[4].sum()) < 1e-12 and got[5].shape == (64, 9)


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_qnep_net_force_vanishes(models, mode):
    """Independent of JAX: every pair term and the reciprocal sum's
    gradient at fixed charges cancel over the atoms.  (The forces are not
    minus the gradient of the energy: as in the reference, the charges'
    mean is held constant when dE/dq chains into them.)"""
    pos, m, el = nacl(True, seed=4)
    s = mt.System(pos=pos, box=m, element_list=el, device="cpu")
    s.calc = NEP(models[mode], device="cpu")
    f = s.get_force()
    assert np.abs(f.sum(axis=0)).max() < 1e-12 * max(1.0, np.abs(f).sum())
    assert np.abs(f).max() > 1e-3


def test_qnep_repeats_bit_for_bit(models):
    pos, m, el = nacl(False, seed=5)
    runs = []
    for _ in range(2):
        pot = NEP(models[1], device="cpu")
        pot.calculate(mt.System(pos=pos, box=m, element_list=el, device="cpu"))
        runs.append([pot._fetch(k) for k in KEYS])
    for k, a, b in zip(KEYS, *runs):
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_charges_need_a_charge_model(tmp_path):
    pos, m, el = nacl(False)
    path = write_nep(tmp_path / "plain.txt", **SMALL)
    s = mt.System(pos=pos, box=m, element_list=el, device="cpu")
    pot = NEP(path, device="cpu")
    for get in (pot.get_charges, pot.get_bec):
        with pytest.raises(ValueError, match="qNEP"):
            get(s)


def _spline_case(bc, uniform):
    rng = np.random.default_rng(0)
    if uniform:
        x = np.linspace(0, 2 * np.pi, 13)
    else:
        x = np.sort(rng.uniform(0, 2 * np.pi, 13))
        x[0], x[-1] = 0.0, 2 * np.pi
    y = np.sin(x)
    if bc == "clamped":
        return (mt.Spline(x, y, bc_type=bc, dy0=1.0, dyn=1.0),
                JSpline(x, y, bc_type=bc, dy0=1.0, dyn=1.0),
                SciSpline(x, y, bc_type=((1, 1.0), (1, 1.0))))
    return (mt.Spline(x, y, bc_type=bc), JSpline(x, y, bc_type=bc),
            SciSpline(x, y, bc_type=bc))


@pytest.mark.parametrize("bc", ["not-a-knot", "natural", "clamped"])
@pytest.mark.parametrize("uniform", [True, False])
def test_spline_evaluate_torch_matches_jax_and_scipy(bc, uniform):
    sp, jsp, ref = _spline_case(bc, uniform)
    for attr in ("x", "y", "_a", "_b", "_c", "_d"):
        np.testing.assert_array_equal(getattr(sp, attr), getattr(jsp, attr))
    xq = np.linspace(0, 2 * np.pi, 257)
    for order, tol in ((0, 1e-12), (1, 1e-10), (2, 1e-9)):
        got = sp.evaluate_torch(torch.tensor(xq), order)
        assert got.dtype == torch.float64
        want = np.asarray(jsp.evaluate_jax(jnp.asarray(xq), order))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)
        assert np.allclose(got.numpy(), ref(xq, order), atol=tol)
    np.testing.assert_array_equal(sp(xq), jsp(xq))
    np.testing.assert_array_equal(sp.derivative(xq), jsp.derivative(xq))


def test_spline_evaluate_torch_float32_and_shapes():
    x = np.linspace(0, 3, 9)
    sp = mt.Spline(x, np.cos(x))
    xq = torch.linspace(0, 3, 24, dtype=torch.float32).reshape(4, 6)
    got = sp.evaluate_torch(xq)
    assert got.shape == (4, 6) and got.dtype == torch.float64
    want = sp(xq.double().numpy().ravel()).reshape(4, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)


def test_spline_contracts_as_jax():
    x = np.linspace(0, 1, 5)
    sp = mt.Spline(x, x**3)
    with pytest.raises(IndexError):
        sp.evaluate(1.5)
    out = sp(np.array([-0.5, 0.5, 2.0]))
    assert np.isnan(out[0]) and np.isnan(out[2]) and np.isfinite(out[1])
    for bad in (([0.0], [1.0]), ([0, 1, 1], [0, 1, 2])):
        with pytest.raises(ValueError):
            mt.Spline(*bad)
    assert not hasattr(mt.Spline, "evaluate_jax")
