"""Port parity: NEP (``mdapy_tpu_torch/potentials/nep.py``, ROADMAP A9).

Small seeded NEP3, NEP4 + ZBL and NEP5 models (Cu and Ni, narrow widths)
are written in ``tmp_path`` by ``tests/_nep_file.py`` in the format both
packages' ``NEP._parse`` read.  The parsed weights must be equal (the
function that carries the JAX package's parameters into the port), and a
seeded, rattled Cu-Ni alloy gives the same energies, forces, virials,
stress, descriptors and latent space from the JAX ``NEP`` (CPU, float64) and
the port's (``device="cpu"``) at rtol = atol = 1e-9.  The port's forces on
the CPU repeat bit for bit.  The charge models are
``tests/test_torch_qnep.py``'s.  ``chip_smoke.py`` [P1] runs a NEP4 + ZBL
model at GPUMD's default widths on the card.
"""

import numpy as np
import pytest
import torch

import mdapy_tpu as mp
from _nep_file import write_nep
from _torch_system import StandInSystem
from mdapy_tpu.potentials.nep import NEP as JNEP
from mdapy_tpu_torch.potentials.nep import NEP

TOL = 1e-9
SMALL = dict(cutoff=(5.0, 4.0), n_max=(3, 3), basis_size=(4, 4), neurons=8)
MODELS = {
    "nep3": dict(version=3, l_max=(4, 2, 1), seed=3, **SMALL),
    "nep4_zbl": dict(version=4, l_max=(4, 2, 0), zbl=(1.5, 2.4), seed=4, **SMALL),
    "nep5": dict(version=5, l_max=(3, 0, 1), seed=5, **SMALL),
}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("nep")
    out = {k: write_nep(d / f"{k}.txt", **kw) for k, kw in MODELS.items()}
    out["flexible"] = write_nep(d / "flexible.txt", version=4, zbl="flexible",
                                l_max=(4, 2, 0), seed=6, **SMALL)
    out["charge"] = write_nep(d / "charge.txt", version=4, charge_mode=1,
                              l_max=(4, 2, 0), seed=8, **SMALL)
    return out


def alloy(seed=1):
    s = mp.build_crystal("Cu", "fcc", 3.615, nx=3, ny=3, nz=3)
    rng = np.random.default_rng(seed)
    s.set_element(np.where(rng.random(s.N) < 0.3, "Ni", "Cu").astype(object))
    # rattled enough that some pairs come inside the ZBL cutoff of 2.4 A
    s.update_pos(s.pos + rng.normal(0.0, 0.15, s.pos.shape))
    return s


@pytest.mark.parametrize("name", ["nep3", "nep4_zbl", "nep5", "flexible"])
def test_parsed_weights_equal(models, name):
    j, t = JNEP(models[name]), NEP(models[name], device="cpu")
    for attr in ("version", "zbl_enabled", "zbl_flexibled", "zbl_rc_inner",
                 "zbl_rc_outer", "rc_radial", "rc_angular", "L4", "L5", "dim",
                 "num_neurons", "b1", "elements_list"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for attr in ("w0", "b0", "w1", "q_scaler", "c_radial", "c_angular",
                 "atomic_numbers"):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr), err_msg=attr)
    if name == "flexible":
        np.testing.assert_array_equal(t.zbl_para, j.zbl_para)


@pytest.mark.parametrize("name", ["nep3", "nep4_zbl", "nep5"])
def test_nep_matches_jax(models, name):
    s = alloy()
    jpot, tpot = JNEP(models[name]), NEP(models[name], device="cpu")
    s.calc = jpot
    want = (s.get_energies(), s.get_force(), s.get_virials(), s.get_stress(),
            jpot.get_descriptors(s), jpot.get_latent_space(s))
    t = StandInSystem(s.pos, s.box, np.asarray(s.data["element"]))
    t.calc = tpot
    got = (t.get_energies(), t.get_force(), t.get_virials(), t.get_stress(),
           tpot.get_descriptors(t), tpot.get_latent_space(t))
    names = ("energies", "forces", "virials", "stress", "descriptors", "latent")
    for n, g, w in zip(names, got, want):
        assert g.shape == w.shape, n
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=n)
    assert np.abs(got[1]).max() > 1e-3  # forces are not trivially zero


def test_forces_repeat_bit_for_bit(models):
    s = alloy(seed=2)
    runs = []
    for _ in range(2):
        t = StandInSystem(s.pos, s.box, np.asarray(s.data["element"]))
        t.calc = NEP(models["nep4_zbl"], device="cpu")
        runs.append((t.get_energies(), t.get_force(), t.get_virials()))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_unported_models_and_card_default(models):
    # qNEP models are ported now (tests/test_torch_qnep.py holds them)
    assert NEP(models["charge"], device="cpu").charge_mode == 1
    if torch.cuda.is_available():
        assert NEP(models["nep3"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            NEP(models["nep3"])
