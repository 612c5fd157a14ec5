"""Port parity: the FIRE minimizer (``mdapy_tpu_torch/potentials/
minimizer.py``, ROADMAP A9) driving the port's EAM.

The eight modes of ``tests/test_potentials.py::_FIRE_MODES`` (FIRE2 or
ABC-FIRE; positions or positions + cell, with a mask, hydrostatic strain,
constant volume or a scalar pressure), 20 steps each on a seeded, rattled
Cu-Ni alloy: the JAX ``FIRE`` on a JAX ``System`` with the JAX ``EAM`` (CPU,
float64) against the port's ``FIRE`` on ``tests/_torch_system.py`` with the
port's ``EAM(device="cpu")``.  Positions, energies and stress within 1e-8.
``chip_smoke.py`` [F1] relaxes 256,000 atoms on the card.
"""

import numpy as np
import pytest

import mdapy_tpu as mp
from _torch_system import StandInSystem
from mdapy_tpu.potentials.eam import EAM as JEAM, EAMGenerator
from mdapy_tpu.potentials.minimizer import FIRE as JFIRE
from mdapy_tpu_torch.potentials.eam import EAM
from mdapy_tpu_torch.potentials.minimizer import FIRE

TOL = 1e-8
STEPS = 20

# (use_abc, optimize_cell, mask, hydrostatic, constant volume, pressure), as
# tests/test_potentials.py:71-80
FIRE_MODES = [
    (False, False, None, False, False, 0),
    (True, False, None, False, False, 0),
    (False, True, None, False, False, 0),
    (True, True, None, False, False, 0),
    (False, True, [1, 0, 0, 0, 0, 0], False, False, 0),
    (False, True, None, True, False, 0),
    (False, True, None, False, True, 0),
    (False, True, None, False, False, 1),
]


@pytest.fixture(scope="module")
def eam_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("fire") / "CuNi.eam.alloy"
    EAMGenerator(["Cu", "Ni"], output_filename=str(path))
    return str(path)


@pytest.mark.parametrize("idx,params", list(enumerate(FIRE_MODES)))
def test_fire_modes_match_jax(eam_file, idx, params):
    use_abc, cell, mask, hydro, cv, p = params
    s = mp.build_crystal("Cu", "fcc", 3.615, nx=4, ny=4, nz=4)
    rng = np.random.default_rng(100 + idx)
    s.set_element(np.where(rng.random(s.N) < 0.3, "Ni", "Cu").astype(object))
    s.update_pos(s.pos + rng.normal(0.0, 0.08, s.pos.shape))
    t = StandInSystem(s.pos, s.box, np.asarray(s.data["element"]))
    s.calc = JEAM(eam_file)
    t.calc = EAM(eam_file, device="cpu")
    e0 = t.get_energy()
    kw = dict(use_abc=use_abc, optimize_cell=cell, mask=mask,
              hydrostatic_strain=hydro, constant_volume=cv, scalar_pressure=p)
    JFIRE(s, **kw).run(steps=STEPS)
    FIRE(t, **kw).run(steps=STEPS)
    np.testing.assert_allclose(t.box.matrix, s.box.matrix, rtol=0, atol=TOL)
    np.testing.assert_allclose(t.pos, s.pos, rtol=0, atol=TOL)
    np.testing.assert_allclose(t.get_energies(), s.get_energies(), rtol=0, atol=TOL)
    np.testing.assert_allclose(t.get_stress(), s.get_stress(), rtol=0, atol=TOL)
    assert t.get_energy() < e0
