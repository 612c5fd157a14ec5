"""Port parity: the elastic stacks and the wrappers (ROADMAP A9e).

``mdapy_tpu_torch.potentials.{elastic, bond_stiffness, qha_elastic,
md_elastic, lammps, nep4ase}`` against the JAX package's on the same
inputs, on the CPU.  The calculators are ``tests/_toy_calc.py``'s
Lennard-Jones and its port twin (``tests/_elastic_standins.py``, the same
arithmetic), the two packages' EAM on one ``EAMGenerator(["Cu"])`` file,
and the two packages' NEP on ``tests/_nep_file.py``'s model.  LAMMPS,
phonopy, spglib and ASE are absent from both machines, so their host logic
runs against recording stand-ins (``tests/_elastic_standins.py``) put into
``sys.modules`` for both packages; without them both raise the same
ImportError.

Tolerances: the elastic tensors within 1e-10 of the largest |C_ij|
(measured: LJ bit for bit, EAM 3.3e-15); the bond stiffnesses within 1e-10
(measured 8.2e-13 on k ~ 38 eV/A^2: the two packages' neighbor lists order
tied neighbors differently, so the design matrix sums in another order); every file, command log and the
host-side fits (``DeformedStructureSet``, ``ElasticTensor``, QHA's
``compute``, ``assemble_elastic_tensor``) bit for bit; NEP4ASE within
1e-10.
"""

import os
import tempfile

import numpy as np
import pytest

import mdapy_tpu as mp
import mdapy_tpu_torch as mt
from mdapy_tpu.potentials import elastic as jel
from mdapy_tpu.potentials import lammps as jlmp
from mdapy_tpu.potentials import md_elastic as jmd
from mdapy_tpu.potentials import nep4ase as jase
from mdapy_tpu.potentials import qha_elastic as jqha
from mdapy_tpu_torch.potentials import elastic as tel
from mdapy_tpu_torch.potentials import lammps as tlmp
from mdapy_tpu_torch.potentials import md_elastic as tmd
from mdapy_tpu_torch.potentials import nep4ase as tase
from mdapy_tpu_torch.potentials import qha_elastic as tqha

import _elastic_standins as standins
from _nep_file import write_nep
from _toy_calc import LJCalculator as JaxLJ

TOL_C = 1e-10
TOL_K = 1e-10


def _cu_unit(pkg):
    kw = {} if pkg is mp else {"device": "cpu"}
    return pkg.build_crystal("Cu", "fcc", 3.615, **kw)


def _voigt_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= TOL_C * np.abs(b).max(), np.abs(a - b).max()


@pytest.fixture(scope="module")
def eam_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("eam") / "Cu.eam.alloy"
    mp.EAMGenerator(["Cu"], output_filename=str(path))
    return str(path)


@pytest.mark.parametrize("calc", ["lj", "eam"])
def test_elastic_constant_matches_jax(calc, eam_file):
    """``get_elastic_constant`` at its defaults on the Cu unit cell: the
    cell relaxation, 24 deformed copies on the system's device, their
    relaxations and the fits."""
    if calc == "lj":
        jcalc, tcalc = JaxLJ(), standins.LJCalculator()
    else:
        jcalc, tcalc = mp.EAM(eam_file), mt.EAM(eam_file, device="cpu")
    ref = jel.get_elastic_constant(_cu_unit(mp), jcalc)
    got = tel.get_elastic_constant(_cu_unit(mt), tcalc)
    assert isinstance(got, tel.ElasticTensor)
    _voigt_close(got.voigt, ref.voigt)
    C = got.voigt
    assert np.allclose(C, C.T) and C[0, 0] - C[0, 1] > 0 and C[3, 3] > 0
    assert abs(got.bulk_modulus_voigt - ref.bulk_modulus_voigt) <= (
        TOL_C * abs(ref.bulk_modulus_voigt))


def test_deformed_structures_and_fit_bit_for_bit():
    s_j, s_t = _cu_unit(mp), _cu_unit(mt)
    jset = jel.DeformedStructureSet(s_j)
    tset = tel.DeformedStructureSet(s_t)
    assert len(tset) == len(jset) == 24
    for (jd, js), (td, ts) in zip(jset, tset):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(ts.pos, js.pos)
        np.testing.assert_array_equal(ts.box.matrix, js.box.matrix)
        assert ts.device == s_t.device and isinstance(ts, mt.System)
        assert list(ts.data["element"]) == list(js.data["element"])
    rng = np.random.default_rng(0)
    strains = [tel.strain_from_deformation(d) for d, _ in tset]
    stresses = [rng.normal(size=(3, 3)) for _ in strains]
    stresses = [0.5 * (s + s.T) for s in stresses]
    eq = rng.normal(size=(3, 3))
    for eq_stress in (eq, None):
        j = jel.ElasticTensor.from_independent_strains(strains, stresses, eq_stress)
        t = tel.ElasticTensor.from_independent_strains(strains, stresses, eq_stress)
        np.testing.assert_array_equal(t.voigt, j.voigt)
        assert t.shear_modulus_voigt == j.shear_modulus_voigt


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _bond_systems(pkg, alloy):
    kw = {} if pkg is mp else {"device": "cpu"}
    if alloy:
        return pkg.build_hea(("Al", "Cu"), (0.5, 0.5), "fcc", a=3.85, nx=2,
                             ny=2, nz=2, random_seed=1, **kw)
    return pkg.build_crystal("Al", "fcc", a=4.05, nx=2, ny=2, nz=2, **kw)


@pytest.mark.parametrize("alloy", [False, True])
def test_bond_stiffness_matches_jax(alloy, tmp_path):
    """2x2x2 FCC Al and a 2x2x2 Al-Cu random alloy, ``rc_bond=3.0``, three
    strains, linear k(r): 193 force calls a strain in each package."""
    kw = dict(rc_bond=3.0, delta=0.01)
    ref = mp.BondStiffness(_bond_systems(mp, alloy), JaxLJ(rc=5.0), **kw).compute()
    got = mt.BondStiffness(_bond_systems(mt, alloy), standins.LJCalculator(rc=5.0),
                           **kw).compute()
    np.testing.assert_allclose(got.shells, ref.shells, rtol=0, atol=TOL_K)
    assert sorted(got.k_long) == sorted(ref.k_long) and len(got.k_long) == (
        3 if alloy else 1)
    for key in ref.k_long:
        np.testing.assert_allclose(got.k_long[key], ref.k_long[key], atol=TOL_K)
        np.testing.assert_allclose(got.k_trans[key], ref.k_trans[key], atol=TOL_K)
    # the bond table: the same rows, in another order among tied neighbors
    cols = ["element_a", "element_b", "shell", "r", "strain", "k_long",
            "k_trans"]
    assert isinstance(got.bond_table, mt.AtomFrame)
    assert list(got.bond_table.columns) == list(ref.bond_table.columns) == cols

    def rows(table):
        keys = [np.asarray(table[c]).astype(str) for c in cols[:3]]
        vals = np.column_stack([np.asarray(table[c], float) for c in cols[3:]])
        order = np.lexsort((np.round(vals[:, 3], 6), np.round(vals[:, 0], 6),
                            vals[:, 1], *keys[::-1]))
        return [k[order] for k in keys], vals[order]

    (tk, tv), (jk, jv) = rows(got.bond_table), rows(ref.bond_table)
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=TOL_K)
    got.write_slspring(str(tmp_path / "t.out"))
    ref.write_slspring(str(tmp_path / "j.out"))
    assert (tmp_path / "t.out").read_bytes() == (tmp_path / "j.out").read_bytes()
    if not alloy:
        tp = got.generate_perturbed_structures(str(tmp_path / "tp"))
        jp = ref.generate_perturbed_structures(str(tmp_path / "jp"))
        assert tp == jp and len(tp) == 32 * 3 * 2
        assert _tree(tmp_path / "tp") == _tree(tmp_path / "jp")


def _fake_free_energies(qha, V0):
    """tests/test_elastic_logic.py:120-136: an analytic F(cell, T)."""
    C_true = np.zeros((6, 6))
    C_true[:3, :3] = 140.0
    np.fill_diagonal(C_true[:3, :3], 220.0)
    C_true[3, 3] = C_true[4, 4] = C_true[5, 5] = 100.0
    C_true /= jqha.EV_A3_TO_GPA

    def free_energies():
        out = np.zeros((len(qha.unique_cells), len(qha.temperatures)))
        for ci, uc in enumerate(qha.unique_cells):
            V = V0 * (1.0 + uc["volume_strain"])
            mode = (np.zeros(6) if uc["mode"] < 0
                    else np.asarray(qha.modes[uc["mode"]], float))
            eps = mode * uc["eps"]
            elastic = 0.5 * V * eps @ C_true @ eps
            for ti, T in enumerate(qha.temperatures):
                out[ci, ti] = elastic + 1e-3 * (V - V0 * (1.0 + 2e-5 * T)) ** 2
        return out

    return free_energies


def _qha(pkg_mod, system, crystal_class="cubic"):
    return pkg_mod.QHAElastic(
        system, calc=None, crystal_class=crystal_class, t_min=100.0,
        t_max=300.0, t_step=100.0, volume_strains=[-0.01, 0.0, 0.01],
        strain_values=[-0.01, 0.0, 0.01])


def test_qha_compute_and_files_match_jax(monkeypatch, tmp_path):
    for a, b in zip(tqha.CUBIC_STRAIN_MODES + tqha.HEXAGONAL_STRAIN_MODES,
                    jqha.CUBIC_STRAIN_MODES + jqha.HEXAGONAL_STRAIN_MODES):
        np.testing.assert_array_equal(a, b)
    s_j, s_t = _cu_unit(mp), _cu_unit(mt)
    jq, tq = _qha(jqha, s_j), _qha(tqha, s_t)
    assert tq.grid == jq.grid and len(tq.unique_cells) == len(jq.unique_cells)
    for tu, ju in zip(tq.unique_cells, jq.unique_cells):
        np.testing.assert_array_equal(tu["system"].pos, ju["system"].pos)
        np.testing.assert_array_equal(tu["system"].box.matrix,
                                      ju["system"].box.matrix)
        assert tu["system"].device == s_t.device
    V0 = abs(np.linalg.det(s_j.box.matrix))
    jq._free_energies = _fake_free_energies(jq, V0)
    tq._free_energies = _fake_free_energies(tq, V0)
    ref, got = jq.compute(), tq.compute()
    assert isinstance(got, mt.AtomFrame) and got is tq.results_df
    assert list(got.columns) == list(ref.columns) == [
        "T", "V", "C11", "C12", "C44", "B"]
    for c in ref.columns:
        np.testing.assert_array_equal(np.asarray(got[c]), ref[c].to_numpy())
    np.testing.assert_allclose(np.asarray(got["C11"]), 220.0, rtol=1e-4)
    # the DFT round trip through the phonopy stand-in
    standins.install(monkeypatch)
    jq.export_inputs(tmp_path / "j")
    tq.export_inputs(tmp_path / "t")
    jt, tt = _tree(tmp_path / "j"), _tree(tmp_path / "t")
    assert tt == jt and len(tt) == 1 + 3 * len(tq.unique_cells) == 64
    rng = np.random.default_rng(4)
    for ci in range(len(tq.unique_cells)):
        for d in ("t", "j"):
            sub = tmp_path / d / f"cell-{ci:03d}"
            (sub / "static" / "OSZICAR").write_text(
                f"   1 F= -.1E+02 E0= {-3.5 - ci * 1e-3:.8E}  d E =0.0\n")
        for k in (1, 2):
            rows = "".join(f"<v> {x:.8f} {y:.8f} {z:.8f} </v>\n"
                           for x, y, z in rng.normal(size=(32, 3)))
            for d in ("t", "j"):
                (tmp_path / d / f"cell-{ci:03d}" / f"disp-{k:03d}" /
                 "vasprun.xml").write_text(
                    f'<varray name="forces">\n{rows}</varray>\n')
    jq.import_results(tmp_path / "j")
    tq.import_results(tmp_path / "t")
    for tu, ju in zip(tq.unique_cells, jq.unique_cells):
        assert tu["E_static"] == ju["E_static"]
        np.testing.assert_array_equal(np.array(tu["forces"]),
                                      np.array(ju["forces"]))


def test_qha_needs_spglib_and_phonopy(monkeypatch):
    """Without spglib (class detection) and phonopy both packages raise the
    same ImportError."""
    monkeypatch.setitem(__import__("sys").modules, "spglib", None)
    monkeypatch.setitem(__import__("sys").modules, "phonopy", None)
    msgs = []
    for mod, s in ((jqha, _cu_unit(mp)), (tqha, _cu_unit(mt))):
        with pytest.raises(ImportError) as err:
            _qha(mod, s, crystal_class=None)
        msgs.append(str(err.value))
        q = _qha(mod, s)
        with pytest.raises(ImportError, match="phonopy") as err:
            q._phonopy_for(q.unique_cells[0])
        msgs.append(str(err.value))
    assert msgs[:2] == msgs[2:] and "spglib" in msgs[0]


def test_md_elastic_math_matches_jax():
    rng = np.random.default_rng(0)
    s_plus, s_minus = rng.normal(size=(6, 6)), rng.normal(size=(6, 6))
    C = tmd.assemble_elastic_tensor(s_plus, s_minus, 0.015)
    np.testing.assert_array_equal(C, jmd.assemble_elastic_tensor(s_plus, s_minus, 0.015))
    C = C + 300 * np.eye(6)
    args = (C, rng.normal(size=6), 1000.0, 301.5, 300.0, "isothermal")
    t, j = tmd.MDElasticResult(*args), jmd.MDElasticResult(*args)
    assert t.cubic_average() == j.cubic_average()
    assert t.vrh() == j.vrh() and t.born_stable_cubic() == j.born_stable_cubic()
    jobs = list(range(-3, 4))
    for workers in (1, 2):
        assert tmd.fanout(abs, jobs, workers) == jmd.fanout(abs, jobs, workers)


def _run_both(monkeypatch, fn):
    """Run ``fn(package_modules)`` for JAX then the port under one lammps
    stand-in; returns (jax result, jax log, port result, port log)."""
    log = standins.install(monkeypatch)
    out = []
    for mods in ((jlmp, jmd, mp), (tlmp, tmd, mt)):
        del log[:]
        out += [fn(*mods), list(log)]
    return out


def _same_log(a, b):
    assert len(a) == len(b) and len(a) > 5
    for x, y in zip(a, b):
        assert x == y, (x, y)


def test_md_elastic_run_matches_jax(monkeypatch, tmp_path):
    restart_dir = str(tmp_path / "mdel")
    os.makedirs(restart_dir)
    monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix="": restart_dir)

    def run(lmp_mod, md_mod, pkg):
        s = _cu_unit(pkg)
        return md_mod.MDElastic(s, 300.0, "eam/alloy", "* * Cu.eam.alloy Cu",
                                ["Cu"], n_equil=20, n_run=40,
                                n_relax=20).run()

    jr, jlog, tr, tlog = _run_both(monkeypatch, run)
    _same_log(tlog, jlog)
    assert sum(e[0] == "lammps" for e in tlog) == 13
    np.testing.assert_array_equal(tr.C, jr.C)
    np.testing.assert_array_equal(tr.stress_ref, jr.stress_ref)
    assert (tr.V_eq, tr.T_actual, tr.ensemble) == (jr.V_eq, jr.T_actual, jr.ensemble)


def test_lammps_potential_and_runner_match_jax(monkeypatch):
    def run(lmp_mod, md_mod, pkg):
        s = _cu_unit(pkg)
        pot = lmp_mod.LammpsPotential("pair_style eam/alloy\npair_coeff * * "
                                      "Cu.eam.alloy Cu", ["Cu"],
                                      extra_commands="neighbor 2.0 bin")
        s.calc = pot
        res = {k: np.array(getattr(s, f"get_{k}")()) for k in (
            "energies", "force", "stress", "virials")}
        with lmp_mod.LammpsRunner(s, "pair_style eam/alloy", ["Cu", "Ni"]) as r:
            r.minimize()
            r.minimize_box(ptarget=1.0)
            for ens in ("nve", "nvt", "npt"):
                r.run_md(ensemble=ens, steps=10)
            out = r.get_system()
        assert isinstance(out, pkg.System)
        res.update(pos=out.pos, box=out.box.matrix, origin=out.box.origin,
                   elements=np.asarray(out.data["element"]).astype(str))
        return res

    jr, jlog, tr, tlog = _run_both(monkeypatch, run)
    _same_log(tlog, jlog)
    assert sorted(tr) == sorted(jr)
    for k in jr:
        np.testing.assert_array_equal(tr[k], jr[k])


def test_wrappers_need_their_packages(monkeypatch, tmp_path):
    """Without ``lammps`` and ``ase`` both packages raise the same
    ImportError, naming the package."""
    sys_mods = __import__("sys").modules
    for name in ("lammps", "ase", "ase.calculators",
                 "ase.calculators.calculator"):
        monkeypatch.setitem(sys_mods, name, None)
    msgs = []
    for lmp_mod, md_mod, ase_mod, pkg in ((jlmp, jmd, jase, mp),
                                          (tlmp, tmd, tase, mt)):
        s = _cu_unit(pkg)
        pot = lmp_mod.LammpsPotential("pair_style zero 3.0", ["Cu"])
        for call in (lambda: pot.calculate(s),
                     lambda: lmp_mod.LammpsRunner(s, "pair_style zero", ["Cu"]),
                     lambda: md_mod.MDElastic(s, 300.0, "zero", "* *", ["Cu"]),
                     lambda: ase_mod.NEP4ASE(str(tmp_path / "none.txt"))):
            with pytest.raises(ImportError) as err:
                call()
            msgs.append(str(err.value))
    assert msgs[:4] == msgs[4:]
    assert "lammps" in msgs[0] and "ase" in msgs[3]


def test_nep4ase_matches_jax(monkeypatch, tmp_path):
    """NEP4ASE through the ase stand-in: energies, forces and stress
    within 1e-10, with a non-periodic z (the cell grows by 3 rc there)."""
    standins.install(monkeypatch)
    model = write_nep(tmp_path / "nep.txt", elements=("Cu", "Ni"),
                      cutoff=(5.0, 4.0), n_max=(3, 3), basis_size=(4, 4),
                      neurons=8)
    s = mt.build_crystal("Cu", "fcc", 3.615, nx=2, ny=2, nz=2, device="cpu")
    rng = np.random.default_rng(2)
    pos = s.pos + rng.normal(0, 0.05, s.pos.shape)
    symbols = ["Cu", "Ni"] * (s.N // 2)
    for pbc in ((True, True, False),):
        atoms = standins.Atoms(symbols, pos, s.box.matrix, pbc)
        j = jase.NEP4ASE(model)
        t = tase.NEP4ASE(model, device="cpu")
        assert t.device.type == "cpu"
        j.calculate(atoms)
        t.calculate(atoms)
        assert sorted(t.results) == ["energies", "energy", "forces", "stress"]
        for k in j.results:
            np.testing.assert_allclose(t.results[k], j.results[k], rtol=0,
                                       atol=1e-10)
        assert t.results["stress"].shape == (6,)
