"""Port parity: special quasirandom structures (``mdapy_tpu_torch/build/
sqs.py`` over ``native/sqs_engine.cpp``; ROADMAP A12d).

The same seeded systems go through the JAX package (CPU, float64) and the
port.  Without Monte Carlo (``max_steps=0``) the clusters, correlations,
objective and per-channel deltas agree within 1e-12.  With it, the chains
of ``tests/test_sqs.py``'s in-repo cases (:88, :111, :124) run the same
draws, but an accept compares ``exp(-delta / T)`` with a draw, and the
JAX package's ``-march=native`` build contracts the objective's sums into
FMAs where the port's build does not (ROADMAP C16): the best
configurations part at a recorded chain length (``FIRST_APART``); one step
shorter they are the same, with correlations and objective within 1e-12.  With
the JAX flags added to the port's build the results are the JAX package's
bit for bit at the cases' full lengths.
"""

from collections import Counter

import numpy as np
import pytest

import mdapy_tpu as mp
from mdapy_tpu.core.box import Box as JBox
import mdapy_tpu_torch as mt

from _native_flags import JAX_FLAGS, port_engine_flags, private_jax_build

TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _jax_engine_of_our_own(tmp_path_factory):
    undo = private_jax_build(tmp_path_factory)
    yield
    undo()


def _triclinic(pkg):
    L, n = 3.0, 6
    box = np.array([[L * n, 0, 0], [L * 0.3 * n, L * n, 0],
                    [L * 0.2 * n, L * 0.1 * n, L * n]])
    frac = np.array([(i, j, k) for i in range(n) for j in range(n)
                     for k in range(n)]) / n
    elem = np.random.default_rng(0).choice(["A", "B", "C"], size=n ** 3)
    kw = {"box": JBox(box)} if pkg is mp else {"box": box, "device": "cpu"}
    return pkg.System(pos=frac @ box, element_list=elem.astype(object), **kw)


def _hea(pkg, elems, structure, a, cells, seed):
    kw = {} if pkg is mp else {"device": "cpu"}
    return pkg.build_hea(elems, (1.0 / len(elems),) * len(elems), structure, a,
                         nx=cells[0], ny=cells[1], nz=cells[2],
                         random_seed=seed, **kw)


FIVE = ("Fe", "Ni", "Co", "Mn", "Cr")
# tests/test_sqs.py's in-repo Monte Carlo cases: (system, SQS arguments)
CASES = {
    "triclinic": (_triclinic, dict(cutoffs={2: 4.0}, n_replicas=4,
                                   max_steps=50000, T=0.02, seed=1)),
    "drives_down": (lambda p: _hea(p, FIVE, "fcc", 3.55, (3, 3, 3), 1),
                    dict(cutoffs={2: 2.7}, n_replicas=4, max_steps=100000,
                         T=0.02, seed=2)),
    "preserves_cell": (lambda p: _hea(p, ("A", "B", "C"), "bcc", 2.87,
                                      (3, 3, 3), 42),
                       dict(cutoffs={2: 3.5}, n_replicas=2, max_steps=20000,
                            T=0.05, seed=0)),
}
# C16: the shortest chain at which the port's best configuration leaves the
# JAX package's (g++ 12, -march=native on an FMA host); one step shorter
# the two keep the same configuration
FIRST_APART = {"triclinic": 45626, "drives_down": 76882,
               "preserves_cell": 4754}
# no Monte Carlo: pairs, triplets and quads on small cells
STATIC = {
    "pairs_triclinic": (_triclinic, {2: 4.0}),
    "triplets": (lambda p: _hea(p, FIVE, "fcc", 3.55, (2, 2, 2), 1),
                 {2: 4.0, 3: 3.0}),
    "quads": (lambda p: _hea(p, FIVE, "fcc", 3.55, (2, 2, 2), 0),
              {2: 4.0, 3: 2.7, 4: 2.7}),
    "small_box_triplets": (lambda p: _hea(p, ("A", "B", "C"), "fcc", 1.0,
                                          (1, 1, 5), 0), {2: 1.05, 3: 1.05}),
}


def _run(make, **kw):
    return (mp.SQS(make(mp), **kw).compute(), mt.SQS(make(mt), **kw).compute())


def _same_types(j, t):
    """The same best configuration; then its correlations and objective
    agree within TOL (their sums are patched step by step, in each build's
    rounding)."""
    if not np.array_equal(t._best_types, j._best_types):
        return False
    np.testing.assert_allclose(t.correlations, j.correlations, rtol=0, atol=TOL)
    assert abs(t.objective - j.objective) <= TOL
    return True


def _same_bits(j, t):
    return (np.array_equal(t._best_types, j._best_types)
            and t.objective == j.objective
            and t.correlations.tobytes() == j.correlations.tobytes()
            and t._delta.tobytes() == j._delta.tobytes())


@pytest.mark.parametrize("name", sorted(STATIC))
def test_static_correlations_match_jax(name):
    make, cutoffs = STATIC[name]
    j, t = _run(make, cutoffs=cutoffs, n_replicas=1, max_steps=0)
    np.testing.assert_array_equal(t._best_types, j._best_types)
    np.testing.assert_allclose(t.correlations, j.correlations, rtol=0, atol=TOL)
    np.testing.assert_allclose(t._delta, j._delta, rtol=0, atol=TOL)
    assert abs(t.objective - j.objective) <= TOL
    assert len(t.channel_info) == len(j.channel_info)
    for a, b in zip(t.channel_info, j.channel_info):
        assert {k: v for k, v in a.items() if k != "corr"} == \
            {k: v for k, v in b.items() if k != "corr"}
    bodies = Counter(ci["n_pts"] for ci in t.channel_info)
    assert set(bodies) == set(cutoffs)
    assert isinstance(t.system, mt.System) and t.system.device.type == "cpu"


def test_enumerated_clusters_match_jax():
    make, cutoffs = STATIC["quads"]
    j = mp.SQS(make(mp), cutoffs=cutoffs)._enumerate_clusters()
    t = mt.SQS(make(mt), cutoffs=cutoffs)._enumerate_clusters()
    assert t[1] == j[1] and t[2] == j[2]
    for (nj, cj, sj, dj), (nt, ct, st, dt) in zip(j[0], t[0]):
        assert nj == nt and dj == dt
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(st, sj)
    assert [b[0] for b in t[0]] == [2, 3, 4] and len(t[0][2][1]) > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_monte_carlo_parts_from_jax_at_the_recorded_step(name):
    make, kw = CASES[name]
    step = FIRST_APART[name]
    assert step <= kw["max_steps"]
    assert _same_types(*_run(make, **dict(kw, max_steps=step - 1)))
    assert not _same_types(*_run(make, **dict(kw, max_steps=step)))
    j, t = _run(make, **kw)
    assert not _same_types(j, t)
    # what the cases assert of each package holds for the port
    assert np.allclose(t.system.box.matrix, j.system.box.matrix)
    for col in ("x", "y", "z"):
        np.testing.assert_array_equal(t.system.data[col], j.system.data[col])
    assert Counter(np.asarray(t.system.data["element"]).astype(str).tolist()) \
        == Counter(np.asarray(make(mt).data["element"]).astype(str).tolist())
    assert t.objective < 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_monte_carlo_with_the_jax_build_flags_is_jax(name):
    """C16's cause: the port's engine copy built with the JAX package's
    flags runs every chain to the JAX package's result."""
    make, kw = CASES[name]
    j = mp.SQS(make(mp), **kw).compute()
    with port_engine_flags(JAX_FLAGS):
        t = mt.SQS(make(mt), **kw).compute()
    assert _same_bits(j, t)
    np.testing.assert_array_equal(np.asarray(t.system.data["element"]).astype(str),
                                  np.asarray(j.system.data["element"]).astype(str))
    np.testing.assert_array_equal(t.system.data["type"], j.system.data["type"])


def test_is_sqs_matches_jax():
    make, cutoffs = STATIC["triplets"]
    j, t = _run(make, cutoffs=cutoffs, n_replicas=1, max_steps=0)
    vj, ij = j.is_sqs(tol=0.02, verbose=False)
    vt, it = t.is_sqs(tol=0.02, verbose=False)
    assert vt == vj and not vt
    assert it["absolute"] == pytest.approx(ij["absolute"], abs=TOL)
    for a, b in zip(it["warren_cowley"]["per_shell"],
                    ij["warren_cowley"]["per_shell"]):
        assert a["shell"] == b["shell"] and a["rc"] == b["rc"]
        np.testing.assert_allclose(a["matrix"], b["matrix"], rtol=0, atol=TOL)


def test_cutoff_errors_match_jax():
    s = _hea(mt, ("A", "B"), "fcc", 3.6, (2, 2, 2), 0)
    for cut, msg in (({3: 3.0}, "must include key 2"),
                     ({2: 3.0, 5: 3.0}, "2-, 3- and 4-body")):
        with pytest.raises(ValueError, match=msg):
            mt.SQS(s, cutoffs=cut)
