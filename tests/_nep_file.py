"""A seeded NEP model file, written in the format GPUMD's ``nep.txt`` has
and both packages' ``NEP._parse`` read, shared by the CPU parity tests
``tests/test_torch_nep.py`` and ``tests/test_torch_qnep.py`` and
``chip_smoke.py`` [P1] and [Q1], and the rock-salt crystal the charge
models run on.  numpy only.

The weights are random draws from ``seed``, sized so that the ANN's hidden
layer is neither dead nor saturated on a metal's neighborhoods; they model
nothing physical."""

import numpy as np


def write_nep(path, version=4, elements=("Cu", "Ni"), zbl=None,
              cutoff=(8.0, 4.0), n_max=(4, 4), basis_size=(8, 8),
              l_max=(4, 2, 0), neurons=30, seed=0, charge_mode=0) -> str:
    """Write a NEP3/4/5 file to ``path`` and return the path.

    ``charge_mode`` 1, 2 or 3 writes a ``nep4_charge<mode>`` (qNEP) model:
    each type's weights gain the charge head's ``neurons`` values after its
    output weights, and sqrt(eps_inf), drawn from [1, 2), precedes the
    output bias.

    ``zbl`` is None, an (inner, outer) cutoff pair, or "flexible" (the
    ``zbl 0 0`` header and 10 parameters per type pair after q_scaler).
    The defaults are GPUMD's ``nep.in`` defaults: ``cutoff 8 4``, ``n_max
    4 4``, ``basis_size 8 8``, ``l_max 4 2 0``, ``neuron 30``."""
    rng = np.random.default_rng(seed)
    nt = len(elements)
    name = {3: "nep3", 4: "nep4", 5: "nep5"}[version]
    num_L = l_max[0] + int(l_max[1] == 2) + int(l_max[2] == 1)
    dim = (n_max[0] + 1) + (n_max[1] + 1) * num_L
    if version == 3:
        num_ann = (dim + 2) * neurons + 1
    elif version == 4:
        num_ann = (dim + 2) * neurons * nt + 1
    else:
        num_ann = ((dim + 2) * neurons + 1) * nt + 1
    if charge_mode:
        num_ann += neurons * nt + 1
    num_c = nt * nt * ((n_max[0] + 1) * (basis_size[0] + 1)
                       + (n_max[1] + 1) * (basis_size[1] + 1))
    if charge_mode:
        name += f"{'_zbl' if zbl else ''}_charge{charge_mode}"
    elif zbl:
        name += "_zbl"
    lines = [f"{name} {nt} {' '.join(elements)}"]
    if zbl == "flexible":
        lines.append("zbl 0 0")
    elif zbl:
        lines.append(f"zbl {zbl[0]} {zbl[1]}")
    lines += [f"cutoff {cutoff[0]} {cutoff[1]} 1000 1000",
              f"n_max {n_max[0]} {n_max[1]}",
              f"basis_size {basis_size[0]} {basis_size[1]}",
              f"l_max {l_max[0]} {l_max[1]} {l_max[2]}",
              f"ANN {neurons} 0"]
    ann = rng.normal(0.0, 0.15, num_ann)
    if charge_mode:
        ann[-2] = rng.uniform(1.0, 2.0)  # sqrt(eps_inf)
    c = rng.normal(0.0, 0.3, num_c)
    q_scaler = rng.uniform(0.05, 0.5, dim)
    values = [ann, c, q_scaler]
    if zbl == "flexible":
        values.append(rng.uniform(0.1, 2.0, 10 * (nt * (nt + 1) // 2)))
    lines += [f"{v:.15e}" for v in np.concatenate(values)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def rock_salt(cells: int, a: float = 5.64, rattle: float = 0.05, seed: int = 0,
              tilt=None):
    """(positions, cell, elements) of rock-salt NaCl: cells^3 conventional
    cells of edge ``a`` (8 atoms each), rattled by normal(0, ``rattle``) A;
    ``tilt`` (3, 3), added to the cubic cell, makes it triclinic."""
    fcc = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    basis = np.vstack([fcc, fcc + [.5, 0, 0]])
    grid = np.mgrid[0:cells, 0:cells, 0:cells].reshape(3, -1).T
    frac = (basis[None] + grid[:, None]).reshape(-1, 3) / cells
    m = np.eye(3) * a * cells + (0.0 if tilt is None else np.asarray(tilt))
    pos = frac @ m + np.random.default_rng(seed).normal(0.0, rattle, frac.shape)
    elements = np.array(["Na"] * 4 + ["Cl"] * 4, dtype=object)
    return pos, m, np.tile(elements, len(grid))
