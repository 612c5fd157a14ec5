"""A seeded NEP model file, written in the format GPUMD's ``nep.txt`` has
and both packages' ``NEP._parse`` read, shared by the CPU parity test
``tests/test_torch_nep.py`` and ``chip_smoke.py`` [P1].  numpy only.

The weights are random draws from ``seed``, sized so that the ANN's hidden
layer is neither dead nor saturated on a metal's neighborhoods; they model
nothing physical."""

import numpy as np


def write_nep(path, version=4, elements=("Cu", "Ni"), zbl=None,
              cutoff=(8.0, 4.0), n_max=(4, 4), basis_size=(8, 8),
              l_max=(4, 2, 0), neurons=30, seed=0) -> str:
    """Write a NEP3/4/5 file to ``path`` and return the path.

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
    num_c = nt * nt * ((n_max[0] + 1) * (basis_size[0] + 1)
                       + (n_max[1] + 1) * (basis_size[1] + 1))
    lines = [f"{name}{'_zbl' if zbl else ''} {nt} {' '.join(elements)}"]
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
    c = rng.normal(0.0, 0.3, num_c)
    q_scaler = rng.uniform(0.05, 0.5, dim)
    values = [ann, c, q_scaler]
    if zbl == "flexible":
        values.append(rng.uniform(0.1, 2.0, 10 * (nt * (nt + 1) // 2)))
    lines += [f"{v:.15e}" for v in np.concatenate(values)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)
