"""Debye S(k) at its default rc = L/2 on perfect FCC CoNiCr blocks, the
port (CPU) against the JAX package (CPU): the pairs whose exact distance
is rc, how many of them each package counts, and the largest difference
of S(k) relative to its largest value (ROADMAP C15).

    JAX_PLATFORMS=cpu python tools/sk_rc_shell.py [cells ...]

Needs both packages; sizes of 6 and 10 cells (864 and 4,000 atoms) take
a few seconds each on the CPU.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "tests")]

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import mdapy_tpu as mp  # noqa: E402
import mdapy_tpu_torch as mt  # noqa: E402
from test_torch_analysis_host import _shell_bounds  # noqa: E402

A, NBIN = 3.59, 200


def main(cells_list):
    for cells in cells_list:
        s = mp.build_hea(("Co", "Ni", "Cr"), (0.3, 0.3, 0.4), "fcc", A,
                         nx=cells, ny=cells, nz=cells, random_seed=2)
        pos, m = np.asarray(s.pos), np.asarray(s.box.matrix)
        el = np.asarray(s.data["element"]).astype(str)
        rc = m[0, 0] / 2
        j = mp.RadialDistributionFunction(pos, m, rc, NBIN, elements=el)
        t = mt.RadialDistributionFunction(pos, m, rc, NBIN, elements=el,
                                          device="cpu")
        jc = np.asarray(j._stream_counts()).sum(axis=(0, 1)).astype(np.int64)
        tc = t._stream_counts(torch.as_tensor(t.type_idx)).numpy().sum(
            axis=(0, 1))
        sure, slack = _shell_bounds(pos, cells, A, NBIN)
        sj = mp.StructureFactor(pos, m, cal_partial=True, elements=el).compute()
        st = mt.StructureFactor(pos, m, cal_partial=True, elements=el,
                                device="cpu").compute()
        rel = float(np.abs(st.Sk - sj.Sk).max() / np.abs(sj.Sk).max())
        print(f"{cells}^3 cells, {len(pos)} atoms, rc {rc:.4f} A: "
              f"{int(slack[-1])} ordered pairs on the last bin's edges; "
              f"its counts: port {int(tc[-1])}, JAX {int(jc[-1])}, exact "
              f"{int(sure[-1])} off the edges; bins that differ "
              f"{np.nonzero(tc != jc)[0].tolist()}; S(k) max |port - JAX| "
              f"/ max |S| = {rel:.3e}")


if __name__ == "__main__":
    main([int(c) for c in sys.argv[1:]] or [6, 10])
