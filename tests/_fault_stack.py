"""A close-packed stack that holds an intrinsic stacking fault, a twin
boundary and an extrinsic stacking fault, with the planar-fault code PTM's
``identify_fcc_planar_faults`` must give each layer; shared by
``tests/test_torch_ptm.py`` (a small stack, against the JAX package) and
``chip_smoke.py`` [S6] (10,000 atoms a layer, 100 layers).

Layers are stacked as in ``tests/test_ptm.py:_stack``, each letter A, B, C
shifting the layer by (1/2, sqrt(3)/6) of the in-plane spacing from the
one before.  Step k (layer k to k+1) goes one letter forward or back; a
layer is hcp-like where its two steps differ.  One step turned back makes
two adjacent hcp layers (an ISF, code 2); every step from one on turned
back makes one (a twin boundary, 3); two steps turned back make two hcp
layers with one fcc layer between (an ESF, 5); fcc layers are 0.  The
free surfaces in z (the first and last layer) carry no expectation.
"""

import numpy as np


def fault_stack(side: int, layers: int, a: float = 2.556):
    """(positions, box matrix, boundary, layer of each atom, expected
    code of each layer with -1 at the two surfaces)."""
    steps = np.ones(layers - 1, dtype=int)
    q = (layers - 1) // 4
    steps[q] = -1                       # ISF: layers q and q + 1
    steps[2 * q:] *= -1                 # twin: layer 2q
    steps[3 * q:3 * q + 2] *= -1        # ESF: layers 3q and 3q + 2
    letter = np.concatenate([[0], np.cumsum(steps)]) % 3
    hcp = np.zeros(layers, dtype=bool)
    hcp[1:-1] = steps[:-1] != steps[1:]
    expect = np.zeros(layers, dtype=int)
    for i in np.nonzero(hcp)[0]:
        if hcp[i - 1] or hcp[i + 1]:
            expect[i] = 2
        elif (i >= 2 and hcp[i - 2]) or (i + 2 < layers and hcp[i + 2]):
            expect[i] = 5
        else:
            expect[i] = 3
    expect[[0, -1]] = -1
    dz = a * np.sqrt(2.0 / 3.0)
    i, j = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    plane = np.stack([(i + 0.5 * j).ravel(), (np.sqrt(3) / 2 * j).ravel()], 1)
    shift = np.array([0.5, np.sqrt(3) / 6])
    pos = np.concatenate([
        np.c_[(plane + letter[k] * shift) * a, np.full(len(plane), k * dz)]
        for k in range(layers)])
    matrix = np.array([[side * a, 0, 0],
                       [side * a * 0.5, side * a * np.sqrt(3) / 2, 0],
                       [0, 0, layers * dz]])
    layer = np.repeat(np.arange(layers), side * side)
    return pos, matrix, np.array([1, 1, 0]), layer, expect
