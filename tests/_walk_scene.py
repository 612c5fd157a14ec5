"""The scene of long light-grid cell walks (the megakernel's shadow walks),
shared by ``tests/test_torch_walks.py`` (the port's plain version against
the JAX package on the CPU) and ``chip_smoke.py`` phase [2w] (the hand
kernel against the plain version on the card).  numpy only."""

import numpy as np

# (n column atoms, their alpha, what else): walks of n + 1 records (the
# column's and the target's own), one that reaches the 1e-3 floor at its 40th
# occluder, one with an opaque-factor atom at index 20, and "stop" ones that
# a sphere below the target ends by a key stop at record n + 1
WALK_CASES = ((30, 0.05, ""), (31, 0.05, ""), (32, 0.05, "stop"),
              (62, 0.05, ""), (63, 0.05, ""), (64, 0.05, "stop"),
              (50, 0.16, ""), (40, 0.1, "opaque20"), (44, 0.02, "stop"))


def walk_scene():
    """A scene of long light-grid cell walks: one opaque target sphere (r
    1.2) per entry of WALK_CASES, in a row along y 3 A apart, each under a
    column of small atoms (r 0.45, 1 A apart) that rises from 2.5 A above
    its centre along the light (1, 0, 1) / sqrt(2), so that the cell over a
    target's lit pole holds the column's records in key order, then the
    target's own (and a "stop" case's sphere 3.5 A below it along the
    light).  Returns positions, colours, radii, the keywords of an
    orthographic camera that looks down on the targets, and the light
    direction in the renderer's (z-flipped) frame."""
    lw = np.array([1.0, 0.0, 1.0]) / np.sqrt(2.0)
    rng = np.random.default_rng(23)
    pos, alpha, radii = [], [], []
    for i, (n, a, what) in enumerate(WALK_CASES):
        c = np.array([0.0, 3.0 * i, 0.0])
        pos.append(c)
        alpha.append(1.0)
        radii.append(1.2)
        for k in range(n):
            pos.append(c + (2.5 + k) * lw)
            alpha.append(0.999995 if what == "opaque20" and k == 20 else a)
            radii.append(0.45)
        if what == "stop":
            pos.append(c - 3.5 * lw)
            alpha.append(1.0)
            radii.append(1.0)
    pos = np.array(pos)
    colors = np.c_[rng.uniform(0.3, 1.0, (len(pos), 3)), alpha].astype(np.float32)
    cam = dict(is_perspective=False, field_of_view=13.5,
               position=(6.0, 12.0, 50.0), direction=(0.0, 0.0, -1.0),
               up=(0.0, 1.0, 0.0))
    return pos, colors, np.array(radii, np.float32), cam, lw * np.array([1.0, 1.0, -1.0])
