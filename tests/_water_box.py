"""A box of water molecules on a cubic grid with seeded orientations (numpy
only), shared by ``tests/test_torch_analysis_host.py`` and ``chip_smoke.py``
[S5] for the chemical-species count.

Each molecule is O at a grid point with its two H at 0.9572 A and an H-O-H
angle of 104.52 degrees, turned by a uniformly random rotation.  At a
spacing of 3.1 A no atom of one molecule comes within 1.18 A of another
molecule's atoms, so at ``scale=0.4`` (vdW cut-offs 0.96-1.2 A) every
molecule is one H2O."""

import numpy as np

OH = 0.9572
HOH = np.radians(104.52)


def water_box(n_side: int, spacing: float = 3.1, seed: int = 0):
    """(positions (3 n^3, 3), elements (O, H, H, ...) as objects, box edge)."""
    rng = np.random.default_rng(seed)
    grid = np.mgrid[0:n_side, 0:n_side, 0:n_side].reshape(3, -1).T * spacing
    local = np.array([[0.0, 0.0, 0.0], [OH, 0.0, 0.0],
                      [OH * np.cos(HOH), OH * np.sin(HOH), 0.0]])
    q = rng.normal(size=(len(grid), 4))
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    rot = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], axis=1)
    pos = (grid[:, None, :] + np.einsum("mij,kj->mki", rot, local)).reshape(-1, 3)
    elements = np.tile(np.array(["O", "H", "H"], dtype=object), len(grid))
    return pos, elements, n_side * spacing
