"""An FCC block of a random solid solution (the equiatomic high-entropy
alloys of mdapy's examples)."""

from __future__ import annotations

import numpy as np

from .elements import rgba
from .lattice import fcc_block


def build(spec: dict, rng: np.random.Generator):
    """(positions, colors, radii): ``spec["cells"]`` FCC cells of edge
    ``spec["a"]`` per axis; the sites are shared out among
    ``spec["elements"]`` in equal numbers (the first elements take one
    more where the count does not divide), in an order ``rng`` shuffles."""
    n = int(spec["cells"])
    pos = fcc_block(n, n, n, float(spec["a"]))
    elements = list(spec["elements"])
    counts = np.full(len(elements), len(pos) // len(elements))
    counts[: len(pos) - counts.sum()] += 1
    species = np.repeat(np.arange(len(elements)), counts)
    rng.shuffle(species)
    colors = rgba([elements[k] for k in species])
    radii = np.full(len(pos), float(spec["radius"]), np.float32)
    return pos, colors, radii
