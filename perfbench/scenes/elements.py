"""Element colours: the Jmol palette's RGB bytes for the elements the
configurations use (the values of ``mdapy``'s element table)."""

from __future__ import annotations

import numpy as np

JMOL_RGB = {
    "Co": (240, 144, 160),
    "Cr": (138, 153, 199),
    "Cu": (200, 128, 51),
    "Fe": (224, 102, 51),
    "Mn": (155, 122, 198),
    "Ni": (80, 208, 80),
}


def rgba(elements) -> np.ndarray:
    """(N, 4) float32 colours, alpha 1, for a sequence of element names."""
    names = sorted(set(elements))
    unknown = [e for e in names if e not in JMOL_RGB]
    if unknown:
        raise ValueError(f"no colour for elements {unknown}")
    table = np.array([(*JMOL_RGB[e], 255) for e in names], np.float64) / 255.0
    index = {e: i for i, e in enumerate(names)}
    return table[[index[e] for e in elements]].astype(np.float32)
