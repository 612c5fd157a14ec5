"""Scene assembly: world-space spheres -> flipped, padded torch tensors.

Port of ``mdapy_tpu/render/scene.py`` (``Scene`` :41, ``build_scene`` :96,
``_pad_to`` :28, ``_round_up`` :35) for the sphere-only render slice.  All
coordinates are z-flipped into Tachyon space (tvec, tachyon_render.h:58), and
the arrays are padded to a multiple of ``pad`` with radius -1 slots that no
ray can hit, exactly as the JAX package pads them.  Bond and box-edge
cylinders are ROADMAP B1d.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Scene", "build_scene"]

FLIP = np.array([1.0, 1.0, -1.0])


def _pad_to(arr: np.ndarray, n: int, fill: float = 0.0) -> np.ndarray:
    if arr.shape[0] == n:
        return arr
    pad = np.full((n - arr.shape[0],) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


@dataclass
class Scene:
    """Padded sphere tensors in flipped (Tachyon) space, on one device."""

    sph_center: torch.Tensor  # (Ns, 3)
    sph_radius: torch.Tensor  # (Ns,)   (-1 padding)
    sph_color: torch.Tensor   # (Ns, 4)


def build_scene(
    positions: np.ndarray,
    colors: np.ndarray,
    radii: np.ndarray,
    dtype: torch.dtype = torch.float32,
    pad: int = 256,
    device="cpu",
) -> Scene:
    """One sphere per particle with alpha > 0 (tachyon_render.h:302-305),
    z-flipped and padded to a multiple of ``pad``."""
    positions = np.asarray(positions, dtype=np.float64) * FLIP
    colors = np.asarray(colors, dtype=np.float64)
    radii = np.asarray(radii, dtype=np.float64)

    # zero-alpha particles are skipped by the reference (tachyon_render.h:305)
    keep = colors[:, 3] > 0.0
    ns = _round_up(int(keep.sum()), pad)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def put(a, fill=0.0):
        return torch.from_numpy(
            np.ascontiguousarray(_pad_to(a, ns, fill).astype(np_dtype))
        ).to(device)

    return Scene(
        sph_center=put(positions[keep]),
        sph_radius=put(radii[keep], fill=-1.0),
        sph_color=put(colors[keep]),
    )
