"""Carry the JAX package's render state into the port's structures.

The renderer has no weights; its state is the scene and the acceleration
structures built from it.  These converters take the JAX package's Scene,
ScreenBins and light records (anything ``np.asarray`` accepts) and return
the port's tensors, so a test can feed *identical* accel inputs to the JAX
kernel and to the port's kernel path and hold kernel parity apart from
accel parity.  Nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .accel import ScreenBins
from .scene import Scene

__all__ = [
    "scene_from_numpy", "screen_bins_from_numpy", "light_records_from_numpy",
    "extra_lights_from_numpy",
]


def scene_from_numpy(scene, device="cpu", dtype=torch.float32) -> Scene:
    """JAX ``Scene`` (sphere fields) -> port ``Scene``."""
    def t(a):
        return torch.as_tensor(np.array(a), device=device).to(dtype)

    return Scene(t(scene.sph_center), t(scene.sph_radius), t(scene.sph_color))


def screen_bins_from_numpy(sph_chunks, sph_zmin, tiles_x: int, tiles_y: int,
                           tile_px: int = 16, device="cpu") -> ScreenBins:
    """JAX ``ScreenBins.sph_chunks`` / ``sph_zmin`` -> port ``ScreenBins``."""
    chunks = np.asarray(sph_chunks)
    if tile_px != 16 or chunks.shape[-1] != 128:
        raise ValueError("the port's kernel takes 16 px tiles and 128-wide chunks")
    return ScreenBins(
        torch.as_tensor(chunks.astype(np.int64), device=device),
        torch.as_tensor(np.array(sph_zmin, np.float32), device=device),
        tiles_x, tiles_y, tile_px,
    )


def light_records_from_numpy(ldata, offs, count, lkmax, device="cpu"):
    """JAX light records -> port CSR records.

    The JAX layout is (8, CAP) rows with each cell's segment padded to a
    multiple of the TPU window width; the port's is compact (M, 8) rows.
    Returns (lrec, offs i32, count i32, lkmax f32) as ``build_light_records``
    does."""
    ldata = np.asarray(ldata, np.float32)
    offs = np.asarray(offs, np.int64)
    count = np.asarray(count, np.int64)
    rows = np.concatenate(
        [np.arange(o, o + c) for o, c in zip(offs, count)] or [np.zeros(0, np.int64)]
    ).astype(np.int64)
    new_offs = np.cumsum(count) - count

    def t(a, dtype):
        return torch.as_tensor(np.array(a), device=device).to(dtype)

    return (t(ldata[:, rows].T, torch.float32), t(new_offs, torch.int32),
            t(count, torch.int32), t(np.asarray(lkmax, np.float32), torch.float32))


def extra_lights_from_numpy(extra_lights, device="cpu") -> list:
    """JAX ``render_image_mega`` ``extra_lights`` entries
    ``(lrow, ldata, loffs, lcnt, occ[, lkmax])`` -> the port's
    ``stack_lights`` entries ``(lrow, lrec, loffs, lcnt, lkmax)``.

    The cylinder/ring occluder slot must be None: the port has no cylinders
    yet (ROADMAP B1d)."""
    out = []
    for entry in extra_lights:
        lrow, ldata, loffs, lcnt, occ = entry[:5]
        if occ is not None:
            raise ValueError("cylinder/ring occluders are not ported yet "
                             "(ROADMAP B1d)")
        ncells = np.asarray(loffs).shape[0]
        lkmax = entry[5] if len(entry) > 5 and entry[5] is not None else (
            np.full(ncells, 1e18, np.float32))
        out.append((np.asarray(lrow, np.float32),
                    *light_records_from_numpy(ldata, loffs, lcnt, lkmax,
                                              device=device)))
    return out
