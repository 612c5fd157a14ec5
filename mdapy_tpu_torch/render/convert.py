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
from .megakernel import OtherRecords
from .scene import Scene

__all__ = [
    "scene_from_numpy", "screen_bins_from_numpy", "light_records_from_numpy",
    "extra_lights_from_numpy", "other_records_from_numpy",
]


def scene_from_numpy(scene, device="cpu", dtype=torch.float32) -> Scene:
    """JAX ``Scene`` -> port ``Scene`` (spheres, cylinders and rings)."""
    def t(a):
        return torch.as_tensor(np.array(a), device=device).to(dtype)

    return Scene(*(t(getattr(scene, f)) for f in (
        "sph_center", "sph_radius", "sph_color", "cyl_base", "cyl_axis",
        "cyl_radius", "cyl_color", "ring_center", "ring_normal", "ring_rout",
        "ring_color")))


def other_records_from_numpy(other_data, other_count, occ_recs=None,
                             n_occ: int = 0, extra_occ=(),
                             device="cpu") -> OtherRecords:
    """JAX ``gather_other_records`` output -> port ``OtherRecords``.

    ``other_data`` (nb, 16, KO) holds each tile's first ``other_count[t]``
    records, the rest padding; the port's records are compact (M, 16) rows,
    tile after tile.  ``occ_recs`` (16, KG) is the primary light's occluder
    table, its first ``n_occ`` columns live; ``extra_occ`` the sky lights'
    tables in light order (a None entry reuses the primary's, as the JAX
    wrapper does, megakernel.py:1960-1962).  Without ``occ_recs`` no
    occluder is tested."""
    data = np.asarray(other_data, np.float32)
    count = np.asarray(other_count, np.int64)
    rows = np.concatenate([data[t, :, :c].T for t, c in enumerate(count)]
                          or [np.zeros((0, 16), np.float32)])
    offs = np.cumsum(count) - count

    def t(a, dtype):
        return torch.as_tensor(np.array(a), device=device).to(dtype)

    occ = None
    if occ_recs is not None:
        tables = [occ_recs] + [occ_recs if o is None else o for o in extra_occ]
        occ = t(np.stack([np.asarray(o, np.float32)[:, :n_occ].T
                          for o in tables]), torch.float32)
    return OtherRecords(t(rows, torch.float32), t(offs, torch.int32),
                        t(count, torch.int32), occ)


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

    The cylinder/ring occluder tables (the entries' fifth slot) go to
    ``other_records_from_numpy`` as its ``extra_occ``."""
    out = []
    for entry in extra_lights:
        lrow, ldata, loffs, lcnt = entry[:4]
        ncells = np.asarray(loffs).shape[0]
        lkmax = entry[5] if len(entry) > 5 and entry[5] is not None else (
            np.full(ncells, 1e18, np.float32))
        out.append((np.asarray(lrow, np.float32),
                    *light_records_from_numpy(ldata, loffs, lcnt, lkmax,
                                              device=device)))
    return out
