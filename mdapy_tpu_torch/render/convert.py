"""Carry the JAX package's render state into the port's structures.

The renderer has no weights; its state is the scene and the acceleration
structures built from it.  These converters take the JAX package's Scene,
ScreenBins and light records (anything ``np.asarray`` accepts) and return
the port's tensors, so a test can feed *identical* accel inputs to the JAX
kernel and to the port's kernel path and hold kernel parity apart from
accel parity.  Every converter takes the target ``device`` as a required
keyword: "cuda" for the hand kernels, "cpu" for their plain versions.
Nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .accel import LightBins, LightKind, ScreenBins
from .megakernel import OtherRecords
from .scene import Scene

__all__ = [
    "scene_from_numpy", "screen_bins_from_numpy", "light_records_from_numpy",
    "light_bins_from_numpy", "extra_lights_from_numpy",
    "other_records_from_numpy",
]


def scene_from_numpy(scene, *, device, dtype=torch.float32) -> Scene:
    """JAX ``Scene`` -> port ``Scene`` (spheres, cylinders and rings)."""
    def t(a):
        return torch.as_tensor(np.array(a), device=device).to(dtype)

    return Scene(*(t(getattr(scene, f)) for f in (
        "sph_center", "sph_radius", "sph_color", "cyl_base", "cyl_axis",
        "cyl_radius", "cyl_color", "ring_center", "ring_normal", "ring_rout",
        "ring_color")))


def other_records_from_numpy(other_data, other_count, occ_recs=None,
                             n_occ: int = 0, extra_occ=(), *,
                             device) -> OtherRecords:
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
                           tile_px: int = 16, *, device, cyl=None,
                           ring=None, ncyl: int = 0) -> ScreenBins:
    """JAX ``ScreenBins`` -> port ``ScreenBins``: ``sph_chunks`` and
    ``sph_zmin``, and, when given, the ``cyl`` and ``ring`` ``KindBins``
    (-1 padded per-tile lists with their counts), which become the port's
    per-tile CSR list: a tile's cylinders in slot order, then its rings with
    ids moved up by ``ncyl``, the scene's padded cylinder count."""
    chunks = np.asarray(sph_chunks)
    if tile_px != 16 or chunks.shape[-1] != 128:
        raise ValueError("the port's kernel takes 16 px tiles and 128-wide chunks")

    def t(a, dtype):
        return torch.as_tensor(np.array(a), device=device).to(dtype)

    oth = (None, None, None, 0)
    if cyl is not None or ring is not None:
        nb = tiles_x * tiles_y
        ids, tile, count, k_other = [], [], np.zeros(nb, np.int64), 0
        for kind, base in ((cyl, 0), (ring, ncyl)):
            if kind is None:
                continue
            cand = np.asarray(kind.cand).astype(np.int64)
            cnt = np.asarray(kind.count).astype(np.int64)
            live = np.arange(cand.shape[1])[None, :] < cnt[:, None]
            ids.append(cand[live] + base)
            tile.append(np.nonzero(live)[0])
            count += cnt
            k_other += cand.shape[1]
        order = np.argsort(np.concatenate(tile), kind="stable")
        oth = (t(np.concatenate(ids)[order], torch.int64),
               t(np.cumsum(count) - count, torch.int64),
               t(count, torch.int64), k_other)
    return ScreenBins(t(chunks, torch.int64), t(sph_zmin, torch.float32),
                      tiles_x, tiles_y, tile_px, *oth)


def light_bins_from_numpy(lb, *, device) -> LightBins:
    """JAX ``LightBins`` (its ``sph``, ``cyl`` and ``ring`` ``LightKind``
    cells) -> port ``LightBins``.  The JAX cells are dense (ncells, K) rows
    in ascending key order; the port's are compact CSR in descending order,
    so each cell's live entries are reversed.  A kind the JAX build left out
    (no live primitive) becomes empty cells."""
    ncells = lb.grid * lb.grid

    def t(a, dtype):
        return torch.as_tensor(np.array(a), device=device).to(dtype)

    def kind(k) -> LightKind:
        if k is None:
            z = np.zeros(ncells, np.int64)
            return LightKind(t(z[:0], torch.int64), t(z[:0], torch.float32),
                             t(z, torch.int64), t(z, torch.int64))
        cand = np.asarray(k.cand)[:, ::-1]
        count = np.asarray(k.count).astype(np.int64)
        # the live slots of a reversed row are its last count[i]
        live = np.arange(cand.shape[1])[None, :] >= cand.shape[1] - count[:, None]
        return LightKind(
            t(cand[live], torch.int64),
            t(np.asarray(k.keys)[:, ::-1][live], torch.float32),
            t(np.cumsum(count) - count, torch.int64), t(count, torch.int64))

    sph = kind(lb.sph)
    return LightBins(
        sph.ids, sph.offs, sph.count, t(lb.L, torch.float32),
        t(lb.e1, torch.float32), t(lb.e2, torch.float32),
        t(lb.org, torch.float32), t(lb.inv_cell, torch.float32), lb.grid,
        sph.keys, kind(lb.cyl), kind(lb.ring))


def light_records_from_numpy(ldata, offs, count, lkmax, *, device):
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


def extra_lights_from_numpy(extra_lights, *, device) -> list:
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
