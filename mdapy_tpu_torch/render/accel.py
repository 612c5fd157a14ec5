"""Acceleration structures for the render slice — binning, not BVHs.

Port of ``mdapy_tpu/render/accel.py``:

  * screen-tile bins (``build_screen_bins`` :417): conservative per-sphere
    screen-space spans -> (tile, sphere) pairs -> per-tile candidate lists,
    depth-sorted front to back and cut into 128-wide chunks, each with its
    minimum conservative depth (``zmin``) for the kernel's early exit; the
    cylinders and rings get per-tile lists from their bounding spheres
    (``_prim_bounds`` :378), the cylinders' pairs culled to the projected
    segment's band (``_cyl_screen_seg`` :323, ``_seg_tile_cull`` :49);
  * light-grid bins (``build_light_bins`` :528): a 2D grid perpendicular to
    the directional light, framed over every kind (:533-539); each cell
    lists the spheres whose lateral footprint overlaps it, sorted by
    descending far-depth key c.L + r, and, on request, the cylinders and
    rings by their bounding spheres (``_prim_bounds`` :378), which the tiled
    tracer's shadow pass reads (``tracer_tiled._shadow_filter_lb``);
  * light records (``build_light_records`` :613): the CSR rows
    ``[cu, cv, ck, r, key, alpha, 0, 0]`` the shadow sweep reads, with the
    per-cell maximum key ``lkmax``;
  * one build for every light, K lights at a time (the JAX build makes
    them light by light): ``frame_light_batch`` frames K lights in one pass
    and reads their frames and pair counts to the host in one copy;
    ``bin_light_group`` expands and sorts a group of them in one pass,
    bucket light * ncells + cell, and ``light_group_records`` gathers the
    group's records, with no read from the device.  The primary light is a
    batch of one (``build_light_bins``, ``build_light_records``), fast AO's
    sky lights a batch of K (``render.build_ao_lights``); a light's cells
    and records do not depend on the lights built beside it.
    ``light_rows`` packs the lights' rows for the megakernel;
  * cylinder and ring records (``_other_records`` :638, ``_gather_other``
    :667, ``gather_other_records`` :687): 16-float rows per primitive, the
    tiles' candidates gathered back to back, and one occluder table per
    light with its light-space cull data.

The (bucket, item) pair expansion is ``repeat_interleave`` over the span
sizes, so the scatter-offset clamp of the JAX build (``accel.py:86``,
ROADMAP fault C1) has no counterpart here.  The power-of-two capacity caches
and the 128-lane padding of the JAX build exist only for XLA's static shapes
and are dropped; the chunk width stays 128, and the cyl/ring lists and
occluder tables are compact, not padded to 128 lanes.  So is
``scene_live_counts`` (accel.py:362): the JAX build needs live counts to
size static shapes and to skip empty primitive kinds, and the pair
expansion here needs neither.  The light cells of all three kinds are compact
CSR lists in descending key order, where the JAX build pads each kind to a
dense (ncells, K) table in ascending order; no candidate is cut in either.
The megakernel reads the sphere cells only, so the cylinder and ring cells
are built only when ``build_light_bins`` is asked for them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import ieee

__all__ = [
    "ScreenBins", "LightBins", "LightKind", "build_screen_bins",
    "build_light_bins",
    "build_light_records", "other_table", "gather_other_records",
    "occluder_records", "LightBatch", "LightGroup", "frame_light_batch",
    "split_light_batch", "bin_light_group", "light_group_bins",
    "light_group_records", "light_rows",
]

BIG_DEPTH = 1e17
CH = 128         # candidates per chunk (the kernel stages one chunk at a time)


class ScreenBins(NamedTuple):
    sph_chunks: torch.Tensor  # (nb, nchunks, CH) int64 depth-sorted ids, -1 padded
    sph_zmin: torch.Tensor    # (nb, nchunks) chunk min depths (BIG_DEPTH if empty)
    tiles_x: int
    tiles_y: int
    tile_px: int
    # cylinders and rings: per-tile ids back to back, cylinders by ascending
    # id, then rings by ascending id + Nc (the padded cylinder count)
    oth_ids: Optional[torch.Tensor] = None     # (M,) int64
    oth_offs: Optional[torch.Tensor] = None    # (nb,) int64 starts
    oth_count: Optional[torch.Tensor] = None   # (nb,) int64
    # the JAX renderer's per-tile bound: the widest tile's cylinder count
    # plus its ring count, each rounded up to 8 (render.py:399-402)
    k_other: int = 0


class LightKind(NamedTuple):
    """One primitive kind's light cells, compact CSR."""

    ids: torch.Tensor     # (M,) ids within the kind, by cell, then descending key
    keys: torch.Tensor    # (M,) far-depth key c.L + r of each entry's bound
    offs: torch.Tensor    # (ncells,) int64 CSR starts
    count: torch.Tensor   # (ncells,) int64


class LightBins(NamedTuple):
    ids: torch.Tensor     # (M,) sphere ids, by cell, then descending far key
    offs: torch.Tensor    # (ncells,) int64 CSR starts
    count: torch.Tensor   # (ncells,) int64
    L: torch.Tensor       # (3,) light direction (the stored N-dot direction)
    e1: torch.Tensor      # (3,) lateral basis
    e2: torch.Tensor      # (3,)
    org: torch.Tensor     # (2,) lateral origin (umin, vmin)
    inv_cell: torch.Tensor  # () cells per unit length
    grid: int
    keys: Optional[torch.Tensor] = None   # (M,) the spheres' far keys
    # the cylinders' and rings' cells, from their bounding spheres; None
    # when not asked for (the megakernel reads the spheres' only)
    cyl: Optional[LightKind] = None
    ring: Optional[LightKind] = None
    # (9,) f32 host frame [e1, e2, org, inv_cell], as its pass read it
    frame: Optional[np.ndarray] = None
    # (LightBatch, LightGroup, light) of the pass that built it, which
    # build_light_records gathers from
    source: Optional[tuple] = None

    @property
    def sph(self) -> LightKind:
        return LightKind(self.ids, self.keys, self.offs, self.count)


def _expand_pairs(x0, y0, span_w, span_h, nx: int, total: Optional[int] = None):
    """Spans -> (bucket, item) pairs, one pair per covered bucket.

    Items with an empty span contribute no pair wherever they sit in the
    array (no offset clamp, so no fault C1).  ``total``, the number of
    pairs when the caller knows it, spares the expansion its read of the
    sizes' sum."""
    sizes = span_w * span_h
    n = sizes.shape[0]
    item = torch.repeat_interleave(torch.arange(n, device=sizes.device), sizes,
                                   output_size=total)
    offsets = torch.cumsum(sizes, 0) - sizes
    local = torch.arange(item.shape[0], device=sizes.device) - offsets[item]
    w = span_w[item]
    bucket = (y0[item] + local // w) * nx + (x0[item] + local % w)
    return bucket, item


def _csr_sort(bucket, item, key, nbuckets: int):
    """Sort pairs by bucket, then by ``key`` ascending (stable, so equal keys
    keep item order).  Returns (bucket_s, item_s, key_s, count, start)."""
    order = torch.argsort(key, stable=True)
    order = order[torch.argsort(bucket[order], stable=True)]
    bucket_s = bucket[order]
    count = torch.bincount(bucket_s, minlength=nbuckets)
    start = torch.cumsum(count, 0) - count
    return bucket_s, item[order], key[order], count, start


# ---------------------------------------------------------------------------
# screen-space bins
# ---------------------------------------------------------------------------


def _screen_px_bounds(centers, radii, origin, right, up2, view, left, bottom,
                      psx, psy, width: int, height: int, perspective: bool):
    """Per-sphere conservative pixel bounds (px0, px1, py0, py1) and the
    behind-camera flag (accel.py:195-228)."""
    rel = centers - origin
    xc = rel @ right
    yc = rel @ up2
    zc = rel @ view
    r = radii
    if perspective:
        def extent(lat, dep):
            unbounded = dep <= r
            d2 = lat * lat + dep * dep
            root = ieee.sqrt(torch.clamp(d2 - r * r, min=1e-20))
            denom = dep * dep - r * r
            safe = torch.where(unbounded, torch.ones_like(denom), denom)
            u1 = (lat * dep - r * root) / safe
            u2 = (lat * dep + r * root) / safe
            return u1, u2, unbounded

        ux0, ux1, unb_x = extent(xc, zc)
        uy0, uy1, unb_y = extent(yc, zc)
        unb = unb_x | unb_y
        zero = torch.zeros_like(ux0)
        px0 = torch.where(unb, zero, (ux0 - left) / psx)
        px1 = torch.where(unb, zero + float(width), (ux1 - left) / psx)
        py0 = torch.where(unb, zero, (uy0 - bottom) / psy)
        py1 = torch.where(unb, zero + float(height), (uy1 - bottom) / psy)
        behind = zc <= -r
    else:
        px0 = (xc - r - left) / psx
        px1 = (xc + r - left) / psx
        py0 = (yc - r - bottom) / psy
        py1 = (yc + r - bottom) / psy
        behind = torch.zeros_like(xc, dtype=torch.bool)
    return px0, px1, py0, py1, behind


SPAN_PAD = 1.5   # px: 1-based sampling + 0.5px AA jitter


def _screen_spans(centers, radii, origin, right, up2, view, left, bottom,
                  psx, psy, width: int, height: int, tile_px: int,
                  perspective: bool):
    """Per-sphere tile span (tx0, ty0, span_w, span_h); span 0 when the
    sphere is dead, behind the camera or off screen (accel.py:195)."""
    px0, px1, py0, py1, behind = _screen_px_bounds(
        centers, radii, origin, right, up2, view, left, bottom, psx, psy,
        width, height, perspective)
    pad = SPAN_PAD
    ntx = (width - 1) // tile_px
    nty = (height - 1) // tile_px

    def tile_of(p, hi):
        return torch.clamp(torch.floor(p / tile_px), 0, hi).to(torch.int64)

    tx0 = tile_of(px0 - pad, ntx)
    tx1 = tile_of(px1 + pad, ntx)
    ty0 = tile_of(py0 - pad, nty)
    ty1 = tile_of(py1 + pad, nty)
    offscreen = ((px1 < -pad) | (px0 > width + pad)
                 | (py1 < -pad) | (py0 > height + pad))
    live = (radii > 0) & ~behind & ~offscreen
    span_w = torch.where(live, tx1 - tx0 + 1, 0)
    span_h = torch.where(live, ty1 - ty0 + 1, 0)
    return tx0, ty0, span_w, span_h


def _screen_setup(frame, width: int, height: int, dtype, device):
    """Host-side screen basis, computed as the JAX build computes it."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    ipr = np.asarray(frame["iplaneright"], np_dtype)
    ipu = np.asarray(frame["iplaneup"], np_dtype)
    psx = float(np.linalg.norm(ipr))
    psy = float(np.linalg.norm(ipu))

    def t(a):
        return torch.as_tensor(np.asarray(a, np_dtype), device=device)

    return dict(
        origin=t(frame["origin"]), right=t(ipr / psx), up2=t(ipu / psy),
        view=t(frame["view"]), left=t(-0.5 * psx * width),
        bottom=t(-0.5 * psy * height), psx=t(psx), psy=t(psy),
    )


def _cyl_screen_seg(base, axis, radii, g, perspective: bool):
    """Projected 2D segment (pixel coords) and radius pad per cylinder, and
    whether its cull applies (accel.py:323-359): endpoints behind the camera,
    or a bounding tube that reaches the camera plane, leave it inactive."""
    origin, right, up2, view = g["origin"], g["right"], g["up2"], g["view"]
    left, bottom, psx, psy = g["left"], g["bottom"], g["psx"], g["psy"]

    def proj(rel):
        xc = rel @ right
        yc = rel @ up2
        zc = rel @ view
        if perspective:
            zs = torch.clamp(zc, min=1e-6)
            return (xc / zs - left) / psx, (yc / zs - bottom) / psy, zc
        return (xc - left) / psx, (yc - bottom) / psy, torch.ones_like(zc)

    x0p, y0p, z0 = proj(base - origin)
    x1p, y1p, z1 = proj(base + axis - origin)
    ps = torch.minimum(psx, psy)
    if perspective:
        zmin = torch.clamp(torch.minimum(z0, z1), min=1e-6)
        # finite-distance silhouette half-width times sec^2 of the frame
        # corner's angle
        sec2 = 1.0 + left * left + bottom * bottom
        safe = ieee.sqrt(torch.clamp(zmin * zmin - radii * radii, min=1e-12))
        rpad = radii * sec2 / (safe * ps)
        active = ((z0 > 1e-6) & (z1 > 1e-6) & (radii > 0)
                  & (zmin > radii * 1.05))
    else:
        rpad = radii / ps
        active = radii > 0
    return x0p, y0p, x1p, y1p, rpad, active


def _seg_tile_cull(seg, item, tx, ty, tile_px: int):
    """True where the item's projected segment band misses the tile
    (accel.py:49-69); inactive items are never culled."""
    sx0, sy0, sx1, sy1, rpad, active = seg
    cx = (tx.to(sx0.dtype) + 0.5) * tile_px
    cy = (ty.to(sx0.dtype) + 0.5) * tile_px
    ax, ay = sx0[item], sy0[item]
    bx, by = sx1[item] - ax, sy1[item] - ay
    wx, wy = cx - ax, cy - ay
    denom = torch.clamp(bx * bx + by * by, min=1e-12)
    t = torch.clamp((wx * bx + wy * by) / denom, 0.0, 1.0)
    dx = wx - t * bx
    dy = wy - t * by
    lim = rpad[item] + 0.70711 * tile_px + 1.5
    return active[item] & (dx * dx + dy * dy > lim * lim)


def _round8(x: int) -> int:
    return max(8, -(-int(x) // 8) * 8)


def build_screen_bins(scene, frame, width: int, height: int,
                      tile_px: int = 16) -> ScreenBins:
    """Per-tile front-to-back sphere chunks and their min depths, and the
    per-tile cylinder and ring lists."""
    centers, radii = scene.sph_center, scene.sph_radius
    g = _screen_setup(frame, width, height, centers.dtype, centers.device)
    tiles_x = -(-width // tile_px)
    tiles_y = -(-height // tile_px)
    nb = tiles_x * tiles_y
    persp = bool(frame["perspective"])

    def spans(c, r):
        return _screen_spans(
            c, r, g["origin"], g["right"], g["up2"], g["view"],
            g["left"], g["bottom"], g["psx"], g["psy"],
            width, height, tile_px, persp,
        )

    tx0, ty0, sw, sh = spans(centers, radii)
    bucket, item = _expand_pairs(tx0, ty0, sw, sh, tiles_x)
    # conservative front depth (zc - r) orders each tile's candidates
    depth = (centers @ g["view"]) - radii - (g["origin"] @ g["view"])
    bucket_s, item_s, d_s, count, start = _csr_sort(
        bucket, item, depth[item], nb)
    kmax = int(count.max()) if nb else 0
    nchunks = max(1, -(-kmax // CH))
    local = torch.arange(bucket_s.shape[0], device=centers.device) - start[bucket_s]
    cand = torch.full((nb, nchunks * CH), -1, dtype=torch.int64,
                      device=centers.device)
    dpad = torch.full((nb, nchunks * CH), BIG_DEPTH, dtype=centers.dtype,
                      device=centers.device)
    cand[bucket_s, local] = item_s
    dpad[bucket_s, local] = d_s
    zmin = dpad[:, ::CH].contiguous()

    # cylinders (bounding sphere about the midpoint, pairs culled to the
    # projected segment's band), then rings; ids of rings follow Nc
    cyl_live = scene.cyl_radius > 0
    cmid = scene.cyl_base + 0.5 * scene.cyl_axis
    cr = torch.where(cyl_live, 0.5 * torch.linalg.norm(scene.cyl_axis, dim=-1)
                     + scene.cyl_radius, -1.0)
    cb, ci = _expand_pairs(*spans(cmid, cr), tiles_x)
    seg = _cyl_screen_seg(scene.cyl_base, scene.cyl_axis, scene.cyl_radius, g,
                          persp)
    keep = ~_seg_tile_cull(seg, ci, cb % tiles_x, cb // tiles_x, tile_px)
    cb, ci = cb[keep], ci[keep]
    rb, ri = _expand_pairs(*spans(scene.ring_center, scene.ring_rout), tiles_x)
    k_other = 0
    for live, b in ((cyl_live, cb), (scene.ring_rout > 0, rb)):
        if bool(live.any()):
            k_other += _round8(int(torch.bincount(b, minlength=nb).max())
                               if nb else 0)
    ob = torch.cat([cb, rb])
    oi = torch.cat([ci, ri + scene.cyl_base.shape[0]])
    order = torch.argsort(ob, stable=True)
    ocount = torch.bincount(ob, minlength=nb)
    return ScreenBins(cand.view(nb, nchunks, CH), zmin, tiles_x, tiles_y,
                      tile_px, oi[order], torch.cumsum(ocount, 0) - ocount,
                      ocount, k_other)


# ---------------------------------------------------------------------------
# light-space bins and records
# ---------------------------------------------------------------------------


# device bytes a (light, cell, sphere) pair of a batched pass holds at its
# peak, the (K, N) projections and spans included: the int64 items, buckets
# and sort orders, the keys, its 32-byte record (91 measured on an H100 at
# the render demo's 2.04 M pairs)
PAIR_BYTES = 96


class LightBatch(NamedTuple):
    """K directional lights framed in one pass (``frame_light_batch``).

    Its bounds are the bounding spheres of every kind: the spheres, then
    the cylinders, then the rings (``kinds``); each bound is projected and
    spanned on each light's grid."""

    L: torch.Tensor         # (K, 3) light directions
    e1: torch.Tensor        # (K, 3) lateral bases
    e2: torch.Tensor        # (K, 3)
    org: torch.Tensor       # (K, 2) lateral origins (umin, vmin)
    inv_cell: torch.Tensor  # (K,) cells per unit length
    u: torch.Tensor         # (K, B) the bounds' c.e1
    v: torch.Tensor         # (K, B) the bounds' c.e2
    ck: torch.Tensor        # (K, B) the bounds' c.L
    r: torch.Tensor         # (B,) the bounds' radii, <= 0 for a dead one
    x0: torch.Tensor        # (K, B) int64 first cell column of each bound
    y0: torch.Tensor        # (K, B) int64 first cell row
    span_w: torch.Tensor    # (K, B) int64 cells wide, 0 for a dead bound
    span_h: torch.Tensor    # (K, B) int64 cells high
    pairs: np.ndarray       # (K, 3) int64 each light's pairs of each kind
    frames: np.ndarray      # (K, 9) f32 each light's e1, e2, org, inv_cell
    grid: int
    kinds: tuple            # (0, N, N + Nc, B): where each kind's bounds start


class LightGroup(NamedTuple):
    """Lights ``lights`` of a LightBatch binned in one pass
    (``bin_light_group``), one kind of bound: their (cell, item) pairs by
    light, then cell, then descending far key, ties by item id."""

    lights: range
    kind: int             # 0 spheres, 1 cylinders, 2 rings
    item: torch.Tensor    # (M,) light within the group * the kind's count + id
    key: torch.Tensor     # (M,) far key c.L + r of each pair's bound
    first: torch.Tensor   # (len(lights) * ncells + 1,) int64 each cell's first pair, then M
    base: np.ndarray      # (len(lights) + 1,) each light's first pair, then M


def frame_light_batch(scene, light_dirs, grid: int = 32) -> LightBatch:
    """The lights' bases and grids, each grid framed over every kind's
    bounding spheres (cylinder midpoints with half-length + radius, rings
    with their outer radius; the JAX build's accel.py:533-539), the bounds'
    projections and cell spans, and each light's pair count of each kind.
    The frames and counts are read to the host in one copy, the light-grid
    build's only read from the device."""
    centers, radii = scene.sph_center, scene.sph_radius
    dtype, dev = centers.dtype, centers.device
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    L = torch.as_tensor(np.asarray(light_dirs, np_dtype).reshape(-1, 3))
    a = torch.zeros_like(L)
    along_x = L[:, 0].abs() < 0.9
    a[:, 0] = along_x.to(dtype)
    a[:, 1] = (~along_x).to(dtype)
    # pageable memory staged at once: the upload waits for no queued work
    L, a = torch.stack([L, a]).to(dev, non_blocking=True)
    e1 = torch.linalg.cross(L, a)
    e1 = e1 / torch.linalg.norm(e1, dim=-1, keepdim=True)
    e2 = torch.linalg.cross(L, e1)
    cmid = scene.cyl_base + 0.5 * scene.cyl_axis
    clen = torch.linalg.norm(scene.cyl_axis, dim=-1)
    cr = torch.where(scene.cyl_radius > 0, 0.5 * clen + scene.cyl_radius, -1.0)
    allc = torch.cat([centers, cmid, scene.ring_center])
    allr = torch.cat([radii, cr, scene.ring_rout])
    k, n, nc = L.shape[0], centers.shape[0], cmid.shape[0]
    u = torch.empty((k, allc.shape[0]), dtype=dtype, device=dev)
    v = torch.empty_like(u)
    ck = torch.empty_like(u)
    # one matrix-vector product a light and axis: a matrix product rounds
    # the three-term dot products otherwise, and a light's cells must not
    # depend on the lights built beside it
    for j in range(k):
        torch.mv(allc, e1[j], out=u[j])
        torch.mv(allc, e2[j], out=v[j])
        torch.mv(allc, L[j], out=ck[j])
    live = allr > 0
    big = torch.tensor(1e30, dtype=dtype, device=dev)
    umin = torch.where(live, u - allr, big).amin(1)
    vmin = torch.where(live, v - allr, big).amin(1)
    umax = torch.where(live, u + allr, -big).amax(1)
    vmax = torch.where(live, v + allr, -big).amax(1)
    extent = torch.clamp(torch.maximum(umax - umin, vmax - vmin), min=1e-6)
    inv_cell = grid / extent

    def cell_of(p):
        return torch.clamp(torch.floor(p * inv_cell[:, None]), 0,
                           grid - 1).to(torch.int64)

    x0 = cell_of(u - allr - umin[:, None])
    x1 = cell_of(u + allr - umin[:, None])
    y0 = cell_of(v - allr - vmin[:, None])
    y1 = cell_of(v + allr - vmin[:, None])
    span_w = torch.where(live, x1 - x0 + 1, 0)
    span_h = torch.where(live, y1 - y0 + 1, 0)
    org = torch.stack([umin, vmin], 1)
    kinds = (0, n, n + nc, allc.shape[0])
    sizes = span_w * span_h
    pairs = torch.stack([sizes[:, s:e].sum(1)
                         for s, e in zip(kinds, kinds[1:])], 1)
    f64 = torch.float64
    host = torch.cat([torch.cat([e1, e2, org, inv_cell[:, None]], 1).to(f64),
                      pairs.to(f64)], 1).cpu().numpy()
    return LightBatch(L, e1, e2, org, inv_cell, u, v, ck, allr, x0, y0,
                      span_w, span_h, host[:, 9:].astype(np.int64),
                      host[:, :9].astype(np.float32), grid, kinds)


def split_light_batch(pairs: np.ndarray, max_pairs: int) -> list:
    """Consecutive lights in groups (ranges) of at most ``max_pairs`` pairs
    each; a light with more takes a group alone."""
    groups, start, held = [], 0, 0
    for j, p in enumerate(int(p) for p in pairs):
        if j > start and held + p > max_pairs:
            groups.append(range(start, j))
            start, held = j, 0
        held += p
    groups.append(range(start, len(pairs)))
    return groups


def bin_light_group(batch: LightBatch, lights: range,
                    kind: int = 0) -> LightGroup:
    """The (cell, item) pairs of ``lights``' bounds of one kind, expanded
    and sorted in one pass: by light, then cell, then descending far key,
    ties by item id (``_csr_sort``'s order), with no read from the device."""
    ks = slice(lights.start, lights.stop)
    cols = slice(batch.kinds[kind], batch.kinds[kind + 1])
    ncells = batch.grid * batch.grid
    base = np.concatenate([[0], np.cumsum(batch.pairs[ks, kind])])
    cell, item = _expand_pairs(
        *(t[ks, cols].reshape(-1) for t in (batch.x0, batch.y0, batch.span_w,
                                            batch.span_h)),
        batch.grid, total=int(base[-1]))
    key = (batch.ck[ks, cols] + batch.r[cols]).reshape(-1)[item]
    bucket = item // max(cols.stop - cols.start, 1) * ncells + cell
    order = torch.argsort(-key, stable=True)
    bucket = bucket[order]
    by_cell = torch.argsort(bucket, stable=True)
    order = order[by_cell]
    first = torch.searchsorted(bucket[by_cell], torch.arange(
        len(lights) * ncells + 1, device=bucket.device))
    return LightGroup(lights, kind, item[order], key[order], first, base)


def _group_kind(batch: LightBatch, group: LightGroup, j: int) -> LightKind:
    """Light ``j``'s cells of ``group``'s kind, in views of its tensors."""
    i = j - group.lights.start
    ncells = batch.grid * batch.grid
    n = batch.kinds[group.kind + 1] - batch.kinds[group.kind]
    b0, b1 = int(group.base[i]), int(group.base[i + 1])
    start = group.first[i * ncells:(i + 1) * ncells]
    count = group.first[i * ncells + 1:(i + 1) * ncells + 1] - start
    return LightKind(group.item[b0:b1] - i * n, group.key[b0:b1], start - b0,
                     count)


def light_group_bins(batch: LightBatch, group: LightGroup, j: int) -> LightBins:
    """Light ``j`` of a group of spheres as LightBins (spheres only), with
    its host frame and the pass it came from."""
    sph = _group_kind(batch, group, j)
    return LightBins(sph.ids, sph.offs, sph.count, batch.L[j], batch.e1[j],
                     batch.e2[j], batch.org[j], batch.inv_cell[j], batch.grid,
                     sph.keys, frame=batch.frames[j], source=(batch, group, j))


def light_group_records(batch: LightBatch, group: LightGroup, scene) -> list:
    """Each light's ``build_light_records`` tuple (lrec, offs, count,
    lkmax), gathered for a whole group of spheres at once; each tuple holds
    views of the group's tensors, its offsets counted from its own first
    record."""
    ks = slice(group.lights.start, group.lights.stop)
    kg, ncells = len(group.lights), batch.grid * batch.grid
    item, n = group.item, batch.kinds[1]
    ids = item % max(n, 1)
    cu = (batch.u[ks, :n] - batch.org[ks, 0:1]).reshape(-1)[item]
    cv = (batch.v[ks, :n] - batch.org[ks, 1:2]).reshape(-1)[item]
    ck = batch.ck[ks, :n].reshape(-1)[item]
    zero = torch.zeros_like(cu)
    lrec = torch.stack(
        [cu, cv, ck, scene.sph_radius[ids], group.key,
         scene.sph_color[ids, 3], zero, zero], dim=1).to(torch.float32)
    start = group.first[:-1]
    count = group.first[1:] - start
    lkmax = torch.full((kg * ncells,), -BIG_DEPTH, dtype=torch.float32,
                       device=lrec.device)
    if lrec.shape[0]:
        lkmax = torch.where(count > 0,
                            lrec[torch.clamp(start, max=lrec.shape[0] - 1), 4],
                            lkmax)
    start = start.view(kg, ncells)
    offs = (start - start[:, :1]).to(torch.int32)
    count = count.view(kg, ncells).to(torch.int32)
    lkmax = lkmax.view(kg, ncells)
    b = [int(x) for x in group.base]
    return [(lrec[b[i]:b[i + 1]], offs[i], count[i], lkmax[i])
            for i in range(kg)]


def build_light_bins(scene, light_dir, grid: int = 32,
                     other_kinds: bool = False) -> LightBins:
    """Light-grid cells -> sphere ids sorted by descending far key c.L + r:
    one light through the batched pass.  With ``other_kinds`` the cylinders
    and rings are binned too, by their bounding spheres (accel.py:544-560)."""
    batch = frame_light_batch(scene, light_dir, grid)
    lb = light_group_bins(batch, bin_light_group(batch, range(1)), 0)
    if other_kinds:
        cyl, ring = (_group_kind(batch, bin_light_group(batch, range(1), k), 0)
                     for k in (1, 2))
        lb = lb._replace(cyl=cyl, ring=ring)
    return lb


def build_light_records(lb: LightBins, scene):
    """CSR shadow records for the kernel's sweep.

    Returns (lrec (M, 8) f32 rows [cu, cv, ck, r, key, alpha, 0, 0],
    offs (ncells,) i32, count (ncells,) i32, lkmax (ncells,) f32), where
    (cu, cv) are lateral light-space coordinates, ck = c.L and
    key = ck + r; rows run by descending key within each cell, and lkmax is
    each cell's largest key (-BIG_DEPTH for an empty cell)."""
    batch, group, j = lb.source
    return light_group_records(batch, group, scene)[j - group.lights.start]


def light_rows(dirs, frames, lightcol, rmax=0.0) -> np.ndarray:
    """(K, 16) f32 light rows [dir(3), e1(3), e2(3), org(2), inv_cell,
    lightcol, rmax, 0, 0] (a ``megakernel.LightStack`` row; its first 13
    slots are ``params[15:28]``) from K directions, their (K, 9) host frames
    [e1, e2, org, inv_cell] (``LightBatch.frames``), the lights' colour and
    the scene's max radius, as the JAX front end stores them."""
    dirs = np.asarray(dirs, np.float32).reshape(-1, 3)
    rows = np.zeros((dirs.shape[0], 16), np.float32)
    rows[:, 0:3] = dirs
    rows[:, 3:12] = frames
    rows[:, 12] = lightcol
    rows[:, 13] = rmax
    return rows


# ---------------------------------------------------------------------------
# cylinder and ring records
# ---------------------------------------------------------------------------


def other_table(scene) -> torch.Tensor:
    """(Nc + Nr, 16) f32 records of every cylinder, then every ring
    (accel.py:638-664): rows [p(3), rad, rgba(4), unit axis(3), typ, alen,
    0, 0, 0] — p the cylinder base or ring centre, the axis the cylinder
    direction or ring normal, typ 1 (cylinder) or 2 (ring), alen the
    cylinder length (0 for a ring); dead primitives carry radius -1."""
    cb, ca = scene.cyl_base, scene.cyl_axis
    alen = torch.linalg.norm(ca, dim=-1)
    ahat = ca / torch.clamp(alen, min=1e-30)[:, None]
    crad = torch.where(scene.cyl_radius > 0, scene.cyl_radius, -1.0)
    nc = cb.shape[0]
    crec = torch.cat([
        cb, crad[:, None], scene.cyl_color, ahat,
        torch.full((nc, 1), 1.0, dtype=cb.dtype, device=cb.device),
        alen[:, None], torch.zeros((nc, 3), dtype=cb.dtype, device=cb.device),
    ], dim=1)
    rc = scene.ring_center
    rrad = torch.where(scene.ring_rout > 0, scene.ring_rout, -1.0)
    nr = rc.shape[0]
    rrec = torch.cat([
        rc, rrad[:, None], scene.ring_color, scene.ring_normal,
        torch.full((nr, 1), 2.0, dtype=rc.dtype, device=rc.device),
        torch.zeros((nr, 4), dtype=rc.dtype, device=rc.device),
    ], dim=1)
    return torch.cat([crec, rrec]).to(torch.float32)


def gather_other_records(bins: ScreenBins, table: torch.Tensor):
    """The tiles' cylinder and ring candidates as (orec (M, 16) f32, ooffs
    (nb,) i32, ocnt (nb,) i32): tile t's records at rows ooffs[t] ..
    ooffs[t] + ocnt[t], cylinders by ascending id, then rings — the order of
    the JAX gather's stable compaction (accel.py:667-684), without its
    128-lane padding."""
    return (table[bins.oth_ids].contiguous(), bins.oth_offs.to(torch.int32),
            bins.oth_count.to(torch.int32))


def occluder_records(table: torch.Tensor, lb: LightBins) -> torch.Tensor:
    """One light's occluder table (accel.py:713-742): the live rows of
    ``table`` in order, with rows 4-7 and 13-14 given over to light-space
    cull data — 4, 5 the lateral (u, v) of p, 13, 14 of the far end (p +
    axis * alen; a ring's far end is p), 6 the lateral pad (the radius), 7
    the far key max(p.L, p1.L) + radius — and row 15 the alpha."""
    rec = table[table[:, 3] > 0].clone()
    rec[:, 15] = rec[:, 7]
    f32 = torch.float32
    e1, e2, L, org = (t.to(device=rec.device, dtype=f32)
                      for t in (lb.e1, lb.e2, lb.L, lb.org))
    p0 = rec[:, 0:3]
    p1 = p0 + torch.where(rec[:, 11:12] == 1.0, rec[:, 8:11] * rec[:, 12:13], 0.0)
    rec[:, 4] = p0 @ e1 - org[0]
    rec[:, 5] = p0 @ e2 - org[1]
    rec[:, 13] = p1 @ e1 - org[0]
    rec[:, 14] = p1 @ e2 - org[1]
    rec[:, 6] = rec[:, 3]
    rec[:, 7] = torch.maximum(p0 @ L, p1 @ L) + rec[:, 3]
    return rec
