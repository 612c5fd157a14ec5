"""Tile-binned tracer: the heavy-bond and sphere-less paths.

Port of ``mdapy_tpu/render/tracer_tiled.py``: ``render_image_pallas`` (:471)
and ``render_image_tiled`` (:331), with ``_ray_box_texit`` (:89), the
cylinder/ring merge (:564-621, :113-150) and the light-grid shadow pass
``_shadow_filter_lb`` (:195).  The front end takes these paths for a scene
whose cylinders and rings pass the megakernel's limits, or that has no live
sphere (``render.py``).

``render_image_pallas`` keeps the JAX function's name so a reader finds it;
the name is historical, nothing here is Pallas.  Per band of tiles it

  * draws the AA jitter with JAX's threefry generator (``rng.py``), one
    ``uniform`` over the band's ``(nb, S, P, 2)``, sample 0 unjittered;
  * generates every ray of the band and caps it at the scene AABB's exit;
  * finds each ray's nearest sphere with the chunked closest hit
    (``tile_kernels.closest_hit_spheres_tiles``: the hand kernel on the
    card);
  * tests each tile's cylinders and rings densely
    (``megakernel._closest_hit_other``); one replaces the sphere hit only at
    a strictly smaller t;
  * shades: normal by kind, facing flip, Lambert n.L, and for a lit point
    the shadow filter — for a sphere-only scene given its light records the
    light-grid kernel (``tile_kernels.shadow_filter_tiles``), else
    ``_shadow_filter_lb`` over the light cells of all three kinds;
  * takes the AA mean and assembles the band's image.

``render_image_tiled`` differs in what shows in the image: the jitter is
drawn per tile from ``fold_in(key, tile)`` over ``(S, P, 2)``, and the order
is cylinders, rings, then spheres, each replacing only at a strictly smaller
t, so a cylinder keeps a tie.

Where the JAX code maps over tiles with ``lax.map``, these passes are torch
ops batched over tiles under the megakernel's element budget
(``megakernel._PLAIN_ELEMS``), ragged lists going through CSR offsets: the
cylinder/ring pass takes tiles of like candidate count together, and the
shadow pass walks each lit ray's cell lists in steps.  The JAX shadow pass's
windows of 32 and its ``start = #keys <= tau`` suffix are a traversal order,
not a result: a lit point is blocked when, in its light cell, a candidate of
any kind with key > tau is hit by the exact ray test.

``render_image_tiled`` also peels translucent scenes (``cfg.transparency``,
``tracer_tiled.py:433-448``): ``max_trans`` peels per ray, each from the
last hit plus eps along the ray, composited with weight W (a miss is the
background at alpha 1), and the residual W sees the background.  Its shadow
rays are then transmissions (``_shadow_filter_lb``'s ``with_trans``,
:216-247): every candidate with key > tau that the ray hits multiplies by
1 - alpha, one at alpha >= 0.99999 blocks, and the walk runs to the end of
the cell's suffix.  ``render_image_pallas`` refuses transparency, as the
JAX function asserts (:494).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import megakernel as _mk
from . import ieee, rng, tile_kernels
from .accel import (LightBins, ScreenBins, build_light_bins, build_screen_bins,
                    gather_other_records, other_table)
from .gather import gather_chunk_data
from .megakernel import BIG, BIG_DEPTH, MINCONTRIB, OtherRecords

__all__ = ["render_image_pallas", "render_image_pallas_banded",
           "render_image_tiled", "band_bins", "band_other",
           "build_screen_bins", "build_light_bins"]

_SHADOW_WINDOW = 32      # candidates a lit ray tests per step of its walk
AMBIENT, DIFFUSE_K = 0.3, 0.8


def band_bins(bins: ScreenBins, ty0: int, ty1: int) -> ScreenBins:
    """The screen bins of tile rows [ty0, ty1): the rows' sphere chunks and
    CSR starts; ``oth_ids`` stays whole, the starts point into it."""
    b0, b1 = ty0 * bins.tiles_x, ty1 * bins.tiles_x
    cut = (lambda t: None if t is None else t[b0:b1])
    return bins._replace(
        sph_chunks=bins.sph_chunks[b0:b1], sph_zmin=bins.sph_zmin[b0:b1],
        tiles_y=ty1 - ty0, oth_offs=cut(bins.oth_offs),
        oth_count=cut(bins.oth_count))


def band_other(other, b0: int, b1: int):
    """The cyl/ring records of tiles [b0, b1) (the records stay whole)."""
    if other is None:
        return None
    return OtherRecords(other.orec, other.ooffs[b0:b1], other.ocnt[b0:b1])


def _ray_box_texit(o, d, lo, hi):
    """Ray-AABB exit parameter; -BIG where the ray misses the box entirely."""
    inv = 1.0 / torch.where(d.abs() > 1e-30, d, 1e-30)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tnear = torch.minimum(t0, t1).amax(dim=-1)
    tfar = torch.maximum(t0, t1).amin(dim=-1)
    return torch.where(tfar >= tnear.clamp(min=0.0), tfar, -BIG)


def _scene_aabb(scene):
    """Conservative AABB over the live primitives of every kind."""
    def minmax(centers, extent, live):
        lo = torch.where(live[:, None], centers - extent[:, None], 1e30).amin(0)
        hi = torch.where(live[:, None], centers + extent[:, None], -1e30).amax(0)
        return lo, hi

    lo1, hi1 = minmax(scene.sph_center, scene.sph_radius, scene.sph_radius > 0)
    cmid = scene.cyl_base + 0.5 * scene.cyl_axis
    cext = (0.5 * torch.linalg.norm(scene.cyl_axis, dim=-1)
            + scene.cyl_radius.clamp(min=0.0))
    lo2, hi2 = minmax(cmid, cext, scene.cyl_radius > 0)
    lo3, hi3 = minmax(scene.ring_center, scene.ring_rout, scene.ring_rout > 0)
    return (torch.minimum(lo1, torch.minimum(lo2, lo3)),
            torch.maximum(hi1, torch.maximum(hi2, hi3)))


@functools.lru_cache(maxsize=8)
def _jitter(seed: int, nb: int, S: int, P: int, per_tile: bool, device: str):
    """The AA jitter (nb, S, P, 2) in [-0.5, 0.5), sample 0 zeroed: one draw
    over the whole shape, or per tile from ``fold_in(key, tile)``.  It
    depends on nothing but these arguments, so repeated frames (and the equal
    bands of one frame) share it."""
    key = rng.prng_key(seed, device)
    if per_tile:
        keys = rng.fold_in(key, torch.arange(nb, device=device))
        jit2 = rng.uniform(keys, (S, P, 2), -0.5, 0.5)
    else:
        jit2 = rng.uniform(key, (nb, S, P, 2), -0.5, 0.5)
    jit2[:, 0] = 0.0
    return jit2


@functools.lru_cache(maxsize=16)
def _tile_batches(ocnt, b0: int, b1: int, R: int) -> tuple:
    """The batches of the dense cyl/ring pass over tiles [b0, b1) of a frame
    with per-tile candidate counts ``ocnt``, R rays a tile: index tensors
    (relative to b0) of tiles of like count, each batch's (tiles, rays,
    slots) block within the element budget; empty tiles are left out.
    Reading the counts waits for the device, and the batches depend on
    nothing but these arguments, so they are kept by the identity of
    ``ocnt``: the frames of one view share them."""
    cnt = ocnt[b0:b1].cpu().numpy().astype(np.int64)
    order = np.argsort(cnt, kind="stable")
    order = order[cnt[order] > 0]
    batches = []
    i = 0
    while i < len(order):
        j = i + 1
        while j < len(order) and (j + 1 - i) * R * cnt[order[j]] <= _mk._PLAIN_ELEMS:
            j += 1
        batches.append(torch.as_tensor(order[i:j], device=ocnt.device))
        i = j
    return tuple(batches)


def _other_hit(other, o, d, eps: float, batches=None):
    """Nearest cylinder or ring per ray: t (nb, R) (BIG on a miss) and the
    winner's row of ``other.orec`` (-1 on a miss); among equal t the lowest
    slot wins (cylinders come before rings).  Tiles of like candidate count
    go through ``megakernel._closest_hit_other`` together (``batches``, from
    ``_tile_batches``), so that a batch's dense (tiles, rays, slots) block
    wastes little on padding."""
    nb, R = o.shape[:2]
    dev = o.device
    bt = torch.full((nb, R), BIG, dtype=torch.float32, device=dev)
    widx = torch.full((nb, R), -1, dtype=torch.int64, device=dev)
    if batches is None:
        batches = _tile_batches(other.ocnt, 0, nb, R)
    for tiles in batches:
        ob, db = o[tiles], d[tiles]
        bt[tiles], widx[tiles] = _mk._closest_hit_other(
            other, tiles, ob.unbind(-1), db.unbind(-1), bt[tiles], eps, False)
    return bt, widx


def _walk_cells(kind, cell, tau, blocked, test, alpha=None,
                filt=None) -> None:
    """Walk each ray's light cell of ``kind``: the candidates whose key
    exceeds the ray's ``tau`` and which ``test(rays, ids)`` (index tensors
    (A, 1) and (A, W) -> bool (A, W)) finds hit.  A cell's candidates run
    by descending key, so a walk ends at the first key <= tau.

    Without ``alpha`` a hit marks the ray in ``blocked`` (N,) and ends its
    walk.  With ``alpha`` (``alpha(ids)``, the transmissions of
    ``tracer_tiled.py:216-247``) a hit at alpha >= 0.99999 does that, and
    every other hit multiplies the ray's ``filt`` (N,) by 1 - its alpha,
    window by window to the end of the suffix.  Rays already blocked are
    not walked: their filter no longer counts."""
    cnt = kind.count[cell]
    off = kind.offs[cell]
    step = torch.arange(_SHADOW_WINDOW, device=tau.device)
    batch = max(1, _mk._PLAIN_ELEMS // (4 * _SHADOW_WINDOW))
    todo = torch.nonzero(~blocked & (cnt > 0)).flatten()
    for s0 in range(0, todo.shape[0], batch):
        active = todo[s0:s0 + batch]
        k0 = 0
        while active.numel():
            kk = k0 + step[None, :]
            n = cnt[active, None]
            idx = off[active, None] + torch.minimum(kk, n - 1)
            stop = (kk >= n) | (kind.keys[idx] <= tau[active, None])
            stop = torch.cumsum(stop.to(torch.int32), dim=1) > 0
            ids = kind.ids[idx]
            hit = test(active[:, None], ids) & ~stop
            if alpha is None:
                done = hit.any(dim=1)
            else:
                a = alpha(ids)
                opaque = a >= 0.99999
                done = (hit & opaque).any(dim=1)
                filt[active] *= torch.where(hit & ~opaque, 1.0 - a,
                                            1.0).prod(dim=1)
            blocked[active[done]] = True
            active = active[~done & ~stop[:, -1]]
            k0 += _SHADOW_WINDOW


def _shadow_filter_lb(hit, scene, lb: LightBins, light, eps: float,
                      with_trans: bool = False):
    """True where the point ``hit`` (N, 3) is shadowed: in its light-grid
    cell, a sphere, cylinder or ring whose far key exceeds the point's depth
    along the light is hit by the ray from the point toward the light.
    ``with_trans``: the transmission in [0, 1] instead (N,) f32."""
    hx, hy, hz = hit.unbind(-1)
    lx, ly, lz = light.unbind(0)
    u = hx * lb.e1[0] + hy * lb.e1[1] + hz * lb.e1[2] - lb.org[0]
    v = hx * lb.e2[0] + hy * lb.e2[1] + hz * lb.e2[2] - lb.org[1]
    tau = hx * lb.L[0] + hy * lb.L[1] + hz * lb.L[2]
    gx = torch.clamp(torch.floor(u * lb.inv_cell), 0, lb.grid - 1).to(torch.int64)
    gy = torch.clamp(torch.floor(v * lb.inv_cell), 0, lb.grid - 1).to(torch.int64)
    cell = gy * lb.grid + gx
    blocked = torch.zeros(hit.shape[0], dtype=torch.bool, device=hit.device)
    filt = torch.ones(hit.shape[0], dtype=torch.float32, device=hit.device)

    def walk(kind, test, alpha):
        _walk_cells(kind, cell, tau, blocked, test,
                    alpha if with_trans else None, filt)

    if lb.ids.shape[0]:
        cx, cy, cz = scene.sph_center.unbind(-1)
        rad = scene.sph_radius

        def t_sph(rays, ids):
            ocx, ocy, ocz = hx[rays] - cx[ids], hy[rays] - cy[ids], hz[rays] - cz[ids]
            r = rad[ids]
            b = ocx * lx + ocy * ly + ocz * lz
            cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
            disc = b * b - cc
            ok = (disc >= 0.0) & (r > 0.0)
            sq = ieee.sqrt(torch.where(ok, disc, 0.0))
            return ok & ((-b - sq > eps) | (sq - b > eps))

        walk(lb.sph, t_sph, lambda ids: scene.sph_color[ids, 3])

    if lb.cyl is not None and (lb.cyl.ids.shape[0] or lb.ring.ids.shape[0]):
        # rows of the cyl/ring table (cylinders, then rings) and their
        # ray-independent terms toward this light
        table = other_table(scene)
        px, py, pz, rr = table[:, :4].unbind(1)
        axx, axy, axz, typ, alen = table[:, 8:13].unbind(1)
        dda = axx * lx + axy * ly + axz * lz
        dpx, dpy, dpz = lx - dda * axx, ly - dda * axy, lz - dda * axz
        a2 = dpx * dpx + dpy * dpy + dpz * dpz
        inv_a2 = 1.0 / torch.where(a2 > 1e-12, a2, 1.0)
        ncyl = scene.cyl_base.shape[0]

        def t_other(base):
            def test(rays, ids):
                i = ids + base
                return _mk._cylring_occludes(
                    (hx[rays] - px[i], hy[rays] - py[i], hz[rays] - pz[i]),
                    (axx[i], axy[i], axz[i]), rr[i], typ[i], alen[i], dda[i],
                    (dpx[i], dpy[i], dpz[i]), a2[i], inv_a2[i], (lx, ly, lz),
                    eps) & (rr[i] > 0.0)
            return test

        walk(lb.cyl, t_other(0), lambda ids: table[ids, 7])
        walk(lb.ring, t_other(ncyl), lambda ids: table[ids + ncyl, 7])
    if with_trans:
        return torch.where(blocked, 0.0, filt)
    return blocked


def _raygen(origin, lowleft, ipr, ipu, view, cfg, perspective: bool, seed,
            tile_px: int, tiles_x: int, tiles_y: int, ty_offset,
            per_tile_jitter: bool):
    """The rays of every tile, (nb, R, 3) origins and unit directions in the
    lane order sample * P + pixel (tracer_tiled.py:513-540)."""
    dev, f32 = origin.device, torch.float32
    P = tile_px * tile_px
    nb = tiles_x * tiles_y
    S = (cfg.aa_samples if cfg.aa_enabled else 0) + 1
    R = P * S
    dynamic_sched = cfg.ao_enabled or (cfg.aa_enabled and cfg.aa_samples > 4)
    off = 0.0 if dynamic_sched else 1.0
    ix = torch.arange(tile_px, dtype=f32, device=dev)
    sub_x = ix.repeat(tile_px)
    sub_y = ix.repeat_interleave(tile_px)
    tid = torch.arange(nb, device=dev)
    tx = (tid % tiles_x).to(f32)
    ty = (tid // tiles_x).to(f32) + float(ty_offset)
    px0 = tx[:, None] * tile_px + sub_x[None, :] + off          # (nb, P)
    py0 = ty[:, None] * tile_px + sub_y[None, :] + off
    jit2 = _jitter(int(seed), nb, S, P, per_tile_jitter, str(dev))
    x = (px0[:, None, :] + jit2[..., 0]).reshape(nb, R)
    y = (py0[:, None, :] + jit2[..., 1]).reshape(nb, R)
    rays = lowleft + x[..., None] * ipr + y[..., None] * ipu
    if perspective:
        d = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
        return origin.expand(nb, R, 3).contiguous(), d
    return rays, view.expand(nb, R, 3).contiguous()


def _closest(scene, bins, chunk_data, other, o, d, eps: float,
             spheres_first: bool, other_batches=None):
    """Nearest primitive per ray: t (nb, R) (BIG on a miss), the unflipped
    normal (nb, R, 3) and the colour with its alpha (nb, R, 4).  Spheres go through the chunked
    closest hit, cylinders and rings through the dense pass; whichever kind
    comes second replaces the first only at a strictly smaller t."""
    nb, R = o.shape[:2]
    dev, f32 = o.device, torch.float32
    if chunk_data is not None:
        lo, hi = _scene_aabb(scene)
        tcap = _ray_box_texit(o, d, lo, hi)
        best_t, rec = tile_kernels.closest_hit_spheres_tiles(
            o, d, tcap, bins.sph_zmin, chunk_data, eps=eps)
        have = rec[..., 3] > 0
        hit0 = o + torch.where(have, best_t, 0.0)[..., None] * d
        n0 = hit0 - rec[..., 0:3]
        n0 = n0 / torch.linalg.norm(n0, dim=-1, keepdim=True).clamp(min=1e-30)
        N = torch.where(have[..., None], n0, 0.0)
        col = torch.where(have[..., None], rec[..., 4:8], 0.0)
    else:
        best_t = torch.full((nb, R), BIG, dtype=f32, device=dev)
        N = torch.zeros((nb, R, 3), dtype=f32, device=dev)
        col = torch.zeros((nb, R, 4), dtype=f32, device=dev)
    if other is not None and other.orec.shape[0]:
        t_o, widx = _other_hit(other, o, d, eps, other_batches)
        # spheres first: a cylinder or ring wins at a strictly smaller t;
        # cylinders and rings first: a sphere does
        won = ((t_o < best_t) if spheres_first
               else ((t_o < BIG_DEPTH) & ~(best_t < t_o)))
        sel = torch.nonzero(won.reshape(-1)).flatten()
        row = other.orec[widx.reshape(-1)[sel]]                   # (n, 16)
        t_w = t_o.reshape(-1)[sel]
        rel = (o.reshape(-1, 3)[sel] + t_w[:, None] * d.reshape(-1, 3)[sel]
               - row[:, 0:3])
        ahat = row[:, 8:11]
        # cylinder: radial minus the axis part; ring: the plane normal
        n_c = rel - (rel * ahat).sum(-1, keepdim=True) * ahat
        n_c = n_c / torch.linalg.norm(n_c, dim=-1, keepdim=True).clamp(min=1e-30)
        N.reshape(-1, 3)[sel] = torch.where(row[:, 11:12] == 2.0, ahat, n_c)
        col.reshape(-1, 4)[sel] = row[:, 4:8]
        best_t.reshape(-1)[sel] = t_w
    return best_t, N, col


def _shade(scene, lb, o, d, best_t, N, col, light, bg, cfg, shadows: bool,
           light_records):
    """Facing flip, Lambert term, shadow filter -> (nb, R, 3) RGB and the
    miss mask (nb, R)."""
    nb, R = best_t.shape
    dev, f32 = o.device, torch.float32
    missed = best_t >= BIG_DEPTH      # a miss holds BIG; no hit lies this far
    facing = (N * d).sum(-1, keepdim=True)
    N = torch.where(facing > 0, -N, N)
    tsafe = torch.where(missed, 0.0, best_t)
    hit = o + tsafe[..., None] * d
    inten = N[..., 0] * light[0] + N[..., 1] * light[1] + N[..., 2] * light[2]
    lit = (inten > MINCONTRIB) & ~missed
    filt = torch.ones((nb, R), dtype=f32, device=dev)
    if shadows and light_records is not None:
        lrec, loffs, lcnt = light_records[:3]
        hx, hy, hz = hit.unbind(-1)
        u = hx * lb.e1[0] + hy * lb.e1[1] + hz * lb.e1[2] - lb.org[0]
        v = hx * lb.e2[0] + hy * lb.e2[1] + hz * lb.e2[2] - lb.org[1]
        tau = hx * lb.L[0] + hy * lb.L[1] + hz * lb.L[2]
        gx = torch.clamp(torch.floor(u * lb.inv_cell), 0, lb.grid - 1)
        gy = torch.clamp(torch.floor(v * lb.inv_cell), 0, lb.grid - 1)
        filt = tile_kernels.shadow_filter_tiles(
            torch.stack([u, v, tau], dim=-1),
            torch.stack([gx, gy], dim=-1).to(torch.int32),
            lit.to(torch.int32), lrec, loffs, lcnt,
            grid_n=lb.grid, eps=cfg.eps)
    elif shadows and cfg.transparency:
        sel = torch.nonzero(lit.reshape(-1)).flatten()
        filt.reshape(-1)[sel] = _shadow_filter_lb(
            hit.reshape(-1, 3)[sel], scene, lb, light, cfg.eps, True)
    elif shadows:
        sel = torch.nonzero(lit.reshape(-1)).flatten()
        blocked = _shadow_filter_lb(hit.reshape(-1, 3)[sel], scene, lb, light,
                                    cfg.eps)
        filt.reshape(-1)[sel[blocked]] = 0.0
    if cfg.direct_light_enabled:
        diffuse = torch.where(lit, inten * cfg.direct_light_intensity * filt, 0.0)
    else:
        diffuse = torch.zeros((nb, R), dtype=f32, device=dev)
    shade = DIFFUSE_K * diffuse + AMBIENT
    return torch.where(missed[..., None], bg, col * shade[..., None]), missed


def _render(scene, bins, chunk_data, lb, origin, lowleft, iplaneright,
            iplaneup, view, light_dir, cfg, width: int, height: int,
            perspective: bool, seed, tile_px: int, tiles_x: int, tiles_y: int,
            *, ty_offset, do_flip: bool, light_records, other,
            per_tile_jitter: bool, spheres_first: bool, other_batches=None):
    if cfg.ao_enabled:
        raise ValueError("the tiled tracer does no ambient occlusion")
    shadows = cfg.shadows_enabled and cfg.direct_light_enabled
    if (shadows and light_records is None and other is not None
            and other.orec.shape[0] and lb.cyl is None):
        raise ValueError("the light bins lack the cylinder and ring cells "
                         "(build_light_bins(..., other_kinds=True))")
    dev = scene.sph_center.device

    def vec(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    origin, lowleft, ipr, ipu, view, light, bg = (vec(a) for a in (
        origin, lowleft, iplaneright, iplaneup, view, light_dir,
        cfg.background))
    S = (cfg.aa_samples if cfg.aa_enabled else 0) + 1
    o, d = _raygen(origin, lowleft, ipr, ipu, view, cfg, perspective, seed,
                   tile_px, tiles_x, tiles_y, ty_offset, per_tile_jitter)
    if not cfg.transparency:
        best_t, N, col = _closest(scene, bins, chunk_data, other, o, d,
                                  cfg.eps, spheres_first, other_batches)
        rgb, _ = _shade(scene, lb, o, d, best_t, N, col[..., :3], light, bg,
                        cfg, shadows, light_records)
    else:
        # peels along the ray (tracer_tiled.py:433-448)
        o_cur = o
        weight = torch.ones(o.shape[:2], dtype=torch.float32, device=dev)
        acc = torch.zeros_like(o)
        for _ in range(cfg.max_trans):
            best_t, N, col = _closest(scene, bins, chunk_data, other, o_cur,
                                      d, cfg.eps, spheres_first, other_batches)
            srgb, missed = _shade(scene, lb, o_cur, d, best_t, N, col[..., :3],
                                  light, bg, cfg, shadows, light_records)
            a = torch.where(missed, 1.0, col[..., 3])
            acc = acc + (weight * a)[..., None] * srgb
            weight = weight * (1.0 - a)
            tsafe = torch.where(missed, 0.0, best_t)
            o_cur = o_cur + (tsafe + cfg.eps)[..., None] * d
        rgb = acc + weight[..., None] * bg
    out = rgb.reshape(rgb.shape[0], S, -1, 3).mean(dim=1)
    img = out.reshape(tiles_y, tiles_x, tile_px, tile_px, 3)
    img = img.permute(0, 2, 1, 3, 4).reshape(tiles_y * tile_px,
                                             tiles_x * tile_px, 3)
    img = img[:height, :width]
    return torch.flip(img, dims=[0]) if do_flip else img


def _other_of(scene, bins, other):
    if other is not None or bins.oth_ids is None or not bins.oth_ids.shape[0]:
        return other
    return OtherRecords(*gather_other_records(bins, other_table(scene)))


def render_image_pallas(scene, bins: ScreenBins, chunk_data, lb: LightBins,
                        origin, lowleft, iplaneright, iplaneup, view,
                        light_dir, cfg, width: int, height: int,
                        perspective: bool, seed, tile_px: int, tiles_x: int,
                        tiles_y: int, ty_offset=0, do_flip: bool = True,
                        light_records=None, other=None,
                        other_batches=None) -> torch.Tensor:
    """Opaque-scene renderer: chunked sphere closest hit + global shading ->
    (height, width, 3) f32 RGB.

    ``bins`` and ``chunk_data`` (``gather_chunk_data``) cover the
    ``tiles_x * tiles_y`` tiles drawn; the front end calls this per band of
    tile rows (``band_bins``; ``ty_offset`` shifts the pixel rows and
    ``do_flip=False`` leaves the vertical flip to the assembly).
    ``light_records`` = (lrec, offs, cnt[, lkmax]) from
    ``accel.build_light_records`` sends the shadow test to the light-grid
    kernel, which knows spheres only: pass it for a sphere-only scene (the
    grid is ``lb``'s; the JAX function's ``light_grid_n`` is not needed).
    Without it ``lb`` must carry the cells of every kind
    (``build_light_bins(..., other_kinds=True)``).  ``other`` may pass the
    tiles' cyl/ring records (``OtherRecords``, ``band_other``) when the
    caller keeps them; else they are gathered from ``bins``;
    ``other_batches`` their ``_tile_batches``.  Opaque scenes only: a
    ``cfg.transparency`` raises, as the JAX function asserts."""
    if cfg.transparency:
        raise ValueError("render_image_pallas renders opaque scenes; "
                         "render_image_tiled peels translucent ones")
    return _render(
        scene, bins, chunk_data, lb, origin, lowleft, iplaneright, iplaneup,
        view, light_dir, cfg, width, height, perspective, seed, tile_px,
        tiles_x, tiles_y, ty_offset=ty_offset, do_flip=do_flip,
        light_records=light_records, other=_other_of(scene, bins, other),
        per_tile_jitter=False, spheres_first=True, other_batches=other_batches)


BAND_TILES = 2048   # tiles per band of the JAX front end (render.py:713)


def render_image_pallas_banded(scene, bins: ScreenBins, chunk_data,
                               lb: LightBins, frame: dict, cfg, width: int,
                               height: int, seed, light_records=None,
                               other=None) -> torch.Tensor:
    """A whole frame through ``render_image_pallas`` in bands of
    ``max(1, BAND_TILES // tiles_x)`` tile rows, joined, cropped and flipped
    -> (height, width, 3) f32, exactly as the JAX front end bands it
    (render.py:712-742): every band draws its jitter from the same key over
    its own tiles, so the banding is part of the picture.  ``frame`` is the
    ``camera_frame`` dict; ``bins``, ``chunk_data`` and ``other`` cover the
    whole frame, and a ``chunk_data`` of None gathers each band's records
    in turn."""
    cam = tuple(frame[k] for k in ("origin", "lowleft", "iplaneright",
                                   "iplaneup", "view", "light_dir"))
    other = _other_of(scene, bins, other)
    band_rows = max(1, BAND_TILES // bins.tiles_x)
    S = (cfg.aa_samples if cfg.aa_enabled else 0) + 1
    R = S * bins.tile_px * bins.tile_px
    bands = []
    for ty0 in range(0, bins.tiles_y, band_rows):
        ty1 = min(bins.tiles_y, ty0 + band_rows)
        b0, b1 = ty0 * bins.tiles_x, ty1 * bins.tiles_x
        sub = band_bins(bins, ty0, ty1)
        cd = (chunk_data[b0:b1] if chunk_data is not None else
              gather_chunk_data(sub.sph_chunks, scene.sph_center,
                                scene.sph_radius, scene.sph_color))
        bands.append(render_image_pallas(
            scene, sub, cd, lb, *cam,
            cfg, width, (ty1 - ty0) * bins.tile_px, bool(frame["perspective"]),
            seed, bins.tile_px, bins.tiles_x, ty1 - ty0, ty_offset=ty0,
            do_flip=False, light_records=light_records,
            other=band_other(other, b0, b1),
            other_batches=(None if other is None
                           else _tile_batches(other.ocnt, b0, b1, R))))
    return torch.flip(torch.cat(bands, dim=0)[:height], dims=[0])


def render_image_tiled(scene, bins: ScreenBins, lb: LightBins, origin,
                       lowleft, iplaneright, iplaneup, view, light_dir, cfg,
                       width: int, height: int, perspective: bool, seed,
                       tile_px: int, tiles_x: int, tiles_y: int,
                       chunk_data=None, other=None) -> torch.Tensor:
    """Render (height, width, 3) f32 RGB via the screen bins, in the order
    cylinders, rings, spheres, opaque or translucent; the path of a scene
    without a live sphere.

    ``lb`` carries the light cells of every kind.  ``chunk_data`` and
    ``other`` may pass the sphere and cyl/ring records when the caller keeps
    them; else the spheres' are gathered when the scene has a live sphere,
    and the cylinders' and rings' from ``bins``."""
    if chunk_data is None and bool((scene.sph_radius > 0).any()):
        chunk_data = gather_chunk_data(bins.sph_chunks, scene.sph_center,
                                       scene.sph_radius, scene.sph_color)
    return _render(
        scene, bins, chunk_data, lb, origin, lowleft, iplaneright, iplaneup,
        view, light_dir, cfg, width, height, perspective, seed, tile_px,
        tiles_x, tiles_y, ty_offset=0, do_flip=True, light_records=None,
        other=_other_of(scene, bins, other), per_tile_jitter=True,
        spheres_first=False)
