"""The fused render pass: raygen, closest hit, shading, shadows, AA mean.

Port of ``mdapy_tpu/render/megakernel.py`` — ``build_mega_params`` (:81),
``_hash_jitter`` (:110), the Pallas kernel ``_mega_kernel`` (:156), its host
wrapper ``render_image_mega`` (:1852) and its banded form
``render_image_mega_banded`` (:2085) —
for spheres, bond and box-edge cylinders and their ring caps, lit by the
primary directional light and, with ambient occlusion, by the AO sky lights
that share its traversal, opaque or translucent (ROADMAP B1a-B1e).

Per 16x16 screen tile and per AA sample the pass:
  * generates the ray (perspective or orthographic), jittered by a 32-bit
    integer hash for samples s > 0, and clips it to the scene AABB (tcap);
  * walks the tile's depth-sorted 128-wide candidate chunks front to back
    and stops at the first chunk whose ``zmin`` is not below the tile's
    max over rays of min(best_t, tcap); a sphere is hit where the stable
    discriminant r^2 - |w|^2 (w = oc - b d, b = oc.d) is >= 0, behind a
    gate for camera rays (``_closest_hit``), and its hit point is put back
    on its surface along the normal;
  * tests the tile's cylinder and ring records (``OtherRecords``) densely;
    one replaces the best hit only when its t is strictly smaller, so a
    sphere keeps a tie and the lowest slot wins among them;
  * shades the winner: normal by type (radial, radial minus the axis part,
    ring axis), facing flip, miss, Lambert n.L;
  * for a lit point, walks its light-grid cell's records in descending
    far-key order and stops at the first occluder, or once key <= tau + eps
    (no later record can occlude); a point the walk leaves clear is tested
    against the light's occluder table (every live cylinder and ring), of
    which only the entries that pass a conservative light-space cull
    against the lit points of its tile (per group of SG samples) are tried;
  * adds each light's n.L term in light order; the primary light (light 0)
    is shadowed per sample, an AO sky light (l > 0) only on sample 0's hit
    point, whose visibility every sample then shares (the JAX package's
    ``ao_shared`` mode, its default);
  * writes the AA mean as (tiles, 3*256) rows [R | G | B].

Transparency peeling (``n_peel`` > 1, or ``peel1``; ``megakernel.py:
205-216, 328-406, 1338-1396``): a ray starts with weight W = 1 and colour
0; each peel traces it, shades the hit with colour c and alpha a (a miss is
the background at a = 1), adds W a c and multiplies W by 1 - a.  Peel p > 0
starts from the previous peel's hit point plus eps along the ray (a miss's
"hit" is its own origin) and runs for a tile only while the largest W over
all its rays and samples exceeds ``PEEL_SKIP``; with ``n_peel`` > 1 the
zmin exit adds each ray's camera depth so far (CUMT, the sum of tsafe + eps
over its peels).  Shadows become transmissions: each occluder multiplies by
1 - alpha, one at alpha >= ``OPAQUE_ALPHA`` by 0; a cell walk also ends
once the transmission is at or below ``TRANS_FLOOR`` (where the JAX
kernel's window sweep goes on multiplying a ray while others of its cell
still need the window: ROADMAP C7), and the occluder table multiplies every
lit ray whose transmission is > 0.  The frame is the sum over peels plus
the residual W times the background, averaged over the samples.  ``peel1``
is one such peel.

The lights reach the pass as one ``LightStack`` (``stack_lights``): the
primary light's row comes from ``params``, the sky lights' rows and CSR
records from ``extra_lights`` entries, with the JAX wrapper's meaning.

``mega_render`` dispatches on the tensors' device: CUDA tensors go to the
hand kernel (``csrc/mega_render.cu``), CPU tensors to ``mega_render_plain``,
the plain torch version of the same computation.  The banded form
(B1f) launches the same pass once per band of tile rows, for a frame whose
candidate records pass the memory budget.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import ieee
from .accel import light_rows

__all__ = [
    "LightStack", "OtherRecords", "build_mega_params", "hash_jitter",
    "mega_render", "mega_render_plain", "mega_render_cuda",
    "plain_work", "count_work", "render_image_mega",
    "render_image_mega_banded", "render_mega_band", "stack_lights",
    "kernel_attrs", "launches", "reset_launches",
]

BIG = 1e18
BIG_DEPTH = 1e17
MINCONTRIB = 1.0 / 512.0
TILE_PX = 16
BAND_SEED_STRIDE = 9973    # a band's AA seed is seed + 9973 * band
P = TILE_PX * TILE_PX      # pixels per tile = threads per kernel block
CH = 128                   # candidates per chunk
SG = 8                     # AA samples per kernel sample group
# element budget of one (tiles, rays, CH) temporary in the plain version
_PLAIN_ELEMS = 1 << 26
_SHADOW_STEP = 64          # records per step of the plain shadow walk
MAX_LIGHTS = 64            # lights one launch takes (the kernel's 64-bit mask)
PEEL_SKIP = 1e-4           # a peel p > 0 runs while a tile's largest W exceeds it
OPAQUE_ALPHA = 0.99999     # an occluder at or above this alpha blocks fully
TRANS_FLOOR = 1e-3         # a cell walk ends once the transmission is <= this
GATE = 1.0 - 2.0 ** -18    # a camera ray tests a sphere's stable form where
                           # b^2 >= GATE |oc|^2 - r^2 (_closest_hit)
# per-block shared memory the kernel's peel state may take; past it the
# state goes to a device buffer (mega_render_cuda)
PEEL_SMEM_BYTES = 160 << 10

# hand-kernel launches since the last reset_launches()
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


# tests done by the plain version, by kind, while plain_work() runs
_work = None


def _count(kind: str, n) -> None:
    if _work is not None:
        _work[kind] = _work.get(kind, 0) + int(n)


def build_mega_params(frame, lb, aabb_lo, aabb_hi, cfg) -> np.ndarray:
    """Pack the per-frame scalars into one (64,) f32 vector (same slots as
    the JAX package's); slots 15-27 are the primary light's row
    (``accel.light_rows``), its frame the one ``lb`` carries (the JAX
    package's bins: read from its arrays)."""
    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.asarray(a, np.float32)

    lframe = np.zeros(9, np.float32)
    if lb is not None:
        lframe = getattr(lb, "frame", None)
        if lframe is None:
            lframe = np.concatenate([host(a).reshape(-1) for a in (
                lb.e1, lb.e2, lb.org, lb.inv_cell)])
    lightcol = np.float32(cfg.direct_light_intensity)
    if cfg.ao_enabled:
        lightcol *= 0.2   # rt_rescale_lights(0.2) parity (tachyon_render.h:199)
    p = np.zeros(64, np.float32)
    p[0:3] = host(frame["origin"])
    p[3:6] = host(frame["lowleft"])
    p[6:9] = host(frame["iplaneright"])
    p[9:12] = host(frame["iplaneup"])
    p[12:15] = host(frame["view"])
    p[15:28] = light_rows(frame["light_dir"], lframe, lightcol)[0, :13]
    p[28:31] = host(cfg.background)
    p[31:34] = host(aabb_lo)
    p[34:37] = host(aabb_hi)
    # pixel-center offset: matches the XLA paths' dynamic_sched convention
    dynamic_sched = cfg.ao_enabled or (cfg.aa_enabled and cfg.aa_samples > 4)
    p[37] = 0.0 if dynamic_sched else 1.0
    p[38] = 0.3  # Tachyon material ambient (tachyon_render.h makeTex)
    return p


class LightStack(NamedTuple):
    """L directional lights for one launch, their CSR records back to back.

    Light 0 is the primary light, lights 1.. the AO sky lights; a row of
    ``lparams`` is one light's ``accel.light_rows`` row."""

    lparams: torch.Tensor  # (L, 16) f32
    lrec: torch.Tensor     # (M, 8) f32 rows of every light
    loffs: torch.Tensor    # (L, ncells) i32 starts into lrec
    lcnt: torch.Tensor     # (L, ncells) i32
    lkmax: torch.Tensor    # (L, ncells) f32 per-cell max far key


class OtherRecords(NamedTuple):
    """The cylinders and rings of one launch, riding beside its LightStack.

    ``orec`` holds each tile's candidate records back to back (tile t's at
    rows ``ooffs[t] .. ooffs[t] + ocnt[t]``, in slot order: cylinders by
    ascending id, then rings), rows [p(3), rad, rgba(4), axis(3), typ (1
    cylinder, 2 ring), alen, 0, 0, 0] as ``accel.other_table`` packs them.
    ``occ`` holds one occluder table per light of the stack, every live
    cylinder and ring with rows 4-7 and 13-14 in that light's space [u0, v0,
    pad, far key, ..., u1, v1] and row 15 the alpha
    (``accel.occluder_records``); None tests no occluder."""

    orec: torch.Tensor                    # (M, 16) f32
    ooffs: torch.Tensor                   # (nb,) i32
    ocnt: torch.Tensor                    # (nb,) i32
    occ: Optional[torch.Tensor] = None    # (L, nocc, 16) f32


def stack_lights(params, lrec, loffs, lcnt, lkmax, extra_lights=None, *,
                 grid_n: int, device=None) -> LightStack:
    """Stack the primary light and ``extra_lights`` for one launch.

    ``lrec, loffs, lcnt, lkmax`` are the primary light's records from
    ``build_light_records``; ``lrec=None`` gives it an empty CSR (no
    shadows).  Each extra entry is ``(lrow (16,), lrec, loffs, lcnt,
    lkmax[, occ])`` (an occluder table rides in ``OtherRecords``, not
    here); its base offset in the stacked records is folded into its
    ``loffs``.  A ``None`` lkmax never skips a cell (+BIG).  Row 0 comes from
    ``params[15:28]``, as at ``megakernel.py:1936-1939``."""
    ncells = grid_n * grid_n
    if device is None:
        device = lrec.device if lrec is not None else torch.device("cpu")
    f32, i32 = torch.float32, torch.int32
    p = np.asarray(params, np.float32)
    rows = [torch.as_tensor(light_rows(p[15:18], p[18:27], p[27])[0])]
    if lrec is None:
        lrec = torch.zeros((0, 8), dtype=f32, device=device)
        loffs = lcnt = torch.zeros(ncells, dtype=i32, device=device)
        lkmax = torch.full((ncells,), -BIG_DEPTH, dtype=f32, device=device)
    lights = [(lrec, loffs, lcnt, lkmax)]
    for lrow, lrec_k, loffs_k, lcnt_k, lkmax_k in (e[:5] for e in extra_lights or ()):
        rows.append(torch.as_tensor(np.asarray(lrow, np.float32)))
        lights.append((lrec_k, loffs_k, lcnt_k, lkmax_k))
    recs, offs, cnts, kms = [], [], [], []
    base = 0
    for lrec_k, loffs_k, lcnt_k, lkmax_k in lights:
        if lrec_k.dim() != 2 or lrec_k.shape[1] != 8:
            raise ValueError(f"light records must be (M, 8), got "
                             f"{tuple(lrec_k.shape)}")
        for t, name in ((loffs_k, "loffs"), (lcnt_k, "lcnt")):
            if tuple(t.shape) != (ncells,):
                raise ValueError(f"{name} must be ({ncells},), got "
                                 f"{tuple(t.shape)}")
        if lkmax_k is None:
            lkmax_k = torch.full((ncells,), BIG, dtype=f32, device=device)
        recs.append(lrec_k.to(device=device, dtype=f32))
        offs.append(loffs_k.to(device=device, dtype=torch.int64) + base)
        cnts.append(lcnt_k.to(device=device, dtype=i32))
        kms.append(lkmax_k.to(device=device, dtype=f32))
        base += lrec_k.shape[0]
    if base >= 2**31:
        raise ValueError(f"{base} light records overflow the int32 offsets")
    return LightStack(
        torch.stack(rows).to(device),
        recs[0].contiguous() if len(recs) == 1 else torch.cat(recs),
        torch.stack(offs).to(i32), torch.stack(cnts), torch.stack(kms),
    )


def hash_jitter(tile, s, seed, pix):
    """Deterministic per-(tile, sample, pixel) jitter in [-0.5, 0.5).

    The JAX package's int32 avalanche hash, bit for bit: int64 arithmetic
    masked to 32 bits stands in for wrapping int32 multiplies and logical
    right shifts."""
    def mul(a, c):
        # (a * c) mod 2**32 for 0 <= a < 2**32 without int64 overflow
        return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & m

    m = 0xFFFFFFFF
    h0 = (mul(tile & m, 0x9E3779B9) + mul(s & m, 0xC2B2AE35)
          + mul(seed & m, 374761393)) & m
    v = (mul(pix & m, 0x85EBCA6B) + h0) & m
    v = v ^ (v >> 16)
    v = mul(v, 2127912214)
    v = v ^ (v >> 15)
    v = mul(v, 0xC2B2AE35)
    v = v ^ (v >> 16)
    jx = (v & 0xFFFF).to(torch.float32) * (1.0 / 65536.0) - 0.5
    jy = ((v >> 16) & 0xFFFF).to(torch.float32) * (1.0 / 65536.0) - 0.5
    return jx, jy


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------


def _raygen(p, tiles, S: int, seed: int, tiles_x: int, perspective: bool):
    """Rays (T, S*P) in the kernel's lane order s*P + pixel."""
    dev = p.device
    lane = torch.arange(S * P, device=dev, dtype=torch.int64)
    pixl = lane % P
    s_vec = lane // P
    t = tiles[:, None]
    jx, jy = hash_jitter(t, s_vec[None], int(seed), pixl[None])
    nz = (s_vec > 0).to(torch.float32)
    sub_x = (pixl % TILE_PX).to(torch.float32)
    sub_y = (pixl // TILE_PX).to(torch.float32)
    txf = (t % tiles_x).to(torch.float32)
    tyf = (t // tiles_x).to(torch.float32)
    off = p[37]
    x = txf * TILE_PX + sub_x + off + jx * nz
    y = tyf * TILE_PX + sub_y + off + jy * nz
    dx = p[3] + x * p[6] + y * p[9]
    dy = p[4] + x * p[7] + y * p[10]
    dz = p[5] + x * p[8] + y * p[11]
    if perspective:
        inv = torch.rsqrt(dx * dx + dy * dy + dz * dz)
        d = (dx * inv, dy * inv, dz * inv)
        o = tuple(torch.full_like(dx, 0.0) + p[i] for i in range(3))
    else:
        o = (dx, dy, dz)
        d = tuple(torch.full_like(dx, 0.0) + p[12 + i] for i in range(3))
    return o, d, _tcap(p, o, d)


def _tcap(p, o, d):
    """Where each ray leaves the scene AABB (-BIG when it misses the box)."""
    def axis_exit(o1, d1, lo1, hi1):
        invd = 1.0 / torch.where(d1.abs() > 1e-30, d1, torch.full_like(d1, 1e-30))
        t0 = (lo1 - o1) * invd
        t1 = (hi1 - o1) * invd
        return torch.minimum(t0, t1), torch.maximum(t0, t1)

    n0, f0 = axis_exit(o[0], d[0], p[31], p[34])
    n1, f1 = axis_exit(o[1], d[1], p[32], p[35])
    n2, f2 = axis_exit(o[2], d[2], p[33], p[36])
    tnear = torch.maximum(torch.maximum(n0, n1), n2)
    tfar = torch.minimum(torch.minimum(f0, f1), f2)
    return torch.where(tfar >= torch.clamp(tnear, min=0.0), tfar,
                       torch.full_like(tfar, -BIG))


def _closest_hit(chunk_data, zmin, tiles, o, d, tcap, eps: float,
                 perspective: bool, cumt=None, reach=None, stable: bool = True):
    """Front-to-back chunk walk with the per-tile zmin early exit.

    ``perspective`` says every ray starts at the camera, ``o[i][0, 0]``;
    else each starts at its own origin.  ``cumt`` (T, R), when given, is
    each ray's camera depth so far, added to its bound in the exit test.
    ``reach`` (T,) int64, when given, gets the number of chunks each tile
    walked.  Returns best t (T, R) and the winner's flat slot c*CH + j (-1 on miss);
    ties keep the lowest slot of the earliest chunk.

    Each candidate's t is the smallest root beyond eps of the stable
    discriminant; the kernel takes it only for the candidates that can
    still win (-b - sqrt(r^2) before the best t so far, below which no
    root lies), to the same result.  ``stable=False`` takes b^2 - (|oc|^2
    - r^2) instead, as the tiled tracer's kernel (``csrc/tile_kernels.cu``)
    does."""
    T, R = tcap.shape
    nchunks = chunk_data.shape[1]
    dev = tcap.device
    bt = torch.full((T, R), BIG, dtype=torch.float32, device=dev)
    bidx = torch.full((T, R), -1, dtype=torch.int64, device=dev)
    needed = (tcap if cumt is None else tcap + cumt).max(dim=1).values
    slots = torch.arange(CH, device=dev)
    for c in range(nchunks):
        act = torch.nonzero(zmin[tiles, c] < needed).flatten()
        if act.numel() == 0:
            break
        _count("sphere", act.numel() * R * CH)
        if reach is not None:
            reach[act] = c + 1
        rec = chunk_data[tiles[act], c]                 # (A, 8, CH)
        cx, cy, cz, r = (rec[:, i, None, :] for i in range(4))
        dx, dy, dz = (v[act, :, None] for v in d)
        if perspective:
            ocx = o[0][0, 0] - cx
            ocy = o[1][0, 0] - cy
            ocz = o[2][0, 0] - cz
        else:
            ocx = o[0][act, :, None] - cx
            ocy = o[1][act, :, None] - cy
            ocz = o[2][act, :, None] - cz
        b = ocx * dx + ocy * dy + ocz * dz
        r2 = r * r
        if stable:
            # the stable discriminant r^2 - |w|^2, w = oc - b d (``tracer.py:
            # _sph``): b^2 - (|oc|^2 - r^2) loses about four digits in
            # float32 with the camera hundreds of Angstrom away, enough to
            # pick another sphere at a seam or a silhouette and to put the
            # hit point past eps inside its sphere, where a sky light's walk
            # finds the sphere itself
            wx = ocx - b * dx
            wy = ocy - b * dy
            wz = ocz - b * dz
            disc = r2 - (wx * wx + wy * wy + wz * wz)
        else:
            disc = b * b - (ocx * ocx + ocy * ocy + ocz * ocz - r2)
        ok = (disc >= 0.0) & (r > 0.0)
        if stable and perspective:
            # the kernel's gate: b^2 against |oc|^2 - r^2 lowered by 2^-18
            # |oc|^2, far more than either side's rounding, so it passes
            # every sphere the stable form hits and few others
            oo = ocx * ocx + ocy * ocy + ocz * ocz
            ok = ok & (b * b >= oo * GATE - r2)
        sq = ieee.sqrt(torch.where(ok, disc, 0.0))
        t1 = -b - sq
        t2 = sq - b
        big = torch.full_like(t1, BIG)
        t = torch.where(t1 > eps, t1, torch.where(t2 > eps, t2, big))
        t = torch.where(ok, t, big)
        tmin = t.min(dim=2).values
        # exclusive winner: the lowest slot among equal t (adjacent spheres
        # can tie at seam pixels)
        jmin = torch.where(t == tmin[..., None], slots, CH).min(dim=2).values
        bt_a = bt[act]
        better = tmin < bt_a
        bt_a = torch.where(better, tmin, bt_a)
        bt[act] = bt_a
        bidx[act] = torch.where(better, c * CH + jmin, bidx[act])
        bound = torch.minimum(bt_a, tcap[act])
        if cumt is not None:
            bound = bound + cumt[act]
        needed[act] = bound.max(dim=1).values
    return bt, bidx


def _closest_hit_other(other, tiles, o, d, bt, eps: float, perspective: bool):
    """Dense cyl/ring pass after the sphere walk (``megakernel.py:483-568``).

    Returns the new best t (T, R) and the winner's row of ``other.orec``
    (-1 where no cylinder or ring won).  A record replaces the best hit only
    when its t is strictly smaller; among equal t the lowest slot wins."""
    T, R = bt.shape
    dev = bt.device
    widx = torch.full((T, R), -1, dtype=torch.int64, device=dev)
    cnt = other.ocnt[tiles].to(torch.int64)
    K = int(cnt.max()) if T else 0
    _count("cylring", cnt.sum() * R)
    if K == 0:
        return bt, widx
    slots = torch.arange(K, device=dev)
    valid = slots[None, :] < cnt[:, None]
    rows = torch.where(valid, other.ooffs[tiles].to(torch.int64)[:, None] + slots,
                       torch.zeros_like(slots))
    bt = bt.clone()
    step = max(1, _PLAIN_ELEMS // (R * K))
    for a in range(0, T, step):
        sl = slice(a, min(T, a + step))
        rec = other.orec[rows[sl]]                        # (t, K, 16)
        px, py, pz, rad = (rec[:, None, :, i] for i in range(4))
        rad = torch.where(valid[sl][:, None, :], rad, -1.0)
        axx, axy, axz, typ, alen = (rec[:, None, :, i] for i in range(8, 13))
        dx, dy, dz = (v[sl, :, None] for v in d)
        if perspective:
            ocx = o[0][0, 0] - px
            ocy = o[1][0, 0] - py
            ocz = o[2][0, 0] - pz
        else:
            ocx = o[0][sl, :, None] - px
            ocy = o[1][sl, :, None] - py
            ocz = o[2][sl, :, None] - pz
        oca = ocx * axx + ocy * axy + ocz * axz
        opx = ocx - oca * axx
        opy = ocy - oca * axy
        opz = ocz - oca * axz
        cq = opx * opx + opy * opy + opz * opz - rad * rad
        dda = axx * dx + axy * dy + axz * dz              # (t, R, K)
        # cylinder body, stable perpendicular-vector form
        dpx = dx - dda * axx
        dpy = dy - dda * axy
        dpz = dz - dda * axz
        a2 = dpx * dpx + dpy * dpy + dpz * dpz
        bq = opx * dpx + opy * dpy + opz * dpz
        disc = bq * bq - a2 * cq
        live_c = (typ == 1.0) & (rad > 0.0) & (disc >= 0.0) & (a2 > 1e-12)
        inv_a2 = 1.0 / torch.where(a2 > 1e-12, a2, 1.0)
        sq = ieee.sqrt(torch.where(live_c, disc, 0.0))
        t1 = (-bq - sq) * inv_a2
        t2 = (-bq + sq) * inv_a2
        s1 = oca + t1 * dda
        s2 = oca + t2 * dda
        ok1 = live_c & (t1 > eps) & (s1 >= 0.0) & (s1 <= alen)
        ok2 = live_c & (t2 > eps) & (s2 >= 0.0) & (s2 <= alen)
        big = torch.full_like(t1, BIG)
        tc = torch.where(ok1, t1, torch.where(ok2, t2, big))
        # ring disc in the plane whose normal is the axis
        ring = (typ == 2.0) & (rad > 0.0) & (dda.abs() > 1e-12)
        tr0 = -oca / torch.where(ring, dda, 1.0)
        rx = ocx + tr0 * dx
        ry = ocy + tr0 * dy
        rz = ocz + tr0 * dz
        rho2 = rx * rx + ry * ry + rz * rz
        okr = ring & (tr0 > eps) & (rho2 <= rad * rad)
        t = torch.where(okr, tr0, tc)
        tmin = t.min(dim=2).values
        jmin = torch.where(t == tmin[..., None], slots, K).min(dim=2).values
        bt_a = bt[sl]
        better = tmin < bt_a
        bt[sl] = torch.where(better, tmin, bt_a)
        widx[sl] = torch.where(better, rows[sl].gather(1, jmin), widx[sl])
    return bt, widx


def _cylring_occludes(oc, axis, rr, typ, al, dda, dp, a2, inv_a2, light,
                      eps: float):
    """True where the ray from a point along the unit direction ``light``
    hits a cylinder body (typ 1) or ring disc (typ 2) at t > eps.  ``oc`` is
    the point minus the record's position, ``axis`` its unit axis, ``rr`` its
    radius, ``al`` the cylinder length; ``dda`` = axis.light, ``dp`` = light
    minus its axis part, ``a2`` = |dp|^2 and ``inv_a2`` = 1 / a2 (1 where a2
    <= 1e-12) are the record's ray-independent terms.  Vectors are 3-tuples;
    everything broadcasts together."""
    ocx, ocy, ocz = oc
    ax_, ay_, az_ = axis
    lx, ly, lz = light
    oca = ocx * ax_ + ocy * ay_ + ocz * az_
    opx = ocx - oca * ax_
    opy = ocy - oca * ay_
    opz = ocz - oca * az_
    bq = opx * dp[0] + opy * dp[1] + opz * dp[2]
    cq = opx * opx + opy * opy + opz * opz - rr * rr
    disc = bq * bq - a2 * cq
    live_c = (typ == 1.0) & (disc >= 0.0) & (a2 > 1e-12)
    sq = ieee.sqrt(torch.where(live_c, disc, 0.0))
    t1 = (-bq - sq) * inv_a2
    t2 = (-bq + sq) * inv_a2
    s1_ = oca + t1 * dda
    s2_ = oca + t2 * dda
    occ_c = live_c & (((t1 > eps) & (s1_ >= 0.0) & (s1_ <= al))
                      | ((t2 > eps) & (s2_ >= 0.0) & (s2_ <= al)))
    ring = (typ == 2.0) & (dda.abs() > 1e-12)
    tr0 = -oca / torch.where(ring, dda, 1.0)
    rx = ocx + tr0 * lx
    ry = ocy + tr0 * ly
    rz = ocz + tr0 * lz
    occ_r = ring & (tr0 > eps) & (rx * rx + ry * ry + rz * rz <= rr * rr)
    return occ_c | occ_r


def _occluders_blocked(occ, lp, h, rect, test, groups, eps: float,
                       trans=None):
    """Occluder-table test toward light row ``lp`` (``megakernel.py:1153-1295``):
    True where a cylinder or ring of ``occ`` (nocc, 16) blocks a hit point
    of ``h`` (three (T, R) tensors) marked in ``test``.

    For each lane range of ``groups`` and each tile, the (u, v) rectangle
    and least tau of the ``rect`` lanes decide which entries are tried: the
    conservative cull of the JAX kernel, computed as the hand kernel
    computes it for its sample groups.

    With ``trans`` (T, R), the transmissions so far, returns them multiplied
    by 1 - alpha (0 at alpha >= OPAQUE_ALPHA) of each entry that blocks the
    point, in ascending entry order, as the kernel multiplies them."""
    hx, hy, hz = h
    T = hx.shape[0]
    blocked = torch.zeros_like(test) if trans is None else trans.clone()
    if occ.shape[0] == 0 or T == 0:
        return blocked
    hits = []   # (tile, lane, entry) of each blocking pair, by ray then entry
    lx, ly, lz = lp[0], lp[1], lp[2]
    u = hx * lp[3] + hy * lp[4] + hz * lp[5] - lp[9]
    v = hx * lp[6] + hy * lp[7] + hz * lp[8] - lp[10]
    tau = hx * lp[0] + hy * lp[1] + hz * lp[2]
    px, py, pz, rad, gu0, gv0, grb, gkey = occ[:, :8].unbind(1)
    axx, axy, axz, typ, alen, gu1, gv1 = occ[:, 8:15].unbind(1)
    # ray-independent terms of each entry
    dda = axx * lx + axy * ly + axz * lz
    dpx = lx - dda * axx
    dpy = ly - dda * axy
    dpz = lz - dda * axz
    a2 = dpx * dpx + dpy * dpy + dpz * dpz
    inv_a2 = 1.0 / torch.where(a2 > 1e-12, a2, 1.0)
    bx = gu1 - gu0
    by = gv1 - gv0
    blen = torch.clamp(bx * bx + by * by, min=1e-12)
    for a, b in groups:
        r = rect[:, a:b]
        umin = torch.where(r, u[:, a:b], BIG).amin(1)
        umax = torch.where(r, u[:, a:b], -BIG).amax(1)
        vmin = torch.where(r, v[:, a:b], BIG).amin(1)
        vmax = torch.where(r, v[:, a:b], -BIG).amax(1)
        tmin = torch.where(r, tau[:, a:b], BIG).amin(1)
        live = umax >= umin
        _count("cull", live.sum() * occ.shape[0])
        ucx = 0.5 * (umin + umax)
        vcx = 0.5 * (vmin + vmax)
        du = umax - umin
        dv = vmax - vmin
        halfdiag = 0.5 * ieee.sqrt(du * du + dv * dv)
        wx = ucx[:, None] - gu0
        wy = vcx[:, None] - gv0
        ts = torch.clamp((wx * bx + wy * by) / blen, 0.0, 1.0)
        dxs = wx - ts * bx
        dys = wy - ts * by
        lim = grb + halfdiag[:, None] + eps
        keep = (live[:, None] & (rad > 0.0) & (dxs * dxs + dys * dys <= lim * lim)
                & (gkey > (tmin + eps)[:, None]))
        tt, oo = torch.nonzero(keep, as_tuple=True)    # by tile, then entry
        nsv = torch.bincount(tt, minlength=T)
        svoff = torch.cumsum(nsv, 0) - nsv
        rt, rl = torch.nonzero(test[:, a:b], as_tuple=True)
        rl = rl + a
        npair = nsv[rt]
        cum = torch.cumsum(npair, 0).cpu()
        s0 = 0
        while s0 < rt.shape[0]:
            # rays [s0, s1) with at most _PLAIN_ELEMS (ray, entry) pairs
            base = int(cum[s0 - 1]) if s0 else 0
            s1 = max(s0 + 1, int(torch.searchsorted(cum, base + _PLAIN_ELEMS,
                                                    right=True)))
            n = npair[s0:s1]
            ray = torch.repeat_interleave(torch.arange(s0, s1, device=n.device), n)
            local = (torch.arange(ray.shape[0], device=n.device)
                     - (torch.cumsum(n, 0) - n)[ray - s0])
            i = oo[svoff[rt[ray]] + local]
            _count("occluder", ray.shape[0])
            tr_, tl_ = rt[ray], rl[ray]
            hit_ = _cylring_occludes(
                (hx[tr_, tl_] - px[i], hy[tr_, tl_] - py[i], hz[tr_, tl_] - pz[i]),
                (axx[i], axy[i], axz[i]), rad[i], typ[i], alen[i], dda[i],
                (dpx[i], dpy[i], dpz[i]), a2[i], inv_a2[i], (lx, ly, lz), eps)
            hit = ray[hit_]
            if trans is None:
                blocked[rt[hit], rl[hit]] = True
            else:
                hits.append((rt[hit], rl[hit], i[hit_]))
            s0 = s1
    if trans is None or not hits:
        return blocked
    ht, hl, hi = (torch.cat(x) for x in zip(*hits))
    if ht.numel() == 0:
        return blocked
    alpha = occ[hi, 15]
    fac = torch.where(alpha >= OPAQUE_ALPHA, 0.0, 1.0 - alpha)
    # each ray's factors one after another: its k-th pair at step k
    ray = ht * hx.shape[1] + hl
    first = torch.ones_like(ray, dtype=torch.bool)
    first[1:] = ray[1:] != ray[:-1]
    start = torch.nonzero(first).flatten()
    pos = torch.arange(ray.numel(), device=ray.device) - start[torch.cumsum(
        first.to(torch.int64), 0) - 1]
    for k in range(int(pos.max()) + 1):
        at = pos == k
        blocked[ht[at], hl[at]] = blocked[ht[at], hl[at]] * fac[at]
    return blocked


def _shadow_blocked(lrec, loffs, lcnt, lkmax, u, v, tau, cell, eps: float,
                    walked=None, trans: bool = False):
    """1.0 where some record of the ray's cell occludes it, else 0.0.

    Walks each ray's descending-key records in steps of _SHADOW_STEP; a ray
    retires at its first occluder or once key <= tau + eps.  ``lkmax`` (each
    cell's largest key) spares the walk of a cell that cannot occlude; None
    walks every non-empty cell, to the same result.  ``walked`` (int64, one
    per ray), when given, gains the number of records each ray's walk read.

    With ``trans`` it returns each ray's transmission instead: every
    occluder multiplies it by 1 - alpha (record row 5; 0 at alpha >=
    OPAQUE_ALPHA), in record order, and the walk retires at key <= tau + eps
    or once the transmission is at or below TRANS_FLOOR (the kernel's
    queued walks, ``csrc/mega_render.cu:walk_serial`` and ``walk_warp``,
    stop at the same record)."""
    out = torch.ones_like(tau) if trans else torch.zeros_like(tau)
    tau_eps = tau + eps
    cnt = lcnt[cell].to(torch.int64)
    off = loffs[cell].to(torch.int64)
    live = cnt > 0
    if lkmax is not None:
        live = live & (lkmax[cell] > tau_eps)
    active = torch.nonzero(live).flatten()
    k0 = 0
    step = torch.arange(_SHADOW_STEP, device=tau.device)
    while active.numel():
        kk = k0 + step[None, :]
        valid = kk < cnt[active, None]
        idx = off[active, None] + torch.minimum(kk, cnt[active, None] - 1)
        rec = lrec[idx]                                   # (A, W, 8)
        stop = ~valid | (rec[..., 4] <= tau_eps[active, None])
        du = rec[..., 0] - u[active, None]
        dv = rec[..., 1] - v[active, None]
        sr = rec[..., 3]
        s2 = sr * sr - (du * du + dv * dv)
        q = tau_eps[active, None] - rec[..., 2]
        occ = (s2 > 0.0) & (sr > 0.0) & ((q < 0.0) | (s2 > q * q))
        read = None
        if trans:
            alpha = rec[..., 5]
            fac = torch.where(alpha >= OPAQUE_ALPHA, 0.0, 1.0 - alpha)
            tr = out[active]
            retire = torch.zeros_like(tr, dtype=torch.bool)
            read = torch.zeros_like(active)
            # one record after another, so the products round as the kernel's
            for j in range(_SHADOW_STEP):
                go = ~retire & ~stop[:, j]
                read += go
                tr = torch.where(go & occ[:, j], tr * fac[:, j], tr)
                retire = retire | stop[:, j] | (tr <= TRANS_FLOOR)
            out[active] = tr
        else:
            stop = torch.cumsum(stop.to(torch.int32), dim=1) > 0
            occ = occ & ~stop
            if _work is not None or walked is not None:
                # records a walk reads: up to its first occluder or its stop
                read = (~stop & (torch.cumsum(occ, 1) - occ.int() == 0)).sum(dim=1)
            hit = occ.any(dim=1)
            out[active[hit]] = 1.0
            retire = hit | stop[:, -1]
        if read is not None:
            _count("record", read.sum())
            if walked is not None:
                walked[active] += read
        active = active[~retire]
        k0 += _SHADOW_STEP
    return out


def _light_blocked(lights, lp, l: int, h, sel, *, grid_n, eps,
                   trans: bool = False):
    """Shadow test of the hit points ``h[i].flatten()[sel]`` toward light
    ``l`` (row ``lp``): 1.0 where an occluder blocks the point, else 0.0;
    with ``trans``, each point's transmission."""
    hx, hy, hz = (x.flatten()[sel] for x in h)
    u = hx * lp[3] + hy * lp[4] + hz * lp[5] - lp[9]
    v = hx * lp[6] + hy * lp[7] + hz * lp[8] - lp[10]
    tau = hx * lp[0] + hy * lp[1] + hz * lp[2]
    gx = torch.clamp(torch.floor(u * lp[11]), 0, grid_n - 1)
    gy = torch.clamp(torch.floor(v * lp[11]), 0, grid_n - 1)
    cell = (gy * grid_n + gx).to(torch.int64) + l * grid_n * grid_n
    return _shadow_blocked(lights.lrec, lights.loffs.view(-1),
                           lights.lcnt.view(-1), lights.lkmax.view(-1),
                           u, v, tau, cell, eps, trans=trans)


def _on_sphere(h, rec, n, sph):
    """The hit points ``h`` of the sphere winners (``sph``) put back on
    their spheres (records ``rec``) along the unit normals ``n``: o + t d
    carries the rounding of t and of the camera's distance (up to 5e-5 A at
    190 A), which a sky light's walk at a grazing angle reads as the sphere
    shadowing itself.  As the kernel does it."""
    return [torch.where(sph, rec[..., i] + rec[..., 3] * n[i], h[i])
            for i in range(3)]


def _surfaces(chunk_data, zmin, lights, other, p, tiles, o, d, tcap, cumt,
              *, S, grid_n, eps, camo, shadows, trans, reach=None):
    """One trace of the rays (T, R) from ``o`` along ``d``: closest hit,
    surface and the lights' sum of lit * n.L * lightcol * filter, the filter
    a transmission with ``trans`` and 0 or 1 without.  ``camo`` says every
    ray starts at the camera; ``reach`` as ``_closest_hit``'s.  Returns
    (rec (T, R, 8): the winner's record rows [centre, r, rgba], missed,
    tsafe, hit point, the sum)."""
    bt, bidx = _closest_hit(chunk_data, zmin, tiles, o, d, tcap, eps, camo,
                            cumt=cumt, reach=reach)
    if other is not None:
        bt, widx = _closest_hit_other(other, tiles, o, d, bt, eps, camo)
    T, R = bt.shape
    hit = bidx >= 0
    c = bidx.clamp(min=0) // CH
    j = bidx.clamp(min=0) % CH
    rec = chunk_data[tiles[:, None], c, :, j]               # (T, R, 8)
    rec = torch.where(hit[..., None], rec, 0.0)
    if other is not None:
        # a cyl/ring winner's record: rows 0-7 as a sphere's, then the axis
        # and the type (0 for a sphere)
        owin = (widx >= 0)[..., None]
        orow = other.orec[widx.clamp(min=0)]                 # (T, R, 16)
        rec = torch.where(owin, orow[..., :8], rec)
        axis = torch.where(owin, orow[..., 8:12], 0.0)
    missed = (bt >= BIG_DEPTH) | (rec[..., 3] <= 0.0)
    tsafe = torch.where(missed, 0.0, bt)
    h = [o[i] + tsafe * d[i] for i in range(3)]
    n = [h[i] - rec[..., i] for i in range(3)]
    if other is not None:
        # cylinder: radial minus the axis part; ring: the plane normal
        typ = axis[..., 3]
        sax = n[0] * axis[..., 0] + n[1] * axis[..., 1] + n[2] * axis[..., 2]
        n = [torch.where(typ == 1.0, n[i] - sax * axis[..., i], n[i])
             for i in range(3)]
        n = [torch.where(typ == 2.0, axis[..., i], n[i]) for i in range(3)]
    inv = torch.rsqrt(torch.clamp(n[0] * n[0] + n[1] * n[1] + n[2] * n[2],
                                  min=1e-30))
    n = [x * inv for x in n]
    h = _on_sphere(h, rec, n,
                   ~missed if other is None else ~missed & (typ == 0.0))
    facing = n[0] * d[0] + n[1] * d[1] + n[2] * d[2]
    flip = torch.where(facing > 0.0, -1.0, 1.0)
    n = [x * flip for x in n]
    occ = other.occ if (other is not None and shadows) else None
    ngroups = -(-S // SG)
    groups = [(g * S // ngroups * P, (g + 1) * S // ngroups * P)
              for g in range(ngroups)]

    def table(l, lp, hh, lit, filt, groups):
        """The occluder table of light l on the points its walk left
        unblocked (opaque) or with transmission > 0."""
        if occ is None:
            return filt
        if trans:
            return _occluders_blocked(occ[l], lp, hh, lit, lit & (filt > 0.0),
                                      groups, eps, trans=filt)
        return torch.where(
            _occluders_blocked(occ[l], lp, hh, lit, lit & (filt > 0.0), groups,
                               eps), 0.0, filt)

    # per light, in light order: sh += lit * (n.L) * lightcol * filter
    sh = None
    for l in range(lights.lparams.shape[0] if lights is not None else 1):
        lp = p[15:27] if l == 0 else lights.lparams[l]
        lightcol = p[27] if l == 0 else lp[12]
        inten = n[0] * lp[0] + n[1] * lp[1] + n[2] * lp[2]
        litb = (inten > MINCONTRIB) & ~missed
        lit = litb.to(torch.float32)
        filt = torch.ones_like(inten)
        if shadows and l == 0:
            # the primary light: every sample's own hit point
            sel = torch.nonzero(litb.flatten()).flatten()
            _count("lit", sel.numel())
            res = _light_blocked(lights, lp, l, h, sel, grid_n=grid_n,
                                 eps=eps, trans=trans)
            filt = filt.flatten().index_put(
                (sel,), res if trans else 1.0 - res).view(T, R)
            filt = table(l, lp, h, litb, filt, groups)
        elif shadows:
            # a sky light: sample 0's hit point, shared by every sample
            h0 = [x[:, :P] for x in h]
            sel = torch.nonzero(litb[:, :P].flatten()).flatten()
            res = _light_blocked(lights, lp, l, h0, sel, grid_n=grid_n,
                                 eps=eps, trans=trans)
            filt0 = torch.ones((T * P,), dtype=torch.float32, device=p.device)
            filt0 = filt0.index_put((sel,), res if trans else 1.0 - res)
            filt0 = table(l, lp, h0, litb[:, :P], filt0.view(T, P), [(0, P)])
            filt = filt0.repeat(1, S)
        term = lit * inten * lightcol * filt
        sh = term if sh is None else sh + term
    return rec, missed, tsafe, h, sh


def _render_batch(chunk_data, zmin, lights, other, p, tiles, *,
                  S, seed, tiles_x, grid_n, eps, perspective, shadows, inv_s,
                  n_peel, peel1):
    o, d, tcap = _raygen(p, tiles, S, seed, tiles_x, perspective)
    T, R = tcap.shape
    kw = dict(S=S, grid_n=grid_n, eps=eps, shadows=shadows)
    # tiles with no candidate at all are background, as the kernel writes them
    dead = ~(zmin[tiles, 0] < BIG_DEPTH)
    if other is not None:
        dead = dead & (other.ocnt[tiles] == 0)
    # while counting: the chunks each tile reads, the deepest walk of its
    # peels ("chunk"), and the live tiles that run each peel ("peel<p>")
    reach = (torch.zeros(T, dtype=torch.int64, device=p.device)
             if _work is not None else None)
    if not (n_peel > 1 or peel1):
        rec, missed, _, _, sh = _surfaces(
            chunk_data, zmin, lights, other, p, tiles, o, d, tcap, None,
            camo=perspective, trans=False, reach=reach, **kw)
        shade = 0.8 * sh + p[38]
        cols = [torch.where(missed, p[28 + ch], rec[..., 4 + ch] * shade)
                for ch in range(3)]
        resid = None
    else:
        # peels: every ray's weight, colour sums, last hit and camera depth
        multi = n_peel > 1
        w = torch.ones((T, R), dtype=torch.float32, device=p.device)
        cols = [torch.zeros_like(w) for _ in range(3)]
        hit = [x.clone() for x in o]
        cumt = torch.zeros_like(w) if multi else None
        act = torch.arange(T, device=p.device)
        for peel in range(n_peel):
            if peel:
                # a later peel runs for the tiles whose largest W is > PEEL_SKIP
                act = act[w[act].amax(dim=1) > PEEL_SKIP]
                if act.numel() == 0:
                    break
            _count(f"peel{peel}", (~dead[act]).sum())
            da = tuple(x[act] for x in d)
            if peel:
                oa = tuple(hit[i][act] + eps * da[i] for i in range(3))
                ta = _tcap(p, oa, da)
            else:
                oa, ta = o, tcap
            ra = None if reach is None else torch.zeros_like(act)
            rec, missed, tsafe, h, sh = _surfaces(
                chunk_data, zmin, lights, other, p, tiles[act], oa, da, ta,
                cumt[act] if multi else None,
                camo=perspective and not multi, trans=True, reach=ra, **kw)
            if reach is not None:
                reach[act] = torch.maximum(reach[act], ra)
            if multi:
                cumt[act] = cumt[act] + tsafe + eps
            shade = 0.8 * sh + p[38]
            a = torch.where(missed, 1.0, rec[..., 7])
            wa = w[act]
            for ch in range(3):
                c = torch.where(missed, p[28 + ch], rec[..., 4 + ch] * shade)
                cols[ch][act] = cols[ch][act] + wa * a * c
            w[act] = wa * (1.0 - a)
            for i in range(3):
                hit[i][act] = h[i]
        resid = w.view(T, S, P)
    if reach is not None:
        _count("chunk", reach.sum())
    out = []
    for ch in range(3):
        col = cols[ch].view(T, S, P)
        acc = torch.zeros((T, P), dtype=torch.float32, device=col.device)
        for s in range(S):
            acc = acc + col[:, s]
            if resid is not None:
                # the residual weight sees the background
                acc = acc + resid[:, s] * p[28 + ch]
        out.append(acc * inv_s)
    out = torch.cat(out, dim=1)                              # (T, 3*P)
    bg = torch.repeat_interleave(p[28:31], P)
    return torch.where(dead[:, None], bg[None, :], out)


def _tile_range(tiles, nb: int):
    lo, hi = (0, nb) if tiles is None else (int(tiles[0]), int(tiles[1]))
    if not 0 <= lo <= hi <= nb:
        raise ValueError(f"tile range {tiles} outside [0, {nb}]")
    return lo, hi


def _nlights(lights, shadows: bool) -> int:
    if lights is None:
        if shadows:
            raise ValueError("shadows need a LightStack (stack_lights)")
        return 1
    if not isinstance(lights, LightStack):
        raise ValueError(f"lights must be a LightStack, got {type(lights).__name__}")
    return lights.lparams.shape[0]


def _nocc(other, nl: int, shadows: bool) -> int:
    """Occluders per light of ``other`` (0 when none is tested)."""
    if other is None:
        return 0
    if not isinstance(other, OtherRecords):
        raise ValueError(f"other must be OtherRecords, got {type(other).__name__}")
    if other.occ is None or not shadows:
        return 0
    if other.occ.dim() != 3 or tuple(other.occ.shape[::2]) != (nl, 16):
        raise ValueError(f"occ must be ({nl}, nocc, 16), got "
                         f"{tuple(other.occ.shape)}")
    return other.occ.shape[1]


def _check_peel(n_peel: int, peel1: bool) -> None:
    if n_peel < 1:
        raise ValueError(f"n_peel must be >= 1, got {n_peel}")
    if peel1 and n_peel != 1:
        raise ValueError(f"peel1 is one peel; n_peel must be 1, got {n_peel}")


def mega_render_plain(chunk_data, zmin, lights, params, seed, *, S: int,
                      tiles_x: int, grid_n: int, eps: float, perspective: bool,
                      shadows: bool, tiles=None, other=None, n_peel: int = 1,
                      peel1: bool = False) -> torch.Tensor:
    """Plain torch version of the kernel: (ntiles, 3*256) f32 [R|G|B] rows
    for the tiles in ``tiles`` = (first, end), all tiles by default.

    ``lights`` is a ``LightStack`` (None: the primary light alone, without
    shadows); ``other`` the cylinders and rings (``OtherRecords``) or None.
    ``n_peel`` > 1 peels up to that many layers, ``peel1`` composites one;
    either turns transparency on (the module docstring).  Runs on the
    inputs' device; tiles go through in batches that keep each (tiles,
    rays, CH) temporary within _PLAIN_ELEMS elements."""
    _check_peel(n_peel, peel1)
    _nocc(other, _nlights(lights, shadows), shadows)
    nb, nchunks, _, ch = chunk_data.shape
    lo, hi = _tile_range(tiles, nb)
    dev = chunk_data.device
    p = torch.as_tensor(params, dtype=torch.float32, device=dev)
    inv_s = float(np.float32(1.0 / S))
    batch = max(1, _PLAIN_ELEMS // (S * P * ch))
    out = torch.empty((hi - lo, 3 * P), dtype=torch.float32, device=dev)
    for t0 in range(lo, hi, batch):
        tiles = torch.arange(t0, min(hi, t0 + batch), device=dev)
        out[t0 - lo:t0 - lo + tiles.shape[0]] = _render_batch(
            chunk_data, zmin, lights, other, p, tiles,
            S=S, seed=seed, tiles_x=tiles_x, grid_n=grid_n, eps=eps,
            perspective=perspective, shadows=shadows, inv_s=inv_s,
            n_peel=n_peel, peel1=peel1,
        )
    return out


# ---------------------------------------------------------------------------
# hand CUDA kernel
# ---------------------------------------------------------------------------


def _check(t, name, dtype, ndim, device):
    if t.dtype != dtype or t.dim() != ndim or t.device != device:
        raise ValueError(
            f"{name}: expected {ndim}-d {dtype} on {device}, got "
            f"{t.dim()}-d {t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def mega_render_cuda(chunk_data, zmin, lights, params, seed, *, S: int,
                     tiles_x: int, grid_n: int, eps: float, perspective: bool,
                     shadows: bool, tiles=None, other=None, n_peel: int = 1,
                     peel1: bool = False) -> torch.Tensor:
    """Launch the hand kernel on CUDA tensors: (ntiles, 3*256) f32 rows
    for the tiles in ``tiles`` = (first, end), all tiles by default.

    With peeling the kernel keeps 8 floats a sample and pixel (origin, W,
    colour sums, camera depth) across its peels, in shared memory while
    that fits ``PEEL_SMEM_BYTES``; past it in a device buffer, with the
    tiles launched in batches whose buffer stays within 256 MiB."""
    from ._build import load_mega_render

    global launches
    _check_peel(n_peel, peel1)
    peel = n_peel > 1 or peel1
    dev = chunk_data.device
    if dev.type != "cuda":
        raise ValueError(f"mega_render_cuda needs CUDA tensors, got {dev}")
    nb, nchunks, rows, ch = chunk_data.shape
    if rows != 8 or ch != CH:
        raise ValueError(f"chunk_data must be (nb, nchunks, 8, {CH}), got "
                         f"{tuple(chunk_data.shape)}")
    if S < 1:
        raise ValueError(f"S must be >= 1, got {S}")
    nl = _nlights(lights, shadows)
    f32, i32 = torch.float32, torch.int32
    _check(chunk_data, "chunk_data", f32, 4, dev)
    _check(zmin, "zmin", f32, 2, dev)
    if tuple(zmin.shape) != (nb, nchunks):
        raise ValueError(f"zmin must be {(nb, nchunks)}, got {tuple(zmin.shape)}")
    p = torch.as_tensor(params, dtype=f32, device=dev).contiguous()
    if p.shape != (64,):
        raise ValueError(f"params must be (64,), got {tuple(p.shape)}")
    if lights is None:
        # the kernel reads no light input; hand it valid dummy pointers
        lparams = lrec = torch.zeros((1, 16), dtype=f32, device=dev)
        loffs = lcnt = torch.zeros((1, 1), dtype=i32, device=dev)
        lkmax = torch.zeros((1, 1), dtype=f32, device=dev)
    else:
        lparams, lrec, loffs, lcnt, lkmax = lights
        ncells = grid_n * grid_n
        _check(lparams, "lparams", f32, 2, dev)
        if tuple(lparams.shape) != (nl, 16):
            raise ValueError(f"lparams must be ({nl}, 16), got "
                             f"{tuple(lparams.shape)}")
        if nl > MAX_LIGHTS:
            raise ValueError(f"{nl} lights given; the kernel takes at most "
                             f"{MAX_LIGHTS}")
        _check(lrec, "lrec", f32, 2, dev)
        if lrec.shape[1] != 8:
            raise ValueError(f"lrec must be (M, 8), got {tuple(lrec.shape)}")
        for t, name, dt in ((loffs, "loffs", i32), (lcnt, "lcnt", i32),
                            (lkmax, "lkmax", f32)):
            _check(t, name, dt, 2, dev)
            if tuple(t.shape) != (nl, ncells):
                raise ValueError(f"{name} must be ({nl}, {ncells}), got "
                                 f"{tuple(t.shape)}")
        if lrec.shape[0] == 0:
            lrec = torch.zeros((1, 8), dtype=f32, device=dev)
    nocc = _nocc(other, nl, shadows)
    if other is None:
        # the sphere-only kernel reads none of these; valid dummy pointers
        orec = occ = torch.zeros((1, 16), dtype=f32, device=dev)
        ooffs = ocnt = torch.zeros(1, dtype=i32, device=dev)
    else:
        orec, ooffs, ocnt, occ = other
        _check(orec, "orec", f32, 2, dev)
        if orec.shape[1] != 16:
            raise ValueError(f"orec must be (M, 16), got {tuple(orec.shape)}")
        for t, name in ((ooffs, "ooffs"), (ocnt, "ocnt")):
            _check(t, name, i32, 1, dev)
            if t.shape[0] != nb:
                raise ValueError(f"{name} must be ({nb},), got {tuple(t.shape)}")
        if orec.shape[0] == 0:
            orec = torch.zeros((1, 16), dtype=f32, device=dev)
        if nocc:
            _check(occ, "occ", f32, 3, dev)
        else:
            occ = torch.zeros((1, 16), dtype=f32, device=dev)
    lo, hi = _tile_range(tiles, nb)
    out = torch.empty((hi - lo, 3 * P), dtype=f32, device=dev)
    if hi == lo:
        return out
    lib = load_mega_render()
    ptr = ctypes.c_void_p
    batch, state = hi - lo, None
    if peel and 4 * (8 + (nl - 1) * P + 8 * S * P) > PEEL_SMEM_BYTES:
        batch = max(1, (256 << 20) // (4 * 8 * S * P))
        state = torch.empty((min(batch, hi - lo), 8 * S * P), dtype=f32,
                            device=dev)
    with torch.cuda.device(dev):   # the launch goes to the tensors' card
        for t0 in range(lo, hi, batch):
            rc = lib.mega_render_launch(
                ptr(p.data_ptr()), ptr(lparams.data_ptr()),
                ptr(chunk_data.data_ptr()), ptr(zmin.data_ptr()),
                ptr(lrec.data_ptr()), ptr(loffs.data_ptr()),
                ptr(lcnt.data_ptr()), ptr(lkmax.data_ptr()),
                ptr(orec.data_ptr()), ptr(ooffs.data_ptr()),
                ptr(ocnt.data_ptr()), ptr(occ.data_ptr()),
                ptr(out[t0 - lo:].data_ptr()), min(batch, hi - t0), t0,
                nchunks, tiles_x, S, int(seed) & 0xFFFFFFFF, grid_n, nl, nocc,
                eps, float(np.float32(1.0 / S)), int(bool(perspective)),
                int(bool(shadows)), int(other is not None), int(peel), n_peel,
                ptr(None if state is None else state.data_ptr()),
                ptr(torch.cuda.current_stream(dev).cuda_stream),
            )
            if rc != 0:
                raise RuntimeError(
                    f"mega_render kernel launch failed: CUDA error {rc}")
            launches += 1
    return out


def kernel_attrs(*, perspective: bool, shadows: bool, ao: bool, other: bool,
                 peel: bool, S: int = 1, nlights: int = 1) -> dict:
    """The compiled kernel variant a launch with these flags picks:
    registers a thread, local (spill) bytes a thread, static shared bytes,
    and the blocks an SM holds at once (the CUDA occupancy calculator, with
    a peel launch's state in shared memory for S samples and nlights
    lights).  Needs the card."""
    from ._build import load_mega_render

    out = (ctypes.c_int * 4)()
    rc = load_mega_render().mega_render_attrs(
        int(perspective), int(shadows), int(ao), int(other), int(peel), S,
        nlights, ctypes.c_void_p(ctypes.addressof(out)))
    if rc != 0:
        raise RuntimeError(f"mega_render_attrs failed: CUDA error {rc}")
    return dict(registers=out[0], local_bytes=out[1], static_smem=out[2],
                blocks_per_sm=out[3])


def count_work(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)``, a plain version built on this module's
    passes, and return the tests it did, by kind: "sphere" (ray x candidate
    in the chunks the early exit left), "cylring" (ray x tile cyl/ring
    record), "record" (shadow records the cell walks read up to their first
    occluder or stop), "cull" (occluder-table entries culled per tile and
    sample group) and "occluder" (ray x entry that passed the cull); and
    from ``mega_render_plain`` the counts "chunk" (candidate chunks a tile
    reads: its deepest walk over its peels), "lit" (primary-light walks)
    and "peel<p>" (live tiles that run peel p)."""
    global _work
    _work = {}
    try:
        fn(*args, **kwargs)
        return _work
    finally:
        _work = None


def plain_work(*args, **kwargs) -> dict:
    """The tests ``mega_render_plain`` does, by kind (``count_work``)."""
    return count_work(mega_render_plain, *args, **kwargs)


def mega_render(chunk_data, *args, **kwargs) -> torch.Tensor:
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    if chunk_data.device.type == "cuda":
        return mega_render_cuda(chunk_data, *args, **kwargs)
    if chunk_data.device.type == "cpu":
        return mega_render_plain(chunk_data, *args, **kwargs)
    raise ValueError(f"no render path for device {chunk_data.device}")


def render_image_mega(chunk_data, zmin, lights, params, seed, *, S: int,
                      width: int, height: int, tiles_x: int, tiles_y: int,
                      grid_n: int, eps: float, perspective: bool,
                      shadows: bool, quantized: bool = False,
                      other=None, n_peel: int = 1,
                      peel1: bool = False) -> torch.Tensor:
    """Full-frame render -> (height, width, 3) f32 RGB, or uint8 (rounded)
    when ``quantized`` (the device serving path).

    ``chunk_data`` / ``zmin`` come from ``gather_chunk_data`` and
    ``build_screen_bins``; ``lights`` from ``stack_lights`` (None: no
    shadows, primary light only); ``other`` holds the cylinders and rings
    (``OtherRecords``, with one occluder table per light), or None.
    ``n_peel`` > 1 or ``peel1`` turns transparency peeling on."""
    nb = chunk_data.shape[0]
    if nb != tiles_x * tiles_y:
        raise ValueError(f"{nb} tiles given for a {tiles_x}x{tiles_y} grid")
    out = mega_render(
        chunk_data, zmin, lights, params, seed,
        S=S, tiles_x=tiles_x, grid_n=grid_n, eps=eps,
        perspective=perspective, shadows=shadows, other=other,
        n_peel=n_peel, peel1=peel1,
    )
    img = out.view(tiles_y, tiles_x, 3, TILE_PX, TILE_PX)
    img = img.permute(0, 3, 1, 4, 2).reshape(tiles_y * TILE_PX,
                                              tiles_x * TILE_PX, 3)
    img = torch.flip(img[:height, :width], dims=[0])
    if quantized:
        img = torch.clamp(torch.round(img * 255.0), 0.0, 255.0).to(torch.uint8)
    return img


def render_image_mega_banded(scene, bins, lights, params, seed, *, S: int,
                             width: int, height: int, grid_n: int,
                             eps: float, perspective: bool, shadows: bool,
                             quantized: bool = False, other=None,
                             n_peel: int = 1, peel1: bool = False,
                             max_band_bytes: int = 2 << 30) -> torch.Tensor:
    """``render_image_mega`` in bands of tile rows, for a frame whose
    candidate records pass the memory budget
    (``mdapy_tpu/render/megakernel.py:2085``).

    The sphere table is packed once.  Band b (of ``rows_band`` tile rows,
    the most whose records fit in ``max_band_bytes`` and that divide
    ``tiles_y``) gathers its own records, moves the image plane's lower
    left corner up by b * band_h * ``params[9:12]`` and seeds its AA hash
    with ``seed + 9973 * b`` (the kernel keys the hash on the band's own
    tile ids, which restart at 0); the bands run top band first, stack, and
    the top pad is cropped.  ``lights`` and ``other`` (with its occluder
    tables) are the whole frame's, as for ``render_image_mega``."""
    from .gather import gather_chunk_data, pack_sphere_table

    tiles_x, tiles_y = bins.tiles_x, bins.tiles_y
    nb, nchunks, ch = bins.sph_chunks.shape
    bytes_per_row = tiles_x * nchunks * 8 * ch * 4
    rows_band = max(1, min(tiles_y, max_band_bytes // max(bytes_per_row, 1)))
    while tiles_y % rows_band:
        rows_band -= 1
    table = pack_sphere_table(scene.sph_center, scene.sph_radius,
                              scene.sph_color)
    imgs = []
    for b in range(tiles_y // rows_band - 1, -1, -1):   # top band first
        b0, b1 = b * rows_band * tiles_x, (b + 1) * rows_band * tiles_x
        cd = gather_chunk_data(bins.sph_chunks[b0:b1], scene.sph_center,
                               scene.sph_radius, scene.sph_color, table=table)
        imgs.append(render_mega_band(
            cd, bins.sph_zmin, lights, params, seed, b, rows_band=rows_band,
            S=S, width=width, tiles_x=tiles_x, grid_n=grid_n, eps=eps,
            perspective=perspective, shadows=shadows, quantized=quantized,
            other=other, n_peel=n_peel, peel1=peel1))
    img = torch.cat(imgs, dim=0)
    pad_top = tiles_y * TILE_PX - height
    return img[pad_top:] if pad_top else img


def render_mega_band(chunk_data, zmin, lights, params, seed, band: int, *,
                     rows_band: int, tiles_x: int, other=None,
                     **kw) -> torch.Tensor:
    """Band ``band`` (counted from the bottom) of ``rows_band`` tile rows of
    a frame -> (rows_band * 16, width, 3): ``render_image_mega`` with the
    image plane's lower left corner moved up by ``band * band_h`` rows in
    float32 and the AA hash seeded with ``seed + 9973 * band`` (the kernel
    keys the hash on the band's own tile ids, which restart at 0), as the
    JAX package's banded and sharded renders do.  ``chunk_data`` holds the
    band's tiles alone; ``zmin`` and ``other`` (its per-tile offsets and
    counts) are the whole frame's.  The banded render and the sharded
    renders of ``render/distributed.py`` and ``render/multihost.py`` call
    it, one band a call."""
    b0, b1 = band * rows_band * tiles_x, (band + 1) * rows_band * tiles_x
    band_h = rows_band * TILE_PX
    p = np.array(params, np.float32)
    p[3:6] = p[3:6] + np.float32(band * band_h) * p[9:12]
    oth = None if other is None else other._replace(
        ooffs=other.ooffs[b0:b1], ocnt=other.ocnt[b0:b1])
    return render_image_mega(
        chunk_data, zmin[b0:b1], lights, p, seed + band * BAND_SEED_STRIDE,
        height=band_h, tiles_x=tiles_x, tiles_y=rows_band, other=oth, **kw)
