"""Edge cases of the tiled tracer's two kernels, numpy only.

Shared by ``tests/test_torch_tile_cases.py`` (the port's plain versions
against the JAX package and a numpy brute force on the CPU) and
``chip_smoke.py`` phase [2t] (the hand kernels against the plain versions
on the card, at max |diff| 0).

``HIT_CASES`` names the chunked closest hit's argument sets (``hit_case``):
R of 1, 31, 1,664 (one slice), 3,328 (two) and 4,097 (three slices); one
chunk and many; every ray from one origin (the perspective camera) and
rays from their own origins, and a slice with one ray off the shared
origin; equal t across chunks and across lanes (the same sphere in two
lanes of chunk 0 and in chunk 1, each in its own colour); padded slots (r
= -1 and r = 0), rays with tcap = -1e18, and a tile with no live chunk.

``SHADOW_CASES`` names the shadow filter's (``shadow_case``): cells of 0,
1, 31-33, 63-65 and 200 records; an occluder at record 0, at record 32 and
at the last; key stops in mid-step with a record past them that would
occlude (so a walk that ignored the stop would differ); a first key below
tau + eps; no lit ray, warps with one lit lane and warps with all 32; and
an empty record table (M = 0).

``closest_hit_numpy`` and ``shadow_filter_numpy`` are the brute force: the
walks as the JAX kernels define them, ray by ray, in float32.
"""

import numpy as np

CH = 128
SLICE = 2048
BIG = np.float32(1e18)
BIG_DEPTH = np.float32(1e17)
EPS = np.float32(4e-4)
GRID = 4          # the shadow cases' light grid is GRID x GRID cells


def _chunks(rng, nchunks, origin, camera, front_r, dead):
    """One tile's (nchunks, 8, CH) records, depth-sorted, and its zmin (a
    lower bound of t from here on: the distance from the camera less r, or
    for rays along +z the depth less r)."""
    n = nchunks * CH
    c = np.stack([rng.uniform(-4.0, 4.0, n), rng.uniform(-4.0, 4.0, n),
                  rng.uniform(6.0, 30.0, n)], 1)
    r = rng.uniform(0.2, 0.7, n)
    rgba = rng.uniform(0.1, 1.0, (n, 4))
    def depth(c, r):
        return (np.linalg.norm(c - origin, axis=-1) if camera else c[..., 2]) - r

    order = np.argsort(depth(c, r))
    c, r, rgba = c[order], r[order], rgba[order]
    rec = np.concatenate([c, r[:, None], rgba], 1).reshape(nchunks, CH, 8)
    if dead:
        # padded slots, as gather_chunk_data writes them (r = -1), and r = 0
        rec[-1, CH // 2:, 3] = -1.0
        rec[0, 5:9, 3] = 0.0
    if front_r:
        # one sphere in front of the rest, in lanes 3 and 70 of chunk 0 and
        # lane 0 of chunk 1, each in its own colour: equal t across lanes and
        # across chunks
        front = np.array([0.0, 0.0, 4.0, front_r])
        for c_, j, col in ((0, 3, 0.25), (0, 70, 0.5), (min(1, nchunks - 1), 0, 0.75)):
            rec[c_, j, :4] = front
            rec[c_, j, 4:] = col
    live = rec[..., 3] > 0
    zmin = np.where(live, depth(rec[..., :3], rec[..., 3]), BIG_DEPTH).min(1)
    zmin = np.minimum.accumulate(zmin[::-1])[::-1]   # a lower bound from here on
    return rec.transpose(0, 2, 1).astype(np.float32), zmin.astype(np.float32)


def hit_case(*, R, nchunks, nb=3, camera=True, seed=0, front_r=0.3,
             dead=True):
    """The closest hit's arguments (o, d, tcap, zmin, chunk_data) as float32
    numpy arrays: nb tiles of R rays toward a box of spheres; tile nb - 1
    has no live chunk.  A front sphere of radius front_r (none at 0) that
    covers every camera ray ends the walk after chunk 0."""
    rng = np.random.default_rng(seed)
    origin = np.array([0.0, 0.0, 0.0])
    x = rng.uniform(-0.2, 0.2, (nb, R))
    y = rng.uniform(-0.2, 0.2, (nb, R))
    if camera:
        d = np.stack([x, y, np.ones_like(x)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(origin, d.shape).copy()
        if R > SLICE:
            o[0, R - 1, 0] = np.float32(1e-3)   # the last slice of tile 0 is not
    else:
        o = np.stack([20.0 * x, 20.0 * y, np.zeros_like(x)], -1)
        d = np.broadcast_to([0.0, 0.0, 1.0], o.shape).copy()
    # where each ray leaves the box z < 31; -1e18 for a tenth of them
    tcap = np.where(rng.uniform(size=(nb, R)) < 0.1, -1e18, 31.0 / d[..., 2])
    recs, zmins = zip(*(_chunks(rng, nchunks, origin, camera, front_r, dead)
                        for _ in range(nb)))
    cd, zmin = np.stack(recs), np.stack(zmins)
    cd[-1, :, 3] = -1.0
    zmin[-1] = BIG_DEPTH
    f = np.float32
    return (o.astype(f), d.astype(f), tcap.astype(f), zmin.astype(f),
            np.ascontiguousarray(cd, f))


# name -> hit_case's arguments
HIT_CASES = {
    "R1_one_chunk": dict(R=1, nchunks=1, front_r=0.0),
    "R31_own_origins": dict(R=31, nchunks=3, camera=False, seed=1),
    "R1664_one_chunk": dict(R=1664, nchunks=1, seed=2),
    "R1664_own_origins": dict(R=1664, nchunks=6, camera=False, seed=3),
    "R3328_camera": dict(R=3328, nchunks=6, seed=4),
    "R3328_front": dict(R=3328, nchunks=4, seed=5, front_r=1.5, dead=False),
    "R4097_camera": dict(R=4097, nchunks=4, seed=6),
    "R4097_own_origins": dict(R=4097, nchunks=2, nb=2, camera=False, seed=7),
}


def closest_hit_numpy(o, d, tcap, zmin, chunk_data, eps=EPS):
    """Brute force: each slice of at most SLICE rays walks the chunks while
    zmin[c] < max(min(best_t, tcap)); strict < keeps the earlier chunk,
    argmin the lower lane."""
    f = np.float32
    nb, R = tcap.shape
    best_t = np.full((nb, R), BIG, f)
    rec = np.zeros((nb, R, 8), f)
    n = -(-R // SLICE)
    for tile in range(nb):
        for g in range(n):
            lo, hi = g * R // n, (g + 1) * R // n
            oo, dd, cap = o[tile, lo:hi], d[tile, lo:hi], tcap[tile, lo:hi]
            bt = np.full(hi - lo, BIG, f)
            bi = np.full(hi - lo, -1)
            need = cap.max()
            for c in range(zmin.shape[1]):
                if not zmin[tile, c] < need:
                    break
                cx, cy, cz, r = chunk_data[tile, c, :4]
                ocx = oo[:, 0:1] - cx
                ocy = oo[:, 1:2] - cy
                ocz = oo[:, 2:3] - cz
                b = ocx * dd[:, 0:1] + ocy * dd[:, 1:2] + ocz * dd[:, 2:3]
                ccb = ocx * ocx + ocy * ocy + ocz * ocz - r * r
                disc = b * b - ccb
                ok = (disc >= 0) & (r > 0)
                sq = np.sqrt(np.where(ok, disc, f(0)))
                t1 = -b - sq
                t2 = sq - b
                t = np.where(t1 > eps, t1, np.where(t2 > eps, t2, BIG))
                t = np.where(ok, t, BIG)
                j = t.argmin(1)
                tm = t[np.arange(hi - lo), j]
                better = tm < bt
                bt = np.where(better, tm, bt)
                bi = np.where(better, c * CH + j, bi)
                need = np.minimum(bt, cap).max()
            best_t[tile, lo:hi] = bt
            hit = bi >= 0
            rec[tile, lo:hi][hit] = chunk_data[tile, bi[hit] // CH, :, bi[hit] % CH]
    return best_t, rec


# ---- the shadow filter ------------------------------------------------------

# records per cell, row by row of the 4x4 grid
CELL_SIZES = (0, 1, 31, 32, 33, 63, 64, 65, 200, 2, 5, 33, 64, 0, 1, 40)


def _records(rng):
    """(M, 8) rows [cu, cv, ck, r, key, alpha, 0, 0] per cell by descending
    key, with offs and cnt; key = ck + r (the far depth) except where a
    case makes it lower on purpose."""
    rows, offs, cnt = [], [], []
    for cell, n in enumerate(CELL_SIZES):
        gx, gy = cell % GRID, cell // GRID
        cu = gx + rng.uniform(0.05, 0.95, n)
        cv = gy + rng.uniform(0.05, 0.95, n)
        r = rng.uniform(0.02, 0.06, n)
        ck = np.sort(rng.uniform(0.0, 50.0, n))[::-1]
        offs.append(sum(len(x) for x in rows))
        cnt.append(n)
        rows.append(np.stack([cu, cv, ck, r, ck + r, np.ones(n), np.zeros(n),
                              np.zeros(n)], 1))
    lrec = np.concatenate(rows).astype(np.float32)
    return lrec, np.array(offs, np.int32), np.array(cnt, np.int32)


def _ray_at(lrec, off, k, tau):
    """(u, v, tau) on the disc of record k of the cell at off."""
    return np.array([lrec[off + k, 0], lrec[off + k, 1], tau])


def shadow_case(*, R, nb=3, seed=0, lit_share=0.35, empty=False,
                offgrid=False):
    """The shadow filter's arguments (uvt, cellxy, lit, lrec, offs, cnt) as
    numpy arrays (float32, int32): random rays over the grid, then rays
    placed on purpose (occluders at records 0, 32 and last of a cell, key
    stops in mid-step with an occluding record past them, a first key under
    tau + eps) and lit patterns by warp (none, one lane, all 32).  With
    offgrid, some rays name a cell outside the grid, which the port clamps
    axis by axis (the JAX kernel takes cells inside the grid only)."""
    rng = np.random.default_rng(seed)
    if empty:
        lrec = np.zeros((0, 8), np.float32)
        offs = np.zeros(GRID * GRID, np.int32)
        cnt = np.zeros(GRID * GRID, np.int32)
    else:
        lrec, offs, cnt = _records(rng)
    n = nb * R
    uvt = np.stack([rng.uniform(0, GRID, n), rng.uniform(0, GRID, n),
                    rng.uniform(-5.0, 55.0, n)], 1)
    lit = (rng.uniform(size=n) < lit_share).astype(np.int32)
    # lit patterns by warp: none, one lane, all 32
    if n >= 96 and lit_share:
        lit[0:32] = 0
        lit[32:64] = 0
        lit[40] = 1
        lit[64:96] = 1
    if not empty and n >= 192 and lit_share:
        placed = []
        for cell in np.nonzero(cnt >= 33)[0]:
            off, c = int(offs[cell]), int(cnt[cell])
            for k in sorted({0, 32, c - 1}):
                placed.append(_ray_at(lrec, off, k, lrec[off + k, 2] - 1.0))
        # key stops in mid-step: record 40 of the 65-record cell (a warp's
        # second step) and record 10 of the 33-record cell (the serial
        # stage) sit at the ray with a key under tau + eps; the next record
        # covers the ray from above, but the walk ends first
        for cell, k in ((7, 40), (4, 10)):
            off = int(offs[cell])
            tau = lrec[off + k, 4] + 0.5
            lrec[off + k:off + k + 2, :2] = lrec[off + k, :2]
            lrec[off + k + 1, 2] = tau + 2.0          # ck above the point,
            lrec[off + k + 1, 4] = lrec[off + k, 4]   # its key below tau + eps
            placed.append(_ray_at(lrec, off, k, tau))
        # the first key of the 64-record cell under tau + eps
        off = int(offs[6])
        placed.append(_ray_at(lrec, off, 0, lrec[off, 4] + 1.0))
        placed = np.array(placed)
        at = 96 + rng.choice(n - 96, len(placed), replace=False)
        uvt[at] = placed
        lit[at] = 1
    cell = np.clip(np.floor(uvt[:, :2]).astype(np.int32), 0, GRID - 1)
    if offgrid:
        cell[::7] += np.array([GRID, -3], np.int32)
    return (uvt.reshape(nb, R, 3).astype(np.float32),
            cell.reshape(nb, R, 2), lit.reshape(nb, R), lrec, offs, cnt)


# name -> shadow_case's arguments; grid_n = GRID
SHADOW_CASES = {
    "R1": dict(R=1, nb=2, lit_share=1.0),
    "R31_offgrid": dict(R=31, seed=1, offgrid=True),
    "R384": dict(R=384, nb=4, seed=2),
    "R3328": dict(R=3328, nb=2, seed=3),
    "R384_none_lit": dict(R=384, nb=2, seed=4, lit_share=0.0),
    "R128_no_records": dict(R=128, nb=2, seed=5, empty=True),
}


def shadow_filter_numpy(uvt, cellxy, lit, lrec, offs, cnt, grid_n=GRID,
                        eps=EPS, stops=True):
    """Brute force: a lit ray walks its cell's records in order and is
    blocked by the first that occludes it, unless a key at or below tau +
    eps comes first (with stops=False, a walk that ignores the keys)."""
    nb, R = lit.shape
    filt = np.ones(nb * R, np.float32)
    uvt = uvt.reshape(-1, 3)
    cxy = np.clip(cellxy.reshape(-1, 2), 0, grid_n - 1)
    for i in np.nonzero(lit.reshape(-1) > 0)[0]:
        u, v, tau = uvt[i]
        te = tau + np.float32(eps)
        cell = cxy[i, 1] * grid_n + cxy[i, 0]
        for k in range(int(offs[cell]), int(offs[cell]) + int(cnt[cell])):
            cu, cv, ck, r, key = lrec[k, :5]
            if stops and key <= te:
                break
            du, dv = cu - u, cv - v
            s2 = r * r - (du * du + dv * dv)
            q = te - ck
            if s2 > 0 and r > 0 and (q < 0 or s2 > q * q):
                filt[i] = 0.0
                break
    return filt.reshape(nb, R)


def occluder_index_numpy(uvt, cellxy, lit, lrec, offs, cnt, grid_n=GRID,
                         eps=EPS):
    """For each lit ray the index in its cell of the record that blocks it
    (-1 when none does): what the cases are built to reach."""
    out = []
    uvt = uvt.reshape(-1, 3)
    cxy = np.clip(cellxy.reshape(-1, 2), 0, grid_n - 1)
    for i in np.nonzero(lit.reshape(-1) > 0)[0]:
        u, v, tau = uvt[i]
        te = tau + np.float32(eps)
        cell = cxy[i, 1] * grid_n + cxy[i, 0]
        hit = -1
        for k in range(int(cnt[cell])):
            cu, cv, ck, r, key = lrec[int(offs[cell]) + k, :5]
            if key <= te:
                break
            s2 = r * r - ((cu - u) * (cu - u) + (cv - v) * (cv - v))
            q = te - ck
            if s2 > 0 and r > 0 and (q < 0 or s2 > q * q):
                hit = k
                break
        out.append((int(cnt[cell]), hit))
    return out
