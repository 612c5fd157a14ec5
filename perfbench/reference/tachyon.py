"""Plain reference of the image that mdapy's TachyonRender draws of a scene
of opaque spheres, pixel by pixel, in plain PyTorch.

It follows what the renderer's documentation and the Tachyon CPU renderer
it copies define, and computes it the direct way: every ray is tested
against every sphere, with no screen bins, light grids, chunks or early
exits.  It imports nothing of the program.

* Camera (Tachyon ``camera.c``): world vectors are z-flipped; view =
  normalize(dir), right = normalize(up x view), up2 = normalize(view x
  right); the image plane is (W/H)/zoom by 1/zoom with zoom = 0.5 /
  tan(fov/2); pixel (x, y), counted from the lower left, is sampled at
  lowleft + (x + o + jx) * right_step + (y + o + jy) * up_step, with o = 0
  when AO is on or more than 4 AA samples are taken and 1 otherwise; the
  image is flipped so that its first row is the top.
* Samples: S = aa_samples + 1 rays a pixel; sample 0 has no jitter, sample
  s > 0 the renderer's 32-bit avalanche hash of (16x16 tile, s, seed,
  pixel within the tile), two 16-bit halves giving (jx, jy) in [-1/2, 1/2).
* Closest hit: the nearest root t > eps (4e-4) of |o + t d - c| = r over
  every sphere of radius > 0; no hit gives the background.
* Shading: n = normalize(h - c), turned to face the ray; each light adds
  [n.L > 1/512] * n.L * colour * visibility; the pixel's sample is
  rgb * (0.8 * sum + 0.3), and the pixel the mean of its samples, cut to
  bytes by truncation (by rounding with ``rounded``: the frame the
  renderer leaves on the device).
* Lights: the camera's light (its direction is -normalize(flip(0.2 right -
  0.2 up - view))) of intensity ``direct_light_intensity``, times 0.2 with
  AO; with AO also 2 * K sky lights, K = ao_samples // 2 Fibonacci
  directions of the upper hemisphere and their opposites, each of colour
  4 / (2K) * ao_brightness.
* Visibility: a point is shadowed from light L when a sphere crosses the
  ray from it along L beyond eps.  The camera light is tested at each
  sample's own hit point (when shadows are on); each sky light at sample
  0's hit point, and that visibility is shared by every sample of the
  pixel (where sample 0 is not lit by it, the others count as visible).
* Alpha: with ``transparent``, 0 where every channel lies within 1.5 of
  the background's byte, else 255; without, 255.

``render_pixels`` computes the chosen pixels in the dtype given: float64
for the reference, a lower precision for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 4e-4
MINCONTRIB = 1.0 / 512.0
FLIP = np.array([1.0, 1.0, -1.0])
TILE = 16
BIG = 1e30
# elements of one (rays, spheres) temporary
BLOCK_ELEMS = 1 << 26


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def camera_frame(camera: dict, width: int, height: int) -> dict:
    """Ray origin, image-plane corner and steps, and the camera light's
    direction, in flipped space (float64 numpy)."""
    if not camera["is_perspective"]:
        raise ValueError("the reference renders perspective cameras only")
    pos = np.asarray(camera["position"], np.float64)
    direction = np.asarray(camera["direction"], np.float64)
    up = np.asarray(camera["up"], np.float64)
    d0 = _unit(direction)
    r0 = _unit(np.cross(d0, _unit(up)))
    u0 = _unit(np.cross(r0, d0))
    light = -_unit((0.2 * r0 - 0.2 * u0 - d0) * FLIP)
    view = _unit(direction * FLIP)
    right = _unit(np.cross(_unit(up * FLIP), view))
    up2 = _unit(np.cross(view, right))
    zoom = 0.5 / math.tan(0.5 * float(camera["field_of_view"]))
    px, py = (width / height) / zoom, 1.0 / zoom
    return {"origin": pos * FLIP,
            "lowleft": view - 0.5 * px * right - 0.5 * py * up2,
            "right_step": px * right / width, "up_step": py * up2 / height,
            "light": light}


def jitter(tile: np.ndarray, s: np.ndarray, seed: int, pix: np.ndarray):
    """(jx, jy) in [-1/2, 1/2) of sample ``s`` of pixel ``pix`` (0..255)
    of tile ``tile``: 32-bit wrapping arithmetic in uint64."""
    m = np.uint64(0xFFFFFFFF)

    def u(x):
        return np.asarray(x, np.int64).astype(np.uint64) & m

    h0 = (u(tile) * np.uint64(0x9E3779B9) + u(s) * np.uint64(0xC2B2AE35)
          + u(seed) * np.uint64(374761393)) & m
    v = (u(pix) * np.uint64(0x85EBCA6B) + h0) & m
    v ^= v >> np.uint64(16)
    v = (v * np.uint64(2127912214)) & m
    v ^= v >> np.uint64(15)
    v = (v * np.uint64(0xC2B2AE35)) & m
    v ^= v >> np.uint64(16)
    jx = (v & np.uint64(0xFFFF)).astype(np.float64) / 65536.0 - 0.5
    jy = ((v >> np.uint64(16)) & np.uint64(0xFFFF)).astype(np.float64) / 65536.0 - 0.5
    return jx, jy


def sky_directions(ao_samples: int) -> np.ndarray:
    """The 2K sky-light directions: K stratified Fibonacci directions of
    the upper hemisphere, then their opposites."""
    k = max(1, int(ao_samples) // 2)
    i = np.arange(k, dtype=np.float64) + 0.5
    phi = i * (np.pi * (3.0 - np.sqrt(5.0)))
    z = i / k
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    hemi = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)
    return np.concatenate([hemi, -hemi])


def _blocks(n_rays: int, n_spheres: int):
    step = max(1, BLOCK_ELEMS // max(n_spheres, 1))
    for a in range(0, n_rays, step):
        yield slice(a, min(n_rays, a + step))


def _closest_hit(org, dirs, centers, radii):
    """Nearest t > eps of each ray (BIG on a miss) and its sphere's index;
    every ray starts at ``org``."""
    rel = centers - org                                  # (N, 3)
    cc = (rel * rel).sum(dim=1) - radii * radii
    alive = radii > 0
    t_best = torch.empty(dirs.shape[0], dtype=dirs.dtype, device=dirs.device)
    i_best = torch.empty(dirs.shape[0], dtype=torch.int64, device=dirs.device)
    for blk in _blocks(dirs.shape[0], centers.shape[0]):
        b = dirs[blk] @ rel.T                            # d.(c - o)
        disc = b * b - cc
        ok = (disc >= 0) & alive
        sq = torch.sqrt(torch.clamp(disc, min=0))
        near, far = b - sq, b + sq
        t = torch.where(near > EPS, near, torch.where(far > EPS, far, BIG))
        t = torch.where(ok, t, torch.full_like(t, BIG))
        t_best[blk], i_best[blk] = t.min(dim=1)
    return t_best, i_best


def _shadowed(points, light, centers, radii):
    """True where a sphere crosses the ray from each point along ``light``
    beyond eps."""
    L = light
    a = torch.tensor([1.0, 0.0, 0.0] if abs(float(L[0])) < 0.9
                     else [0.0, 1.0, 0.0], dtype=L.dtype, device=L.device)
    e1 = torch.linalg.cross(L, a)
    e1 = e1 / torch.linalg.norm(e1)
    e2 = torch.linalg.cross(L, e1)
    cu, cv, ck = centers @ e1, centers @ e2, centers @ L
    pu, pv, pk = points @ e1, points @ e2, points @ L
    r2 = radii * radii
    alive = radii > 0
    out = torch.zeros(points.shape[0], dtype=torch.bool, device=points.device)
    for blk in _blocks(points.shape[0], centers.shape[0]):
        du = cu[None] - pu[blk, None]
        dv = cv[None] - pv[blk, None]
        s2 = r2[None] - du * du - dv * dv
        q = pk[blk, None] + EPS - ck[None]
        occ = (s2 > 0) & alive[None] & ((q < 0) | (s2 > q * q))
        out[blk] = occ.any(dim=1)
    return out


def render_pixels(positions, colors, radii, camera: dict, settings: dict,
                  rows: np.ndarray, cols: np.ndarray, *,
                  dtype=torch.float64, device="cpu") -> np.ndarray:
    """RGBA bytes (n, 4) of the pixels (rows[k], cols[k]) of the image, rows
    counted from the top.  ``settings``: width, height, antialiasing,
    aa_samples, ao, ao_samples, ao_brightness, shadows,
    direct_light_intensity, background, transparent, seed, and optionally
    rounded."""
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            return _render(positions, colors, radii, camera, settings, rows,
                           cols, dtype, torch.device(device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32


def _render(positions, colors, radii, camera, st, rows, cols, dtype, dev):
    W, H = int(st["width"]), int(st["height"])
    aa = bool(st["antialiasing"])
    S = (int(st["aa_samples"]) if aa else 0) + 1
    ao = bool(st["ao"])
    colors = np.asarray(colors, np.float64)
    keep = colors[:, 3] > 0
    if not np.all(colors[keep, 3] >= 1.0):
        raise ValueError("the reference renders opaque spheres only")

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev).to(dtype)

    centers = t(np.asarray(positions, np.float64)[keep] * FLIP)
    rad = t(np.asarray(radii, np.float64)[keep])
    rgb = t(colors[keep, :3])
    fr = camera_frame(camera, W, H)

    # sample positions on the image plane, lower-left pixel coordinates
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    n = rows.size
    y, x = H - 1 - rows, cols
    tiles_x = -(-W // TILE)
    tile = (y // TILE) * tiles_x + x // TILE
    pix = (y % TILE) * TILE + x % TILE
    s = np.arange(S)
    jx, jy = jitter(tile[:, None], s[None], st["seed"], pix[:, None])
    jx[:, 0] = jy[:, 0] = 0.0
    off = 0.0 if (ao or (aa and int(st["aa_samples"]) > 4)) else 1.0
    sx = t(x[:, None] + off + jx)                        # (n, S)
    sy = t(y[:, None] + off + jy)
    d = (t(fr["lowleft"]) + sx[..., None] * t(fr["right_step"])
         + sy[..., None] * t(fr["up_step"]))
    d = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).reshape(n * S, 3)
    org = t(fr["origin"])

    t_hit, idx = _closest_hit(org, d, centers, rad)
    hit = t_hit < 0.5 * BIG
    idx = torch.where(hit, idx, 0)
    h = org + torch.where(hit, t_hit, 0)[:, None] * d
    nrm = h - centers[idx]
    nrm = nrm / torch.linalg.norm(nrm, dim=1, keepdim=True)
    nrm = torch.where(((nrm * d).sum(dim=1) > 0)[:, None], -nrm, nrm)

    lights = [(t(fr["light"]), float(st["direct_light_intensity"])
               * (0.2 if ao else 1.0), bool(st["shadows"]), False)]
    if ao:
        k2 = max(1, int(st["ao_samples"]) // 2)
        col = 4.0 / (2 * k2) * float(st["ao_brightness"])
        lights += [(t(dk), col, True, True) for dk in sky_directions(st["ao_samples"])]
    first = torch.zeros(n * S, dtype=torch.bool, device=dev)
    first[::S] = True
    total = torch.zeros(n * S, dtype=dtype, device=dev)
    for L, lightcol, tested, shared in lights:
        inten = nrm @ L
        lit = (inten > MINCONTRIB) & hit
        vis = torch.ones(n * S, dtype=dtype, device=dev)
        if tested:
            probe = lit & first if shared else lit
            sel = torch.nonzero(probe).flatten()
            blocked = _shadowed(h[sel], L, centers, rad)
            vis[sel] = torch.where(blocked, 0.0, 1.0).to(dtype)
            if shared:
                vis = vis.view(n, S)[:, :1].expand(n, S).reshape(-1)
        total = total + torch.where(lit, inten * lightcol * vis, 0)
    shade = 0.8 * total + 0.3
    bg = t(st["background"][:3])
    sample = torch.where(hit[:, None], rgb[idx] * shade[:, None], bg)
    mean = sample.view(n, S, 3).mean(dim=1)
    cut = torch.round if st.get("rounded") else torch.trunc
    q = torch.clamp(cut(mean * 255.0), 0, 255).to(torch.float64)
    q = q.cpu().numpy().astype(np.uint8)
    out = np.empty((n, 4), np.uint8)
    out[:, :3] = q
    if st["transparent"]:
        bgb = np.asarray(st["background"][:3], np.float32) * np.float32(255.0)
        near = np.abs(q.astype(np.float32) - bgb).max(axis=1) < 1.5
        out[:, 3] = np.where(near, 0, 255)
    else:
        out[:, 3] = 255
    return out
