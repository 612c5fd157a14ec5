"""The exact tracer: every ray against every primitive, in torch ops.

Port of ``mdapy_tpu/render/tracer.py``: the intersections ``_sphere_t``
(:58), ``_cyl_t`` (:73, the perpendicular components formed first, :82-87)
and ``_ring_t`` (:105), ``trace_closest`` (:127), ``occlusion`` (:142),
``shadow_filter`` (:152), ``_surface`` (:182), ``_shade_batch`` (:218) and
``render_image`` (:307).  The shading is Tachyon's, as there:

  rgb = base * (0.8 * (lit * light_scale * (N.L) * 0.9 * filt + ao) + 0.3)
  ao  = (2/K) * sum_k unoccluded_k * |N.d_k| * ao_brightness

with ``light_scale`` 0.2 when AO is on, ``MINCONTRIB`` the floor of a lit
point, K hemisphere rays per sample offset by ``eps * N``, and with
transparency ``max_trans`` peels composited along the ray.

The JAX tracer is XLA ops, not a Pallas kernel, so this one is torch ops:
on the caller's device, in the scene's dtype (float32 on the card, float64
for the CPU route and the gradient checks), and differentiable by autograd.
Four things differ from the JAX code in how, not in what, it computes:

  * **Blocks.** A (rays, primitives) intersection is computed in blocks of
    primitives under ``BLOCK_ELEMS``, with a running minimum and its index
    (ties to the lowest index, as ``jnp.argmin``; sphere < cylinder < ring
    on equal t), a running "any hit", or a running transmission product.
  * **Winners, then gradients.** The closest hit is found under
    ``torch.no_grad``; its t is taken again for the winning primitive alone,
    with the same formula, which is where the gradient of ``jnp.min`` goes.
    Blocked and shadow tests carry no gradient, as in JAX; a transmission
    product carries one to the alphas.
  * **The sphere's discriminant** is r^2 - |oc - b d|^2, formed as the
    cylinders' is (``_sph``); the JAX tracer's b^2 - (|oc|^2 - r^2) is the
    same number in exact arithmetic and loses about four digits of it in
    float32.
  * **Only the rays that count.** Shadow rays go out from lit points and AO
    rays from hit points, and a peel traces only the rays whose weight is
    still above 0: JAX traces the others and then discards them.

The draws are JAX's, bit for bit (``rng.py``): ``PRNGKey(seed)``, then
``fold_in(key, ci)`` for chunk ``ci`` of ``CHUNK`` pixels, ``split(k, 3)``
per AA sample with the jitter ``uniform(kjit, (CHUNK, 2))``, ``split(k)``
and ``normal(sub, (CHUNK, 3))`` per AO ray, and ``split(key, max_trans)``
for the peels.  The chunk stays the unit of drawing, whatever the unit of
computing: ``render_image(rows=...)`` renders a band of rows with the
draws of the whole frame.  ``normal`` goes through ``torch.erfinv``, which
is not XLA's polynomial (``rng.normal``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import ieee, rng
from .config import RenderConfig, quantize
from .scene import Scene

__all__ = ["RenderConfig", "render_image", "trace_closest", "occlusion",
           "shadow_filter", "quantize", "count_tests"]

MINCONTRIB = 1.0 / 512.0
BIG = 1e18
CHUNK = 16384          # pixels one chunk's draws cover (tracer.py:320)
# (rays x primitives) elements one block of a brute-force pass holds
BLOCK_ELEMS = 1 << 24
AMBIENT, DIFFUSE_K = 0.3, 0.8

KINDS = ("sphere", "cylinder", "ring")
# ray-primitive tests by kind since the last count_tests() reset
tests = dict.fromkeys(KINDS, 0)


def count_tests(reset: bool = True) -> dict:
    """The ray-primitive tests of the brute-force passes by kind since the
    last reset (every ray of a pass against every primitive slot)."""
    n = dict(tests)
    if reset:
        tests.update(dict.fromkeys(KINDS, 0))
    return n


# ---------------------------------------------------------------------------
# intersections on 3-tuples of broadcastable components
# ---------------------------------------------------------------------------


def _sqrt(x):
    # ieee.sqrt refines in place, which autograd cannot follow
    return torch.sqrt(x) if x.requires_grad else ieee.sqrt(x)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _rows(a):
    """(R, 3) -> three (R, 1) columns."""
    return tuple(a[:, i:i + 1] for i in range(3))


def _cols(a):
    """(C, 3) -> three (1, C) rows."""
    return tuple(a[None, :, i] for i in range(3))


def _xyz(a):
    return (a[..., 0], a[..., 1], a[..., 2])


def _vdot(a, b):
    """Dot products over the last axis of two (..., 3) tensors, summed x, y,
    z in that order on every device (a reduction's order is the device's)."""
    return _dot(_xyz(a), _xyz(b))


def _sph(o, d, c, r, eps):
    oc = _sub(o, c)
    b = _dot(oc, d)                     # d assumed unit
    # r^2 - |oc - b d|^2, the JAX tracer's b^2 - (|oc|^2 - r^2) with the
    # perpendicular part formed first, as its cylinders do: b^2 and |oc|^2
    # cancel in float32 at the camera's distance (config 4's float32
    # position gradients: cosine 0.70 against float64 with b^2 - c, 0.997
    # with this form)
    p = tuple(oc[i] - b * d[i] for i in range(3))
    disc = r * r - _dot(p, p)
    ok = (disc >= 0.0) & (r > 0.0)
    # the root's derivative is infinite at disc = 0 (a tangent ray, which
    # float32 rounding makes exact now and then): it takes the root of 0
    # through the discarded branch, so the gradient there is 0
    sq = _sqrt(torch.where(ok & (disc > 0.0), disc, 0.0))
    t1 = -b - sq
    t2 = -b + sq
    t = torch.where(t1 > eps, t1, torch.where(t2 > eps, t2, BIG))
    return torch.where(ok, t, BIG)


def _cyl(o, d, base, ahat, alen, r, eps):
    oc = _sub(o, base)
    dda = _dot(d, ahat)
    oca = _dot(oc, ahat)
    # the perpendicular vectors first: ``1 - dda^2`` and ``|oc|^2 - oca^2``
    # cancel in float32 for rays nearly parallel to long thin cylinders
    dp = tuple(d[i] - dda * ahat[i] for i in range(3))
    op = tuple(oc[i] - oca * ahat[i] for i in range(3))
    a2 = _dot(dp, dp)
    b = _dot(op, dp)
    c = _dot(op, op) - r * r
    disc = b * b - a2 * c
    live = (r > 0.0) & (disc >= 0.0) & (a2 > 1e-12)
    sq = _sqrt(torch.where(live & (disc > 0.0), disc, 0.0))
    inv_a2 = 1.0 / torch.where(a2 > 1e-12, a2, 1.0)
    t1 = (-b - sq) * inv_a2
    t2 = (-b + sq) * inv_a2
    s1 = oca + t1 * dda
    s2 = oca + t2 * dda
    ok1 = live & (t1 > eps) & (s1 >= 0.0) & (s1 <= alen)
    ok2 = live & (t2 > eps) & (s2 >= 0.0) & (s2 <= alen)
    return torch.where(ok1, t1, torch.where(ok2, t2, BIG))


def _ring(o, d, c, n, cn, rout, eps):
    dn = _dot(d, n)
    num = cn - _dot(o, n)
    big_dn = dn.abs() > 1e-12
    t = num / torch.where(big_dn, dn, 1.0)
    hit = tuple(o[i] + t * d[i] - c[i] for i in range(3))
    rho2 = _dot(hit, hit)
    ok = (rout > 0.0) & big_dn & (t > eps) & (rho2 <= rout * rout)
    return torch.where(ok, t, BIG)


def _axis(axis):
    """|axis| and the unit axis (``_cyl_t``'s ``alen`` and ``ahat``)."""
    alen = _sqrt(_dot(_xyz(axis), _xyz(axis)))
    return axis / alen.clamp(min=1e-30)[..., None], alen


def _sphere_t(o, d, centers, radii, eps):
    """Closest positive hit parameter per (ray, sphere) (R, C); BIG on a
    miss."""
    return _sph(_rows(o), _rows(d), _cols(centers), radii[None, :], eps)


def _cyl_t(o, d, base, axis, radii, eps):
    """Finite (uncapped) cylinder along ``axis`` from ``base`` (R, C)."""
    ahat, alen = _axis(axis)
    return _cyl(_rows(o), _rows(d), _cols(base), _cols(ahat), alen[None, :],
                radii[None, :], eps)


def _ring_t(o, d, centers, normals, rout, eps):
    """Flat ring (disk, inner radius 0) through ``centers`` (R, C)."""
    cn = _dot(_xyz(centers), _xyz(normals))
    return _ring(_rows(o), _rows(d), _cols(centers), _cols(normals),
                 cn[None, :], rout[None, :], eps)


# ---------------------------------------------------------------------------
# blocked passes over every primitive
# ---------------------------------------------------------------------------


def _kinds(scene: Scene):
    """Per kind: (count, block test (o, d, c0, c1, eps) -> (R, c1 - c0),
    pair test (o, d, idx, eps) -> (R,), alpha (C,))."""
    with torch.no_grad():
        ahat, alen = _axis(scene.cyl_axis)
        cn = _dot(_xyz(scene.ring_center), _xyz(scene.ring_normal))

    def sph_block(o, d, c0, c1, eps):
        return _sph(_rows(o), _rows(d), _cols(scene.sph_center[c0:c1]),
                    scene.sph_radius[None, c0:c1], eps)

    def cyl_block(o, d, c0, c1, eps):
        return _cyl(_rows(o), _rows(d), _cols(scene.cyl_base[c0:c1]),
                    _cols(ahat[c0:c1]), alen[None, c0:c1],
                    scene.cyl_radius[None, c0:c1], eps)

    def ring_block(o, d, c0, c1, eps):
        return _ring(_rows(o), _rows(d), _cols(scene.ring_center[c0:c1]),
                     _cols(scene.ring_normal[c0:c1]), cn[None, c0:c1],
                     scene.ring_rout[None, c0:c1], eps)

    def sph_pair(o, d, i, eps):
        return _sph(_xyz(o), _xyz(d), _xyz(scene.sph_center[i]),
                    scene.sph_radius[i], eps)

    def cyl_pair(o, d, i, eps):
        ah, al = _axis(scene.cyl_axis[i])
        return _cyl(_xyz(o), _xyz(d), _xyz(scene.cyl_base[i]), _xyz(ah), al,
                    scene.cyl_radius[i], eps)

    def ring_pair(o, d, i, eps):
        c, n = scene.ring_center[i], scene.ring_normal[i]
        return _ring(_xyz(o), _xyz(d), _xyz(c), _xyz(n), _dot(_xyz(c), _xyz(n)),
                     scene.ring_rout[i], eps)

    return (
        (scene.sph_center.shape[0], sph_block, sph_pair, scene.sph_color[:, 3]),
        (scene.cyl_base.shape[0], cyl_block, cyl_pair, scene.cyl_color[:, 3]),
        (scene.ring_center.shape[0], ring_block, ring_pair,
         scene.ring_color[:, 3]),
    )


def _blocks(o, d, k: int, n: int, block, eps):
    """(c0, t) per block of primitives [c0, c0 + width) of kind ``k``."""
    width = max(1, BLOCK_ELEMS // max(1, o.shape[0]))
    for c0 in range(0, n, width):
        c1 = min(n, c0 + width)
        tests[KINDS[k]] += o.shape[0] * (c1 - c0)
        yield c0, block(o, d, c0, c1, eps)


def trace_closest(o, d, scene: Scene, eps):
    """(t, kind, idx) per ray: kind 0 = sphere, 1 = cylinder, 2 = ring; t =
    BIG on a miss (kind 0, idx 0 then, as ``jnp.argmin`` of a row of BIG)."""
    R = o.shape[0]
    kinds = _kinds(scene)
    with torch.no_grad():
        best = torch.full((R,), BIG, dtype=o.dtype, device=o.device)
        kind = torch.zeros(R, dtype=torch.int64, device=o.device)
        idx = torch.zeros(R, dtype=torch.int64, device=o.device)
        for k, (n, block, _, _) in enumerate(kinds):
            for c0, t in _blocks(o.detach(), d.detach(), k, n, block, eps):
                tmin, imin = t.min(dim=1)
                better = tmin < best
                best = torch.where(better, tmin, best)
                kind = torch.where(better, k, kind)
                idx = torch.where(better, imin + c0, idx)
    # the winner's t again, where the gradient of the minimum goes
    t = None
    for k in (2, 1, 0):
        n, _, pair, _ = kinds[k]
        tk = pair(o, d, idx.clamp(max=n - 1), eps)
        t = tk if t is None else torch.where(kind == k, tk, t)
    return torch.where(best >= BIG, BIG, t), kind, idx


def occlusion(o, d, maxdist, scene: Scene, eps):
    """True where any primitive lies within (eps, maxdist) along the ray."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    with torch.no_grad():
        for k, (n, block, _, _) in enumerate(_kinds(scene)):
            for _, t in _blocks(o, d, k, n, block, eps):
                occ |= ((t < maxdist) & (t < BIG)).any(dim=1)
    return occ


def shadow_filter(o, d, maxdist, scene: Scene, eps, with_trans: bool):
    """Light transmission along a shadow ray in [0, 1]: opaque surfaces
    (alpha >= 0.99999) block, transparent ones multiply by 1 - alpha, kind
    by kind (spheres, cylinders, rings); with ``with_trans=False`` a binary
    test."""
    if not with_trans:
        occ = occlusion(o.detach(), d.detach(), maxdist, scene, eps)
        return torch.where(occ, 0.0, 1.0).to(o.dtype)
    blocked = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    filt = None
    for k, (n, block, _, alpha) in enumerate(_kinds(scene)):
        fk = None
        for c0, t in _blocks(o.detach(), d.detach(), k, n, block, eps):
            a = alpha[None, c0:c0 + t.shape[1]]
            with torch.no_grad():
                inrange = (t < maxdist) & (t < BIG)
                opaque = a >= 0.99999
                blocked |= (inrange & opaque).any(dim=1)
                clear = inrange & ~opaque
            fb = torch.where(clear, 1.0 - a, 1.0).prod(dim=1)
            fk = fb if fk is None else fk * fb
        filt = fk if filt is None else filt * fk
    return torch.where(blocked, 0.0, filt).to(o.dtype)


# ---------------------------------------------------------------------------
# shading
# ---------------------------------------------------------------------------


def _unit(v):
    return v / _sqrt(_vdot(v, v)).clamp(min=1e-30)[..., None]


def _surface(scene: Scene, kind, idx, hit, d):
    """(N, rgb, alpha) at the hit points; normals flipped toward the viewer.
    ``idx`` indexes the winner's kind; the other kinds' gathers clamp it, as
    a JAX gather does out of bounds."""
    si = idx.clamp(max=scene.sph_center.shape[0] - 1)
    ci = idx.clamp(max=scene.cyl_base.shape[0] - 1)
    ri = idx.clamp(max=scene.ring_center.shape[0] - 1)
    sn = _unit(hit - scene.sph_center[si])
    cahat = _unit(scene.cyl_axis[ci])
    rel = hit - scene.cyl_base[ci]
    s = _vdot(rel, cahat)[:, None]
    cn = _unit(rel - s * cahat)
    k = kind[:, None]
    N = torch.where(k == 0, sn, torch.where(k == 1, cn, scene.ring_normal[ri]))
    col = torch.where(k == 0, scene.sph_color[si],
                      torch.where(k == 1, scene.cyl_color[ci],
                                  scene.ring_color[ri]))
    facing = _vdot(N, d)[:, None]
    N = torch.where(facing > 0.0, -N, N)
    return N, col[:, :3], col[:, 3]


def _fold(key, data: int):
    """``fold_in`` on a key held as two Python ints."""
    return rng.threefry2x32(key[0], key[1], 0, data & 0xFFFFFFFF)


def _split(key, num: int):
    return [_fold(key, i) for i in range(num)]


def _keys(keys, device):
    return torch.tensor(keys, dtype=torch.int64, device=device)


def _put(full, sel, vals):
    return torch.index_put(full, (sel,), vals)


def _shade_batch(o, d, lanes, scene: Scene, cfg: RenderConfig, light, key,
                 chunk: int):
    """Shade rays -> (R, 3) RGB (unclamped).  ``lanes`` are the rays' lanes
    in their chunk of ``chunk`` pixels, which pick their AO draws."""
    dtype, dev = o.dtype, o.device
    R = o.shape[0]
    bg = torch.as_tensor(cfg.background, dtype=dtype, device=dev)
    light_scale = 0.2 if cfg.ao_enabled else 1.0
    lightcol = cfg.direct_light_intensity

    def bounce(o, d, lanes, key):
        n = o.shape[0]
        t, kind, idx = trace_closest(o, d, scene, cfg.eps)
        missed = t >= BIG
        tsafe = torch.where(missed, 0.0, t)
        hit = o + tsafe[:, None] * d
        N, base, alpha = _surface(scene, kind, idx, hit, d)
        diffuse = torch.zeros(n, dtype=dtype, device=dev)
        if cfg.direct_light_enabled:
            inten = light_scale * _vdot(N, light[None, :])
            lit = inten > MINCONTRIB
            filt = 1.0
            if cfg.shadows_enabled:
                # a missed ray's shade is the background, so only lit hits
                # send shadow rays
                sel = torch.nonzero(lit & ~missed).flatten()
                filt = _put(torch.ones(n, dtype=dtype, device=dev), sel,
                            shadow_filter(hit[sel], light.expand(sel.shape[0], 3),
                                          BIG, scene, cfg.eps, cfg.transparency))
            diffuse = torch.where(lit, inten * lightcol * filt, 0.0)
        ao = torch.zeros(n, dtype=dtype, device=dev)
        if cfg.ao_enabled and cfg.ao_samples > 0:
            subs = []
            for _ in range(cfg.ao_samples):
                key, sub = _split(key, 2)
                subs.append(sub)
            sel = torch.nonzero(~missed).flatten()
            dirs = rng.normal(_keys(subs, dev), (chunk, 3), dtype)[:, lanes[sel]]
            dirs = _unit(dirs)
            Ns = N[sel]
            ndl = _vdot(dirs, Ns[None])
            dirs = torch.where((ndl < 0)[..., None], -dirs, dirs)
            ndl = ndl.abs()
            # AO rays crawl EPSILON along N before testing (shade.c:429)
            start = (hit[sel] + cfg.eps * Ns).expand(cfg.ao_samples, -1, -1)
            filt = shadow_filter(start.reshape(-1, 3), dirs.reshape(-1, 3),
                                 cfg.ao_max_dist, scene, cfg.eps,
                                 cfg.transparency).reshape(cfg.ao_samples, -1)
            acc = torch.zeros(sel.shape[0], dtype=dtype, device=dev)
            for i in range(cfg.ao_samples):
                acc = acc + ndl[i] * filt[i]
            ao = _put(ao, sel, (2.0 / cfg.ao_samples) * acc * cfg.ao_brightness)
        shade = DIFFUSE_K * (diffuse + ao) + AMBIENT
        rgb = torch.where(missed[:, None], bg[None, :], base * shade[:, None])
        return rgb, t, alpha, missed

    if not cfg.transparency:
        return bounce(o, d, lanes, key)[0]

    # transparency peeling (RT_TRANS_VMD): col = a*col + (1-a)*transmitted,
    # along the same ray direction with a fixed budget; a ray whose weight
    # is 0 adds nothing more
    o_cur = o.contiguous()
    weight = torch.ones(R, dtype=dtype, device=dev)
    acc = torch.zeros((R, 3), dtype=dtype, device=dev)
    for k in _split(key, cfg.max_trans):
        act = torch.nonzero(weight > 0.0).flatten()
        if not act.numel():
            break
        rgb, t, alpha, missed = bounce(o_cur[act], d[act], lanes[act], k)
        w = weight[act]
        a = torch.where(missed, 1.0, alpha)
        acc = _put(acc, act, acc[act] + w[:, None] * a[:, None] * rgb)
        weight = _put(weight, act, w * (1.0 - a))
        tsafe = torch.where(missed, 0.0, t)
        o_cur = _put(o_cur, act, o_cur[act] + (tsafe + cfg.eps)[:, None] * d[act])
    # any residual weight sees the background
    return acc + weight[:, None] * bg[None, :]


# ---------------------------------------------------------------------------
# full-image renderer
# ---------------------------------------------------------------------------


def render_image(scene: Scene, origin, lowleft, iplaneright, iplaneup, view,
                 light_dir, cfg: RenderConfig, width: int, height: int,
                 perspective: bool, seed, chunk: int = CHUNK, rows=None):
    """Render (height, width, 3) RGB in the scene's dtype and on its device,
    rows top-down.  ``rows`` = (r0, r1) renders the top-down rows r0..r1-1
    alone, each pixel as the whole frame has it.  Autograd follows the
    scene's tensors."""
    dtype, dev = scene.sph_center.dtype, scene.sph_center.device

    def vec(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=dtype)
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    origin, lowleft, ipr, ipu, view, light = (vec(a) for a in (
        origin, lowleft, iplaneright, iplaneup, view, light_dir))
    r0, r1 = (0, height) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= r0 < r1 <= height:
        raise ValueError(f"rows {rows} outside the frame's {height} rows")
    # scanlines run bottom-up: top-down rows r0..r1-1 are scanlines
    # height-r1 .. height-r0-1
    p0, p1 = (height - r1) * width, (height - r0) * width
    n_aa = cfg.aa_samples if cfg.aa_enabled else 0
    # the reference's static scanline loop samples 1-based coordinates; its
    # dynamic scheduler, used when AO is on or AA > 4 (render.c:117), 0-based
    dynamic_sched = cfg.ao_enabled or (cfg.aa_enabled and cfg.aa_samples > 4)
    off = 0.0 if dynamic_sched else 1.0
    base_key = (0, int(seed) & 0xFFFFFFFF)
    out = []
    for ci in range(p0 // chunk, (p1 - 1) // chunk + 1):
        l0, l1 = max(p0, ci * chunk) - ci * chunk, min(p1, (ci + 1) * chunk) - ci * chunk
        lanes = torch.arange(l0, l1, device=dev)
        pix = ci * chunk + lanes
        px = (pix % width).to(dtype) + off
        py = (pix // width).to(dtype) + off
        k = _fold(base_key, ci)
        samples = []
        for _ in range(n_aa + 1):
            k, kjit, kao = _split(k, 3)
            samples.append((kjit, kao))
        jitter = rng.uniform(_keys([s[0] for s in samples], dev), (chunk, 2),
                             -0.5, 0.5, dtype)[:, l0:l1]
        acc = torch.zeros((l1 - l0, 3), dtype=dtype, device=dev)
        for s, (_, kao) in enumerate(samples):
            x = px if s == 0 else px + jitter[s, :, 0]
            y = py if s == 0 else py + jitter[s, :, 1]
            ray = (lowleft[None, :] + x[:, None] * ipr[None, :]
                   + y[:, None] * ipu[None, :])
            if perspective:
                d = _unit_exact(ray)
                o = origin.expand(l1 - l0, 3)
            else:
                o, d = ray, view.expand(l1 - l0, 3)
            acc = acc + _shade_batch(o, d, lanes, scene, cfg, light, kao, chunk)
        out.append(acc / (n_aa + 1.0))
    img = torch.cat(out).reshape(r1 - r0, width, 3)
    return torch.flip(img, dims=[0])


def _unit_exact(v):
    """v / |v| with no floor (a primary ray is never zero)."""
    return v / _sqrt(_vdot(v, v))[..., None]
