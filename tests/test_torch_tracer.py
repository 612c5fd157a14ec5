"""Port parity: the exact tracer (``render/tracer.py``, ROADMAP A6).

The same inputs, made with numpy from a seed, go through the JAX package's
``mdapy_tpu/render/tracer.py`` (XLA ops, float64 as its CPU renderer runs
it) and the port's ``mdapy_tpu_torch/render/tracer.py`` (torch ops): the
threefry draws it makes, the intersections, the closest hit and both
shadow filters, whole frames, the gradients of an image loss (BASELINE
config 4), and both packages' ``TachyonRender(backend="cpu")`` on the
routes that take this tracer.  ``chip_smoke.py`` [A6] and [A6g] run the
tracer on the card.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mdapy_tpu
import mdapy_tpu_torch
from mdapy_tpu.render import tracer as jtracer
from mdapy_tpu.render.camera import camera_frame, preset_camera
from mdapy_tpu.render.scene import build_scene as jbuild_scene
from mdapy_tpu.render.scene import scene_from_arrays as jscene_from_arrays
from mdapy_tpu_torch.render import render as trender
from mdapy_tpu_torch.render import rng, tracer
from mdapy_tpu_torch.render.config import RenderConfig
from mdapy_tpu_torch.render.scene import build_scene as tbuild_scene
from mdapy_tpu_torch.render.scene import scene_from_arrays

W, H = 48, 40
EPS = 4e-4
_T = {np.float32: torch.float32, np.float64: torch.float64}


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_rng_split_uniform_normal_match_jax(seed):
    """``split`` and ``uniform`` in float32 and float64 are JAX's bit for
    bit, for the shapes the tracer draws and others.  ``normal`` goes
    through ``torch.erfinv``, not XLA's polynomial: it is held within a
    relative 64 eps (float32) and 512 eps (float64) of JAX's (measured 48
    and 341 eps over six keys of (16384, 3) draws), and equal where both
    round alike."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    tkey = rng.fold_in(rng.prng_key(seed), 11)
    for n in (2, 3, 4):
        np.testing.assert_array_equal(
            rng.split(tkey, n).numpy(), np.asarray(jax.random.split(jkey, n)))
    for dt in (np.float32, np.float64):
        for shape in ((16384, 2), (7, 3), (5,)):
            ref = np.asarray(jax.random.uniform(jkey, shape, dt, minval=-0.5,
                                                maxval=0.5))
            got = rng.uniform(tkey, shape, -0.5, 0.5, _T[dt]).numpy()
            assert got.dtype == dt
            np.testing.assert_array_equal(got, ref)
        ref = np.asarray(jax.random.normal(jkey, (16384, 3), dt))
        got = rng.normal(tkey, (16384, 3), _T[dt]).numpy()
        assert got.dtype == dt
        bound = (64 if dt == np.float32 else 512) * np.finfo(dt).eps
        np.testing.assert_array_less(np.abs(got - ref), bound * np.abs(ref) + 1e-300)
        assert (got == ref).mean() > 0.3
    # one key per row, as the tracer draws its AO rays
    keys = rng.split(tkey, 3)
    jkeys = jax.random.split(jkey, 3)
    batch = rng.uniform(keys, (5, 3), dtype=torch.float64).numpy()
    for i in range(3):
        np.testing.assert_array_equal(batch[i], np.asarray(
            jax.random.uniform(jkeys[i], (5, 3), jnp.float64)))


# ---------------------------------------------------------------------------
# intersections, closest hit, shadow filters
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _prims():
    """Seeded rays and primitives: spheres, cylinders (8 rays nearly
    parallel to a long thin cylinder) and rings, with their alphas."""
    r = np.random.default_rng(11)
    n = 400
    o = r.uniform(-6.0, 6.0, (n, 3))
    tgt = r.uniform(-2.0, 2.0, (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cen = r.uniform(-3.0, 3.0, (24, 3))
    rad = r.uniform(0.3, 1.0, 24)
    rad[-3:] = -1.0                                  # padding slots
    base = r.uniform(-3.0, 3.0, (16, 3))
    axis = r.normal(size=(16, 3)) * 2.0
    axis[0] = [0.0, 0.0, 8.0]                        # a long thin box edge
    base[0] = [1.0, 1.0, -4.0]
    crad = r.uniform(0.05, 0.3, 16)
    crad[0] = 0.05
    crad[-2:] = -1.0
    # rays within 1.2 degrees of cylinder 0's axis, entering it from 0.08
    # off the axis half a unit above its base
    o[:8] = base[0] + [0.08, 0.0, 0.5]
    d[:8] = np.c_[-0.02 + r.uniform(-2e-3, 2e-3, 8),
                  r.uniform(-2e-3, 2e-3, 8), np.ones(8)]
    d[:8] /= np.linalg.norm(d[:8], axis=1, keepdims=True)
    rcen = r.uniform(-3.0, 3.0, (12, 3))
    rnorm = r.normal(size=(12, 3))
    rnorm /= np.linalg.norm(rnorm, axis=1, keepdims=True)
    rout = r.uniform(0.2, 0.8, 12)
    rout[-1] = -1.0
    alpha = (r.uniform(0.2, 0.9, 24), r.uniform(0.2, 0.9, 16), r.uniform(0.2, 0.9, 12))
    for a in alpha:
        a[::3] = 1.0
    return o, d, cen, rad, base, axis, crad, rcen, rnorm, rout, alpha


def _scenes(dt):
    o, d, cen, rad, base, axis, crad, rcen, rnorm, rout, alpha = _prims()

    def rgba(n, a):
        return np.c_[np.full((n, 3), 0.5), a]

    parts = (cen, rad, rgba(24, alpha[0]), base, axis, crad, rgba(16, alpha[1]),
             rcen, rnorm, rout, rgba(12, alpha[2]))
    js = jtracer.Scene(*(jnp.asarray(p, dt) for p in parts))
    ts = tracer.Scene(*(torch.as_tensor(p).to(_T[dt]) for p in parts))
    return js, ts, jnp.asarray(o, dt), jnp.asarray(d, dt), torch.as_tensor(o).to(_T[dt]), torch.as_tensor(d).to(_T[dt])


def _t_close(got, ref, dt):
    """Equal misses (BIG) and close hits: exact masks and rtol 1e-12 in
    float64; in float32 rtol 1e-4 and at most 0.5 % of the entries on the
    other side of the hit/miss line (tangent rays)."""
    hit_g, hit_r = got < 1e17, ref < 1e17
    assert hit_r.sum() > 20 and (~hit_r).sum() > 20
    if dt == np.float64:
        np.testing.assert_array_equal(hit_g, hit_r)
        np.testing.assert_allclose(got[hit_r], ref[hit_r], rtol=1e-12, atol=1e-12)
    else:
        assert (hit_g != hit_r).mean() <= 5e-3
        both = hit_g & hit_r
        np.testing.assert_allclose(got[both], ref[both], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_intersections_match_jax(dt):
    """``_sphere_t``, ``_cyl_t`` (with rays nearly parallel to a long thin
    cylinder) and ``_ring_t`` on (400 rays x primitives)."""
    js, ts, jo, jd, to, td = _scenes(dt)
    pairs = (
        (jtracer._sphere_t(jo, jd, js.sph_center, js.sph_radius, EPS),
         tracer._sphere_t(to, td, ts.sph_center, ts.sph_radius, EPS)),
        (jtracer._cyl_t(jo, jd, js.cyl_base, js.cyl_axis, js.cyl_radius, EPS),
         tracer._cyl_t(to, td, ts.cyl_base, ts.cyl_axis, ts.cyl_radius, EPS)),
        (jtracer._ring_t(jo, jd, js.ring_center, js.ring_normal, js.ring_rout, EPS),
         tracer._ring_t(to, td, ts.ring_center, ts.ring_normal, ts.ring_rout, EPS)),
    )
    for ref, got in pairs:
        assert got.dtype == _T[dt] and got.shape == ref.shape
        _t_close(got.numpy(), np.asarray(ref), dt)
    # the grazing rays along cylinder 0 hit it
    tc = pairs[1][1].numpy()
    assert (tc[:8, 0] < 1e17).sum() >= 4


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_closest_hit_and_shadow_filters_match_jax(dt, monkeypatch):
    """``trace_closest`` (over primitive blocks of 7, so the running
    minimum crosses blocks and kinds), ``occlusion`` and both
    ``shadow_filter`` modes."""
    monkeypatch.setattr(tracer, "BLOCK_ELEMS", 7 * 400)
    js, ts, jo, jd, to, td = _scenes(dt)
    jt, jk, ji = (np.asarray(a) for a in jtracer.trace_closest(jo, jd, js, EPS))
    tt, tk, ti = (a.numpy() for a in tracer.trace_closest(to, td, ts, EPS))
    _t_close(tt, jt, dt)
    same = (jt < 1e17) & (tt < 1e17)
    agree = (tk == jk) & (ti == ji)
    if dt == np.float64:
        assert agree.all()
    else:
        assert agree[same].mean() > 0.99
    for maxdist in (1e18, 3.0):
        ref = np.asarray(jtracer.occlusion(jo, jd, maxdist, js, EPS))
        got = tracer.occlusion(to, td, maxdist, ts, EPS).numpy()
        assert 20 < ref.sum() < len(ref) - 20
        assert (got != ref).mean() <= (0 if dt == np.float64 else 5e-3)
        for trans in (False, True):
            ref = np.asarray(jtracer.shadow_filter(jo, jd, maxdist, js, EPS, trans))
            got = tracer.shadow_filter(to, td, maxdist, ts, EPS, trans).numpy()
            assert got.dtype == dt
            if dt == np.float64:
                np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)
            else:
                assert (np.abs(got - ref) > 1e-5).mean() <= 5e-3
            if trans:
                assert ((ref > 0) & (ref < 1)).sum() > 20


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _atoms():
    r = np.random.default_rng(3)
    n = 20
    pos = r.uniform(0.0, 8.0, (n, 3))
    col = np.c_[r.uniform(0.2, 1.0, (n, 3)), np.ones(n)]
    rad = r.uniform(0.6, 1.0, n)
    return pos, col, rad


def _frame(pos, rad, w=W, h=H, preset="perspective"):
    cam = preset_camera(preset, pos, max_radius=float(rad.max()))
    f = camera_frame(cam, w, h)
    return (f["origin"], f["lowleft"], f["iplaneright"], f["iplaneup"],
            f["view"], f["light_dir"]), bool(f["perspective"])


@pytest.mark.parametrize("case", ["aa2_shadows", "ao4", "glass_shadows",
                                  "ao_bonds_box"])
def test_render_image_matches_jax(case):
    """``render_image`` against JAX at 48x40 in float64 with the same seed:
    AA 2 with shadows; AO 4 (no AA: 0-based pixels); translucent atoms
    with shadows (4 peels, transmitted shadows); AO 4 and AA 2 with 6
    bonds and 3 box edges.  The draws are JAX's, but ``normal``'s last
    bits are not (``rng.py``), so an AO ray may flip at a tangency (ROADMAP
    C6): at most 4 pixels over 1e-6 and a mean difference under 1e-8
    (measured max |diff| 3.1e-12 over the four frames, no pixel over
    1e-6)."""
    pos, col, rad = _atoms()
    cam, persp = _frame(pos, rad)
    col = col.copy()
    kw = {}
    cfg = dict(aa_samples=0, aa_enabled=False, ao_enabled=False)
    if case == "aa2_shadows":
        cfg = dict(aa_samples=2, ao_enabled=False)
    elif case == "ao4":
        cfg = dict(aa_samples=0, aa_enabled=False, ao_samples=4)
    elif case == "glass_shadows":
        col[::2, 3] = 0.5
        cfg["transparency"] = True
    else:
        kw = dict(bond_edges=np.stack([pos[:6], pos[6:12]], axis=1),
                  box_edges=np.array([[[0, 0, 0], [8, 0, 0]], [[0, 0, 0], [0, 8, 0]],
                                      [[0, 0, 0], [0, 0, 8]]], float))
        cfg = dict(aa_samples=2, ao_samples=4)
    js = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                      jbuild_scene(pos, col, rad, dtype=np.float64, **kw))
    ts = tbuild_scene(pos, col, rad, dtype=torch.float64, device="cpu", **kw)
    ref = np.asarray(jtracer.render_image(
        js, *cam, jtracer.RenderConfig(**cfg), W, H, persp, 3))
    img = tracer.render_image(ts, *cam, RenderConfig(**cfg), W, H, persp, 3)
    assert img.dtype == torch.float64 and img.shape == (H, W, 3)
    d = np.abs(img.numpy() - ref).max(axis=2)
    assert ref.std() > 0.04
    assert int((d > 1e-6).sum()) <= 4 and d.mean() < 1e-8, (d.max(), d.mean())
    # a band of rows is the frame's rows, with the frame's draws
    band = tracer.render_image(ts, *cam, RenderConfig(**cfg), W, H, persp, 3,
                               rows=(7, 29))
    assert torch.equal(band, img[7:29])


# ---------------------------------------------------------------------------
# gradients (BASELINE config 4, as tests/test_render_grad.py)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _grad_setup():
    r = np.random.default_rng(3)
    n = 20
    pos = r.uniform(0.0, 8.0, (n, 3))
    col = np.c_[r.uniform(0.2, 1.0, (n, 3)), np.ones(n)]
    rad = r.uniform(0.6, 1.0, n)
    cam, _ = _frame(pos, rad)
    target = r.uniform(0, 1, (H, W, 3))
    return pos, rad, col, cam, target


_GRAD_CFG = dict(aa_samples=0, aa_enabled=False, ao_enabled=False,
                 shadows_enabled=False)


def _torch_loss(pos, rad, col):
    _, _, _, cam, target = _grad_setup()
    scene = scene_from_arrays(pos, col, rad, dtype=torch.float64)
    img = tracer.render_image(scene, *cam, RenderConfig(**_GRAD_CFG), W, H,
                              True, 0, chunk=1920)
    return ((img - torch.as_tensor(target)) ** 2).sum()


def test_render_grads_match_jax_grad():
    """The port's autograd against ``jax.grad`` of the same loss on
    ``test_render_grad.py``'s scene: rtol 1e-6 (measured 1e-12)."""
    pos, rad, col, cam, target = _grad_setup()

    def jloss(p, r, c):
        scene = jscene_from_arrays(p, c, r, dtype=jnp.float64)
        img = jtracer.render_image(scene, *cam, jtracer.RenderConfig(**_GRAD_CFG),
                                   W, H, True, 0, chunk=1920)
        return jnp.sum((img - target) ** 2)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(pos, rad, col)
    args = [torch.tensor(a, requires_grad=True) for a in (pos, rad, col)]
    loss = _torch_loss(*args)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss(pos, rad, col))) < 1e-9
    for a, r in zip(args, ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(a.grad.numpy(), r, rtol=1e-6,
                                   atol=1e-6 * np.abs(r).max())


def test_render_grads_match_finite_differences():
    """Central differences at 1e-5 against autograd within 1e-4, on random
    components of each parameter (``test_render_grad.py``'s check)."""
    pos, rad, col, _, _ = _grad_setup()
    args = [torch.tensor(a, requires_grad=True) for a in (pos, rad, col)]
    _torch_loss(*args).backward()
    g_pos, g_rad, g_col = (a.grad.numpy() for a in args)
    assert np.isfinite(g_pos).all() and np.isfinite(g_rad).all()
    assert np.abs(g_pos).max() > 0

    def loss(p, r, c):
        with torch.no_grad():
            return float(_torch_loss(*(torch.as_tensor(x) for x in (p, r, c))))

    eps = 1e-5
    r = np.random.default_rng(0)
    for _ in range(4):
        i, k = r.integers(len(pos)), r.integers(3)
        p1, p2 = pos.copy(), pos.copy()
        p1[i, k] += eps
        p2[i, k] -= eps
        fd = (loss(p1, rad, col) - loss(p2, rad, col)) / (2 * eps)
        assert abs(fd - g_pos[i, k]) <= 1e-4 * max(1.0, abs(fd)), (i, k, fd)
    for _ in range(3):
        i = r.integers(len(pos))
        r1, r2 = rad.copy(), rad.copy()
        r1[i] += eps
        r2[i] -= eps
        fd = (loss(pos, r1, col) - loss(pos, r2, col)) / (2 * eps)
        assert abs(fd - g_rad[i]) <= 1e-4 * max(1.0, abs(fd)), (i, fd)
    for _ in range(3):
        i, k = r.integers(len(pos)), r.integers(3)
        c1, c2 = col.copy(), col.copy()
        c1[i, k] += eps
        c2[i, k] -= eps
        fd = (loss(pos, rad, c1) - loss(pos, rad, c2)) / (2 * eps)
        assert abs(fd - g_col[i, k]) <= 1e-4 * max(1.0, abs(fd)), (i, k, fd)


def test_render_grads_shadows_transparency():
    """Finite, non-zero gradients with shadows and transparency peeling,
    to the positions and to the alphas (through the transmissions)."""
    r = np.random.default_rng(5)
    n = 12
    pos = r.uniform(0.0, 6.0, (n, 3))
    col = np.c_[r.uniform(0.2, 1.0, (n, 3)), np.full(n, 0.5)]
    rad = r.uniform(0.6, 1.0, n)
    cam, _ = _frame(pos, rad, 32, 24)
    cfg = RenderConfig(aa_samples=0, aa_enabled=False, ao_enabled=False,
                       shadows_enabled=True, transparency=True)
    P = torch.tensor(pos, requires_grad=True)
    C = torch.tensor(col, requires_grad=True)
    img = tracer.render_image(scene_from_arrays(P, C, rad, dtype=torch.float64),
                              *cam, cfg, 32, 24, True, 0, chunk=768)
    (img ** 2).sum().backward()
    for g in (P.grad, C.grad):
        assert torch.isfinite(g).all() and g.abs().max() > 0
    assert C.grad[:, 3].abs().max() > 0


def test_scene_from_arrays_device(monkeypatch):
    """``scene_from_arrays`` builds on the card unless asked for the CPU:
    numpy inputs need a card or ``device="cpu"``, tensors keep their
    device.  The CPU scene equals JAX's, and gradients reach the tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pos, rad, col, _, _ = _grad_setup()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scene_from_arrays(pos, col, rad)
    with pytest.raises(RuntimeError, match="CUDA"):
        scene_from_arrays(torch.as_tensor(pos), col, rad, device="cuda")
    got = scene_from_arrays(pos, col, rad, dtype=torch.float64, device="cpu")
    ref = jscene_from_arrays(pos, col, rad, dtype=jnp.float64)
    for name in ("sph_center", "sph_radius", "sph_color", "cyl_radius",
                 "cyl_axis", "ring_rout", "ring_normal"):
        t = getattr(got, name)
        assert t.device.type == "cpu" and t.dtype == torch.float64, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    P = torch.tensor(pos, requires_grad=True)
    sc = scene_from_arrays(P, col, rad)
    assert sc.sph_center.device.type == "cpu" and sc.sph_color.dtype == P.dtype
    sc.sph_center.sum().backward()
    np.testing.assert_array_equal(P.grad.numpy(), np.tile([1.0, 1.0, -1.0],
                                                          (len(pos), 1)))


# ---------------------------------------------------------------------------
# the front end
# ---------------------------------------------------------------------------


def _bcc(n=2, bonds=True):
    s = mdapy_tpu.build_crystal("Fe", "bcc", 2.8665, nx=n, ny=n, nz=n)
    if bonds:
        s.create_bonds(rc=2.6)
    return s


def _compare(img, ref, n_bad):
    assert img.shape == ref.shape and img.dtype == np.uint8
    assert img[..., :3].std() > 1
    d = np.abs(img.astype(np.int32) - ref.astype(np.int32)).max(axis=2)
    assert int((d > 1).sum()) <= n_bad, int((d > 1).sum())


@pytest.mark.parametrize("case", ["small_ao", "heavy_bond_ao", "glass_nospheres",
                                  "no_tiling", "no_pallas"])
def test_tachyon_render_routes_match_jax(case, monkeypatch):
    """Both packages' ``TachyonRender(backend="cpu")`` on the routes that take
    the exact tracer in float64 (``ren._route_name`` "exact"): a small
    scene with the default AO (12) and AA (12); a bond scene past
    ``OTHER_SHADOW_MAX`` with AO 4; a translucent scene of bonds and a cell
    without atoms; ``use_tiling = False`` with shadows only; and
    ``use_pallas = False``, which sends an opaque frame without AO to
    ``render_image_tiled`` in both (the port's in float32, at most 4).  At
    most 2 pixels may differ by more than one level of the truncating
    quantizer (measured 1, 1, 0, 0 and 0: an AO ray that ``normal``'s
    last bits flip)."""
    s = _bcc()
    pos = s.get_positions()
    kw = dict(width=40, height=32)
    jopts, topts = {}, {}
    n_bad = 2
    if case == "small_ao":
        # the defaults cost 13 x 14 ray passes a pixel: a smaller frame
        sys_kw = dict(draw_bond=False)
        kw = dict(width=24, height=20)
    elif case == "heavy_bond_ao":
        # past the cylinder limit with fast AO in the port's route choice
        monkeypatch.setattr(trender, "AO_EXACT_MAX_SPHERES", 0)
        monkeypatch.setattr(trender, "OTHER_SHADOW_MAX", 100)
        sys_kw = dict(draw_bond=True, radii=np.full(s.N, 0.6, np.float32))
        jopts = topts = dict(ao_samples=4, aa_samples=2)
    elif case == "glass_nospheres":
        sys_kw = dict(draw_bond=True, colors=np.zeros((s.N, 4), np.float32),
                      bond_color=(0.8, 0.6, 0.4, 0.5), box_color=(1, 1, 1, 0.6))
        jopts = topts = dict(ao=False, aa_samples=2)
    elif case == "no_tiling":
        sys_kw = dict(draw_bond=True)
        jopts = topts = dict(ao=False, antialiasing=False)
    else:
        sys_kw = dict(draw_bond=True)
        jopts = topts = dict(ao=False, antialiasing=False)
        n_bad = 4
    jren = mdapy_tpu.TachyonRender(backend="cpu", **jopts)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", **topts)
    if case == "no_tiling":
        jren.use_tiling = ren.use_tiling = False
    if case == "no_pallas":
        ren.use_pallas = False
    assert jren.use_pallas is False and jren.use_tiling == ren.use_tiling
    cam = mdapy_tpu.preset_camera("perspective", pos, max_radius=1.0)
    ref = jren.render_system(s, camera=cam, **sys_kw, **kw)
    img = ren.render_system(s, camera=cam, **sys_kw, **kw)
    _compare(img, ref, n_bad)
    assert ren._route_name == ("tiled" if case == "no_pallas" else "exact")
    if ren._route_name == "exact":
        assert ren._exact.sph_center.dtype == torch.float64
