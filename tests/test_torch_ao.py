"""Port parity: fast ambient occlusion (the AO sky lights of kernel B1).

The JAX package's fast AO runs 2*K2 directional sky lights (K2 =
ao_samples // 2 Fibonacci hemisphere directions and their opposites) through
the megakernel beside the primary light, sharing one closest-hit traversal;
each sky light's occlusion is taken at AA sample 0's hit point and shared by
every sample (``ao_shared``).  The port's kernel path runs here as its plain
torch version; ``chip_smoke.py`` holds the hand CUDA kernel against that plain
version on the card.  The JAX reference runs the Pallas megakernel in
interpret mode, as ``tests/test_render_mega.py`` does.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mdapy_tpu
import mdapy_tpu_torch
from mdapy_tpu.render import accel as jaccel
from mdapy_tpu.render import megakernel as jmega
from mdapy_tpu.render.camera import camera_frame, preset_camera
from mdapy_tpu.render.pallas_kernels import gather_chunk_data
from mdapy_tpu.render.render import _fib_hemisphere as jfib_hemisphere
from mdapy_tpu.render.scene import build_scene as jbuild_scene
from mdapy_tpu.render.tracer import RenderConfig
from mdapy_tpu_torch.render import accel as taccel
from mdapy_tpu_torch.render import megakernel as tmega
from mdapy_tpu_torch.render import render as trender
from mdapy_tpu_torch.render.convert import (
    extra_lights_from_numpy, light_records_from_numpy, screen_bins_from_numpy,
)
from mdapy_tpu_torch.render.config import RenderConfig as TRenderConfig
from mdapy_tpu_torch.render.scene import build_scene

W, H = 64, 48
GRID = 32


def _fcc_scene(n=3):
    a = 3.615
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.mgrid[0:n, 0:n, 0:n].reshape(3, -1).T
    pos = (frac[None] + cells[:, None]).reshape(-1, 3) * a
    rng = np.random.default_rng(3)
    colors = np.c_[rng.uniform(0.2, 1.0, (len(pos), 3)), np.ones(len(pos))]
    radii = np.full(len(pos), 1.28, np.float32)
    return pos, colors.astype(np.float32), radii


def _jscene(pos, colors, radii):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                        jbuild_scene(pos, colors, radii, dtype=np.float32))


def _sky_dirs(ao_samples):
    hemi = jfib_hemisphere(max(1, ao_samples // 2))
    return np.concatenate([hemi, -hemi], axis=0)


def _jax_ao_lights(scene, frame, lo, hi, cfg, rmax):
    """The JAX renderer's extra_lights list (render.py:569-626)."""
    k2 = max(1, cfg.ao_samples // 2)
    lightcol = (4.0 / (2 * k2)) * cfg.ao_brightness
    lights = []
    for dk in _sky_dirs(cfg.ao_samples):
        lb = jaccel.build_light_bins(scene, np.asarray(dk, np.float32), grid=GRID)
        lr = jaccel.build_light_records(lb, scene)
        frame_k = dict(frame, light_dir=np.asarray(dk, np.float32))
        p = jmega.build_mega_params(frame_k, lb, lo, hi, cfg)
        p[27] = lightcol
        lrow = np.concatenate([p[15:18], p[18:24], p[24:27], p[27:28],
                               np.zeros(3, np.float32)]).astype(np.float32)
        lrow[13] = rmax
        lights.append((lrow, lr[0], lr[1], lr[2], None, lr[3]))
    return lights


@pytest.mark.parametrize("preset,aa,shadows", [
    ("perspective", 2, True),     # S = 3, per-sample primary shadows
    ("top", 0, False),            # S = 1, the empty primary CSR
])
def test_ao_kernel_slice_matches_interpret(preset, aa, shadows):
    """The JAX accel structures and sky lights, carried over by convert.py,
    go through the JAX megakernel (interpret mode, ``ao_shared``) and the
    port's plain kernel path.

    eps is 1e-2 here, not the renderer's 4e-4.  A lit point lies on its own
    sphere, whose record is in its light cell; the self-occlusion test
    clears it by s2 - q^2 = -2 r (n.L) eps - eps^2, about 1e-4 at eps =
    4e-4.  XLA on the CPU rounds rsqrt differently from torch in ~30 % of
    inputs and contracts a*b - c to an FMA, so the two sides' hit points
    differ by an ulp or two.  Near a silhouette the hit point's error grows
    by b / sqrt(disc) and can exceed that margin, and a sky light's
    visibility then flips (23 pixels of this 64x48 perspective frame at
    eps = 4e-4; each one examined was blocked by its own sphere).  At
    eps = 1e-2 the margin is 25x wider, and what is left to compare is the
    light stacking, the shared sample-0 occlusion and the accumulation
    order."""
    pos, colors, radii = _fcc_scene()
    cam = preset_camera(preset, pos, max_radius=float(radii.max()))
    scene = _jscene(pos, colors, radii)
    frame = camera_frame(cam, W, H)
    persp = bool(frame["perspective"])
    cfg = RenderConfig(aa_samples=aa, aa_enabled=aa > 0, ao_samples=4,
                       ao_enabled=True, shadows_enabled=shadows, eps=1e-2)
    bins = jaccel.build_screen_bins(scene, frame, W, H)
    lb = jaccel.build_light_bins(
        scene, np.asarray(frame["light_dir"], np.float32), grid=GRID)
    cd = gather_chunk_data(bins.sph_chunks, scene.sph_center,
                           scene.sph_radius, scene.sph_color)
    lo = np.asarray(jnp.min(scene.sph_center - scene.sph_radius[:, None], 0))
    hi = np.asarray(jnp.max(scene.sph_center + scene.sph_radius[:, None], 0))
    params = jmega.build_mega_params(frame, lb, lo, hi, cfg)
    assert params[37] == 0.0 and params[27] == np.float32(0.9) * np.float32(0.2)
    extra = _jax_ao_lights(scene, frame, lo, hi, cfg, float(radii.max()))
    ncl = GRID * GRID
    lr0 = (jaccel.build_light_records(lb, scene) if shadows else (
        np.zeros((8, 128), np.float32), np.zeros(ncl, np.int32),
        np.zeros(ncl, np.int32), np.full(ncl, -1e18, np.float32)))
    kw = dict(S=aa + 1, width=W, height=H, tiles_x=bins.tiles_x,
              tiles_y=bins.tiles_y, grid_n=GRID, eps=cfg.eps,
              perspective=persp, shadows=True)
    ref = np.asarray(jmega.render_image_mega(
        cd, bins.sph_zmin, lr0[0], lr0[1], lr0[2], params, 0, lkmax=lr0[3],
        extra_lights=extra, ao_shared=True, interpret=True, **kw))

    tb = screen_bins_from_numpy(bins.sph_chunks, bins.sph_zmin, bins.tiles_x,
                                bins.tiles_y, device="cpu")
    primary = (light_records_from_numpy(*lr0, device="cpu") if shadows
               else (None, None, None, None))
    lights = tmega.stack_lights(params, *primary,
                                extra_lights=extra_lights_from_numpy(
                                    extra, device="cpu"),
                                grid_n=GRID)
    assert lights.lparams.shape == (5, 16) and lights.loffs.shape == (5, ncl)
    before = tmega.launches
    img = tmega.render_image_mega(
        torch.as_tensor(np.array(cd)), tb.sph_zmin, lights, params, 0, **kw)
    assert tmega.launches == before          # CPU tensors: the plain version
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    d = np.abs(img.numpy() - ref)
    assert ref.std() > 0.05
    # fp-order tangency ties may flip a pixel or two (the PR-1 kernel bound)
    assert int((d.max(axis=2) > 1e-3).sum()) <= 2
    assert d.mean() < 1e-4

    # the sky lights change the image: without them it is darker and differs
    alone = tmega.render_image_mega(
        torch.as_tensor(np.array(cd)), tb.sph_zmin,
        tmega.stack_lights(params, *primary, grid_n=GRID), params, 0, **kw)
    assert float((img - alone).mean()) > 0.01


@pytest.mark.parametrize("k", range(12))
def test_ao_light_records_match(k):
    """Light bins, records and rows for each of the 12 sky directions of
    ao_samples=12, upward and downward: the port's build of each light
    alone and of all 12 together (``build_ao_lights``) against the JAX
    build."""
    pos, colors, radii = _fcc_scene()
    jscene = _jscene(pos, colors, radii)
    tscene = build_scene(pos, colors, radii, device="cpu")
    dk = _sky_dirs(12)[k]
    jlb = jaccel.build_light_bins(jscene, np.asarray(dk, np.float32), grid=GRID)
    tlb = taccel.build_light_bins(tscene, dk, grid=GRID)
    for name in ("L", "e1", "e2", "org"):
        np.testing.assert_allclose(getattr(tlb, name).numpy(),
                                   np.asarray(getattr(jlb, name)), atol=1e-5)
    np.testing.assert_allclose(float(tlb.inv_cell), float(jlb.inv_cell),
                               rtol=1e-6)
    jcount = np.asarray(jlb.sph.count)
    np.testing.assert_array_equal(tlb.count.numpy(), jcount)
    jcand = np.asarray(jlb.sph.cand)
    for c in range(GRID * GRID):
        o, n = int(tlb.offs[c]), int(tlb.count[c])
        assert set(tlb.ids[o:o + n].tolist()) == set(jcand[c, :jcount[c]].tolist())

    jrecords = light_records_from_numpy(
        *jaccel.build_light_records(jlb, jscene), device="cpu")
    _match_jax_records(taccel.build_light_records(tlb, tscene), jrecords)

    # the batched build's sky light (records and row) against the JAX
    # build's and the JAX front end's row (render.py:615-621)
    frame = camera_frame(preset_camera("perspective", pos, max_radius=1.28),
                         W, H)
    cfg = RenderConfig(ao_samples=12, ao_enabled=True)
    jrow = _jax_ao_lights(jscene, frame, np.zeros(3), np.ones(3), cfg,
                          1.28)[k][0]
    trow, *trecords, _ = trender.build_ao_lights(
        tscene, 12, cfg.ao_brightness, 1.28, grid=GRID)[k]
    _match_jax_records(trecords, jrecords)
    np.testing.assert_allclose(trow, jrow, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("preset", ["perspective", "top"])
def test_mega_params_from_the_port_light_bins(preset):
    """The port's ``build_mega_params`` fed the port's own one-light
    LightBins against the JAX ``build_mega_params`` fed the JAX bins: slots
    0-63 within 1e-6.  The port's slots 15-27 come from the host frame the
    bins carry, so the bins' device tensors are not read."""
    pos, colors, radii = _fcc_scene()
    jscene = _jscene(pos, colors, radii)
    tscene = build_scene(pos, colors, radii, device="cpu")
    frame = camera_frame(preset_camera(preset, pos, max_radius=1.28), W, H)
    jlb = jaccel.build_light_bins(
        jscene, np.asarray(frame["light_dir"], np.float32), grid=GRID)
    tlb = taccel.build_light_bins(tscene, frame["light_dir"], grid=GRID)
    tlb = tlb._replace(e1=None, e2=None, org=None, inv_cell=None)
    lo, hi = pos.min(axis=0) - 1.28, pos.max(axis=0) + 1.28
    opts = dict(ao_samples=12, ao_enabled=True)
    jp = jmega.build_mega_params(frame, jlb, lo, hi, RenderConfig(**opts))
    tp = tmega.build_mega_params(frame, tlb, lo, hi, TRenderConfig(**opts))
    assert tp.dtype == np.float32 and tp.shape == (64,)
    assert np.array_equal(tp[18:27], tlb.frame) and tlb.frame.any()
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=1e-6, atol=1e-6)


def _match_jax_records(port, jax_records):
    """A light's (lrec, offs, count, lkmax) against the JAX build's: counts
    and offsets exactly, keys non-increasing in each cell, each cell's rows
    and the cell key maxima within 1e-5."""
    trec, toffs, tcnt, tkmax = port
    jrec, joffs, jcnt, jkmax = jax_records
    np.testing.assert_array_equal(tcnt.numpy(), jcnt.numpy())
    np.testing.assert_array_equal(toffs.numpy(), joffs.numpy())
    np.testing.assert_allclose(tkmax.numpy(), jkmax.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert int(tcnt.sum()) > 100
    trec, jrec = trec.numpy(), jrec.numpy()
    for c in np.nonzero(tcnt.numpy())[0]:
        tr = trec[toffs[c]:toffs[c] + tcnt[c]]
        jr = jrec[joffs[c]:joffs[c] + jcnt[c]]
        assert np.all(np.diff(tr[:, 4]) <= 0.0)      # keys non-increasing
        # equal keys may come in another order: compare sorted rows
        to = np.lexsort((tr[:, 1], tr[:, 0], tr[:, 4]))
        jo = np.lexsort((jr[:, 1], jr[:, 0], jr[:, 4]))
        np.testing.assert_allclose(tr[to, :6], jr[jo, :6], rtol=1e-5, atol=1e-5)


def test_ao_render_matches_jax_renderer(monkeypatch):
    """The whole AO slice: the port (backend="cpu", f32, plain kernel) with
    the fast-AO threshold set to 0, against the JAX renderer in fast-AO mode
    (backend="cpu": float64 accel, the interpret-mode megakernel).  AA is off
    so both trace the same rays; f32 vs f64 builds can flip a tangency pixel
    and the truncating quantizer may move a value across an integer, so
    allow 4 pixels differing by more than 1 (the PR-1 whole-slice bound).

    The camera is orthographic: its rays share one direction, so no
    per-ray rsqrt separates the two sides' hit points.  Through the
    perspective camera XLA's rsqrt and FMA rounding flip the sky lights'
    self-occlusion tests at silhouettes (45 pixels of this frame; see
    test_ao_kernel_slice_matches_interpret), which the renderer's eps
    cannot be widened to avoid."""
    monkeypatch.setenv("MDAPY_TPU_AO_MODE", "fast")
    monkeypatch.setattr(trender, "AO_EXACT_MAX_SPHERES", 0)
    pos, colors, radii = _fcc_scene()
    cam = mdapy_tpu.preset_camera("top", pos, max_radius=1.28)
    opts = dict(ao=True, ao_samples=12, antialiasing=False,
                background=(1.0, 1.0, 1.0))
    kw = dict(camera=cam, width=W, height=H, transparent=True)
    jren = mdapy_tpu.TachyonRender(backend="cpu", **opts)
    jren.use_pallas = True            # interpret-mode megakernel on the CPU
    ref = jren.render(pos, colors, radii, **kw)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", **opts)
    img = ren.render(pos, colors, radii, **kw)
    assert img.shape == ref.shape == (H, W, 4) and img.dtype == np.uint8
    d = np.abs(img[..., :3].astype(np.int32) - ref[..., :3].astype(np.int32))
    assert img[..., :3].std() > 1
    assert int((d.max(axis=2) > 1).sum()) <= 4
    # transparent background: alpha 0 where the pixel shows the background
    a = img[..., 3]
    assert 0 < int((a == 0).sum()) < H * W and int((a == 255).sum()) > 0
    assert int((a != ref[..., 3]).sum()) <= 4

    # the repaired fault: with AO on, the port packs the params as the JAX
    # package does — direct light x 0.2 (rt_rescale_lights) and the
    # dynamic-sched pixel-centre offset p[37] = 0
    frame, _, _, lights, params = ren._accel
    cfg = RenderConfig(ao_samples=12, ao_enabled=True, aa_enabled=False,
                       background=(1.0, 1.0, 1.0))
    lb = taccel.build_light_bins(build_scene(pos, colors, radii, device="cpu"),
                                 frame["light_dir"], grid=GRID)
    jp = jmega.build_mega_params(frame, lb, np.zeros(3), np.ones(3), cfg)
    tp = tmega.build_mega_params(frame, lb, np.zeros(3), np.ones(3), ren._cfg)
    np.testing.assert_array_equal(tp, jp)
    assert params[27] == np.float32(0.9) * np.float32(0.2) and params[37] == 0.0
    assert lights.lparams.shape == (13, 16)
    np.testing.assert_array_equal(lights.lparams[0, :13].numpy(), params[15:28])

    # a camera move rebuilds the view structures and reuses the AO lights
    ao = ren._ao
    cam2 = mdapy_tpu_torch.CameraParams(**dict(
        cam.__dict__, position=tuple(np.asarray(cam.position) + 3.0)))
    moved = ren.render(pos, colors, radii, camera=cam2, width=W, height=H)
    assert ren._ao is ao and ren._accel[0] is not frame
    assert not np.array_equal(moved, img)
    dev = ren.render(pos, colors, radii, camera=cam2, width=W, height=H,
                     device_output=True)
    assert dev.dtype == torch.uint8 and dev.shape == (H, W, 3)
    assert ren._ao is ao


def test_ao_small_scene_raises(monkeypatch):
    """At or below AO_EXACT_MAX_SPHERES padded spheres the JAX renderer takes
    the exact AO tracer (ROADMAP A6), and so does the port, in float64 on
    the CPU: at most 2 pixels of the JAX renderer's frame off by more than
    one level (measured 0).  Above it, fast AO."""
    pos, colors, radii = _fcc_scene()            # 108 atoms, 256 padded
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao_samples=4,
                                        antialiasing=False)
    monkeypatch.setattr(trender, "AO_EXACT_MAX_SPHERES", 256)
    exact = ren.render(pos, colors, radii, width=32, height=32)
    assert ren._route_name == "exact" and exact[..., :3].std() > 1
    ref = mdapy_tpu.TachyonRender(backend="cpu", ao_samples=4,
                                  antialiasing=False).render(
        pos, colors, radii, width=32, height=32)
    d = np.abs(exact.astype(np.int32) - ref.astype(np.int32)).max(axis=2)
    assert int((d > 1).sum()) <= 2
    monkeypatch.setattr(trender, "AO_EXACT_MAX_SPHERES", 255)
    img = ren.render(pos, colors, radii, width=32, height=32)
    assert img.shape == (32, 32, 4) and img[..., :3].std() > 1
    assert ren._route_name == "mega"
