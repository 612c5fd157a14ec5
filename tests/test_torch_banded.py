"""Port parity: the banded megakernel render (ROADMAP B1f).

``megakernel.render_image_mega_banded`` and ``gather.gather_chunk_data_banded``
against the JAX package's (``megakernel.py:2085``, ``pallas_kernels.py:72``):
the same JAX acceleration structures, carried over by ``convert.py``, go
through the JAX function (its kernel in interpret mode) and the port's (the
kernel's plain version on CPU tensors), and the front end past
``RECORD_BUDGET_BYTES``.  ``chip_smoke.py`` [B1f] holds the banded frame
against the one-shot frame on the card.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mdapy_tpu_torch
from mdapy_tpu.render import megakernel as jmega
from mdapy_tpu.render.accel import (
    build_light_bins, build_light_records, build_screen_bins,
)
from mdapy_tpu.render.camera import camera_frame, preset_camera
from mdapy_tpu.render.pallas_kernels import gather_chunk_data as jgather
from mdapy_tpu.render.pallas_kernels import gather_chunk_data_banded as jgather_banded
from mdapy_tpu.render.scene import build_scene
from mdapy_tpu.render.tracer import RenderConfig
from mdapy_tpu_torch.render import gather as tgather
from mdapy_tpu_torch.render import megakernel as tmega
from mdapy_tpu_torch.render import render as trender
from mdapy_tpu_torch.render.convert import (
    light_records_from_numpy, scene_from_numpy, screen_bins_from_numpy,
)

W, H = 96, 96          # 6 x 6 tiles: three bands of two tile rows
GRID = 32


@functools.lru_cache(maxsize=None)
def _setup():
    a = 3.615
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.mgrid[0:3, 0:3, 0:3].reshape(3, -1).T
    pos = (frac[None] + cells[:, None]).reshape(-1, 3) * a
    rng = np.random.default_rng(3)
    colors = np.c_[rng.uniform(0.2, 1.0, (len(pos), 3)),
                   np.ones(len(pos))].astype(np.float32)
    radii = np.full(len(pos), 1.28, np.float32)
    scene = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                         build_scene(pos, colors, radii, dtype=np.float32))
    frame = camera_frame(preset_camera("perspective", pos, max_radius=1.28), W, H)
    bins = build_screen_bins(scene, frame, W, H)
    lb = build_light_bins(scene, np.asarray(frame["light_dir"], np.float32),
                          grid=GRID)
    lrec = build_light_records(lb, scene)
    lo = np.asarray(jnp.min(scene.sph_center - scene.sph_radius[:, None], 0))
    hi = np.asarray(jnp.max(scene.sph_center + scene.sph_radius[:, None], 0))
    return scene, frame, bins, lb, lrec, lo, hi


def test_gather_chunk_data_banded_equals_one_shot():
    """The banded gather, at a band of one tile and of 7, equals the
    one-shot gather and the JAX banded gather."""
    scene, _, bins, _, _, _, _ = _setup()
    ts = scene_from_numpy(scene, device="cpu")
    chunks = torch.as_tensor(np.array(bins.sph_chunks))
    one = tgather.gather_chunk_data(chunks, ts.sph_center, ts.sph_radius,
                                    ts.sph_color)
    row = chunks.shape[1] * 8 * chunks.shape[2] * 4
    for band_bytes in (row, 7 * row, 1 << 30):
        got = tgather.gather_chunk_data_banded(
            chunks, ts.sph_center, ts.sph_radius, ts.sph_color,
            band_bytes=band_bytes)
        assert torch.equal(got, one)
    ref = np.asarray(jgather_banded(bins.sph_chunks, scene.sph_center,
                                    scene.sph_radius, scene.sph_color,
                                    band_bytes=7 * row))
    np.testing.assert_array_equal(one.numpy(), ref)
    np.testing.assert_array_equal(ref, np.asarray(jgather(
        bins.sph_chunks, scene.sph_center, scene.sph_radius, scene.sph_color)))


def _spy(module, monkeypatch):
    """Record every ``render_image_mega`` call the module's banded render
    makes: (chunk data, zmin, params, seed, keyword arguments)."""
    calls, inner = [], module.render_image_mega

    def spy(cd, zmin, *args, **kw):
        params, seed = args[-2:]
        calls.append((np.array(cd), np.array(zmin), np.array(params),
                      int(seed), dict(kw)))
        return inner(cd, zmin, *args, **kw)

    monkeypatch.setattr(module, "render_image_mega", spy)
    return calls


@pytest.mark.parametrize("aa,shadows", [(0, True), (2, True), (2, False)])
def test_banded_render_matches_jax(aa, shadows, monkeypatch):
    """Three bands of two tile rows, top band first, each with its own
    gather, its moved image-plane corner and its seed + 9973 b: the port's
    plain path against JAX ``render_image_mega_banded(interpret=True)``.
    The two band loops are bit for bit: every band's records, zmin, params, seed
    and size.  The frames differ where the two packages' one-shot kernel
    slices differ (``test_torch_render.py``: at most 2 tangency pixels
    over 1e-3, mean < 1e-4; measured 2 pixels at S = 1, the one-shot
    frames' same 2, and 2 at S = 3)."""
    scene, frame, bins, lb, lrec, lo, hi = _setup()
    cfg = RenderConfig(aa_samples=aa, aa_enabled=aa > 0, ao_samples=0,
                       ao_enabled=False, shadows_enabled=shadows)
    params = jmega.build_mega_params(frame, lb, lo, hi, cfg)
    row = bins.tiles_x * bins.sph_chunks.shape[1] * 8 * 128 * 4
    kw = dict(S=aa + 1, width=W, height=H, grid_n=GRID, eps=cfg.eps,
              perspective=True, shadows=shadows)
    jl = lrec if shadows else (None, None, None, None)
    jcalls, tcalls = _spy(jmega, monkeypatch), _spy(tmega, monkeypatch)
    ref = np.asarray(jmega.render_image_mega_banded(
        scene, bins, jl[0], jl[1], jl[2], params, 5, lkmax=jl[3],
        interpret=True, max_band_bytes=2 * row, **kw))

    tb = screen_bins_from_numpy(bins.sph_chunks, bins.sph_zmin, bins.tiles_x,
                                bins.tiles_y, device="cpu")
    lights = (tmega.stack_lights(
        params, *light_records_from_numpy(*lrec, device="cpu"), grid_n=GRID)
        if shadows else None)
    before = tmega.launches
    img = tmega.render_image_mega_banded(
        scene_from_numpy(scene, device="cpu"), tb, lights, params, 5,
        max_band_bytes=2 * row, **kw)
    assert tmega.launches == before          # CPU tensors: the plain version
    assert len(tcalls) == len(jcalls) == 3
    for (tcd, tz, tp, tseed, tkw), (jcd, jz, jp, jseed, jkw) in zip(tcalls,
                                                                    jcalls):
        np.testing.assert_array_equal(tcd, jcd)
        np.testing.assert_array_equal(tz, jz)
        np.testing.assert_array_equal(tp, jp)
        assert tseed == jseed and tp.dtype == np.float32
        for k in ("S", "width", "height", "tiles_x", "tiles_y"):
            assert tkw[k] == jkw[k], k
    assert [c[3] for c in tcalls] == [5 + 2 * 9973, 5 + 9973, 5]
    assert img.shape == (H, W, 3) and ref.std() > 0.05
    d = np.abs(img.numpy() - ref)
    assert int((d.max(axis=2) > 1e-3).sum()) <= 2
    assert d.mean() < 1e-4
    # the bands' own seeds: not the one-shot frame's jitter
    one = tmega.render_image_mega(
        torch.as_tensor(np.array(jgather(bins.sph_chunks, scene.sph_center,
                                         scene.sph_radius, scene.sph_color))),
        tb.sph_zmin, lights, params, 5, tiles_x=bins.tiles_x,
        tiles_y=bins.tiles_y, **kw)
    assert (float((one - img).abs().max()) > 1e-3) == (aa > 0)


@pytest.mark.parametrize("ao,alpha", [(False, 1.0), (True, 1.0), (True, 0.5)])
def test_front_end_takes_bands_past_the_record_budget(ao, alpha, monkeypatch):
    """``TachyonRender`` past ``RECORD_BUDGET_BYTES`` (lowered here: there is
    no knob) renders in bands, with fast AO and with
    transparency.  AA is off, so the bands trace the one-shot frame's rays
    up to their float32 image-plane corners.  Without AO at most 2
    tangency pixels differ by more than one level of the quantizer
    (measured 1 of 9,216).  Fast
    AO at eps = 4e-4 is fp-sensitive at sky-light self-occlusion (ROADMAP
    C6): moving the camera by 1e-7 of its distance flips 66 pixels of the
    one-shot frame by more than one level; the bands flip 41 (opaque) and
    42 (translucent), and the bound is 1 % of the pixels."""
    pos = np.asarray(_setup()[0].sph_center, np.float64)[:108] * [1, 1, -1]
    rng = np.random.default_rng(4)
    colors = np.c_[rng.uniform(0.2, 1.0, (len(pos), 3)),
                   np.ones(len(pos))].astype(np.float32)
    colors[::3, 3] = alpha
    radii = np.full(len(pos), 1.28, np.float32)
    cam = mdapy_tpu_torch.preset_camera("perspective", pos, max_radius=1.28)
    kw = dict(camera=cam, width=W, height=H)
    monkeypatch.setattr(trender, "AO_EXACT_MAX_SPHERES", 0)
    opts = dict(backend="cpu", ao=ao, ao_samples=4, antialiasing=False)
    ren = mdapy_tpu_torch.TachyonRender(**opts)
    one = ren.render(pos, colors, radii, **kw)
    assert ren._accel[2] is not None and ren._scene[6] == (alpha < 1)
    monkeypatch.setattr(trender, "RECORD_BUDGET_BYTES", 1 << 16)
    ren = mdapy_tpu_torch.TachyonRender(**opts)
    got = ren.render(pos, colors, radii, **kw)
    assert ren._route_name == "mega" and ren._accel[2] is None
    assert got.shape == (H, W, 4) and got[..., :3].std() > 1
    d = np.abs(got.astype(np.int32) - one).max(axis=2)
    assert int((d > 1).sum()) <= (W * H // 100 if ao else 2), int((d > 1).sum())
    dev = ren.render(pos, colors, radii, device_output=True, **kw)
    assert dev.dtype == torch.uint8 and dev.shape == (H, W, 3)
