"""Port parity: long light-grid cell walks (the megakernel's shadow walks).

The hand kernel queues its shadow walks and walks the long ones one warp per
walk, 32 records a step; its plain torch version walks each ray's records
in steps of ``_SHADOW_STEP`` = 64.  Both must give the serial walk's result:
the first key stop and the first occluder of a binary walk, and the product
of 1 - alpha in record order, ended at 1e-3, of a transmission walk.  This
file holds the plain version against the JAX package's megakernel (interpret
mode) on ``_walk_scene.walk_scene``: columns of small atoms over target
spheres, lit from the side, so that the cells over the targets' lit poles
hold 31, 32, 33, 63, 64 and 65 records, a walk reaches 1e-3 in mid-step, an
atom at alpha 0.999995 ends one, and key stops end others in mid-step.
``chip_smoke.py`` phase [2w] holds the hand kernel against the plain version
on the same scene at max |diff| 0.

Tolerances are those of the peel tests (``tests/test_torch_transparency.py``,
ROADMAP C6), on the pixels where the frames without shadows agree (the
test's docstring says why).  Where a transmission walk reaches 1e-3 the port
stops it and the JAX kernel's window sweep may go on multiplying it (ROADMAP
C7): at most 1e-3 of the light's weight.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _jax_geometry import jax_sphere_hit
from _walk_scene import walk_scene
from mdapy_tpu.render import accel as jaccel
from mdapy_tpu.render import megakernel as jmega
from mdapy_tpu.render.camera import CameraParams, camera_frame
from mdapy_tpu.render.pallas_kernels import gather_chunk_data
from mdapy_tpu.render.scene import build_scene as jbuild_scene
from mdapy_tpu.render.tracer import RenderConfig
from mdapy_tpu_torch.render import megakernel as tmega
from mdapy_tpu_torch.render.convert import (
    light_records_from_numpy, screen_bins_from_numpy,
)

W, H = 96, 80
GRID = 32


def _frames(mode, shadows):
    """The JAX megakernel (interpret mode) and the port's plain version on
    the same JAX-built records of the walk scene: (ref, img, plain work)."""
    pos, colors, radii, cam_kw, light = walk_scene()
    if mode == "opaque":
        colors = colors.copy()
        colors[:, 3] = 1.0
    peel = dict(n_peel=4, peel1=False) if mode == "n_peel=4" else (
        dict(n_peel=1, peel1=True) if mode == "peel1"
        else dict(n_peel=1, peel1=False))
    scene = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                         jbuild_scene(pos, colors, radii, dtype=np.float32))
    frame = dict(camera_frame(CameraParams(**cam_kw), W, H), light_dir=light)
    cfg = RenderConfig(aa_samples=2, ao_enabled=False, shadows_enabled=shadows,
                       transparency=mode != "opaque",
                       max_trans=1 if mode == "peel1" else 4)
    bins = jaccel.build_screen_bins(scene, frame, W, H)
    lb = jaccel.build_light_bins(scene, np.asarray(light, np.float32), grid=GRID)
    cd = gather_chunk_data(bins.sph_chunks, scene.sph_center, scene.sph_radius,
                           scene.sph_color)
    lo, hi = (np.asarray(a, np.float32) for a in scene.bounds())
    params = jmega.build_mega_params(frame, lb, lo, hi, cfg)
    lr = jaccel.build_light_records(lb, scene)
    jl = lr if shadows else (None,) * 4
    kw = dict(S=3, tiles_x=bins.tiles_x, grid_n=GRID, eps=cfg.eps,
              perspective=False, shadows=shadows, **peel)
    ref = np.asarray(jmega.render_image_mega(
        cd, bins.sph_zmin, jl[0], jl[1], jl[2], params, 0, lkmax=jl[3],
        interpret=True, width=W, height=H, tiles_y=bins.tiles_y, **kw))
    tb = screen_bins_from_numpy(bins.sph_chunks, bins.sph_zmin, bins.tiles_x,
                                bins.tiles_y, device="cpu")
    lights = (tmega.stack_lights(params, *light_records_from_numpy(
        *lr, device="cpu"), grid_n=GRID) if shadows else None)
    args = (torch.as_tensor(np.array(cd)), tb.sph_zmin, lights, params, 0)
    img = tmega.render_image_mega(*args, width=W, height=H,
                                  tiles_y=bins.tiles_y, **kw).numpy()
    work = tmega.plain_work(*args, **kw)
    if shadows:
        work["longest"] = int(lights.lcnt[0].max())
    return ref, img, work


@pytest.mark.parametrize("mode", ["n_peel=4", "peel1", "opaque"])
def test_long_walks_match_interpret(monkeypatch, mode):
    """The port's plain version takes the JAX kernel's sphere hit here
    (``tests/_jax_geometry.py``): the shadow bits of grazing-lit points
    follow the hit point.

    The shadowed frames are compared where the unshadowed frames agree
    to 1e-4 (at least 98 % of the pixels): the closest hit alone puts a few
    pixels apart, as the thin columns give many silhouettes and XLA's fused
    multiply-adds move a grazing ray's discriminant (ROADMAP C6).  There no
    pixel may be off by 1e-2, and the peel tests' bound holds: at most 3
    pixels off by more than 2e-3, mean below 2e-4.  The opaque frame may
    have 10 such pixels (7 measured, each below 3.4e-3): a binary shadow bit
    that an ulp of a grazing-lit hit point flips (C6) moves its pixel by
    lightcol * n.L * 0.8 / S, a few 1e-3 where n.L is small."""
    jax_sphere_hit(monkeypatch)
    ref0, img0, _ = _frames(mode, False)
    ref, img, work = _frames(mode, True)
    same = np.abs(img0 - ref0).max(axis=2) <= 1e-4
    assert same.mean() > 0.98
    # the walks are long: cells past 64 records, and the translucent walks
    # read more than half a warp step a lit ray
    assert work["longest"] >= 65
    if mode != "opaque":
        assert work["record"] > 16 * work["lit"]
    # the shadows matter where the frames are compared
    assert int((np.abs(img - img0).max(axis=2)[same] > 0.05).sum()) > 100
    d = np.abs(img - ref).max(axis=2)[same]
    assert d.max() < 1e-2
    assert int((d > 2e-3).sum()) <= (10 if mode == "opaque" else 3)
    assert d.mean() < 2e-4
