"""Port parity: edge cases of the tiled tracer's two kernels.

The plain versions of ``tile_kernels.closest_hit_spheres_tiles`` and
``shadow_filter_tiles`` on ``_tile_cases.py``'s argument sets (R of 1, 31,
1,664, 3,328 and 4,097; equal t across chunks and lanes; padded slots,
rays that leave the box, a tile without a live chunk; cells of 0-200
records with occluders at records 0, 32 and last, key stops in mid-step,
warps with no, one and 32 lit lanes, an empty record table), which
``chip_smoke.py`` phase [2t] holds the hand kernels against at max |diff|
0 on the card.

Every case against a numpy brute force of the walks, exactly: the same
float32 operations in the same order, and the correctly rounded square
root (``render/ieee.py``, ROADMAP C9), also when the CPU's ``torch.sqrt``
is made to return roots good to 12 bits only, as it once did for one
thread's share of a call.  Where R is a multiple of 128 (the JAX wrappers' rule), also against the
JAX package's Pallas kernels in interpret mode, with
``tests/test_torch_tiled.py``'s bounds: XLA contracts b*b - c into an FMA,
which moves a hit's t by rtol 1e-5 plus two float32 roundings of the
discriminant's terms carried through the root, and may flip a grazing hit
(at most 0.1 % of the rays); the JAX shadow test compares ck + sqrt(s2)
where the port compares squares (at most 0.1 % of the lit rays).  The JAX shadow kernel
tests a whole window of 128 records against the window's key bound, not
each record's key, so the rays whose walks the cases end by a key stop
before a record planted to occlude them (key under tau + eps, centre above
the point: a record no scene builds) are held to the brute force only.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _tile_cases as tc
from mdapy_tpu.render import pallas_kernels as jpk
from mdapy_tpu_torch.render import tile_kernels


@functools.lru_cache(maxsize=None)
def _hit(name):
    return tc.hit_case(**tc.HIT_CASES[name])


@functools.lru_cache(maxsize=None)
def _shadow(name):
    return tc.shadow_case(**tc.SHADOW_CASES[name])


@pytest.mark.parametrize("name", list(tc.HIT_CASES))
def test_closest_hit_cases(name):
    o, d, tcap, zmin, cd = _hit(name)
    before = dict(tile_kernels.launches)
    bt, rec = tile_kernels.closest_hit_spheres_tiles(
        *(torch.as_tensor(a) for a in (o, d, tcap, zmin, cd)), eps=float(tc.EPS))
    assert tile_kernels.launches == before    # CPU tensors: the plain version
    bt, rec = bt.numpy(), rec.numpy()
    ref_t, ref_rec = tc.closest_hit_numpy(o, d, tcap, zmin, cd)
    np.testing.assert_array_equal(bt, ref_t)
    np.testing.assert_array_equal(rec, ref_rec)
    # what the case is built to reach
    hit = bt < 1e17
    assert hit[:-1].any() and not hit[-1].any()      # the last tile is empty
    assert not rec[~hit].any() and np.all(bt[~hit] == np.float32(1e18))
    if tc.HIT_CASES[name].get("front_r", 0.3):
        # the front sphere's three copies (lanes 3 and 70 of chunk 0 and
        # lane 0 of chunk 1, or of chunk 0 when it is the only one): the
        # earlier chunk, then the lower lane, wins every tie
        front = np.all(rec[..., :3] == np.float32([0.0, 0.0, 4.0]), -1)
        colour = 0.75 if zmin.shape[1] == 1 else 0.25
        assert front.any() and np.all(rec[front][:, 4:] == np.float32(colour))
    R = o.shape[1]
    if R % 128:
        return
    jt, jrec = jpk.closest_hit_spheres_tiles(
        *(jnp.asarray(a) for a in (o, d, tcap, zmin, cd)), eps=float(tc.EPS),
        interpret=True)
    jt, jrec = np.asarray(jt), np.asarray(jrec)
    jmiss, tmiss = jt >= 1e17, bt >= 1e17
    both = ~jmiss & ~tmiss
    oc = o.astype(np.float64)[both] - rec[both][:, :3]
    b = (oc * d.astype(np.float64)[both]).sum(-1)
    cc = (oc * oc).sum(-1) - rec[both][:, 3].astype(np.float64) ** 2
    sq = np.sqrt(np.maximum(b * b - cc, 1e-30))
    slack = np.finfo(np.float32).eps * (b * b + np.abs(cc)) / (2.0 * sq)
    excess = np.abs(bt[both].astype(np.float64) - jt[both]) - 1e-5 * jt[both]
    assert (excess <= 2.0 * slack).all(), (excess / slack).max()
    same = (jmiss == tmiss) & np.all(rec == jrec, axis=-1)
    assert same.mean() >= 0.999


def _jax_records(lrec, offs, cnt):
    """Port CSR rows -> the JAX layout: (8, CAP) with each cell's segment
    padded to a multiple of 128 (r = -1, key = -1e17 in the padding)."""
    padded = (cnt + 127) // 128 * 128
    joffs = np.cumsum(padded) - padded
    cap = max(128, int(padded.sum()))
    ldata = np.zeros((8, cap), np.float32)
    ldata[3] = -1.0
    ldata[4] = -1e17
    for o, jo, c in zip(offs, joffs, cnt):
        ldata[:, jo:jo + c] = lrec[o:o + c].T
    return ldata, joffs.astype(np.int32), cnt.astype(np.int32)


@pytest.mark.parametrize("name", list(tc.SHADOW_CASES))
def test_shadow_filter_cases(name):
    args = _shadow(name)
    uvt, cellxy, lit, lrec, offs, cnt = args
    before = dict(tile_kernels.launches)
    filt = tile_kernels.shadow_filter_tiles(
        *(torch.as_tensor(a) for a in args), grid_n=tc.GRID,
        eps=float(tc.EPS)).numpy()
    assert tile_kernels.launches == before
    ref = tc.shadow_filter_numpy(*args)
    np.testing.assert_array_equal(filt, ref)
    assert np.all(filt[lit == 0] == 1.0)
    nlit = int(lit.sum())
    if name == "R384_none_lit":
        assert nlit == 0
    if name in ("R384", "R3328"):
        # the walks the case is built for: blocked at record 0, at record
        # 32 and at the last of a long cell; two key stops in mid-step
        # that decide the result; warps with one and with 32 lit lanes
        reached = set(tc.occluder_index_numpy(*args))
        assert {(65, 0), (65, 32), (200, 0), (200, 32), (33, 32)} <= reached
        assert (64, 63) in reached or (65, 64) in reached
        assert int((ref != tc.shadow_filter_numpy(*args, stops=False)).sum()) == 2
        by_warp = lit.reshape(-1)[:96].reshape(3, 32).sum(1)
        assert list(by_warp) == [0, 1, 32]
    R = lit.shape[1]
    if R % 128 or nlit == 0:
        return
    jf = np.asarray(jpk.shadow_filter_tiles(
        jnp.asarray(uvt), jnp.asarray(cellxy), jnp.asarray(lit),
        *(jnp.asarray(a) for a in _jax_records(lrec, offs, cnt)),
        grid_n=tc.GRID, eps=float(tc.EPS), interpret=True))
    keyed = ref == tc.shadow_filter_numpy(*args, stops=False)
    assert int((jf != filt)[keyed].sum()) <= max(1, nlit // 1000)


def _coarse_sqrt(monkeypatch):
    """torch.sqrt made to return roots good to 12 bits only (ROADMAP C9)."""
    exact = torch.sqrt

    def coarse(x, *args, **kwargs):
        y = exact(x, *args, **kwargs)
        return y * (1.0 + 2.0 ** -12) if y.is_floating_point() else y

    monkeypatch.setattr(torch, "sqrt", coarse)


@pytest.mark.parametrize("name", ["R3328_camera", "R1664_own_origins"])
def test_closest_hit_is_exact_under_a_coarse_sqrt(name, monkeypatch):
    """The plain closest hit keeps its correctly rounded roots when the
    CPU's torch.sqrt is off by 2^-12: the brute force, exactly."""
    args = _hit(name)
    _coarse_sqrt(monkeypatch)
    bt, rec = tile_kernels.closest_hit_spheres_tiles(
        *(torch.as_tensor(a) for a in args), eps=float(tc.EPS))
    ref_t, ref_rec = tc.closest_hit_numpy(*args)
    np.testing.assert_array_equal(bt.numpy(), ref_t)
    np.testing.assert_array_equal(rec.numpy(), ref_rec)


def test_walk_frame_is_repeatable_under_a_coarse_sqrt(monkeypatch):
    """ROADMAP C9: the first ``mega_render_plain`` of a process once took
    12-bit roots for one thread's share of the chunk walk and drew 1,803
    pixels of the orthographic walk scene (n_peel 4, AO 4) differently
    from the next calls.  With every torch.sqrt made that coarse, the frame
    is the one the exact roots draw, bit for bit."""
    from _walk_scene import walk_scene
    from mdapy_tpu_torch.render import megakernel
    from mdapy_tpu_torch.render import render as trender
    from mdapy_tpu_torch.render.accel import (
        build_light_bins, build_light_records, build_screen_bins)
    from mdapy_tpu_torch.render.camera import CameraParams, camera_frame
    from mdapy_tpu_torch.render.config import RenderConfig
    from mdapy_tpu_torch.render.gather import gather_chunk_data
    from mdapy_tpu_torch.render.scene import build_scene

    pos, colors, radii, cam_kw, light = walk_scene()
    cfg = RenderConfig(aa_samples=2, ao_enabled=True, ao_samples=4,
                       shadows_enabled=True)
    scene = build_scene(pos, colors, radii, device="cpu")
    frame = dict(camera_frame(CameraParams(**cam_kw), 96, 80),
                 light_dir=np.asarray(light, np.float64))
    bins = build_screen_bins(scene, frame, 96, 80)
    lb = build_light_bins(scene, frame["light_dir"], grid=32)
    cd = gather_chunk_data(bins.sph_chunks, scene.sph_center,
                           scene.sph_radius, scene.sph_color)
    lo = (scene.sph_center - scene.sph_radius[:, None]).min(0).values
    hi = (scene.sph_center + scene.sph_radius[:, None]).max(0).values
    params = megakernel.build_mega_params(frame, lb, lo, hi, cfg)
    extra = trender.build_ao_lights(scene, 4, cfg.ao_brightness,
                                    float(radii.max()), grid=32)
    lights = megakernel.stack_lights(params, *build_light_records(lb, scene),
                                     extra_lights=extra, grid_n=32, device="cpu")
    args = (cd, bins.sph_zmin, lights, params, 0)
    kw = dict(S=3, tiles_x=bins.tiles_x, grid_n=32, eps=cfg.eps,
              perspective=False, shadows=True, n_peel=4)
    exact = megakernel.mega_render_plain(*args, **kw)
    _coarse_sqrt(monkeypatch)
    coarse = megakernel.mega_render_plain(*args, **kw)
    assert float(exact.std()) > 0.02
    assert torch.equal(coarse, exact)
