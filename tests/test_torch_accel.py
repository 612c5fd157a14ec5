"""Port parity: the render slice's host structures, JAX package vs torch port.

Same inputs (made with numpy from a seed) go through ``mdapy_tpu.render``
and ``mdapy_tpu_torch.render``: the scene, the camera frame, the screen-tile
bins, the light-grid bins and records, and the gathered candidate records.
Everything runs on the CPU in float32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdapy_tpu.render import accel as jaccel
from mdapy_tpu.render.camera import camera_frame as jcamera_frame
from mdapy_tpu.render.camera import preset_camera as jpreset_camera
from mdapy_tpu.render.pallas_kernels import gather_chunk_data as jgather
from mdapy_tpu.render.pallas_kernels import gather_chunk_data_banded as jgather_banded
from mdapy_tpu.render.scene import build_scene as jbuild_scene
from mdapy_tpu_torch.render import accel as taccel
from mdapy_tpu_torch.render.camera import CameraParams, camera_frame, preset_camera
from mdapy_tpu_torch.render.convert import scene_from_numpy
from mdapy_tpu_torch.render.gather import gather_chunk_data, gather_chunk_data_banded
from mdapy_tpu_torch.render.scene import build_scene

W, H = 96, 80
GRID = 48


def _fcc_scene(n=3):
    a = 3.615
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.mgrid[0:n, 0:n, 0:n].reshape(3, -1).T
    pos = (frac[None] + cells[:, None]).reshape(-1, 3) * a
    rng = np.random.default_rng(3)
    colors = np.c_[rng.uniform(0.2, 1.0, (len(pos), 3)), np.ones(len(pos))]
    radii = np.full(len(pos), 1.28, np.float32)
    return pos, colors.astype(np.float32), radii


def _both(preset="perspective"):
    pos, colors, radii = _fcc_scene()
    cam = jpreset_camera(preset, pos, max_radius=float(radii.max()))
    jscene = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                          jbuild_scene(pos, colors, radii, dtype=np.float32))
    tscene = build_scene(pos, colors, radii, device="cpu")
    frame = jcamera_frame(cam, W, H)
    return pos, cam, jscene, tscene, frame


def _tile_sets(cand):
    return [set(int(i) for i in row if i >= 0) for row in cand]


@pytest.mark.parametrize("preset", ["perspective", "top"])
def test_scene_and_camera_frame_match(preset):
    pos, colors, radii = _fcc_scene()
    jscene = jbuild_scene(pos, colors, radii, dtype=np.float32)
    tscene = build_scene(pos, colors, radii, device="cpu")
    for name in ("sph_center", "sph_radius", "sph_color"):
        np.testing.assert_allclose(getattr(tscene, name).numpy(),
                                   np.asarray(getattr(jscene, name)), atol=1e-6)
    jcam = jpreset_camera(preset, pos, max_radius=1.28)
    tcam = preset_camera(preset, pos, max_radius=1.28)
    assert tcam.__dict__ == jcam.__dict__
    jf, tf = jcamera_frame(jcam, W, H), camera_frame(tcam, W, H)
    assert tf["perspective"] == jf["perspective"]
    for k in ("origin", "lowleft", "iplaneright", "iplaneup", "view", "light_dir"):
        np.testing.assert_allclose(tf[k], jf[k], atol=1e-6)


@pytest.mark.parametrize("preset", ["perspective", "top"])
def test_screen_bins_match(preset):
    pos, cam, jscene, tscene, frame = _both(preset)
    jb = jaccel.build_screen_bins(jscene, frame, W, H)
    tb = taccel.build_screen_bins(tscene, frame, W, H)
    assert (tb.tiles_x, tb.tiles_y, tb.tile_px) == (jb.tiles_x, jb.tiles_y, 16)
    jc = np.asarray(jb.sph_chunks).reshape(jb.tiles_x * jb.tiles_y, -1)
    tc = tb.sph_chunks.reshape(tb.tiles_x * tb.tiles_y, -1).numpy()
    # a sphere whose span edge lies within 1e-4 px of a tile edge may fall on
    # either side under another summation order; find them in float64
    g = taccel._screen_setup(frame, W, H, torch.float64, "cpu")
    bounds = taccel._screen_px_bounds(
        tscene.sph_center.double(), tscene.sph_radius.double(), g["origin"],
        g["right"], g["up2"], g["view"], g["left"], g["bottom"], g["psx"],
        g["psy"], W, H, bool(frame["perspective"]))[:4]
    pad = taccel.SPAN_PAD
    edges = torch.stack([bounds[0] - pad, bounds[1] + pad,
                         bounds[2] - pad, bounds[3] + pad]) / 16.0
    near_edge = set(np.nonzero(
        ((edges - edges.round()).abs() < 1e-4 / 16).any(0).numpy())[0].tolist())
    jsets, tsets = _tile_sets(jc), _tile_sets(tc)
    n_pairs = 0
    for t, (a, b) in enumerate(zip(jsets, tsets)):
        assert (a ^ b) <= near_edge, f"tile {t}: {sorted(a ^ b)}"
        n_pairs += len(b)
        if a == b:
            n = len(b)
            nch = -(-n // 128)
            np.testing.assert_allclose(
                tb.sph_zmin[t, :nch].numpy(), np.asarray(jb.sph_zmin)[t, :nch],
                rtol=1e-5, atol=1e-5)
    assert n_pairs > 100
    # front-to-back order inside each tile, BIG_DEPTH past the last chunk
    depth = ((tscene.sph_center @ g["view"].float()) - tscene.sph_radius).numpy()
    for row in tc:
        live = row[row >= 0]
        assert np.all(np.diff(depth[live]) >= -1e-5)
        assert np.all(row[len(live):] == -1)


def test_light_bins_and_records_match():
    pos, cam, jscene, tscene, frame = _both()
    L = np.asarray(frame["light_dir"], np.float32)
    jlb = jaccel.build_light_bins(jscene, L, grid=GRID)
    tlb = taccel.build_light_bins(tscene, L, grid=GRID)
    for name in ("L", "e1", "e2", "org"):
        np.testing.assert_allclose(getattr(tlb, name).numpy(),
                                   np.asarray(getattr(jlb, name)), atol=1e-5)
    np.testing.assert_allclose(float(tlb.inv_cell), float(jlb.inv_cell), rtol=1e-6)
    jcount = np.asarray(jlb.sph.count)
    np.testing.assert_array_equal(tlb.count.numpy(), jcount)
    jcand = np.asarray(jlb.sph.cand)
    for c in range(GRID * GRID):
        o, n = int(tlb.offs[c]), int(tlb.count[c])
        assert set(tlb.ids[o:o + n].tolist()) == set(jcand[c, :jcount[c]].tolist())

    jl = jaccel.build_light_records(jlb, jscene)
    tl = taccel.build_light_records(tlb, tscene)
    jdata, joffs, jcnt, jkmax = (np.asarray(a) for a in jl)
    trec, toffs, tcnt, tkmax = (a.numpy() for a in tl)
    np.testing.assert_array_equal(tcnt, jcnt)
    np.testing.assert_allclose(tkmax, jkmax, rtol=1e-5, atol=1e-5)
    assert tcnt.sum() > 100
    for c in np.nonzero(tcnt)[0]:
        tr = trec[toffs[c]:toffs[c] + tcnt[c]]
        jr = jdata[:, joffs[c]:joffs[c] + jcnt[c]].T
        assert np.all(np.diff(tr[:, 4]) <= 0.0)     # keys non-increasing
        assert np.all(np.diff(jr[:, 4]) <= 0.0)
        to = np.lexsort((tr[:, 1], tr[:, 0], tr[:, 4]))
        jo = np.lexsort((jr[:, 1], jr[:, 0], jr[:, 4]))
        np.testing.assert_allclose(tr[to, :6], jr[jo, :6], rtol=1e-5, atol=1e-5)


def test_gather_chunk_data_matches():
    pos, cam, jscene, tscene, frame = _both()
    jb = jaccel.build_screen_bins(jscene, frame, W, H)
    ref = np.asarray(jgather(jb.sph_chunks, jscene.sph_center,
                             jscene.sph_radius, jscene.sph_color))
    s = scene_from_numpy(jscene, device="cpu")
    out = gather_chunk_data(torch.as_tensor(np.asarray(jb.sph_chunks, np.int64)),
                            s.sph_center, s.sph_radius, s.sph_color)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("ch,banded", [(128, False), (45, False), (128, True)],
                         ids=["ch128", "ch45", "ch128_banded"])
def test_gather_chunk_data_padded_ids_match(ch, banded):
    """The CPU gather (the plain version) against JAX's on the scene's
    spheres with random ids, -1 padding and all-padded chunks, bit for bit;
    banded in bands of 2 tiles."""
    _, _, jscene, _, _ = _both()
    s = scene_from_numpy(jscene, device="cpu")
    n = s.sph_center.shape[0]
    rng = np.random.default_rng(ch)
    ids = rng.integers(0, n, (7, 3, ch))
    ids[rng.random(ids.shape) < 0.3] = -1
    ids[1, -1] = -1
    ids[4] = -1
    parts = (jscene.sph_center, jscene.sph_radius, jscene.sph_color)
    tparts = (s.sph_center, s.sph_radius, s.sph_color)
    if banded:
        band = 2 * 3 * 8 * ch * 4
        ref = np.asarray(jgather_banded(jnp.asarray(ids, jnp.int32), *parts,
                                        band_bytes=band))
        out = gather_chunk_data_banded(torch.as_tensor(ids), *tparts,
                                       band_bytes=band)
    else:
        ref = np.asarray(jgather(jnp.asarray(ids, jnp.int32), *parts))
        out = gather_chunk_data(torch.as_tensor(ids), *tparts)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert np.array_equal(out.numpy().view(np.int32), ref.view(np.int32))
    assert (out.numpy()[4, :, 3] == -1.0).all()


def test_screen_bins_exact_power_of_two_total():
    """Fault C1: 256 on-screen spheres cover one tile each, so the pair total
    equals the JAX build's capacity (256), and 10 live off-screen spheres
    plus the scene's padding trail them with empty spans.  The JAX
    scatter-offset clamp (accel.py:86) then hands the last pair slot to a
    trailing empty item; the port must hold every pair the spans imply."""
    n_side, tile = 16, 16
    width = height = n_side * tile
    ij = np.mgrid[0:n_side, 0:n_side].reshape(2, -1).T
    on = np.c_[ij * tile + tile / 2.0, np.zeros(len(ij))]
    off = np.c_[np.full((10, 2), -1000.0), np.zeros(10)]
    pos = np.concatenate([on, off])
    colors = np.ones((len(pos), 4), np.float32)
    radii = np.full(len(pos), 2.0, np.float32)
    # orthographic, 1 px per world unit, pixel (x, y) at world (x, y)
    cam = CameraParams(is_perspective=False, field_of_view=height / 2.0,
                       position=(width / 2.0, height / 2.0, 100.0),
                       direction=(0.0, 0.0, -1.0), up=(0.0, 1.0, 0.0))
    frame = camera_frame(cam, width, height)
    tscene = build_scene(pos, colors, radii, device="cpu")
    assert tscene.sph_center.shape[0] == 512           # 246 padded slots
    tb = taccel.build_screen_bins(tscene, frame, width, height)

    g = taccel._screen_setup(frame, width, height, torch.float32, "cpu")
    tx0, ty0, sw, sh = taccel._screen_spans(
        tscene.sph_center, tscene.sph_radius, g["origin"], g["right"],
        g["up2"], g["view"], g["left"], g["bottom"], g["psx"], g["psy"],
        width, height, tile, False)
    brute = set()
    for i in range(len(tx0)):
        for dy in range(int(sh[i])):
            for dx in range(int(sw[i])):
                brute.add(((int(ty0[i]) + dy) * n_side + int(tx0[i]) + dx, i))
    assert len(brute) == 256
    nb = n_side * n_side
    cand = tb.sph_chunks.reshape(nb, -1).numpy()
    port = {(t, int(i)) for t in range(nb) for i in cand[t] if i >= 0}
    assert port == brute

    jscene = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                          jbuild_scene(pos, colors, radii, dtype=np.float32))
    jb = jaccel.build_screen_bins(jscene, frame, width, height)
    jc = np.asarray(jb.sph_chunks).reshape(nb, -1)
    jpairs = {(t, int(i)) for t in range(nb) for i in jc[t] if i >= 0}
    # where the JAX bins differ: the last pair (sphere 255 in tile 255) is
    # lost to the clamp, leaving a hole in the image
    assert brute - jpairs == {(255, 255)}
    assert jpairs <= brute
