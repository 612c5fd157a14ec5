"""Port parity: bonds and box edges (cylinders and rings, kernel B1d) and
``TachyonRender.render_system``.

The same inputs, made with numpy from a seed, go through the JAX package and
the port: the cell-edge and bond geometry, the scene's cylinder and ring
arrays, the per-tile cyl/ring screen lists, the gathered records and
occluder tables, the light frame over all kinds, the kernel slice (the JAX
megakernel in interpret mode against the port's plain kernel path, fed the
same records by ``convert.py``) and the whole ``render_system`` slice.
``chip_smoke.py`` holds the hand CUDA kernel against the plain path on the
card.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mdapy_tpu
import mdapy_tpu_torch
from mdapy_tpu.core.box import Box
from mdapy_tpu.render import accel as jaccel
from mdapy_tpu.render import geometry as jgeom
from mdapy_tpu.render import megakernel as jmega
from mdapy_tpu.render.camera import camera_frame, preset_camera
from mdapy_tpu.render.pallas_kernels import gather_chunk_data
from mdapy_tpu.render.render import _fib_hemisphere as jfib_hemisphere
from mdapy_tpu.render.scene import build_scene as jbuild_scene
from mdapy_tpu.render.tracer import RenderConfig
from mdapy_tpu_torch.render import accel as taccel
from mdapy_tpu_torch.render import geometry as tgeom
from mdapy_tpu_torch.render import megakernel as tmega
from mdapy_tpu_torch.render import render as trender
from mdapy_tpu_torch.render.convert import (
    extra_lights_from_numpy, light_records_from_numpy, other_records_from_numpy,
    screen_bins_from_numpy,
)
from mdapy_tpu_torch.render.scene import build_scene

W, H = 96, 80
GRID = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _bcc_system(n=3):
    """A JAX ``System``: BCC Fe block, n^3 periodic cells, bonds < 2.6 A."""
    s = mdapy_tpu.build_crystal("Fe", "bcc", 2.8665, nx=n, ny=n, nz=n)
    s.create_bonds(rc=2.6)
    return s


@functools.lru_cache(maxsize=None)
def _bond_scene():
    """Positions, random colours, r = 0.5, and the JAX package's bond
    (r = 0.2) and box (r = 0.1) edges of a 3x3x3 BCC block."""
    s = _bcc_system()
    pos = s.get_positions()
    rng = np.random.default_rng(5)
    colors = np.c_[rng.uniform(0.2, 1.0, (s.N, 3)), np.ones(s.N)].astype(np.float32)
    radii = np.full(s.N, 0.5, np.float32)
    bonds, _ = jgeom.bond_edges(pos, s.box, s.bond, colors, radii, 0.2)
    return pos, colors, radii, bonds, jgeom.box_edges(s.box)


def _scenes(pos, colors, radii, bonds, box, bond_colors=None):
    kw = dict(bond_edges=bonds, bond_colors=bond_colors, bond_radius=0.2,
              box_edges=box, box_edge_radius=0.1)
    jscene = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                          jbuild_scene(pos, colors, radii, dtype=np.float32, **kw))
    return jscene, build_scene(pos, colors, radii, **kw, device="cpu")


@pytest.mark.parametrize("mode", ["uniform", "atom"])
def test_geometry_matches(mode):
    """Box edges and PBC bond segments on a triclinic cell, periodic in x and
    y, with bonds that cross the periodic faces: exact (float64, the same
    operations)."""
    matrix = np.array([[9.0, 0.0, 0.0], [2.5, 8.0, 0.0], [1.5, -1.0, 7.5]])
    box = Box(matrix, boundary=[1, 1, 0], origin=[1.0, -2.0, 0.5])
    rng = np.random.default_rng(11)
    pos = rng.random((40, 3)) @ matrix + box.origin
    d = pos[None] - pos[:, None]
    dmin = np.linalg.norm(box.pbc(d.reshape(-1, 3)).reshape(d.shape), axis=-1)
    i, j = np.nonzero(np.triu(dmin < 3.2, k=1))
    bond = np.c_[i, j]
    colors = np.c_[rng.random((40, 3)), np.ones(40)].astype(np.float32)
    radii = rng.uniform(0.2, 0.6, 40).astype(np.float32)
    np.testing.assert_array_equal(tgeom.box_edges(box), jgeom.box_edges(box))
    je, jc = jgeom.bond_edges(pos, box, bond, colors, radii, 0.15, mode)
    te, tc = tgeom.bond_edges(pos, box, bond, colors, radii, 0.15, mode)
    assert te.shape == je.shape and te.shape[0] > len(bond)   # face splits
    np.testing.assert_array_equal(te, je)
    if mode == "atom":
        np.testing.assert_array_equal(tc, jc)
    else:
        assert tc is None and jc is None


def test_element_tables_and_min_image_match():
    """The port's copies of the element tables and of the minimum image equal
    the JAX package's (exact)."""
    from mdapy_tpu.core import elements as jel
    from mdapy_tpu.core.box import min_image as jmin_image
    from mdapy_tpu_torch.core import elements as tel
    from mdapy_tpu_torch.core.box import min_image as tmin_image

    assert tel.ele_rgb == jel.ele_rgb
    assert tel.ele_radius == jel.ele_radius
    assert tel.type_rgb == jel.type_rgb
    matrix = np.array([[7.0, 0.0, 0.0], [1.5, 6.0, 0.0], [-1.0, 2.0, 8.0]])
    inv = np.linalg.inv(matrix)
    rij = np.random.default_rng(4).uniform(-15.0, 15.0, (200, 3))
    for boundary in ([1, 1, 1], [1, 0, 1], [0, 0, 0]):
        np.testing.assert_array_equal(tmin_image(rij, matrix, inv, boundary),
                                      jmin_image(rij, matrix, inv, boundary))


@pytest.mark.parametrize("preset", ["perspective", "top"])
def test_scene_bins_and_records_match(preset):
    pos, colors, radii, bonds, box = _bond_scene()
    rng = np.random.default_rng(2)
    bcol = np.c_[rng.random((len(bonds), 3)), np.ones(len(bonds))]
    bcol[::7, 3] = 0.0                          # alpha-0 bonds are dropped
    jscene, tscene = _scenes(pos, colors, radii, bonds, box, bond_colors=bcol)
    for name in ("cyl_base", "cyl_axis", "cyl_radius", "cyl_color",
                 "ring_center", "ring_normal", "ring_rout", "ring_color",
                 "sph_center", "sph_radius", "sph_color"):
        np.testing.assert_array_equal(getattr(tscene, name).numpy(),
                                      np.asarray(getattr(jscene, name)), name)
    assert int((tscene.cyl_radius > 0).sum()) > 200

    # per-tile cyl/ring lists in the kernel's slot order
    frame = camera_frame(preset_camera(preset, pos, max_radius=0.5), W, H)
    jb = jaccel.build_screen_bins(jscene, frame, W, H)
    tb = taccel.build_screen_bins(tscene, frame, W, H)
    ncyl = jscene.cyl_base.shape[0]
    jc, jr = np.asarray(jb.cyl.cand), np.asarray(jb.ring.cand)
    n_pairs = 0
    for t in range(tb.tiles_x * tb.tiles_y):
        want = np.r_[jc[t][jc[t] >= 0], jr[t][jr[t] >= 0] + ncyl]
        o, n = int(tb.oth_offs[t]), int(tb.oth_count[t])
        np.testing.assert_array_equal(tb.oth_ids[o:o + n].numpy(), want)
        n_pairs += n
    assert n_pairs > 500
    assert tb.k_other == jc.shape[1] + jr.shape[1]

    # the light frame spans the box edges too; the sphere records follow it
    L = np.asarray(frame["light_dir"], np.float32)
    jlb = jaccel.build_light_bins(jscene, L, grid=GRID)
    tlb = taccel.build_light_bins(tscene, L, grid=GRID)
    sph_only = taccel.build_light_bins(
        build_scene(pos, colors, radii, device="cpu"), L, grid=GRID)
    assert not torch.allclose(sph_only.org, tlb.org)
    for name in ("L", "e1", "e2", "org"):
        np.testing.assert_allclose(getattr(tlb, name).numpy(),
                                   np.asarray(getattr(jlb, name)), atol=1e-5)
    np.testing.assert_allclose(float(tlb.inv_cell), float(jlb.inv_cell), rtol=1e-6)
    jrec, joffs, jcnt, jkmax = light_records_from_numpy(
        *jaccel.build_light_records(jlb, jscene), device="cpu")
    trec, toffs, tcnt, tkmax = taccel.build_light_records(tlb, tscene)
    np.testing.assert_array_equal(tcnt.numpy(), jcnt.numpy())
    np.testing.assert_array_equal(toffs.numpy(), joffs.numpy())
    np.testing.assert_allclose(tkmax.numpy(), jkmax.numpy(), rtol=1e-5, atol=1e-5)
    for c in np.nonzero(tcnt.numpy())[0]:
        tr = trec.numpy()[toffs[c]:toffs[c] + tcnt[c]]
        jr_ = jrec.numpy()[joffs[c]:joffs[c] + jcnt[c]]
        to = np.lexsort((tr[:, 1], tr[:, 0], tr[:, 4]))
        jo = np.lexsort((jr_[:, 1], jr_[:, 0], jr_[:, 4]))
        np.testing.assert_allclose(tr[to, :6], jr_[jo, :6], rtol=1e-5, atol=1e-5)

    # gathered per-tile records and the occluder table with its cull rows
    jo = jaccel.gather_other_records(jb, jscene, jlb)
    table = taccel.other_table(tscene)
    orec, ooffs, ocnt = taccel.gather_other_records(tb, table)
    np.testing.assert_array_equal(ocnt.numpy(), np.asarray(jo[1]))
    want = other_records_from_numpy(jo[0], jo[1], device="cpu")
    np.testing.assert_array_equal(ooffs.numpy(), want.ooffs.numpy())
    np.testing.assert_allclose(orec.numpy(), want.orec.numpy(), rtol=1e-6, atol=1e-6)
    occ = taccel.occluder_records(table, tlb)
    assert occ.shape == (jo[3], 16)
    np.testing.assert_allclose(occ.numpy(), np.asarray(jo[2])[:, :jo[3]].T,
                               rtol=1e-6, atol=1e-5)


def _jax_inputs(preset, aa, shadows, ao_samples, eps, w, h):
    """The JAX package's scene, bins, records and params of the bond scene,
    as its renderer builds them for the megakernel (render.py:495-626)."""
    pos, colors, radii, bonds, box = _bond_scene()
    jscene, _ = _scenes(pos, colors, radii, bonds, box)
    frame = camera_frame(preset_camera(preset, pos, max_radius=0.5), w, h)
    cfg = RenderConfig(aa_samples=aa, aa_enabled=aa > 0,
                       ao_samples=ao_samples, ao_enabled=ao_samples > 0,
                       shadows_enabled=shadows, eps=eps)
    bins = jaccel.build_screen_bins(jscene, frame, w, h)
    lb = jaccel.build_light_bins(
        jscene, np.asarray(frame["light_dir"], np.float32), grid=GRID)
    cd = gather_chunk_data(bins.sph_chunks, jscene.sph_center,
                           jscene.sph_radius, jscene.sph_color)
    orec = jaccel.gather_other_records(bins, jscene, lb)
    lo, hi = (np.asarray(a, np.float32) for a in jscene.bounds())
    params = jmega.build_mega_params(frame, lb, lo, hi, cfg)
    extra = []
    if ao_samples:
        k2 = ao_samples // 2
        hemi = jfib_hemisphere(k2)
        for dk in np.concatenate([hemi, -hemi]):
            lb_k = jaccel.build_light_bins(jscene, np.asarray(dk, np.float32),
                                           grid=GRID)
            lr = jaccel.build_light_records(lb_k, jscene)
            p = jmega.build_mega_params(dict(frame, light_dir=dk), lb_k, lo,
                                        hi, cfg)
            lrow = np.r_[p[15:27], (4.0 / (2 * k2)) * cfg.ao_brightness,
                         0.5, 0.0, 0.0].astype(np.float32)
            occ = jaccel.gather_other_records(bins, jscene, lb_k)[2]
            extra.append((lrow, lr[0], lr[1], lr[2], occ, lr[3]))
    return frame, bins, cd, orec, params, extra, \
        jaccel.build_light_records(lb, jscene)


@pytest.mark.parametrize("preset,aa,shadows,ao", [
    ("perspective", 0, True, 0),
    ("perspective", 0, False, 0),
    ("top", 0, True, 0),
    ("top", 2, False, 0),
    ("perspective", 2, True, 0),    # S = 3
    ("top", 0, True, 2),            # 3 lights, 3 occluder tables (eps 1e-2)
])
def test_bond_kernel_slice_matches_interpret(preset, aa, shadows, ao):
    """The JAX records, carried over by convert.py, go through the JAX
    megakernel (interpret mode) and the port's plain kernel path.  The AO
    case runs at 64x48 to keep the interpret-mode kernel's time down."""
    eps = 1e-2 if ao else 4e-4          # sky-light self-occlusion, ROADMAP C6
    w, h = (64, 48) if ao else (W, H)
    frame, bins, cd, orec, params, extra, lr = _jax_inputs(
        preset, aa, shadows, ao, eps, w, h)
    persp = bool(frame["perspective"])
    kw = dict(S=aa + 1, width=w, height=h, tiles_x=bins.tiles_x,
              tiles_y=bins.tiles_y, grid_n=GRID, eps=eps, perspective=persp,
              shadows=shadows or bool(ao))
    ncl = GRID * GRID
    if not shadows:
        lr = (np.zeros((8, 128), np.float32), np.zeros(ncl, np.int32),
              np.zeros(ncl, np.int32), np.full(ncl, -1e18, np.float32))
    jl = lr if kw["shadows"] else (None,) * 4
    ref = np.asarray(jmega.render_image_mega(
        cd, bins.sph_zmin, jl[0], jl[1], jl[2], params, 0, lkmax=jl[3],
        other_data=orec[0], other_count=orec[1], occ_recs=orec[2],
        n_occ=orec[3], extra_lights=extra or None, ao_shared=True,
        interpret=True, **kw))

    tb = screen_bins_from_numpy(bins.sph_chunks, bins.sph_zmin, bins.tiles_x,
                                bins.tiles_y, device="cpu")
    lights = None
    if kw["shadows"]:
        primary = (light_records_from_numpy(*lr, device="cpu") if shadows
                   else (None,) * 4)
        lights = tmega.stack_lights(params, *primary,
                                    extra_lights=extra_lights_from_numpy(
                                        extra, device="cpu"),
                                    grid_n=GRID)
    other = other_records_from_numpy(*orec, extra_occ=[e[4] for e in extra],
                                     device="cpu")
    assert (other.occ.shape == (1 + len(extra), orec[3], 16)
            and orec[3] > 200)
    before = tmega.launches
    img = tmega.render_image_mega(torch.as_tensor(np.array(cd)), tb.sph_zmin,
                                  lights, params, 0, other=other, **kw).numpy()
    assert tmega.launches == before          # CPU tensors: the plain version
    assert img.shape == (h, w, 3) and ref.std() > 0.05
    d = np.abs(img - ref)
    if persp:
        # Thin-cylinder silhouettes: XLA on the CPU contracts the cylinder
        # quadratic's bq*bq - a2*cq into an FMA, and near a grazing hit the
        # normal moves with it.  Measured 13 (S = 1, shadows), 14 (S = 1,
        # no shadows) and 36 (S = 3) pixels over 2e-3, means 1.1e-5 to
        # 1.1e-4; the bound is the JAX package's own for its megakernel on
        # a bond scene (tests/test_render_transparency.py:257-263).
        assert int((d.max(axis=2) > 2e-3).sum()) <= 40
        assert d.mean() < 1e-3
    else:
        # through the orthographic camera the two sides agree to 1 pixel
        # (measured 0 to 1 over 1e-3); the sphere slice's bound
        assert int((d.max(axis=2) > 1e-3).sum()) <= 2
        assert d.mean() < 1e-4

    # the cylinders matter: without them the frame differs
    bare = tmega.render_image_mega(torch.as_tensor(np.array(cd)), tb.sph_zmin,
                                   lights, params, 0, **kw).numpy()
    assert np.abs(bare - img).mean() > 0.01


def test_render_system_matches_jax():
    """The whole slice: the port's ``render_system(draw_bond=True)`` (f32,
    plain kernel) against the JAX renderer's (float64 accel, the
    interpret-mode megakernel) on a JAX ``System``, shadows on, AA off,
    default colours and box, through the perspective preset camera.

    The JAX renderer builds its records in float64 and the port in float32,
    which moves thin-cylinder silhouettes and grazing normals a little:
    measured 8 pixels of 96x80 off by more than one level of the truncating
    quantizer and a mean of 0.0099 levels.  The bounds are the kernel
    slice's perspective count, 40 pixels, and a mean of 0.05 levels."""
    s = _bcc_system()
    cam = mdapy_tpu.preset_camera("perspective", s.get_positions(),
                                  max_radius=0.5)
    kw = dict(camera=cam, width=W, height=H, draw_bond=True, bond_radius=0.2,
              radii=np.full(s.N, 0.5, np.float32))
    jren = mdapy_tpu.TachyonRender(backend="cpu", ao=False, antialiasing=False)
    jren.use_pallas = True            # interpret-mode megakernel on the CPU
    ref = jren.render_system(s, **kw)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False,
                                        antialiasing=False)
    img = ren.render_system(s, **kw)
    assert img.shape == ref.shape == (H, W, 4) and img.dtype == np.uint8
    d = np.abs(img.astype(np.int32) - ref.astype(np.int32)).max(axis=2)
    assert img[..., :3].std() > 1
    assert int((d > 1).sum()) <= 40
    assert float(np.abs(img.astype(np.int32) - ref.astype(np.int32)).mean()) < 0.05
    # the box is drawn by default: without it the frame differs
    nobox = ren.render_system(s, draw_box=False, **kw)
    assert int((np.abs(nobox.astype(np.int32) - img).max(axis=2) > 8).sum()) > 50
    other = ren._other
    assert other is not None and other.occ.shape[0] == 1


def test_render_system_ao_matches_jax(monkeypatch):
    """The whole AO slice with bonds and the box: 3 lights, each with its
    own occluder table, through an orthographic camera (ROADMAP C6), against
    the JAX renderer in fast-AO mode, at 64x48.

    Measured 0 pixels off by more than one level at 64x48; at 96x80 the
    same scene has 10, where the float64 (JAX) and float32 (port) records
    put a sky light's self-occlusion test of a bond on either side of eps
    (the margin of ROADMAP C6).  The bound is the sphere AO slice's, 4."""
    monkeypatch.setenv("MDAPY_TPU_AO_MODE", "fast")
    monkeypatch.setattr(trender, "AO_EXACT_MAX_SPHERES", 0)
    s = _bcc_system()
    cam = mdapy_tpu.preset_camera("top", s.get_positions(), max_radius=0.5)
    opts = dict(ao=True, ao_samples=2, antialiasing=False)
    kw = dict(camera=cam, width=64, height=48, draw_bond=True, bond_radius=0.2,
              radii=np.full(s.N, 0.5, np.float32))
    jren = mdapy_tpu.TachyonRender(backend="cpu", **opts)
    jren.use_pallas = True
    ref = jren.render_system(s, **kw)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", **opts)
    img = ren.render_system(s, **kw)
    d = np.abs(img.astype(np.int32) - ref.astype(np.int32)).max(axis=2)
    assert img[..., :3].std() > 1
    assert int((d > 1).sum()) <= 4
    other = ren._other
    assert other.occ.shape[0] == 3 and len(ren._ao) == 2
    assert all(e[5] is not None for e in ren._ao)


def test_tile_with_only_cylinders_is_live():
    """A box three times the size of the atoms: tiles that hold box edges
    and no sphere are drawn, not left as background."""
    pos, colors, radii, bonds, _ = _bond_scene()
    lo, hi = pos.min(0), pos.max(0)
    c, half = 0.5 * (lo + hi), 1.5 * (hi - lo)
    box = Box(np.diag(2 * half), origin=c - half)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False,
                                        antialiasing=False)
    edges = tgeom.box_edges(box)
    cam = mdapy_tpu_torch.preset_camera("perspective", np.r_[edges[:, 0], edges[:, 1]])
    img = ren.render(pos, colors, radii, camera=cam, box_edges=edges,
                     box_edge_radius=0.3, width=W, height=H)
    bins = ren._accel[1]
    sph_dead = ~(bins.sph_zmin[:, 0] < 1e17)
    only_cyl = sph_dead & (bins.oth_count > 0)
    assert int(only_cyl.sum()) > 5
    tiles = img[..., :3].reshape(H // 16, 16, W // 16, 16, 3)[::-1]
    tiles = tiles.transpose(0, 2, 1, 3, 4).reshape(-1, 256, 3)
    assert int(tiles[only_cyl.numpy()].max()) > 100     # box edges drawn
    assert int(tiles[(sph_dead & (bins.oth_count == 0)).numpy()].max()) == 0
