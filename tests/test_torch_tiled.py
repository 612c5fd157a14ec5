"""Port parity: the tiled tracer (``tracer_tiled.py``) and its two kernels.

The same float32 inputs, made with numpy from a seed, go through the JAX
package and the port: the threefry jitter (``rng.py`` against ``jax.random``),
the chunked sphere closest hit and the light-grid shadow filter (the Pallas
kernels in interpret mode against the port's plain versions), the light
cells of all three kinds, ``render_image_pallas`` and ``render_image_tiled``
fed the same bins by ``convert.py``, and the whole heavy-bond slice through
``TachyonRender``.  ``chip_smoke.py`` holds the hand CUDA kernels against the
plain versions on the card.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mdapy_tpu
import mdapy_tpu_torch
from mdapy_tpu.render import accel as jaccel
from mdapy_tpu.render import geometry as jgeom
from mdapy_tpu.render import pallas_kernels as jpk
from mdapy_tpu.render import tracer_tiled as jtiled
from mdapy_tpu.render.camera import camera_frame, preset_camera
from mdapy_tpu.render.scene import build_scene as jbuild_scene
from mdapy_tpu.render.tracer import RenderConfig
from mdapy_tpu_torch.render import accel as taccel
from mdapy_tpu_torch.render import render as trender
from mdapy_tpu_torch.render import rng, tile_kernels, tracer_tiled
from mdapy_tpu_torch.render.config import RenderConfig as TorchConfig
from mdapy_tpu_torch.render.convert import (
    light_bins_from_numpy, light_records_from_numpy, scene_from_numpy,
    screen_bins_from_numpy,
)

W, H = 96, 80
GRID = 32
EPS = 4e-4


@functools.lru_cache(maxsize=None)
def _bcc_system(n=3):
    """A JAX ``System``: BCC Fe block, n^3 periodic cells, bonds < 2.6 A."""
    s = mdapy_tpu.build_crystal("Fe", "bcc", 2.8665, nx=n, ny=n, nz=n)
    s.create_bonds(rc=2.6)
    return s


def _f32(scene):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), scene)


@functools.lru_cache(maxsize=None)
def _scene(kind: str):
    """(JAX scene in float32, positions) of "spheres" (108 FCC atoms, random
    colours), "bonds" (the 3x3x3 BCC block with its bonds and cell) or
    "nospheres" (the bonds and cell alone)."""
    if kind == "spheres":
        frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
        cells = np.mgrid[0:3, 0:3, 0:3].reshape(3, -1).T
        pos = (frac[None] + cells[:, None]).reshape(-1, 3) * 3.615
        rng_ = np.random.default_rng(3)
        colors = np.c_[rng_.uniform(0.2, 1.0, (len(pos), 3)), np.ones(len(pos))]
        radii = np.full(len(pos), 1.28, np.float32)
        return _f32(jbuild_scene(pos, colors.astype(np.float32), radii,
                                 dtype=np.float32)), pos
    s = _bcc_system()
    pos = s.get_positions()
    rng_ = np.random.default_rng(5)
    colors = np.c_[rng_.uniform(0.2, 1.0, (s.N, 3)), np.ones(s.N)].astype(np.float32)
    radii = np.full(s.N, 0.5, np.float32)
    bonds, _ = jgeom.bond_edges(pos, s.box, s.bond, colors, radii, 0.2)
    keep = slice(None) if kind == "bonds" else slice(0)
    return _f32(jbuild_scene(
        pos[keep], colors[keep], radii[keep], bond_edges=bonds, bond_radius=0.2,
        box_edges=jgeom.box_edges(s.box), box_edge_radius=0.1,
        dtype=np.float32)), pos


@functools.lru_cache(maxsize=None)
def _accel(kind: str, preset: str, relit: bool = True):
    """The JAX frame, screen bins, light bins and sphere records of a scene,
    and the same carried into the port's structures.

    The preset cameras' light shines along the view, so the stored N-dot
    direction lights almost no visible surface and shadows hardly show
    (the reference's headlight geometry).  ``relit`` turns the light to come
    from beside the camera, which lights the visible surfaces and casts
    shadows onto them."""
    jscene, pos = _scene(kind)
    frame = camera_frame(preset_camera(preset, pos, max_radius=0.5), W, H)
    if relit:
        right = np.asarray(frame["iplaneright"], np.float64)
        L = -np.asarray(frame["view"]) + 0.8 * right / np.linalg.norm(right)
        frame = dict(frame, light_dir=L / np.linalg.norm(L))
    nlive = jaccel.scene_live_counts(jscene)
    jb = jaccel.build_screen_bins(jscene, frame, W, H, nlive=nlive)
    jlb = jaccel.build_light_bins(
        jscene, np.asarray(frame["light_dir"], np.float32), grid=GRID, nlive=nlive)
    jcd = None
    if jb.sph_chunks is not None:
        jcd = jpk.gather_chunk_data(jb.sph_chunks, jscene.sph_center,
                                    jscene.sph_radius, jscene.sph_color)
    tscene = scene_from_numpy(jscene, device="cpu")
    nb = jb.tiles_x * jb.tiles_y
    tb = screen_bins_from_numpy(
        jb.sph_chunks if jcd is not None else np.full((nb, 1, 128), -1),
        jb.sph_zmin if jcd is not None else np.full((nb, 1), 1e17, np.float32),
        jb.tiles_x, jb.tiles_y, cyl=jb.cyl, ring=jb.ring,
        ncyl=jscene.cyl_base.shape[0], device="cpu")
    tcd = None if jcd is None else torch.as_tensor(np.array(jcd))
    return (frame, jscene, jb, jlb, jcd, tscene, tb,
            light_bins_from_numpy(jlb, device="cpu"), tcd)


# ---------------------------------------------------------------------------
# (a) the threefry generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 20251])
def test_rng_matches_jax_random_bit_for_bit(seed):
    """``PRNGKey``, ``fold_in`` and ``uniform`` in float32, for the two
    shapes the tracer draws: exact."""
    jkey = jax.random.PRNGKey(seed)
    tkey = rng.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))
    ref = jax.random.uniform(jkey, (7, 3, 256, 2), jnp.float32, minval=-0.5,
                             maxval=0.5)
    got = rng.uniform(tkey, (7, 3, 256, 2), -0.5, 0.5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert -0.5 <= float(got.min()) and float(got.max()) < 0.5
    tiles = np.array([0, 1, 2, 119, 8159], np.int32)
    jkeys = [jax.random.fold_in(jkey, t) for t in tiles]
    tkeys = rng.fold_in(tkey, torch.as_tensor(tiles.astype(np.int64)))
    np.testing.assert_array_equal(tkeys.numpy(), np.stack([np.asarray(k) for k in jkeys]))
    ref = np.stack([np.asarray(jax.random.uniform(
        k, (3, 256, 2), jnp.float32, minval=-0.5, maxval=0.5)) for k in jkeys])
    np.testing.assert_array_equal(
        rng.uniform(tkeys, (3, 256, 2), -0.5, 0.5).numpy(), ref)
    np.testing.assert_array_equal(
        rng.random_bits(tkey, (5, 4)).numpy(),
        np.asarray(jax.random.bits(jkey, (5, 4), jnp.uint32)).astype(np.int64))


# ---------------------------------------------------------------------------
# (b), (c) the two kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _rays(frame, tiles_x, tiles_y, S, seed):
    """Tile-ordered rays (nb, 256 * S, 3) of a frame, jittered with numpy."""
    nb = tiles_x * tiles_y
    r = np.random.default_rng(seed)
    jit = r.uniform(-0.5, 0.5, (nb, S, 256, 2)).astype(np.float32)
    jit[:, 0] = 0.0
    tid = np.arange(nb)
    sub = np.arange(16, dtype=np.float32)
    px = ((tid % tiles_x) * 16)[:, None] + np.tile(sub, 16)[None] + 1.0
    py = ((tid // tiles_x) * 16)[:, None] + np.repeat(sub, 16)[None] + 1.0
    x = (px[:, None, :] + jit[..., 0]).reshape(nb, -1).astype(np.float32)
    y = (py[:, None, :] + jit[..., 1]).reshape(nb, -1).astype(np.float32)
    f = {k: np.asarray(frame[k], np.float32) for k in
         ("origin", "lowleft", "iplaneright", "iplaneup", "view")}
    p = f["lowleft"] + x[..., None] * f["iplaneright"] + y[..., None] * f["iplaneup"]
    if frame["perspective"]:
        d = p / np.linalg.norm(p, axis=-1, keepdims=True)
        o = np.broadcast_to(f["origin"], d.shape)
    else:
        o, d = p, np.broadcast_to(f["view"], p.shape)
    return np.ascontiguousarray(o, np.float32), np.ascontiguousarray(d, np.float32)


@pytest.mark.parametrize("preset,S", [("perspective", 3), ("top", 1)])
def test_kernels_plain_match_pallas_interpret(preset, S):
    """Chunked closest hit, then the shadow filter on its hits, each against
    the Pallas kernel in interpret mode on the same inputs.

    Closest hit: where both hit, ``best_t`` within rtol 1e-5 on at least
    98 % of the rays and within 5e-4 on all (XLA contracts b*b - c into an
    FMA; near a grazing hit sqrt(disc) is small and t = -b - sqrt(disc)
    moves by d(disc) / (2 sqrt(disc)): measured 1.2 % of the hits over 1e-5,
    the largest 8e-5), and on every ray within rtol 1e-5 plus the shift of
    the root under two float32 roundings of the discriminant's terms,
    eps32 (b^2 + |c|) / sqrt(disc) (measured 1.03 roundings at most: the
    excess over 1e-5 is that contraction and nothing else); the winner's
    record equal, and a miss exactly (1e18,
    zeros), on at least 99.9 % of the rays (the same FMA can flip a grazing
    hit, ROADMAP C6).  Shadow filter, lit from beside the camera: equal on
    all but 0.1 % of the lit rays (the same margin, at ck + sqrt(s2)
    against tau + eps; measured 0 of 7,867)."""
    frame, jscene, jb, jlb, jcd, tscene, tb, tlb, tcd = _accel("spheres", preset)
    o, d = _rays(frame, jb.tiles_x, jb.tiles_y, S, seed=11)
    nb, R = o.shape[:2]
    lo = np.asarray(jscene.sph_center - jscene.sph_radius[:, None])[:108].min(0)
    hi = np.asarray(jscene.sph_center + jscene.sph_radius[:, None])[:108].max(0)
    tcap = tracer_tiled._ray_box_texit(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(lo),
        torch.as_tensor(hi)).numpy()
    ref_cap = np.asarray(jtiled._ray_box_texit(
        jnp.asarray(o.reshape(-1, 3)), jnp.asarray(d.reshape(-1, 3)),
        jnp.asarray(lo), jnp.asarray(hi))).reshape(nb, R)
    np.testing.assert_allclose(tcap, ref_cap, rtol=1e-5)
    # rays that leave the box, and a tile without a candidate
    assert (tcap == -1e18).sum() > 100
    if preset == "perspective":
        assert int((np.asarray(jb.sph_zmin)[:, 0] >= 1e17).sum()) >= 1

    jt, jrec = jpk.closest_hit_spheres_tiles(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tcap), jb.sph_zmin, jcd,
        eps=EPS, interpret=True)
    jt, jrec = np.asarray(jt), np.asarray(jrec)
    before = dict(tile_kernels.launches)
    tt, trec = tile_kernels.closest_hit_spheres_tiles(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tcap),
        tb.sph_zmin, tcd, eps=EPS)
    assert tile_kernels.launches == before       # CPU tensors: the plain version
    tt, trec = tt.numpy(), trec.numpy()
    assert tt.shape == (nb, R) and trec.shape == (nb, R, 8)
    jmiss, tmiss = jt >= 1e17, tt >= 1e17
    assert 0.2 < tmiss.mean() < 0.9
    assert np.all(tt[tmiss] == np.float32(1e18)) and not trec[tmiss].any()
    both = ~jmiss & ~tmiss
    rel = np.abs(tt[both] - jt[both]) / jt[both]
    assert (rel > 1e-5).mean() <= 0.02 and rel.max() <= 5e-4, (rel.max(), (rel > 1e-5).mean())
    # every hit is within rtol 1e-5 plus what two float32 roundings of the
    # discriminant's terms move the root by (float64, the port's winner)
    oc = o.astype(np.float64)[both] - trec[both][:, :3]
    b = (oc * d.astype(np.float64)[both]).sum(-1)
    cc = (oc * oc).sum(-1) - trec[both][:, 3].astype(np.float64) ** 2
    sq = np.sqrt(np.maximum(b * b - cc, 1e-30))
    slack = np.finfo(np.float32).eps * (b * b + np.abs(cc)) / (2.0 * sq)
    excess = np.abs(tt[both].astype(np.float64) - jt[both]) - 1e-5 * jt[both]
    assert (excess <= 2.0 * slack).all(), (excess / slack).max()
    same = (jmiss == tmiss) & np.all(trec == jrec, axis=-1)
    assert same.mean() >= 0.999

    # the shadow filter on the port's hits
    t = np.where(tmiss, 0.0, tt)[..., None]
    hit = o + t * d
    n = hit - trec[..., :3]
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    L = np.asarray(jlb.L)
    lit = ((n @ L > 1.0 / 512.0) & ~tmiss).astype(np.int32)
    u = hit @ np.asarray(jlb.e1) - np.asarray(jlb.org)[0]
    v = hit @ np.asarray(jlb.e2) - np.asarray(jlb.org)[1]
    uvt = np.stack([u, v, hit @ L], axis=-1).astype(np.float32)
    cell = np.clip(np.floor(uvt[..., :2] * float(jlb.inv_cell)), 0,
                   GRID - 1).astype(np.int32)
    jl = jaccel.build_light_records(jlb, jscene)
    jf = np.asarray(jpk.shadow_filter_tiles(
        jnp.asarray(uvt), jnp.asarray(cell), jnp.asarray(lit), jl[0], jl[1],
        jl[2], grid_n=GRID, eps=EPS, interpret=True))
    lrec, loffs, lcnt, _ = light_records_from_numpy(*jl, device="cpu")
    tf = tile_kernels.shadow_filter_tiles(
        torch.as_tensor(uvt), torch.as_tensor(cell), torch.as_tensor(lit),
        lrec, loffs, lcnt, grid_n=GRID, eps=EPS).numpy()
    assert tile_kernels.launches == before
    assert set(np.unique(tf)) == {0.0, 1.0} and np.all(tf[lit == 0] == 1.0)
    nlit = int(lit.sum())
    assert nlit > 1000 and int((tf[lit == 1] == 0).sum()) > 50
    assert int((tf != jf).sum()) <= max(1, nlit // 1000)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    o = torch.zeros((2, 256, 3))
    cd = torch.zeros((2, 1, 8, 128))
    with pytest.raises(ValueError, match="CUDA"):
        tile_kernels.closest_hit_spheres_tiles_cuda(
            o, o, torch.zeros((2, 256)), torch.zeros((2, 1)), cd)
    with pytest.raises(ValueError, match="zmin"):
        tile_kernels.closest_hit_spheres_tiles(
            o, o, torch.zeros((2, 256)), torch.zeros((2, 3)), cd)
    with pytest.raises(ValueError, match="tcap"):
        tile_kernels.closest_hit_spheres_tiles(
            o, o, torch.zeros((2, 128)), torch.zeros((2, 1)), cd)
    z = torch.zeros(4, dtype=torch.int32)
    args = (torch.zeros((2, 256, 3)), torch.zeros((2, 256, 2), dtype=torch.int32),
            torch.zeros((2, 256), dtype=torch.int32), torch.zeros((0, 8)), z, z)
    with pytest.raises(ValueError, match="CUDA"):
        tile_kernels.shadow_filter_tiles_cuda(*args, grid_n=2)
    with pytest.raises(ValueError, match="offs"):
        tile_kernels.shadow_filter_tiles(*args, grid_n=3)
    assert bool((tile_kernels.shadow_filter_tiles(*args, grid_n=2) == 1).all())


# ---------------------------------------------------------------------------
# (d) light cells of all three kinds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["perspective", "top"])
def test_light_bins_of_three_kinds_match(preset):
    """The port's light cells hold the JAX cells' candidates, kind by kind
    and cell by cell (as sets; both orders are by key), with keys within
    1e-5 and in descending order; the converter gives the same."""
    frame, jscene, jb, jlb, _, tscene, _, conv, _ = _accel("bonds", preset)
    tlb = taccel.build_light_bins(
        tscene, np.asarray(frame["light_dir"], np.float32), grid=GRID,
        other_kinds=True)
    assert taccel.build_light_bins(tscene, np.asarray(frame["light_dir"]),
                                   grid=GRID).cyl is None
    total = 0
    for name in ("sph", "cyl", "ring"):
        jk, tk, ck = getattr(jlb, name), getattr(tlb, name), getattr(conv, name)
        jcand, jkeys, jcount = (np.asarray(a) for a in jk)
        np.testing.assert_array_equal(tk.count.numpy(), jcount)
        np.testing.assert_array_equal(ck.count.numpy(), jcount)
        np.testing.assert_array_equal(tk.offs.numpy(), np.cumsum(jcount) - jcount)
        for c in np.nonzero(jcount)[0]:
            n, o = jcount[c], int(tk.offs[c])
            ids, keys = tk.ids[o:o + n].numpy(), tk.keys[o:o + n].numpy()
            assert set(ids) == set(jcand[c, :n]) and len(set(ids)) == n
            assert np.all(np.diff(keys) <= 0)
            np.testing.assert_allclose(np.sort(keys), jkeys[c, :n], atol=1e-5)
            np.testing.assert_array_equal(ck.ids[o:o + n].numpy(), jcand[c, :n][::-1])
            np.testing.assert_array_equal(ck.keys[o:o + n].numpy(), jkeys[c, :n][::-1])
        total += int(jcount.sum())
    assert total > 2000 and int(np.asarray(jlb.cyl.count).max()) > 8


# ---------------------------------------------------------------------------
# (e), (f) the two tracers on the same bins
# ---------------------------------------------------------------------------


def _image_close(img, ref, n_bad, mean):
    d = np.abs(img - ref)
    assert ref.std() > 0.05 and img.shape == ref.shape
    assert int((d.max(axis=2) > 2e-3).sum()) <= n_bad, int((d.max(axis=2) > 2e-3).sum())
    assert d.mean() < mean, d.mean()


@pytest.mark.parametrize("kind,preset,aa,relit,band,eps", [
    ("spheres", "perspective", 2, True, None, 1e-2),   # light records: the shadow kernel
    ("spheres", "top", 0, False, None, EPS),
    ("bonds", "perspective", 0, True, None, 1e-2),     # light cells of three kinds
    ("bonds", "top", 2, False, (1, 4), EPS),           # tile rows 1-3, as the front end bands
    ("bonds", "perspective", 0, True, None, EPS),      # well lit at the production eps
])
def test_render_image_pallas_matches_jax(kind, preset, aa, relit, band, eps):
    """``render_image_pallas`` (plain kernels) against the JAX function
    (interpret mode, float32) on the same scene, bins and light cells, with
    light records for the sphere-only scene and without for the bond scene,
    the whole frame or a band with ``ty_offset`` and ``do_flip=False``.

    With AA on (S = 3) both sides trace the same jittered rays, bit for bit.
    Under the preset's own light almost no visible point is lit (see
    ``_accel``), so three cases are relit.  Two of those run at eps = 1e-2,
    because a lit point's test against its own primitive sits at a margin of
    eps, which the two sides' rounding of a grazing t (above) crosses at 4e-4
    (ROADMAP C6: measured 40 pixels at 4e-4 on the spheres, 1 at 1e-2).
    The bounds are the megakernel slice's on these scenes
    (tests/test_torch_bonds.py): at most 40 pixels over 2e-3 and a mean
    under 1e-3 with cylinders (thin-cylinder silhouettes, where XLA's FMA
    moves a grazing hit; measured 7 and 3), 2 pixels and 1e-4 without
    (measured 1 and 0).  The third holds the well-lit bond frame at the
    production eps = 4e-4: at most 100 of the 7,680 pixels over 2e-3 and a
    mean under 2e-3 (measured 66 and 1.1e-3; 2,025 points are lit and 688 of
    them shadowed).  Those pixels come from the hit points, not from the
    shadow pass: on one set of hit points the two passes agree on every one
    (``test_shadow_pass_matches_jax_on_the_same_points``)."""
    frame, jscene, jb, jlb, jcd, tscene, tb, tlb, tcd = _accel(kind, preset, relit)
    cfg = RenderConfig(aa_samples=aa, aa_enabled=aa > 0, ao_enabled=False,
                       shadows_enabled=True, eps=eps)
    cam = tuple(frame[k] for k in ("origin", "lowleft", "iplaneright",
                                   "iplaneup", "view", "light_dir"))
    persp = bool(frame["perspective"])
    jl = jaccel.build_light_records(jlb, jscene) if kind == "spheres" else None
    tl = light_records_from_numpy(*jl, device="cpu") if jl is not None else None
    ty0, ty1 = band or (0, jb.tiles_y)
    b0, b1 = ty0 * jb.tiles_x, ty1 * jb.tiles_x
    kb = (lambda k: None if k is None else jaccel.KindBins(k.cand[b0:b1], k.count[b0:b1]))
    jsub = jaccel.ScreenBins(jb.sph_chunks[b0:b1], jb.sph_zmin[b0:b1], kb(jb.cyl),
                             kb(jb.ring), jb.tiles_x, ty1 - ty0, 16)
    h = H if band is None else (ty1 - ty0) * 16
    more = {} if band is None else dict(ty_offset=ty0, do_flip=False)
    ref = np.asarray(jtiled.render_image_pallas(
        jscene, jsub, jcd[b0:b1], jlb, *cam, cfg, W, h, persp, 7, 16,
        jb.tiles_x, ty1 - ty0, interpret=True, light_records=jl,
        light_grid_n=GRID, **more))
    img = tracer_tiled.render_image_pallas(
        tscene, tracer_tiled.band_bins(tb, ty0, ty1), tcd[b0:b1], tlb, *cam,
        TorchConfig(**cfg._asdict()), W, h, persp, 7, 16, jb.tiles_x,
        ty1 - ty0, light_records=tl, **more).numpy()
    if kind == "bonds" and relit and eps == EPS:
        _image_close(img, ref, 100, 2e-3)
    elif kind == "bonds":
        _image_close(img, ref, 40, 1e-3)
    else:
        _image_close(img, ref, 2, 1e-4)


@pytest.mark.parametrize("kind,preset", [
    ("bonds", "perspective"), ("nospheres", "perspective"), ("bonds", "top")])
def test_shadow_pass_matches_jax_on_the_same_points(kind, preset):
    """``_shadow_filter_lb`` over the light cells of three kinds against the
    JAX function, at the production eps = 4e-4 and lit from beside the
    camera, on one set of hit points: the lit first hits of the port's
    closest-hit passes (S = 1).  Both sides get the same float32 points, so
    what differs is the pass alone: the blocked masks may differ on at most
    0.1 % of the points (measured 0 of 2,025, 2,009 and 2,065, with 688, 681
    and 83 of them blocked)."""
    frame, jscene, jb, jlb, _, tscene, tb, tlb, tcd = _accel(kind, preset)
    cfg = TorchConfig(aa_samples=0, aa_enabled=False, ao_enabled=False,
                      shadows_enabled=True, eps=EPS)
    origin, lowleft, ipr, ipu, view, light = (
        torch.as_tensor(np.asarray(frame[k], np.float32)) for k in (
            "origin", "lowleft", "iplaneright", "iplaneup", "view", "light_dir"))
    o, d = tracer_tiled._raygen(
        origin, lowleft, ipr, ipu, view, cfg, bool(frame["perspective"]), 7,
        16, jb.tiles_x, jb.tiles_y, 0, False)
    best_t, N, _ = tracer_tiled._closest(
        tscene, tb, tcd, tracer_tiled._other_of(tscene, tb, None), o, d, EPS,
        True)
    missed = best_t >= 1e17
    N = torch.where((N * d).sum(-1, keepdim=True) > 0, -N, N)
    lit = ((N * light).sum(-1) > 1.0 / 512.0) & ~missed
    pts = (o + torch.where(missed, 0.0, best_t)[..., None] * d)[lit]
    blocked = tracer_tiled._shadow_filter_lb(pts, tscene, tlb, light, EPS).numpy()
    ref = np.asarray(jtiled._shadow_filter_lb(
        jnp.asarray(pts.numpy()), jscene, jlb, jnp.asarray(light.numpy()), EPS,
        False)) == 0.0
    assert len(pts) > 1500 and int(blocked.sum()) > 50
    assert int((~blocked).sum()) > 500
    assert int((blocked != ref).sum()) <= len(pts) // 1000, int((blocked != ref).sum())


@pytest.mark.parametrize("kind", ["nospheres", "bonds"])
def test_render_image_tiled_matches_jax(kind):
    """``render_image_tiled`` on the bonds and cell alone (the front end's
    use of it) and with the atoms (cylinders, rings, then spheres), relit,
    S = 3 (per-tile ``fold_in`` jitter), shadows on, against the JAX
    function in float32, at eps = 1e-2; the bound of the bond scene above
    (measured 0 and 7 pixels over 2e-3; without the atoms 187 at eps =
    4e-4, the thin bonds' self-occlusion).  The same with transparency
    (ROADMAP A7t), at the same bound."""
    frame, jscene, jb, jlb, _, tscene, tb, tlb, _ = _accel(kind, "perspective")
    assert (jb.sph_chunks is None and jlb.sph is None) == (kind == "nospheres")
    assert jb.cyl is not None
    cfg = RenderConfig(aa_samples=2, aa_enabled=True, ao_enabled=False,
                       shadows_enabled=True, eps=1e-2)
    cam = tuple(frame[k] for k in ("origin", "lowleft", "iplaneright",
                                   "iplaneup", "view", "light_dir"))
    ref = np.asarray(jtiled.render_image_tiled(
        jscene, jb, jlb, *cam, cfg, W, H, True, 7, 16, jb.tiles_x, jb.tiles_y))
    tcfg = TorchConfig(**cfg._asdict())
    img = tracer_tiled.render_image_tiled(
        tscene, tb, tlb, *cam, tcfg, W, H, True, 7, 16, jb.tiles_x,
        jb.tiles_y).numpy()
    _image_close(img, ref, 40, 1e-3)
    # shadows matter on this scene, and transparency is not ported
    flat = tracer_tiled.render_image_tiled(
        tscene, tb, tlb, *cam, tcfg._replace(shadows_enabled=False), W, H,
        True, 7, 16, jb.tiles_x, jb.tiles_y).numpy()
    assert int((np.abs(flat - img).max(axis=2) > 0.1).sum()) > 20
    # and it peels a translucent scene: every other atom at alpha 0.4, the
    # cylinders and rings at 0.6, four peels and transmitted shadows
    # (``with_trans``), against the JAX function on the same colours
    glass = dataclasses.replace(
        jscene, sph_color=jscene.sph_color.at[::2, 3].set(0.4),
        cyl_color=jscene.cyl_color.at[:, 3].set(0.6),
        ring_color=jscene.ring_color.at[:, 3].set(0.6))
    tcfg = tcfg._replace(transparency=True)
    ref = np.asarray(jtiled.render_image_tiled(
        glass, jb, jlb, *cam, cfg._replace(transparency=True), W, H, True, 7,
        16, jb.tiles_x, jb.tiles_y))
    tglass = scene_from_numpy(glass, device="cpu")
    peeled = tracer_tiled.render_image_tiled(
        tglass, tb, tlb, *cam, tcfg, W, H, True, 7, 16, jb.tiles_x,
        jb.tiles_y).numpy()
    _image_close(peeled, ref, 40, 1e-3)
    assert int((np.abs(peeled - img).max(axis=2) > 0.05).sum()) > 100
    with pytest.raises(ValueError, match="opaque"):
        tracer_tiled.render_image_pallas(
            tglass, tb, None, tlb, *cam, tcfg, W, H, True, 7, 16,
            jb.tiles_x, jb.tiles_y)


# ---------------------------------------------------------------------------
# (g) the whole slice
# ---------------------------------------------------------------------------


def test_heavy_bond_render_matches_jax():
    """An 8x8x8 BCC block with its bonds and cell (over 8,192 cylinders and
    rings, so past the megakernel's limit) through ``render_system`` on both
    renderers, shadows on, AA off: the JAX renderer (float64 accel, its
    kernels in interpret mode) takes ``render_image_pallas``, and so does
    the port (f32, plain kernels).  Measured 6 pixels of 96x80 off by more
    than one level of the truncating quantizer and a mean of 0.027 levels
    (4,096 bonds, 13,668 cylinders and rings); the bound is the whole-slice
    bound of tests/test_torch_bonds.py, 40 pixels and a mean of 0.05."""
    s = _bcc_system(8)
    cam = mdapy_tpu.preset_camera("perspective", s.get_positions(), max_radius=0.5)
    kw = dict(camera=cam, width=W, height=H, draw_bond=True, bond_radius=0.2,
              radii=np.full(s.N, 0.5, np.float32))
    jren = mdapy_tpu.TachyonRender(backend="cpu", ao=False, antialiasing=False)
    jren.use_pallas = True
    ref = jren.render_system(s, **kw)
    assert jren._chunk_data_cached[0] == "pallas"
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False, antialiasing=False)
    img = ren.render_system(s, **kw)
    assert ren._route_name == "pallas"
    n_other = int((ren._scene[0].cyl_radius > 0).sum()
                  + (ren._scene[0].ring_rout > 0).sum())
    assert n_other > trender.OTHER_SHADOW_MAX
    assert img.shape == ref.shape == (H, W, 4) and img[..., :3].std() > 1
    d = np.abs(img.astype(np.int32) - ref.astype(np.int32))
    assert int((d.max(axis=2) > 1).sum()) <= 40, int((d.max(axis=2) > 1).sum())
    assert float(d.mean()) < 0.05
    # the frame is cached by view, and a device frame is the rounded tensor
    accel = ren._accel
    dev = ren.render_system(s, **kw)
    assert ren._accel is accel
    np.testing.assert_array_equal(dev, img)
