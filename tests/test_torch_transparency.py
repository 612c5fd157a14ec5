"""Port parity: transparency peeling (kernel B1e) through the megakernel.

A scene with any alpha < 1 on an atom, bond or box edge renders in peels:
each peel composites its hit by alpha and the next starts past it, shadows
become transmissions (each occluder multiplies by 1 - alpha), and the AO sky
lights' shared occlusion becomes a float per light.  The same inputs, made
with numpy from a seed, go through the JAX package (its megakernel in
interpret mode, ``n_peel=4`` or ``peel1``) and the port's plain kernel path
(``mega_render_plain``, fed the same records by ``convert.py``), and through
both packages' ``TachyonRender``.  ``chip_smoke.py`` holds the hand CUDA
kernel against the plain path on the card.

The scenes are copies of ``tests/test_render_transparency.py``'s
``_alpha_scene`` and ``_alpha_bond_scene``, and the tolerances that file's
own: the port walks each ray's transmission to 1e-3 where the JAX kernel's
window sweep may go on multiplying it (ROADMAP C7), a difference of at most
1e-3 of a light's weight.
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
from mdapy_tpu.render.scene import build_scene as jbuild_scene
from mdapy_tpu.render.tracer import RenderConfig
from mdapy_tpu_torch.render import megakernel as tmega
from mdapy_tpu_torch.render import render as trender
from mdapy_tpu_torch.render.convert import (
    light_records_from_numpy, other_records_from_numpy, screen_bins_from_numpy,
)
from mdapy_tpu_torch.render.scene import build_scene

from _jax_geometry import jax_sphere_hit

W, H = 96, 80
GRID = 32


def _alpha_scene(n=3, seed=5):
    a = 3.615
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.mgrid[0:n, 0:n, 0:n].reshape(3, -1).T
    pos = (frac[None] + cells[:, None]).reshape(-1, 3) * a
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0.2, 1.0, (len(pos), 3))
    # mixed alphas: ~half translucent, rest opaque
    alpha = np.where(rng.uniform(size=len(pos)) < 0.5,
                     rng.uniform(0.3, 0.7, len(pos)), 1.0)
    colors = np.c_[rgb, alpha].astype(np.float32)
    radii = np.full(len(pos), 1.28, np.float32)
    return pos, colors, radii


def _alpha_bond_scene(n=2, seed=7):
    """Transparent spheres + alpha bonds + box edges (cyl/ring scene)."""
    a = 3.615
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.mgrid[0:n, 0:n, 0:n].reshape(3, -1).T
    pos = (frac[None] + cells[:, None]).reshape(-1, 3) * a
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0.2, 1.0, (len(pos), 3))
    alpha = np.where(rng.uniform(size=len(pos)) < 0.5,
                     rng.uniform(0.3, 0.7, len(pos)), 1.0)
    colors = np.c_[rgb, alpha].astype(np.float32)
    radii = np.full(len(pos), 0.9, np.float32)
    # nearest-neighbor bonds within 2.7 A
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    ii, jj = np.where((d > 0.1) & (d < 2.7))
    keep = ii < jj
    edges = np.stack([pos[ii[keep]], pos[jj[keep]]], axis=1)[:40]
    bcol = np.c_[rng.uniform(0.3, 1.0, (len(edges), 3)),
                 np.where(rng.uniform(size=len(edges)) < 0.5, 0.5, 1.0)
                 ].astype(np.float32)
    lo, hi = pos.min(0) - 1.5, pos.max(0) + 1.5
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]]])
    box_edges = np.stack([corners, np.roll(corners, -1, 0)], axis=1)
    return pos, colors, radii, edges, bcol, box_edges


BOND_KW = dict(bond_radius=0.25, box_edge_radius=0.12,
               box_color=(1.0, 1.0, 1.0, 0.6))


def _slice(bonds, preset, aa, shadows, n_peel, peel1):
    """The JAX megakernel (interpret mode) and the port's plain kernel path
    on the same JAX-built records: (ref, img) (H, W, 3) f32."""
    if bonds:
        pos, colors, radii, edges, bcol, box = _alpha_bond_scene()
        kw = dict(bond_edges=edges, bond_colors=bcol, box_edges=box, **BOND_KW)
    else:
        pos, colors, radii = _alpha_scene()
        kw = {}
    cam = preset_camera(preset, pos, max_radius=float(radii.max()))
    scene = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                         jbuild_scene(pos, colors, radii, dtype=np.float32, **kw))
    frame = camera_frame(cam, W, H)
    persp = bool(frame["perspective"])
    cfg = RenderConfig(aa_samples=aa, aa_enabled=aa > 0, ao_samples=0,
                       ao_enabled=False, shadows_enabled=shadows,
                       transparency=True, max_trans=1 if peel1 else n_peel)
    bins = jaccel.build_screen_bins(scene, frame, W, H)
    lb = jaccel.build_light_bins(
        scene, np.asarray(frame["light_dir"], np.float32), grid=GRID)
    cd = gather_chunk_data(bins.sph_chunks, scene.sph_center,
                           scene.sph_radius, scene.sph_color)
    lo, hi = (np.asarray(a, np.float32) for a in scene.bounds())
    params = jmega.build_mega_params(frame, lb, lo, hi, cfg)
    lr = jaccel.build_light_records(lb, scene)
    jl = lr if shadows else (None,) * 4
    okw = {}
    other = None
    if bonds:
        orec = jaccel.gather_other_records(bins, scene, lb)
        okw = dict(other_data=orec[0], other_count=orec[1], occ_recs=orec[2],
                   n_occ=orec[3])
        other = other_records_from_numpy(*orec, device="cpu")
        assert other.occ.shape[1] == orec[3] > 100
    kw = dict(S=aa + 1, width=W, height=H, tiles_x=bins.tiles_x,
              tiles_y=bins.tiles_y, grid_n=GRID, eps=cfg.eps,
              perspective=persp, shadows=shadows, n_peel=n_peel, peel1=peel1)
    ref = np.asarray(jmega.render_image_mega(
        cd, bins.sph_zmin, jl[0], jl[1], jl[2], params, 0, lkmax=jl[3],
        interpret=True, **okw, **kw))
    tb = screen_bins_from_numpy(bins.sph_chunks, bins.sph_zmin, bins.tiles_x,
                                bins.tiles_y, device="cpu")
    lights = (tmega.stack_lights(params, *light_records_from_numpy(
        *lr, device="cpu"), grid_n=GRID) if shadows else None)
    before = tmega.launches
    img = tmega.render_image_mega(torch.as_tensor(np.array(cd)), tb.sph_zmin,
                                  lights, params, 0, other=other, **kw)
    assert tmega.launches == before          # CPU tensors: the plain version
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    assert ref.std() > 0.05
    opaque = tmega.render_image_mega(
        torch.as_tensor(np.array(cd)), tb.sph_zmin, lights, params, 0,
        other=other, **dict(kw, n_peel=1, peel1=False)).numpy()
    # the peels matter: the opaque kernel draws another picture
    assert int((np.abs(opaque - img.numpy()).max(axis=2) > 0.05).sum()) > 100
    return ref, img.numpy()


@pytest.mark.parametrize("preset,aa,shadows,n_peel,peel1", [
    ("perspective", 0, False, 4, False),
    ("perspective", 0, True, 4, False),
    ("top", 0, True, 4, False),
    ("top", 0, False, 4, False),
    ("top", 2, True, 4, False),            # AA on: S = 3, the hash bit-exact
    ("perspective", 0, True, 1, True),     # peel1: one composited peel
    ("perspective", 2, True, 1, True),
    ("top", 2, True, 1, True),
])
def test_peel_kernel_slice_matches_interpret(monkeypatch, preset, aa, shadows,
                                             n_peel, peel1):
    """The sphere scene: at most 3 pixels off by more than 2e-3 in a
    channel, mean below 2e-4 (``test_render_transparency.py:84-86``), the
    port's plain version with the JAX kernel's sphere hit
    (``tests/_jax_geometry.py``).

    With AA, n_peel 4 is held through the orthographic camera (measured 0
    pixels over 2e-3).  Through the perspective camera each sample's
    direction comes from an rsqrt that XLA on the CPU rounds differently
    from torch (ROADMAP C6), and a later peel starts where the earlier one
    hit: at S = 3 that moved 4 (no shadows) to 6 (shadows) pixels of this
    96x80 frame over 2e-3, at a mean of 3e-6, one sample of a pixel meeting
    or missing a silhouette.  S = 1 and peel1 at S = 3 stay within the
    bound through both cameras."""
    jax_sphere_hit(monkeypatch)
    ref, img = _slice(False, preset, aa, shadows, n_peel, peel1)
    d = np.abs(img - ref)
    assert int((d.max(axis=2) > 2e-3).sum()) <= 3
    assert d.mean() < 2e-4


@pytest.mark.parametrize("preset,shadows", [
    ("perspective", False), ("perspective", True), ("top", True),
])
def test_peel_bond_kernel_slice_matches_interpret(preset, shadows):
    """Translucent atoms, bonds (alpha 0.5) and box edges (alpha 0.6): at
    most 40 pixels off by more than 2e-3, mean below 1e-3, the JAX
    package's bound for its megakernel on this scene
    (``test_render_transparency.py:257-263``; thin-cylinder silhouettes)."""
    ref, img = _slice(True, preset, 0, shadows, 4, False)
    d = np.abs(img - ref)
    assert int((d.max(axis=2) > 2e-3).sum()) <= 40
    assert d.mean() < 1e-3


def _plain_inputs(colors):
    pos, _, radii = _alpha_scene()
    from mdapy_tpu_torch.render.accel import (
        build_light_bins, build_light_records, build_screen_bins,
    )
    from mdapy_tpu_torch.render.camera import camera_frame as tframe
    from mdapy_tpu_torch.render.config import RenderConfig as TConfig
    from mdapy_tpu_torch.render.gather import gather_chunk_data as tgather

    scene = build_scene(pos, colors, radii, device="cpu")
    frame = tframe(preset_camera("perspective", pos, max_radius=1.28), W, H)
    bins = build_screen_bins(scene, frame, W, H)
    lb = build_light_bins(scene, frame["light_dir"], grid=GRID)
    cd = tgather(bins.sph_chunks, scene.sph_center, scene.sph_radius,
                 scene.sph_color)
    lo, hi = trender._scene_aabb(scene)
    params = tmega.build_mega_params(frame, lb, lo, hi, TConfig(aa_samples=2))
    lights = tmega.stack_lights(params, *build_light_records(lb, scene),
                                grid_n=GRID)
    kw = dict(S=3, tiles_x=bins.tiles_x, grid_n=GRID, eps=4e-4,
              perspective=True, shadows=True)
    return (cd, bins.sph_zmin, lights, params, 0), kw


def test_opaque_scene_equal_at_any_peel_budget():
    """An opaque scene through the peel path equals the opaque path in the
    port exactly: n_peel 4 and peel1 against n_peel 1 (every weight is 0
    after the first peel, every transmission 0 or 1)."""
    _, colors, _ = _alpha_scene()
    colors[:, 3] = 1.0
    args, kw = _plain_inputs(colors)
    one = tmega.mega_render_plain(*args, **kw)
    assert float(one.std()) > 0.05
    assert torch.equal(tmega.mega_render_plain(*args, n_peel=4, **kw), one)
    assert torch.equal(tmega.mega_render_plain(*args, peel1=True, **kw), one)
    with pytest.raises(ValueError, match="n_peel"):
        tmega.mega_render_plain(*args, n_peel=0, **kw)
    with pytest.raises(ValueError, match="peel1"):
        tmega.mega_render_plain(*args, n_peel=4, peel1=True, **kw)


def test_transmission_walk_and_peel_skip():
    """The plain walk's transmission: a ray behind two translucent records
    keeps (1 - a1)(1 - a2); an opaque record (alpha >= 0.99999) stops it at
    0; past the 1e-3 floor the walk ends.  And the peel budget: more peels
    change a translucent frame until every ray has left the block."""
    # two records over the point (u, v) = (0, 0) at depths 5 and 3, above
    # tau = 0; keys descending
    def recs(alphas):
        rows = [[0.0, 0.0, 5.0 - 2.0 * k, 1.0, 6.0 - 2.0 * k, a, 0.0, 0.0]
                for k, a in enumerate(alphas)]
        return torch.tensor(rows, dtype=torch.float32)

    z = torch.zeros(1)
    one = torch.ones(1, dtype=torch.int32)
    for alphas, want in (([0.5, 0.25], 0.5 * 0.75), ([0.5, 0.999995], 0.0),
                         ([0.9995, 0.5], np.float32(1.0) - np.float32(0.9995))):
        lrec = recs(alphas)
        tr = tmega._shadow_blocked(lrec, torch.zeros(1, dtype=torch.int32),
                                   one * len(alphas), None, z, z, z,
                                   torch.zeros(1, dtype=torch.int64), 4e-4,
                                   trans=True)
        assert float(tr) == pytest.approx(float(want), abs=1e-7), alphas
    walked = torch.zeros(1, dtype=torch.int64)
    tmega._shadow_blocked(recs([0.9995, 0.5]), torch.zeros(1, dtype=torch.int32),
                          one * 2, None, z, z, z, torch.zeros(1, dtype=torch.int64),
                          4e-4, walked=walked, trans=True)
    assert int(walked) == 1                 # the floor ended the walk

    pos, colors, radii = _alpha_scene()
    args, kw = _plain_inputs(colors)
    frames = [tmega.mega_render_plain(*args, n_peel=n, **kw)
              for n in (2, 4, 16, 24)]
    assert float((frames[1] - frames[0]).abs().max()) > 0.01
    # no ray meets 16 surfaces of this block: the peels have converged
    assert torch.equal(frames[3], frames[2])


def _jax_renderer(**opts):
    jren = mdapy_tpu.TachyonRender(backend="cpu", **opts)
    jren.use_pallas = True            # interpret-mode megakernel on the CPU
    return jren


def _levels(img, ref, bound):
    assert img.shape == ref.shape and img.dtype == np.uint8
    d = np.abs(img[..., :3].astype(np.int32) - ref[..., :3].astype(np.int32))
    assert img[..., :3].std() > 1
    assert int((d.max(axis=2) > 1).sum()) <= bound


@pytest.mark.parametrize("preset", ["perspective", "top"])
def test_transparent_render_matches_jax_renderer(preset):
    """The whole slice: the port's ``TachyonRender(backend="cpu")`` (f32,
    plain kernel, n_peel = max_trans = 4) against the JAX renderer's (float64
    accel, the interpret-mode megakernel) on the translucent sphere scene,
    AA off, shadows on: at most 4 pixels off by more than one level."""
    pos, colors, radii = _alpha_scene()
    cam = mdapy_tpu.preset_camera(preset, pos, max_radius=1.28)
    kw = dict(camera=cam, width=W, height=H)
    opts = dict(ao=False, antialiasing=False)
    ref = _jax_renderer(**opts).render(pos, colors, radii, **kw)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", **opts)
    img = ren.render(pos, colors, radii, **kw)
    _levels(img, ref, 4)
    assert ren._route_name == "mega" and ren._scene[6]
    # an opaque frame of the same renderer turns transparency off again
    opaque = colors.copy()
    opaque[:, 3] = 1.0
    solid = ren.render(pos, opaque, radii, **kw)
    assert not ren._scene[6]
    assert int((np.abs(solid.astype(np.int32) - img).max(axis=2) > 8).sum()) > 100
    _levels(solid, _jax_renderer(**opts).render(pos, opaque, radii, **kw), 4)


def test_transparent_ao_render_matches_jax_renderer(monkeypatch):
    """AO with peeling (4 sky lights sharing sample 0's transmission per
    peel), through the orthographic camera (ROADMAP C6), against the JAX
    renderer in fast-AO mode, at 48x32 to keep the interpret-mode kernel's
    time down: at most 4 pixels off by more than one level."""
    monkeypatch.setenv("MDAPY_TPU_AO_MODE", "fast")
    monkeypatch.setattr(trender, "AO_EXACT_MAX_SPHERES", 0)
    pos, colors, radii = _alpha_scene()
    cam = mdapy_tpu.preset_camera("top", pos, max_radius=1.28)
    opts = dict(ao=True, ao_samples=4, antialiasing=False)
    kw = dict(camera=cam, width=48, height=32)
    ref = _jax_renderer(**opts).render(pos, colors, radii, **kw)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", **opts)
    img = ren.render(pos, colors, radii, **kw)
    _levels(img, ref, 4)
    assert ren._accel[3].lparams.shape == (5, 16) and ren._scene[6]


def test_transparent_render_system_matches_jax(monkeypatch):
    """``render_system`` with translucent atoms (alpha 0.4), bonds (alpha
    0.5) and cell edges (alpha 0.6), through the orthographic camera, both
    renderers drawing on a JAX ``System``: at most 4 pixels off by more than
    one level; max_trans 1 takes ``peel1`` in both."""
    s = mdapy_tpu.build_crystal("Fe", "bcc", 2.8665, nx=2, ny=2, nz=2)
    s.create_bonds(rc=2.6)
    colors = np.c_[np.tile([[0.2, 0.6, 0.9]], (s.N, 1)), np.full(s.N, 0.4)]
    cam = mdapy_tpu.preset_camera("top", s.get_positions(), max_radius=0.5)
    kw = dict(camera=cam, width=W, height=H, draw_bond=True, bond_radius=0.2,
              radii=np.full(s.N, 0.5, np.float32),
              colors=colors.astype(np.float32),
              bond_color=(0.8, 0.8, 0.8, 0.5), box_color=(1.0, 1.0, 1.0, 0.6))
    opts = dict(ao=False, antialiasing=False)
    ref = _jax_renderer(**opts).render_system(s, **kw)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", **opts)
    img = ren.render_system(s, **kw)
    _levels(img, ref, 4)
    assert ren._route_name == "mega" and ren._other.occ.shape[0] == 1
    # max_trans 1: peel1 on both sides
    jren = _jax_renderer(**opts)
    jren._cfg = jren._cfg._replace(max_trans=1)
    ren._cfg = ren._cfg._replace(max_trans=1)
    one = ren.render_system(s, **kw)
    _levels(one, jren.render_system(s, **kw), 4)
    assert np.abs(one.astype(np.int32) - img).mean() > 0.5


def test_transparent_routes_off_the_megakernel_raise(monkeypatch):
    """Where the JAX renderer sends a transparent scene to its exact tracer
    (render.py:435-445), past the megakernel's cylinder limits or without a
    live sphere, the port takes its exact tracer (ROADMAP A6), in float64:
    at most 2 pixels of the JAX renderer's frame (``backend="cpu"``, which
    takes the exact tracer there too) off by more than one level (measured
    0, 0 and 0)."""
    pos, colors, radii, edges, bcol, box = _alpha_bond_scene()
    opaque = colors.copy()
    opaque[:, 3] = 1.0
    kw = dict(bond_edges=edges, width=32, height=32)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False)
    monkeypatch.setattr(trender, "OTHER_TILE_MAX", 8)
    assert ren.render(pos, opaque, radii, **kw).shape == (32, 32, 4)
    assert ren._route_name == "pallas"
    # AA off on both sides keeps the JAX tracer's time down
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False,
                                        antialiasing=False)
    jren = mdapy_tpu.TachyonRender(backend="cpu", ao=False, antialiasing=False)
    for c, extra in ((colors, {}), (opaque, dict(bond_colors=bcol))):
        img = ren.render(pos, c, radii, **extra, **kw)
        assert ren._route_name == "exact" and ren._scene[6]
        _levels(img, jren.render(pos, c, radii, **extra, **kw), 2)
    monkeypatch.setattr(trender, "OTHER_TILE_MAX", 512)
    none = (np.zeros((0, 3)), np.zeros((0, 4), np.float32),
            np.zeros(0, np.float32))
    cam = mdapy_tpu_torch.preset_camera("perspective", pos, max_radius=0.9)
    assert ren.render(*none, camera=cam, **kw).shape == (32, 32, 4)
    assert ren._route_name == "tiled"
    glass = dict(camera=cam, box_edges=box, box_color=(1.0, 1.0, 1.0, 0.5))
    img = ren.render(*none, **glass, **kw)
    assert ren._route_name == "exact"
    _levels(img, jren.render(*none, **glass, **kw), 2)
