"""Port parity: the render kernel slice and the whole render slice.

The port's kernel path runs here as its plain torch version (CPU tensors);
the hand CUDA kernel is held against that plain version on the card by
``chip_smoke.py``.  The JAX reference runs the Pallas megakernel in
interpret mode, as ``tests/test_render_mega.py`` does.
"""

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
from mdapy_tpu.render import megakernel as jmega
from mdapy_tpu.render.accel import (
    build_light_bins, build_light_records, build_screen_bins,
)
from mdapy_tpu.render.camera import camera_frame, preset_camera
from mdapy_tpu.render.pallas_kernels import gather_chunk_data
from mdapy_tpu.render.scene import build_scene
from mdapy_tpu.render.tracer import RenderConfig
from mdapy_tpu_torch.render import megakernel as tmega
from mdapy_tpu_torch.render.convert import (
    light_records_from_numpy, screen_bins_from_numpy,
)

from _jax_geometry import jax_sphere_hit

W, H = 96, 80
GRID = 48
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fcc_scene(n=3):
    a = 3.615
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.mgrid[0:n, 0:n, 0:n].reshape(3, -1).T
    pos = (frac[None] + cells[:, None]).reshape(-1, 3) * a
    rng = np.random.default_rng(3)
    colors = np.c_[rng.uniform(0.2, 1.0, (len(pos), 3)), np.ones(len(pos))]
    radii = np.full(len(pos), 1.28, np.float32)
    return pos, colors.astype(np.float32), radii


def test_hash_jitter_bit_exact():
    rng = np.random.default_rng(0)
    tile = rng.integers(0, 1 << 20, 4096)
    s = rng.integers(0, 16, 4096)
    pix = rng.integers(0, 256, 4096)
    for seed in (0, 7, -3, 2**31 - 1):
        jx, jy = jmega._hash_jitter(
            jnp.asarray(tile, jnp.int32), jnp.asarray(s, jnp.int32),
            jnp.int32(seed), jnp.asarray(pix, jnp.int32))
        tx, ty = tmega.hash_jitter(torch.as_tensor(tile), torch.as_tensor(s),
                                   seed, torch.as_tensor(pix))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("preset,aa,shadows", [
    ("perspective", 0, True),
    ("perspective", 0, False),
    ("top", 0, True),
    ("top", 0, False),
    ("perspective", 2, True),      # AA on: S = 3, jitter hash bit-exact
])
def test_kernel_slice_matches_interpret(monkeypatch, preset, aa, shadows):
    """The JAX accel structures, carried over by convert.py, go through the
    JAX megakernel (interpret mode) and the port's kernel path, with the
    JAX kernel's sphere hit (``tests/_jax_geometry.py``)."""
    jax_sphere_hit(monkeypatch)
    pos, colors, radii = _fcc_scene()
    cam = preset_camera(preset, pos, max_radius=float(radii.max()))
    scene = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                         build_scene(pos, colors, radii, dtype=np.float32))
    frame = camera_frame(cam, W, H)
    persp = bool(frame["perspective"])
    cfg = RenderConfig(aa_samples=aa, aa_enabled=aa > 0, ao_samples=0,
                       ao_enabled=False, shadows_enabled=shadows)
    bins = build_screen_bins(scene, frame, W, H)
    lb = build_light_bins(scene, np.asarray(frame["light_dir"], np.float32),
                          grid=GRID)
    cd = gather_chunk_data(bins.sph_chunks, scene.sph_center,
                           scene.sph_radius, scene.sph_color)
    lrec = build_light_records(lb, scene)
    lo = np.asarray(jnp.min(scene.sph_center - scene.sph_radius[:, None], 0))
    hi = np.asarray(jnp.max(scene.sph_center + scene.sph_radius[:, None], 0))
    params = jmega.build_mega_params(frame, lb, lo, hi, cfg)
    kw = dict(S=aa + 1, width=W, height=H, tiles_x=bins.tiles_x,
              tiles_y=bins.tiles_y, grid_n=GRID, eps=cfg.eps,
              perspective=persp, shadows=shadows)
    jl = lrec if shadows else (None, None, None, None)
    ref = np.asarray(jmega.render_image_mega(
        cd, bins.sph_zmin, jl[0], jl[1], jl[2], params, 0, lkmax=jl[3],
        interpret=True, **kw))

    tb = screen_bins_from_numpy(bins.sph_chunks, bins.sph_zmin, bins.tiles_x,
                                bins.tiles_y, device="cpu")
    lights = tmega.stack_lights(
        params, *light_records_from_numpy(*lrec, device="cpu"), grid_n=GRID)
    before = tmega.launches
    img = tmega.render_image_mega(
        torch.as_tensor(np.array(cd)), tb.sph_zmin, lights, params, 0, **kw)
    assert tmega.launches == before          # CPU tensors: the plain version
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    d = np.abs(img.numpy() - ref)
    assert ref.std() > 0.05
    # fp-order tangency ties may flip a pixel or two (the JAX package's bound)
    assert int((d.max(axis=2) > 1e-3).sum()) <= 2
    assert d.mean() < 1e-4

    q = tmega.render_image_mega(
        torch.as_tensor(np.array(cd)), tb.sph_zmin, lights, params, 0,
        quantized=True, **kw)
    assert q.dtype == torch.uint8
    np.testing.assert_array_equal(
        q.numpy(), np.clip(np.round(img.numpy() * 255.0), 0, 255))


def test_render_matches_jax_renderer():
    """The whole slice, port (backend="cpu", f32, plain kernel) against the
    JAX package (backend="cpu": float64 and its XLA tiled tracer).  AA is off
    so both trace the same rays; f32 vs f64 and two tracers can flip a
    tangency pixel, and the truncating quantizer may move a value across an
    integer, so allow 4 pixels differing by more than 1."""
    pos, colors, radii = _fcc_scene()
    cam = mdapy_tpu.preset_camera("perspective", pos, max_radius=1.28)
    kw = dict(camera=cam, width=W, height=H)
    jren = mdapy_tpu.TachyonRender(backend="cpu", ao=False, antialiasing=False)
    ref = jren.render(pos, colors, radii, **kw)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False,
                                        antialiasing=False)
    img = ren.render(pos, colors, radii, **kw)
    assert img.shape == ref.shape == (H, W, 4) and img.dtype == np.uint8
    d = np.abs(img.astype(np.int32) - ref.astype(np.int32)).max(axis=2)
    assert img[..., :3].std() > 1
    assert int((d > 1).sum()) <= 4
    # a repeated frame reuses the cached scene and accel structures, whether
    # it passes the same arrays or equal copies; moved atoms rebuild
    accel, key = ren._accel, ren._scene_key
    np.testing.assert_array_equal(ren.render(pos, colors, radii, **kw), img)
    np.testing.assert_array_equal(
        ren.render(pos.copy(), colors.copy(), radii.copy(), **kw), img)
    assert ren._accel is accel and ren._scene_key == key
    moved = ren.render(pos + 0.7, colors, radii, **kw)
    assert ren._scene_key != key and not np.array_equal(moved, img)
    dev = ren.render(pos, colors, radii, device_output=True, **kw)
    assert dev.dtype == torch.uint8 and dev.shape == (H, W, 3)
    # transparent background: alpha 0 where the pixel shows the background
    ta = ren.render(pos, colors, radii, transparent=True, **kw)[..., 3]
    ja = jren.render(pos, colors, radii, transparent=True, **kw)[..., 3]
    assert 0 < int((ta == 0).sum()) < H * W
    assert int((ta != ja).sum()) <= 4


def test_unported_options_raise(monkeypatch):
    """Every route the JAX renderer takes renders: the options that raised
    before the exact tracer (A6) and the banded megakernel (B1f) were
    ported take those."""
    from mdapy_tpu_torch.render import render as trender

    pos, colors, radii = _fcc_scene(2)
    # AO at or below the fast-AO threshold takes the exact tracer (A6)
    ao = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=True)
    exact = ao.render(pos, colors, radii, width=32, height=32)
    assert ao._route_name == "exact" and exact[..., :3].std() > 1
    assert ao._exact.sph_center.dtype == torch.float64
    half = colors.copy()
    half[0, 3] = 0.5
    monkeypatch.setattr(trender, "AO_EXACT_MAX_SPHERES", 0)
    # a translucent atom with AO: the megakernel peels it (B1e)
    img = ao.render(pos, half, radii, width=32, height=32)
    assert ao._route_name == "mega" and ao._scene[6]
    assert img.shape == (32, 32, 4) and img[..., :3].std() > 1
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False)
    edges = np.stack([pos[:4], pos[4:8]], axis=1)       # 4 cylinders, 8 rings
    kw = dict(width=32, height=32)
    # past the JAX package's cyl/ring bounds: render_image_pallas when
    # opaque, the exact tracer with AO
    want = ren.render(pos, colors, radii, bond_edges=edges, **kw)
    assert ren._route_name == "mega"
    monkeypatch.setattr(trender, "OTHER_TILE_MAX", 8)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False)
    got = ren.render(pos, colors, radii, bond_edges=edges, **kw)
    assert ren._route_name == "pallas" and got.shape == (32, 32, 4)
    got = ao.render(pos, colors, radii, box_edges=edges, **kw)
    assert ao._route_name == "exact" and got[..., :3].std() > 1
    monkeypatch.setattr(trender, "OTHER_TILE_MAX", 512)
    monkeypatch.setattr(trender, "OTHER_SHADOW_MAX", 11)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False)
    got = ren.render(pos, colors, radii, bond_edges=edges, **kw)
    assert ren._route_name == "pallas" and got[..., :3].std() > 1
    # AA is on, and the two routes jitter differently: the frames are alike,
    # not equal
    assert np.abs(got.astype(np.int32) - want).mean() < 2.0
    got = ao.render(pos, colors, radii, bond_edges=edges, **kw)
    assert ao._route_name == "exact" and got[..., :3].std() > 1
    # cylinders without a live sphere: render_image_tiled, the exact tracer
    # with AO
    none = (np.zeros((0, 3)), np.zeros((0, 4), np.float32), np.zeros(0, np.float32))
    cam = mdapy_tpu_torch.preset_camera("perspective", pos, max_radius=1.28)
    got = ren.render(*none, bond_edges=edges, camera=cam, **kw)
    assert ren._route_name == "tiled" and got[..., :3].std() > 1
    got = ao.render(*none, bond_edges=edges, camera=cam, **kw)
    assert ao._route_name == "exact" and got[..., :3].std() > 1
    # the global bound holds only where shadows or AO test occluders
    flat = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False, shadows=False)
    assert flat.render(pos, colors, radii, bond_edges=edges, **kw).shape == (32, 32, 4)
    monkeypatch.setattr(trender, "OTHER_SHADOW_MAX", 12)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False)
    assert ren.render(pos, colors, radii, bond_edges=edges, **kw).shape == (32, 32, 4)
    # a transparent box or bond, like a transparent atom, takes the
    # megakernel's peels (B1e) ...
    for extra in (dict(box_edges=edges, box_color=(1.0, 1.0, 1.0, 0.5)),
                  dict(bond_edges=edges, bond_color=(0.8, 0.8, 0.8, 0.5))):
        got = ren.render(pos, colors, radii, **extra, **kw)
        assert ren._route_name == "mega" and ren._scene[6]
        assert got.shape == (32, 32, 4) and got[..., :3].std() > 1
    got = ren.render(pos, half, radii, width=32, height=32)
    assert ren._route_name == "mega" and ren._scene[6]
    # ... and past the cylinder limits, the exact tracer
    monkeypatch.setattr(trender, "OTHER_SHADOW_MAX", 11)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False)
    for extra in (dict(box_edges=edges, box_color=(1.0, 1.0, 1.0, 0.5)),
                  dict(bond_edges=edges)):
        c = colors if "box_edges" in extra else half
        got = ren.render(pos, c, radii, **extra, **kw)
        assert ren._route_name == "exact" and ren._scene[6]
        assert got[..., :3].std() > 1
    # past the record budget the megakernel renders in bands of tile rows
    # (B1f): one band a tile row here; with AA off the bands trace the
    # one-shot frame's rays, their image-plane corners moved in float32
    monkeypatch.setattr(trender, "OTHER_SHADOW_MAX", 12)
    flat = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False,
                                         antialiasing=False)
    one = flat.render(pos, colors, radii, width=32, height=40)
    monkeypatch.setattr(trender, "RECORD_BUDGET_BYTES", 1024)
    flat = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False,
                                         antialiasing=False)
    banded = flat.render(pos, colors, radii, width=32, height=40)
    assert flat._route_name == "mega" and flat._accel[2] is None
    d = np.abs(banded.astype(np.int32) - one).max(axis=2)
    assert int((d > 1).sum()) == 0 and banded[..., :3].std() > 1


def test_cuda_backend_refuses_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mdapy_tpu_torch.TachyonRender(backend="cuda", ao=False)
    with pytest.raises(ValueError, match="CUDA"):
        tmega.mega_render_cuda(
            torch.zeros((1, 1, 8, 128)), torch.zeros((1, 1)), None,
            np.zeros(64, np.float32), 0, S=1, tiles_x=1,
            grid_n=1, eps=4e-4, perspective=True, shadows=False)
    # the low-level path builds on the card unless asked for the CPU
    from mdapy_tpu_torch.render.scene import build_scene as tbuild_scene
    one = (np.zeros((1, 3)), np.ones((1, 4), np.float32), np.ones(1, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbuild_scene(*one)
    assert tbuild_scene(*one, device="cpu").sph_center.device.type == "cpu"


def test_call_surface_matches_jax_renderer(monkeypatch, capsys):
    """ROADMAP C8: ``__init__``, ``render`` and ``render_system`` take the
    JAX renderer's parameters, in its order and with its defaults, apart
    from the backend's name ("tpu" there, "cuda" here); "gpu" means "cuda"
    and "auto" resolves to "cuda" when a card is visible, else to "cpu";
    ``verbosity`` is checked as the JAX renderer checks it, and every
    ``render`` fills ``last_timings`` with the JAX renderer's phase names.
    The JAX renderer's attributes ``use_tiling`` and ``use_pallas`` are
    there, True by default; ``use_pallas`` is True on the CPU as well
    (the port's CPU backend runs the kernels' plain versions, not an
    interpreter), and ``use_tiling = False`` sends a frame to the exact
    tracer."""
    import inspect

    for name in ("__init__", "render", "render_system"):
        jp = inspect.signature(getattr(mdapy_tpu.TachyonRender, name)).parameters
        tp = inspect.signature(getattr(mdapy_tpu_torch.TachyonRender, name)).parameters
        assert list(tp) == list(jp), name
        for k in jp:
            if (name, k) != ("__init__", "backend"):
                assert tp[k].default == jp[k].default, (name, k)
    init = inspect.signature(mdapy_tpu_torch.TachyonRender.__init__).parameters
    assert init["backend"].default == "cuda"
    jren = mdapy_tpu.TachyonRender(backend="cpu")
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu")
    for attr in ("use_tiling", "use_pallas"):
        assert isinstance(getattr(jren, attr), bool)
        assert getattr(ren, attr) is True
    assert jren.use_tiling is True and jren.use_pallas is False

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mdapy_tpu_torch.TachyonRender(backend="auto").backend == "cpu"
    assert mdapy_tpu_torch.TachyonRender(backend=" CPU ").backend == "cpu"
    for asked in ("gpu", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            mdapy_tpu_torch.TachyonRender(backend=asked)
    with pytest.raises(ValueError, match="backend"):
        mdapy_tpu_torch.TachyonRender(backend="tpu")
    with pytest.raises(ValueError, match="verbosity"):
        mdapy_tpu_torch.TachyonRender(backend="cpu", verbosity="loud")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for asked in ("gpu", "auto", "cuda"):
        ren = mdapy_tpu_torch.TachyonRender(backend=asked)
        assert ren.backend == "cuda" and ren._device.type == "cuda"
    monkeypatch.undo()

    pos, colors, radii = _fcc_scene(2)
    ren = mdapy_tpu_torch.TachyonRender(backend="auto", ao=False,
                                        verbosity="timing")
    assert ren.backend == ("cuda" if torch.cuda.is_available() else "cpu")
    assert ren.last_timings == {}
    ren.render(pos, colors, radii, width=32, height=32)
    phases = ("prepare", "scene_build", "accel_build", "trace", "image_out")
    assert tuple(ren.last_timings) == phases
    assert all(v >= 0.0 for v in ren.last_timings.values())
    out = capsys.readouterr().out
    assert f"backend 'auto' -> '{ren.backend}'" in out
    assert "[TachyonRender] prepare=" in out and "total=" in out
    # a warm frame keeps the phases; the device frame has no image_out
    ren.render(pos, colors, radii, width=32, height=32, device_output=True)
    assert tuple(ren.last_timings) == phases[:-1]
    assert "trace=" in capsys.readouterr().out
    quiet = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False)
    quiet.render(pos, colors, radii, width=32, height=32)
    assert tuple(quiet.last_timings) == phases
    assert capsys.readouterr().out == ""
    # without tiling: the exact tracer, which builds no acceleration
    # structure (as in the JAX renderer)
    quiet.use_tiling = False
    quiet.render(pos, colors, radii, width=32, height=32)
    assert quiet._route_name == "exact"
    assert tuple(quiet.last_timings) == ("prepare", "scene_build", "trace",
                                         "image_out")


def test_port_imports_no_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "class Block:\n"
        "    # pandas, pyarrow and polars are absent on the card's machine\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('pandas', 'pyarrow', 'polars'):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import mdapy_tpu_torch as m\n"
        "a = 3.615\n"
        "f = np.array([[0,0,0],[.5,.5,0],[.5,0,.5],[0,.5,.5]])\n"
        "c = np.mgrid[0:2,0:2,0:2].reshape(3,-1).T\n"
        "pos = (f[None] + c[:, None]).reshape(-1, 3) * a\n"
        "col = np.tile(np.array([[.78,.5,.2,1.]], np.float32), (len(pos), 1))\n"
        "rad = np.full(len(pos), 1.28, np.float32)\n"
        "img = m.TachyonRender(backend='cpu', ao=False).render("
        "pos, col, rad, width=48, height=32)\n"
        "assert len(pos) == 32 and img.shape == (32, 48, 4) and img.std() > 1\n"
        "r = m.TachyonRender(backend='cpu', ao_samples=4, aa_samples=2)\n"
        "img = r.render(pos, col, rad, width=48, height=32)\n"
        "assert r._route_name == 'exact' and img.std() > 1\n"
        "m.render.render.AO_EXACT_MAX_SPHERES = 0\n"
        "img = m.TachyonRender(backend='cpu', ao_samples=4).render("
        "pos, col, rad, width=48, height=32)\n"
        "assert img.shape == (32, 48, 4) and img.std() > 1\n"
        "tcol = col.copy()\n"
        "tcol[::2, 3] = 0.4\n"
        "r = m.TachyonRender(backend='cpu', ao=False)\n"
        "glass = r.render(pos, tcol, rad, width=48, height=32)\n"
        "assert r._scene[6] and glass.std() > 1\n"
        "d = np.abs(glass.astype(int) - r.render(pos, col, rad, width=48, "
        "height=32)).max(axis=2)\n"
        "assert (d > 8).sum() > 20\n"
        "class Cell:\n"
        "    matrix = np.eye(3) * 2 * a\n"
        "    origin = np.zeros(3)\n"
        "    boundary = np.array([1, 1, 1])\n"
        "class Frame:\n"
        "    columns = ['element']\n"
        "    def __getitem__(self, k):\n"
        "        return np.array(['Cu'] * len(pos))\n"
        "class Stand:\n"
        "    N, box, data = len(pos), Cell(), Frame()\n"
        "    def get_positions(self):\n"
        "        return pos\n"
        "d = pos[None] - pos[:, None]\n"
        "d -= np.round(d / (2 * a)) * 2 * a\n"
        "i, j = np.nonzero(np.triu(np.linalg.norm(d, axis=-1) < 2.6, k=1))\n"
        "Stand.bond = np.c_[i, j]\n"
        "r = m.TachyonRender(backend='cpu', ao=False)\n"
        "img = r.render_system(Stand(), draw_bond=True, radii=np.full(32, .6), "
        "width=128, height=96)\n"
        "assert img.shape == (96, 128, 4) and img.std() > 1\n"
        "assert len(i) == 192 and r._other.orec.shape[0] > 0\n"
        "m.render.render.OTHER_SHADOW_MAX = 100\n"
        "r = m.TachyonRender(backend='cpu', ao=False)\n"
        "heavy = r.render_system(Stand(), draw_bond=True, radii=np.full(32, .6), "
        "width=128, height=96)\n"
        "assert r._route_name == 'pallas' and heavy.shape == (96, 128, 4)\n"
        "assert np.abs(heavy.astype(int) - img).mean() < 2 and heavy.std() > 1\n"
        "import os, tempfile\n"
        "sys.path.insert(0, 'tests')\n"
        "from _torch_system import StandInSystem\n"
        "nb = m.Neighbor(pos, m.Box(np.eye(3) * 2 * a), 3.0, device='cpu').compute()\n"
        "assert (nb.neighbor_number == 12).all()\n"
        "tmp = tempfile.mkdtemp()\n"
        "g = m.EAMGenerator(['Cu'], output_filename=os.path.join(tmp, 'Cu.eam.alloy'))\n"
        "rng = np.random.default_rng(0)\n"
        "st = StandInSystem(np.tile(pos, (8, 1)) + np.repeat(np.mgrid[0:2, 0:2, "
        "0:2].reshape(3, -1).T * 2 * a, 32, axis=0) + rng.normal(0, .05, (256, 3)), "
        "np.eye(3) * 4 * a, 'Cu')\n"
        "st.calc = m.EAM(g.output_filename, device='cpu')\n"
        "e0 = st.get_energy()\n"
        "assert st.get_force().shape == (256, 3)\n"
        "m.FIRE(st).run(2)\n"
        "assert st.get_energy() < e0\n"
        "box = m.Box(np.eye(3) * 4 * a)\n"
        "assert (m.CommonNeighborAnalysis(st.pos, box, device='cpu').compute()"
        ".cna == 1).all()\n"
        "q = m.SteinhardtBondOrientation(st.pos, box, wlhat=True, "
        "identify_liquid=True, device='cpu').compute()\n"
        "assert q.qnarray.shape == (256, 4) and q.solidliquid.all()\n"
        "c = m.ClusterAnalysis(st.pos[::2], box, 2.9, device='cpu').compute()\n"
        "assert c.cluster_number >= 1 and c.particleClusters.min() == 1\n"
        "s = m.System(pos=st.pos, box=np.eye(3) * 4 * a, "
        "element_list=['Cu'] * 128 + ['Ni'] * 128, device='cpu')\n"
        "for name, kw in (('a.dump', {}), ('a.xyz', {}), ('POSCAR', {}), "
        "('a.data', {'data_format': 'charge'}), ('b.dump.gz', {})):\n"
        "    p = os.path.join(tmp, name)\n"
        "    m.save(p, s, **kw)\n"
        "    r = m.load(p, device='cpu')\n"
        "    assert r.N == 256\n"
        "    assert np.abs(np.sort(r.pos, 0) - np.sort(s.pos, 0)).max() < 1e-9\n"
        "assert (m.load(os.path.join(tmp, 'a.dump'), device='cpu')"
        ".cal_common_neighbor_analysis() == 1).all()\n"
        "sys.path.insert(0, 'tests')\n"
        "from _nep_file import write_nep\n"
        "q = m.NEP(write_nep(os.path.join(tmp, 'q.txt'), elements=('Cu', 'Ni'), "
        "cutoff=(5.0, 4.0), n_max=(3, 3), basis_size=(4, 4), neurons=8, "
        "charge_mode=1), device='cpu')\n"
        "assert q.get_bec(s).shape == (256, 9) and abs(q.get_charges(s).sum()) < 1e-9\n"
        "cu = m.build_crystal('Cu', 'fcc', 3.615, nx=2, ny=2, nz=2, device='cpu')\n"
        "assert cu.N == 32 and isinstance(cu, m.System)\n"
        "pc = m.CreatePolycrystal(m.build_crystal('Cu', 'fcc', 3.615, device='cpu'), "
        "30.0, 2, randomseed=1, metal_overlap_dis=2.0, device='cpu').compute(verbose=False)\n"
        "assert pc.N > 1000 and set(np.unique(pc.data['grain_id'])) == {1, 2}\n"
        "for mode in ('debye', 'direct'):\n"
        "    sk = m.StructureFactor(cu.pos, cu.box, k_max=6.0, nbins=30, mode=mode, "
        "cal_partial=True, elements=cu.data['element'], device='cpu').compute()\n"
        "    assert sk.Sk.shape == (30,) and np.isfinite(sk.get_xray_structure_factor()).any()\n"
        "from _water_box import water_box\n"
        "wp, we, wl = water_box(3)\n"
        "w = m.System(pos=wp, box=np.eye(3) * wl, element_list=we, device='cpu')\n"
        "assert w.cal_chemical_species(['H2O'], scale=0.4, add_mol_id=True) == {'H2O': 27}\n"
        "dz = np.sqrt(2 / 3)\n"
        "off = {'A': (0, 0), 'B': (.5, np.sqrt(3) / 6), 'C': (1, np.sqrt(3) / 3)}\n"
        "seq = 'ABCABCABABCABCA'\n"
        "sp = np.array([(i + j * .5 + off[c][0], j * np.sqrt(3) / 2 + off[c][1], "
        "k * dz) for k, c in enumerate(seq) for i in range(6) for j in range(6)])\n"
        "sm = np.array([[6, 0, 0], [3, 3 * np.sqrt(3), 0], [0, 0, len(seq) * dz]])\n"
        "st = m.System(pos=sp, box=m.Box(sm, [1, 1, 0]), device='cpu')\n"
        "st.cal_polyhedral_template_matching(identify_fcc_planar_faults=True)\n"
        "lay = np.round(sp[:, 2] / dz).astype(int)\n"
        "assert set(np.asarray(st.data['pft'])[lay == 7]) == {2}\n"
        "v = s.cal_voronoi_volume()\n"
        "assert abs(v.volume.sum() / s.box.volume - 1) < 1e-12\n"
        "s.build_voronoi_neighbor()\n"
        "assert s.voro_verlet_list.shape[0] == 256 and s.voro_neighbor_number.min() > 8\n"
        "q = m.SQS(s, cutoffs={2: 3.0}, n_replicas=2, max_steps=200).compute()\n"
        "assert isinstance(q.system, m.System) and q.objective < 0.5\n"
        "for c in ('vx', 'vy', 'vz'):\n"
        "    s.data[c] = np.zeros(256)\n"
        "s.set_pka(100.0, np.array([1.0, 1.0, 0.0]))\n"
        "from mdapy_tpu_torch.core.elements import atomic_masses, atomic_numbers\n"
        "ms = np.array([atomic_masses[atomic_numbers[e]] for e in s.data['element']])\n"
        "assert abs(float(np.sum(ms * s.data['vx']))) < 1e-12\n"
        "np.savetxt(os.path.join(tmp, 'thermo.out'), np.ones((3, 18)))\n"
        "th = m.read_thermo(tmp)\n"
        "assert len(th) == 3 and th.columns[0] == 'T'\n"
        "cu = m.build_crystal('Cu', 'fcc', 3.615, device='cpu')\n"
        "et = m.get_elastic_constant(cu, m.EAM(g.output_filename, device='cpu'))\n"
        "C = et.voigt\n"
        "assert np.allclose(C, C.T) and C[0, 0] - C[0, 1] > 0 and C[3, 3] > 0\n"
        "bs = m.BondStiffness(m.build_crystal('Cu', 'fcc', 3.615, nx=2, ny=2, "
        "nz=2, device='cpu'), m.EAM(g.output_filename, device='cpu'), "
        "rc_bond=3.0, n_lattice=1, poly_order=0).compute()\n"
        "assert bs.k_long[('Cu', 'Cu', 0)][0] > 0 and len(bs.shells) == 1\n"
        "from mdapy_tpu_torch.render import distributed as rd, megakernel as mk\n"
        "r = m.TachyonRender(backend='cpu', ao=False)\n"
        "r.render(pos, col, rad, width=48, height=32)\n"
        "fr, bins, cd, lights, params = r._accel\n"
        "kw = dict(S=r._cfg.aa_samples + 1, width=48, height=32, "
        "tiles_x=bins.tiles_x, tiles_y=bins.tiles_y, grid_n=m.render.render."
        "LIGHT_GRID, eps=r._cfg.eps, perspective=bool(fr['perspective']), "
        "shadows=lights is not None)\n"
        "one = mk.render_image_mega(cd, bins.sph_zmin, lights, params, 0, **kw)\n"
        "got = rd.render_image_mega_sharded(cd, bins.sph_zmin, lights, params, "
        "0, mesh=rd.make_mesh(1, device='cpu'), **kw)\n"
        "assert torch.equal(got, one) and one.std() > 0.02\n"
        "torch.distributed.destroy_process_group()\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not {'pandas', 'pyarrow', 'polars'} & set(sys.modules)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
