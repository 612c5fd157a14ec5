"""Port parity: scale-out over ``torch.distributed`` (ROADMAP A11).

``mdapy_tpu_torch.render.distributed`` and ``render.multihost`` against
the JAX package's (``mdapy_tpu/render/distributed.py``, ``multihost.py``)
on the same inputs: the port runs in spawned gloo worlds of 2 ranks (a
``make_mesh(2)``) and of 4 (a ``make_hier_mesh(2, 2)``), one band a rank
(``tests/_dist_ranks.py``, which imports no jax), the JAX package on a mesh
of the same shape over the virtual CPU devices of ``tests/conftest.py``
(its megakernel in interpret mode).

- The megakernel frames (the small FCC scene of
  ``tests/test_render_mega_sharded.py``, S = 1, shadows): against JAX's
  sharded frame at the sharded megakernel's tolerance
  (``tests/test_render_mega_sharded.py:82-84``: at most 4 pixels over
  1e-3, mean < 1e-4; the two packages' one-shot frames differ in 5
  tangency pixels here, the JAX sharded frame from its one-shot in 2);
  bit for bit with the port's own one-shot frame and its banded frame of
  the same bands (``render_image_mega_banded``, the same per-band code); a
  mesh of one, started by ``make_mesh``, bit for bit too.
- ``render_image_sharded`` with AA jitter (each band a frame with its own
  seed) against JAX at atol 1e-6, float64.
- The train steps, float64: loss at rtol 1e-5 and gradients at rtol 1e-4 /
  atol 1e-7 (``tests/test_render_distributed.py:102-105``), against the
  JAX functions and against the port's unsharded loss and gradient.
- Every rank returns the same frame, loss and gradients.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mdapy_tpu.render import distributed as jdist
from mdapy_tpu.render import multihost as jhost
from mdapy_tpu.render.accel import (
    build_light_bins, build_light_records, build_screen_bins,
)
from mdapy_tpu.render.camera import camera_frame, preset_camera
from mdapy_tpu.render.megakernel import build_mega_params
from mdapy_tpu.render.megakernel import render_image_mega as jmega_one_shot
from mdapy_tpu.render.pallas_kernels import gather_chunk_data
from mdapy_tpu.render.scene import build_scene as jbuild_scene
from mdapy_tpu.render.tracer import RenderConfig as JConfig
from mdapy_tpu.render.tracer import render_image as jrender_image
from mdapy_tpu_torch.render import distributed as tdist
from mdapy_tpu_torch.render import megakernel as tmega
from mdapy_tpu_torch.render import multihost as thost
from mdapy_tpu_torch.render import tracer as ttracer
from mdapy_tpu_torch.render.config import RenderConfig
from mdapy_tpu_torch.render.convert import scene_from_numpy

from _dist_ranks import _port_mega_inputs, _port_scene, run_world
from _jax_geometry import jax_sphere_hit

MW, MH, GRID = 96, 128, 48       # 6 x 8 tiles: bands of 4 and of 2 tile rows
TOL_PIXELS, TOL_PIXEL, TOL_MEAN = 4, 1e-3, 1e-4
TW, TH = 32, 32
CAMERA_KEYS = ("origin", "lowleft", "iplaneright", "iplaneup", "view",
               "light_dir")
# forward: AA jitter, so that each band's seed shows
FWD_CFG = dict(aa_samples=2, aa_enabled=True, ao_samples=0, ao_enabled=False,
               shadows_enabled=True)
# gradients: shadows off (tests/test_render_distributed.py:39-44)
GRAD_CFG = dict(aa_samples=0, aa_enabled=False, ao_samples=0,
                ao_enabled=False, shadows_enabled=False)
HIER_CFG = dict(GRAD_CFG, shadows_enabled=True)


def _fcc(n, seed=None):
    a = 3.615
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.mgrid[0:n, 0:n, 0:n].reshape(3, -1).T
    pos = (frac[None] + cells[:, None]).reshape(-1, 3) * a
    if seed is None:
        colors = np.tile(np.array([[0.7, 0.4, 0.25, 1.0]]), (len(pos), 1))
    else:
        rng = np.random.default_rng(seed)
        colors = np.c_[rng.uniform(0.2, 1.0, (len(pos), 3)), np.ones(len(pos))]
    return pos, colors.astype(np.float32), np.full(len(pos), 1.28, np.float32)


@functools.lru_cache(maxsize=None)
def _mega():
    """The JAX package's megakernel inputs (as tests/test_render_mega_sharded.py
    builds them), as numpy."""
    pos, colors, radii = _fcc(3, seed=3)
    cam = preset_camera("perspective", pos, max_radius=float(radii.max()))
    scene = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                         jbuild_scene(pos, colors, radii, dtype=np.float32))
    frame = camera_frame(cam, MW, MH)
    cfg = JConfig(aa_samples=0, aa_enabled=False, ao_samples=0,
                  ao_enabled=False, shadows_enabled=True)
    bins = build_screen_bins(scene, frame, MW, MH)
    lb = build_light_bins(scene, np.asarray(frame["light_dir"], np.float32),
                          grid=GRID)
    cd = gather_chunk_data(bins.sph_chunks, scene.sph_center, scene.sph_radius,
                           scene.sph_color)
    lrec = build_light_records(lb, scene)
    lo = np.asarray(jnp.min(scene.sph_center - scene.sph_radius[:, None], 0))
    hi = np.asarray(jnp.max(scene.sph_center + scene.sph_radius[:, None], 0))
    params = build_mega_params(frame, lb, lo, hi, cfg)
    return dict(
        chunk_data=np.asarray(cd), sph_chunks=np.asarray(bins.sph_chunks),
        sph_zmin=np.asarray(bins.sph_zmin), tiles_x=bins.tiles_x,
        tiles_y=bins.tiles_y, lrec=tuple(None if x is None else np.asarray(x)
                                         for x in lrec),
        params=np.asarray(params), grid_n=GRID, eps=cfg.eps,
        perspective=bool(frame["perspective"]), W=MW, H=MH)


def _jax_mega(mesh_fn, mesh):
    m = _mega()
    common = dict(S=1, width=MW, height=MH, tiles_x=m["tiles_x"],
                  tiles_y=m["tiles_y"], grid_n=GRID, eps=m["eps"],
                  perspective=m["perspective"], shadows=True, interpret=True)
    args = (m["chunk_data"], m["sph_zmin"], *m["lrec"][:3], m["params"], 0)
    if mesh is None:
        return np.asarray(jmega_one_shot(*args, **common))
    return np.asarray(mesh_fn(*args, mesh=mesh, **common))


def _frame_inputs(n_cells, W, H, rattle=0.0):
    pos, colors, radii = _fcc(n_cells)
    pos = pos + np.random.default_rng(5).normal(0.0, rattle, pos.shape)
    cam = preset_camera("perspective", pos, max_radius=1.28)
    frame = {k: np.asarray(v) for k, v in camera_frame(cam, W, H).items()}
    return pos, colors, radii, frame


@functools.lru_cache(maxsize=None)
def _tracer_inputs():
    pos, colors, radii, frame = _frame_inputs(3, TW, TH)
    return dict(pos=pos, colors=colors, radii=radii, frame=frame, cfg=FWD_CFG,
                W=TW, H=TH, seed=7, chunk=TW * TH // 4)


@functools.lru_cache(maxsize=None)
def _grad_inputs(kind):
    # rattled: on the perfect lattice one pixel of this view ties two
    # spheres, and the last bits of XLA's and torch's arithmetic pick
    # different ones (ROADMAP C6), 0.6 % of the loss
    pos, colors, radii, frame = _frame_inputs(2, TW, TH, rattle=0.05)
    if kind == "flat":
        cfg = GRAD_CFG
        scene = _jscene(pos, colors, radii)
        target = np.asarray(jrender_image(
            scene, *_jcam(frame), JConfig(**cfg), TW, TH, True, 0)) * 0.5
    else:
        cfg = HIER_CFG
        target = np.random.default_rng(3).uniform(0, 1, (TH, TW, 3))
    # float32 on the hierarchical mesh: the JAX package's remat scan carries
    # a float32 loss (mdapy_tpu/render/multihost.py:284)
    return dict(pos=pos, colors=colors, radii=radii, frame=frame, cfg=cfg,
                target=target, W=TW, H=TH, chunk=TW * TH // 8, remat=(1, 2),
                dtype="float64" if kind == "flat" else "float32")


def _jscene(pos, colors, radii, dtype="float64"):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype),
                        jbuild_scene(pos, colors, radii, dtype=dtype))


def _jcam(frame):
    return tuple(jnp.asarray(frame[k], jnp.float64) for k in CAMERA_KEYS)


@functools.lru_cache(maxsize=None)
def _world(kind):
    """Run the port's ranks once per world: 2 ranks flat, 4 as (2, 2)."""
    import tempfile

    world, shape = (2, (2,)) if kind == "flat" else (4, (2, 2))
    # the megakernel frames with the JAX kernel's sphere hit, as
    # test_mega_frames_match_jax_and_the_port compares them
    inputs = dict(mega=dict(_mega(), jax_sphere_hit=True),
                  tracer=_tracer_inputs(), grad=_grad_inputs(kind))
    return run_world(world, shape, inputs, tempfile.mkdtemp(prefix=f"dist_{kind}_"))


def _port_banded(n_bands):
    """The port's banded render in ``n_bands`` bands of the same frame."""
    m = _mega()
    chunk_data, bins, lights, kw = _port_mega_inputs(m)
    scene = scene_from_numpy(jax.tree.map(np.asarray, jbuild_scene(
        *_fcc(3, seed=3), dtype=np.float32)), device="cpu")
    row = m["tiles_x"] * m["sph_chunks"].shape[1] * 8 * m["sph_chunks"].shape[2] * 4
    kw = {k: v for k, v in kw.items() if k not in ("tiles_x", "tiles_y")}
    return tmega.render_image_mega_banded(
        scene, bins, lights, m["params"], 0,
        max_band_bytes=row * (m["tiles_y"] // n_bands), **kw).numpy()


def _port_one_shot():
    m = _mega()
    chunk_data, bins, lights, kw = _port_mega_inputs(m)
    return tmega.render_image_mega(chunk_data, bins.sph_zmin, lights,
                                   m["params"], 0, **kw).numpy()


def _close(a, b):
    d = np.abs(a - b)
    assert int((d.max(axis=2) > TOL_PIXEL).sum()) <= TOL_PIXELS, d.max()
    assert d.mean() < TOL_MEAN


@pytest.mark.parametrize("kind", ["flat", "hier"])
def test_mega_frames_match_jax_and_the_port(monkeypatch, kind):
    """Each rank's whole frame: the same on every rank, bit for bit with
    the port's one-shot frame and its banded frame of the same bands, and
    against the JAX package's sharded frame at its tolerance; the ranks and
    the port's frames here take the JAX kernel's sphere hit
    (``tests/_jax_geometry.py``).  (With the port's own, a band's float32
    image-plane corner moves a ray by an ulp, and on this symmetric
    lattice's mirror plane, where two spheres meet the ray at the same t,
    that picks the other one.)"""
    jax_sphere_hit(monkeypatch)
    ranks = _world(kind)
    n = len(ranks)
    assert sorted(r["position"] for r in ranks) == list(range(n))
    frame = ranks[0]["mega"]
    assert frame.shape == (MH, MW, 3) and frame.std() > 0.02
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["mega"], frame)
    np.testing.assert_array_equal(frame, _port_banded(n))
    np.testing.assert_array_equal(frame, _port_one_shot())
    if kind == "flat":
        ref = _jax_mega(jdist.render_image_mega_sharded, jdist.make_mesh(2))
    else:
        ref = _jax_mega(jhost.render_image_mega_hier, jhost.make_hier_mesh(2, 2))
    _close(frame, ref)


def test_sharded_forward_matches_jax():
    """``render_image_sharded`` with AA jitter: every rank's frame against
    JAX's on ``make_mesh(2)`` at atol 1e-6 (float64)."""
    t = _tracer_inputs()
    ref = np.asarray(jdist.render_image_sharded(
        _jscene(t["pos"], t["colors"], t["radii"]), t["frame"],
        JConfig(**FWD_CFG), TW, TH, jdist.make_mesh(2), seed=t["seed"],
        chunk=t["chunk"]))
    assert ref.std() > 0.02
    for r in _world("flat"):
        np.testing.assert_allclose(r["forward"], ref, atol=1e-6)
    # a hierarchical mesh of 4 bands is four frames of their own
    ref4 = np.asarray(jdist.render_image_sharded(
        _jscene(t["pos"], t["colors"], t["radii"]), t["frame"],
        JConfig(**FWD_CFG), TW, TH, jdist.make_mesh(4), seed=t["seed"],
        chunk=t["chunk"]))
    for r in _world("hier"):
        np.testing.assert_allclose(r["forward"], ref4, atol=1e-6)


def _port_unsharded(g):
    """The port's one-process loss and gradients of the whole frame."""
    scene = _port_scene(g)
    leaves = [t.detach().clone().requires_grad_(True) for t in (
        scene.sph_center, scene.sph_radius, scene.sph_color)]
    s2 = dataclasses.replace(scene, sph_center=leaves[0], sph_radius=leaves[1],
                             sph_color=leaves[2])
    cam = [torch.as_tensor(g["frame"][k]) for k in CAMERA_KEYS]
    img = ttracer.render_image(s2, *cam, RenderConfig(**g["cfg"]), TW, TH,
                               True, 0)
    loss = torch.mean((img - torch.as_tensor(g["target"]).to(img.dtype)) ** 2)
    loss.backward()
    return float(loss.detach()), [t.grad.numpy() for t in leaves]


def _check_step(step, ref_loss, ref_grads):
    loss, grads = step
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-7)


def test_train_step_matches_jax_and_unsharded():
    g = _grad_inputs("flat")
    jloss, jgrads = jdist.render_train_step(
        _jscene(g["pos"], g["colors"], g["radii"]), g["frame"], g["target"],
        JConfig(**g["cfg"]), TW, TH, jdist.make_mesh(2), chunk=g["chunk"])
    uloss, ugrads = _port_unsharded(g)
    assert np.linalg.norm(ugrads[0]) > 0
    for r in _world("flat"):
        _check_step(r["steps"]["flat"], float(jloss), jgrads)
        _check_step(r["steps"]["flat"], uloss, ugrads)


@pytest.mark.parametrize("remat", [1, 2])
def test_hier_train_step_matches_jax_and_unsharded(remat):
    """(2, 2) mesh, the reductions over cores then hosts, ``remat_chunks``
    1 and 2 (async reductions overlapping the next chunk)."""
    g = _grad_inputs("hier")
    jloss, jgrads = jhost.render_train_step_hier(
        _jscene(g["pos"], g["colors"], g["radii"], g["dtype"]), g["frame"],
        g["target"], JConfig(**g["cfg"]), TW, TH, jhost.make_hier_mesh(2, 2),
        chunk=g["chunk"], remat_chunks=remat)
    uloss, ugrads = _port_unsharded(g)
    for r in _world("hier"):
        _check_step(r["steps"][f"hier{remat}"], float(jloss), jgrads)
        _check_step(r["steps"][f"hier{remat}"], uloss, ugrads)


@pytest.fixture
def world_of_one():
    """This process as a world of one rank, started by ``make_mesh``."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_mesh_of_one_is_the_one_shot_frame(world_of_one):
    """``make_mesh(1, device="cpu")`` starts a gloo world of one; its
    sharded and hierarchical frames equal the one-shot frame bit for bit."""
    m = _mega()
    chunk_data, bins, lights, kw = _port_mega_inputs(m)
    one = _port_one_shot()
    mesh = tdist.make_mesh(1, device="cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    got = tdist.render_image_mega_sharded(chunk_data, bins.sph_zmin, lights,
                                          m["params"], 0, mesh=mesh, **kw)
    np.testing.assert_array_equal(got.numpy(), one)
    hier = thost.make_hier_mesh(1, 1, device="cpu")
    assert hier.mesh_dim_names == ("hosts", "cores")
    got = thost.render_image_mega_hier(chunk_data, bins.sph_zmin, lights,
                                       m["params"], 0, mesh=hier, **kw)
    np.testing.assert_array_equal(got.numpy(), one)
    with pytest.raises(ValueError, match="only 1 available"):
        tdist.make_mesh(2, device="cpu")


def test_init_distributed_without_coordinator(monkeypatch):
    monkeypatch.delenv("MDAPY_COORDINATOR", raising=False)
    assert not dist.is_initialized()
    assert thost.init_distributed() == (0, 1) == jhost.init_distributed()
    assert not dist.is_initialized()


def test_card_routes_need_nccl(monkeypatch):
    """No fallback: the card's collectives need NCCL, and the default
    device is the card."""
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        tdist.backend_for("cuda")
    assert tdist.backend_for("cpu") == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdist.make_mesh(1)
