"""Multi-device rendering: scanline bands over a ``torch.distributed`` mesh.

The port of ``mdapy_tpu/render/distributed.py`` (:1-289).  The JAX package
shards the ray grid over a ``jax.sharding.Mesh`` with ``shard_map``; here
the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with one rank a
device, and the functions are SPMD: every rank of the mesh calls them with
the same replicated inputs (the scene, the acceleration structures and the
camera, on its own device) and renders its own horizontal band.  Rank i of
the mesh renders band n-1-i (bands count from the bottom of the image
plane), so the bands stacked in rank order are the image top-down: each
band's image-plane origin moves up by ``row0 * iplaneup`` and its seed is
``seed + band * 9973``, as in the JAX package.  Every rank returns the
whole image (an ``all_gather`` of the bands), and the train step returns
the loss and gradients averaged over the mesh on every rank.

The megakernel route renders each band with ``megakernel.render_mega_band``
(the banded render's per-band code): the hand kernel on CUDA tensors, its
plain version on CPU tensors.  The exact-tracer routes render each band as
a frame of its own with the band's seed (``tracer.render_image``), which is
the JAX semantics: ``render_image(rows=...)`` keeps the whole frame's
draws, a stochastic configuration would differ.

Collectives: NCCL on the cards, gloo on the CPU (``device="cpu"``); a
missing NCCL raises, nothing falls back to gloo.  Averages are a ``SUM``
all-reduce divided by the group's size on both backends (``ReduceOp.AVG``
exists only in NCCL), so the CPU tests run the card's code.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device
from .megakernel import BAND_SEED_STRIDE, TILE_PX, render_mega_band
from .tracer import render_image

__all__ = [
    "make_mesh",
    "render_image_sharded",
    "render_image_mega_sharded",
    "render_train_step",
]

CAMERA_KEYS = ("origin", "lowleft", "iplaneright", "iplaneup", "view",
               "light_dir")


def ensure_process_group(device) -> None:
    """Start a world of one rank when the process has no process group, so
    that a single-process caller needs no set-up (as the JAX call needs
    none): NCCL for ``device`` on the card, gloo on the CPU.  A process
    group that exists already is kept; its backend must suit ``device``."""
    backend = backend_for(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}; "
                           f"a mesh on {torch.device(device).type} needs {backend}")


def backend_for(device) -> str:
    """The collective backend of ``device``: NCCL on the card, gloo on the
    CPU.  A missing NCCL raises."""
    if torch.device(device).type == "cpu":
        return "gloo"
    if not dist.is_nccl_available():
        raise RuntimeError("torch.distributed has no NCCL backend; the card's "
                           "collectives need it (gloo serves device='cpu' only)")
    return "nccl"


def make_mesh(n_devices: Optional[int] = None, axis: str = "tiles",
              device="cuda"):
    """1-D ``DeviceMesh`` over the first ``n_devices`` ranks (default: all),
    on the card unless ``device="cpu"``.  Every rank of the process group
    must call it (it creates the mesh's group)."""
    from torch.distributed.device_mesh import DeviceMesh

    device = resolve_device(device, "make_mesh")
    ensure_process_group(device)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} available")
    return DeviceMesh(device.type, list(range(n)), mesh_dim_names=(axis,))


def mesh_position(mesh) -> int:
    """This rank's place in the mesh, its axes flattened row-major."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    shape = mesh.mesh.shape
    pos = 0
    for c, n in zip(coord, shape):
        pos = pos * n + c
    return pos


def gather_bands(band: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's band, stacked in mesh order along rows: gathered over
    the last mesh axis first, then each earlier one (a host's bands first,
    then across hosts)."""
    out = band.contiguous()
    for dim in reversed(range(mesh.ndim)):
        group = mesh.get_group(dim)
        parts = [torch.empty_like(out) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, out, group=group)
        out = torch.cat(parts, dim=0)
    return out


def mean_over(tensors, mesh, dims) -> None:
    """Average ``tensors`` in place over the mesh axes ``dims``, in order:
    a ``SUM`` all-reduce, then a division by the group's size."""
    for dim in dims:
        group = mesh.get_group(dim)
        size = dist.get_world_size(group)
        for t in tensors:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            t.div_(size)


def render_image_mega_sharded(
    chunk_data,
    zmin,
    lights,
    params,
    seed,
    *,
    S: int,
    width: int,
    height: int,
    tiles_x: int,
    tiles_y: int,
    grid_n: int,
    eps: float,
    perspective: bool,
    shadows: bool,
    mesh,
    quantized: bool = False,
    other=None,
    n_peel: int = 1,
    peel1: bool = False,
):
    """Megakernel forward with the screen-tile axis sharded over ``mesh``.

    The arguments are ``megakernel.render_image_mega``'s, replicated on
    every rank, plus ``mesh``.  The tile-binned inputs (``chunk_data``,
    ``zmin``, ``other``'s per-tile offsets and counts) are tile-major (tile
    = ty * tiles_x + tx), so a band of tile rows is a contiguous slice:
    rank i renders band n-1-i with the same kernel as the one-shot path
    (``render_mega_band``).  The lights and the occluder tables are the
    whole frame's.  Returns the (height, width, 3) frame on every rank; a
    mesh of one renders the one-shot frame bit for bit."""
    n = mesh.size()
    if tiles_y % n != 0:
        raise ValueError(f"tiles_y {tiles_y} not divisible by mesh size {n}")
    rows_t = tiles_y // n
    nb_band = rows_t * tiles_x
    band = n - 1 - mesh_position(mesh)
    img = render_mega_band(
        chunk_data[band * nb_band:(band + 1) * nb_band], zmin, lights, params,
        seed, band, rows_band=rows_t, tiles_x=tiles_x, S=S, width=width,
        grid_n=grid_n, eps=eps, perspective=perspective, shadows=shadows,
        quantized=quantized, other=other, n_peel=n_peel, peel1=peel1)
    img = gather_bands(img, mesh)
    # bands stack top-down; crop the top padding rows (tiles_y*16 - height)
    pad_top = tiles_y * TILE_PX - height
    return img[pad_top:] if pad_top else img


def camera_tensors(frame: dict, scene) -> dict:
    """The camera vectors of ``frame`` in the scene's dtype, on its device."""
    ref = scene.sph_center
    return {k: torch.as_tensor(np.asarray(frame[k])).to(device=ref.device,
                                                       dtype=ref.dtype)
            for k in CAMERA_KEYS}


def render_band(scene, cam: dict, cfg, width: int, rows: int, row0: int,
                perspective: bool, seed: int, chunk: int):
    """A frame of ``rows`` rows whose image plane starts ``row0`` scanlines
    up the full frame's, rendered by the exact tracer with ``seed``."""
    ll = cam["lowleft"] + row0 * cam["iplaneup"]
    return render_image(scene, cam["origin"], ll, cam["iplaneright"],
                        cam["iplaneup"], cam["view"], cam["light_dir"], cfg,
                        width, rows, perspective, seed, chunk=chunk)


def render_image_sharded(
    scene,
    frame: dict,
    cfg,
    width: int,
    height: int,
    mesh,
    seed: int = 0,
    chunk: int = 16384,
):
    """Render (H, W, 3) with scanline bands sharded across ``mesh``, by the
    exact tracer.

    ``height`` must divide evenly by the mesh size.  Rank i traces the
    scanlines of band n-1-i as a frame of its own (seed ``seed + band *
    9973``), and the bands gather top-down: for a deterministic config (no
    AA jitter, no AO sampling) the result equals the single-device
    ``render_image`` output."""
    n = mesh.size()
    if height % n != 0:
        raise ValueError(f"height {height} not divisible by mesh size {n}")
    rows = height // n
    band = n - 1 - mesh_position(mesh)
    cam = camera_tensors(frame, scene)
    with torch.no_grad():
        img = render_band(scene, cam, cfg, width, rows, band * rows,
                          bool(frame["perspective"]),
                          seed + band * BAND_SEED_STRIDE, chunk)
    return gather_bands(img, mesh)


def scene_leaves(scene):
    """(scene with fresh leaf tensors for the sphere centres, radii and
    colours, those three leaves)."""
    leaves = tuple(t.detach().clone().requires_grad_(True) for t in (
        scene.sph_center, scene.sph_radius, scene.sph_color))
    return dataclasses.replace(scene, sph_center=leaves[0],
                               sph_radius=leaves[1], sph_color=leaves[2]), leaves


def render_train_step(
    scene,
    frame: dict,
    target,
    cfg,
    width: int,
    height: int,
    mesh,
    seed: int = 0,
    chunk: int = 16384,
):
    """One differentiable step: forward render -> MSE vs ``target`` ->
    gradients w.r.t. (sph_center, sph_radius, sph_color), mean-reduced over
    the mesh.  ``target`` is the whole (H, W, 3) image, top-down; each rank
    takes its band's rows.  Returns (loss, grads), the same on every rank."""
    n = mesh.size()
    if height % n != 0:
        raise ValueError(f"height {height} not divisible by mesh size {n}")
    rows = height // n
    pos = mesh_position(mesh)
    band = n - 1 - pos
    cam = camera_tensors(frame, scene)
    tgt = torch.as_tensor(np.asarray(target)).to(
        device=scene.sph_center.device, dtype=scene.sph_center.dtype)
    tgt = tgt[pos * rows:(pos + 1) * rows]
    scene2, leaves = scene_leaves(scene)
    img = render_band(scene2, cam, cfg, width, rows, band * rows,
                      bool(frame["perspective"]),
                      seed + band * BAND_SEED_STRIDE, chunk)
    loss = torch.mean((img - tgt) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    mean_over([loss, *grads], mesh, range(mesh.ndim))
    return loss, grads
