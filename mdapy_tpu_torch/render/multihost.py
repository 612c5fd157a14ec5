"""Multi-host scale-out: a ``torch.distributed`` world and hierarchical meshes.

The port of ``mdapy_tpu/render/multihost.py`` (:1-308).  The JAX package
runs one process a host over a GRPC coordinator; here each process is one
rank with one device, in the usual ``torch.distributed`` model:

* ``init_distributed()`` joins the ranks into one process group (a TCP
  rendezvous at the coordinator's address);
* a 2-D ``(hosts, cores)`` ``DeviceMesh``: the ``cores`` axis holds the
  ranks of one host (NVLink), the ``hosts`` axis spans hosts;
* the pixel grid is the data-parallel axis: every rank owns a horizontal
  band of tile rows (a host's bands contiguous, so the gathered frame
  gathers within each host first, then across hosts); the scene tables
  are replicated on every rank;
* the training step reduces pixel-loss gradients hierarchically (over
  ``cores``, then ``hosts``) and renders each band in row chunks under
  ``torch.utils.checkpoint``, so the backward pass is a sequence of
  independent blocks; each chunk's reductions start, asynchronously, as
  soon as its backward retires and overlap the next chunk's work.

A world of one rank (one card, or the CPU) runs the same code on a mesh of
shape (1, 1); the CPU tests run worlds of 2 and 4 over gloo.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device
from .distributed import (
    BAND_SEED_STRIDE, backend_for, camera_tensors, ensure_process_group,
    gather_bands, mean_over, mesh_position, render_band, scene_leaves,
)

__all__ = [
    "init_distributed",
    "make_hier_mesh",
    "render_image_mega_hier",
    "render_train_step_hier",
]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    device="cuda",
) -> Tuple[int, int]:
    """Join the multi-process world; a no-op for single-process runs.

    Arguments fall back to ``MDAPY_COORDINATOR`` (``host:port``) /
    ``MDAPY_NUM_PROCS`` / ``MDAPY_PROC_ID``.  With a coordinator, the
    process group starts with a TCP rendezvous there: NCCL on the card
    (``local_device_ids[0]``, default the rank modulo the cards, becomes
    the current card), gloo with ``device="cpu"``.  Returns ``(rank,
    world_size)``: (0, 1) without a coordinator and a process group."""
    addr = coordinator_address or os.environ.get("MDAPY_COORDINATOR")
    if addr:
        device = resolve_device(device, "init_distributed")
        world = int(num_processes if num_processes is not None
                    else os.environ.get("MDAPY_NUM_PROCS", "1"))
        rank = int(process_id if process_id is not None
                   else os.environ.get("MDAPY_PROC_ID", "0"))
        if device.type == "cuda":
            torch.cuda.set_device(local_device_ids[0] if local_device_ids
                                  else rank % torch.cuda.device_count())
        dist.init_process_group(backend_for(device), init_method=f"tcp://{addr}",
                                world_size=world, rank=rank)
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def make_hier_mesh(
    n_hosts: Optional[int] = None,
    cores_per_host: Optional[int] = None,
    axis_names: Tuple[str, str] = ("hosts", "cores"),
    device="cuda",
):
    """(hosts, cores) ``DeviceMesh`` with each host's ranks on one row.

    ``cores_per_host`` defaults to ``LOCAL_WORLD_SIZE`` (the ranks a
    launcher started on one host; the whole world without it) and
    ``n_hosts`` to the world's size over it.  Ranks are taken in order, so
    a launcher's host-local ranks fill one row.  Starts a world of one
    rank when the process has no process group."""
    from torch.distributed.device_mesh import DeviceMesh

    device = resolve_device(device, "make_hier_mesh")
    ensure_process_group(device)
    world = dist.get_world_size()
    if cores_per_host is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cores_per_host = (max(world // n_hosts, 1) if n_hosts is not None
                          else local)
    if n_hosts is None:
        n_hosts = max(world // cores_per_host, 1)
    need = n_hosts * cores_per_host
    if need > world:
        raise ValueError(
            f"mesh {n_hosts}x{cores_per_host} needs {need} devices, "
            f"have {world}"
        )
    grid = torch.arange(need).reshape(n_hosts, cores_per_host)
    return DeviceMesh(device.type, grid, mesh_dim_names=tuple(axis_names))


def render_image_mega_hier(
    chunk_data, zmin, lights, params, seed,
    *,
    S: int, width: int, height: int, tiles_x: int, tiles_y: int,
    grid_n: int, eps: float, perspective: bool, shadows: bool,
    mesh, quantized: bool = False, other=None, n_peel: int = 1,
    peel1: bool = False,
):
    """Megakernel forward over a hierarchical mesh.

    Every rank of the flattened (hosts, cores) grid renders one horizontal
    tile band (rank i of the flattened grid band n-1-i, as
    ``render_image_mega_sharded``); a host's bands are contiguous rows of
    the frame, gathered within the host first and then across hosts.
    Scene tables replicate on every rank."""
    from .distributed import render_image_mega_sharded

    return render_image_mega_sharded(
        chunk_data, zmin, lights, params, seed, S=S, width=width,
        height=height, tiles_x=tiles_x, tiles_y=tiles_y, grid_n=grid_n,
        eps=eps, perspective=perspective, shadows=shadows, mesh=mesh,
        quantized=quantized, other=other, n_peel=n_peel, peel1=peel1)


def render_train_step_hier(
    scene, frame: dict, target, cfg, width: int, height: int, mesh,
    seed: int = 0, chunk: int = 16384, remat_chunks: int = 1,
):
    """Differentiable pixel-loss step on a hierarchical mesh.

    Each rank renders its scanline band as ``remat_chunks`` row chunks, each
    a frame of ``rows / remat_chunks`` rows with the band's seed, under
    ``torch.utils.checkpoint``: the backward pass recomputes one chunk at a
    time (bounded memory).  Chunk ci starts ``ci * crow`` rows up the band
    and matches the target rows ``(remat_chunks - 1 - ci) * crow`` down it.
    As each chunk's backward retires, its loss and gradients start their
    mean over ``cores`` and then over ``hosts`` (``async_op=True``), while
    the next chunk renders; the chunks' shares are summed in chunk order
    once every reduction has finished.  Returns (loss, grads), the same on
    every rank."""
    n = mesh.size()
    if height % n != 0:
        raise ValueError(f"height {height} not divisible by mesh size {n}")
    rows = height // n
    if rows % remat_chunks != 0:
        raise ValueError(f"band rows {rows} not divisible by {remat_chunks}")
    crow = rows // remat_chunks
    pos = mesh_position(mesh)
    band = n - 1 - pos
    band_seed = seed + band * BAND_SEED_STRIDE
    perspective = bool(frame["perspective"])
    cam = camera_tensors(frame, scene)
    ref = scene.sph_center
    tgt = torch.as_tensor(np.asarray(target)).to(device=ref.device,
                                                 dtype=ref.dtype)
    tgt = tgt[pos * rows:(pos + 1) * rows]
    scene2, leaves = scene_leaves(scene)
    norm = rows * width * 3
    dims = list(reversed(range(mesh.ndim)))     # cores first, then hosts

    def chunk_loss(ci, c, r, col):
        s = dataclasses.replace(scene2, sph_center=c, sph_radius=r,
                                sph_color=col)
        img = render_band(s, cam, cfg, width, crow, band * rows + ci * crow,
                          perspective, band_seed, chunk)
        # chunk rows count bottom-up in the image plane; the target is
        # top-down, so chunk ci maps to target rows (k - 1 - ci) * crow
        t0 = (remat_chunks - 1 - ci) * crow
        return torch.sum((img - tgt[t0:t0 + crow]) ** 2)

    if remat_chunks == 1:
        loss = torch.utils.checkpoint.checkpoint(
            chunk_loss, 0, *leaves, use_reentrant=False) / norm
        grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        mean_over([loss, *grads], mesh, dims)
        return loss, grads

    # one flat buffer a chunk, [loss, grads...], reduced over cores then
    # hosts: a chunk's next axis starts when its previous one has finished
    shapes = [t.shape for t in leaves]
    pending = []          # [buffer, work, index of the next axis in dims]

    def advance(entry, block: bool) -> None:
        buf, work, k = entry
        if work is None or not (block or work.is_completed()):
            return
        work.wait()
        buf.div_(dist.get_world_size(mesh.get_group(dims[k - 1])))
        entry[1] = (dist.all_reduce(buf, op=dist.ReduceOp.SUM,
                                    group=mesh.get_group(dims[k]),
                                    async_op=True) if k < len(dims) else None)
        entry[2] = k + 1

    for ci in range(remat_chunks):
        l_c = torch.utils.checkpoint.checkpoint(
            chunk_loss, ci, *leaves, use_reentrant=False)
        g_c = torch.autograd.grad(l_c, leaves)
        buf = torch.cat([l_c.detach().reshape(1)] + [g.reshape(-1) for g in g_c])
        for entry in pending:
            advance(entry, block=False)
        work = dist.all_reduce(buf, op=dist.ReduceOp.SUM,
                               group=mesh.get_group(dims[0]), async_op=True)
        pending.append([buf, work, 1])
    total = torch.zeros_like(pending[0][0])
    for entry in pending:
        while entry[1] is not None:
            advance(entry, block=True)
        total = total + entry[0]
    total = total * (1.0 / norm)
    loss, flat = total[0], total[1:]
    grads, at = [], 0
    for shape in shapes:
        size = int(np.prod(shape))
        grads.append(flat[at:at + size].reshape(shape))
        at += size
    return loss, tuple(grads)
