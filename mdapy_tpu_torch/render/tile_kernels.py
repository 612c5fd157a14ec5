"""The tiled tracer's two kernels: chunked sphere closest hit, shadow filter.

Port of ``mdapy_tpu/render/pallas_kernels.py``: ``closest_hit_spheres_tiles``
(:414, the Pallas kernel ``_kernel`` :97) and ``shadow_filter_tiles`` (:357,
the Pallas kernel ``_shadow_kernel`` :220).  ``gather_chunk_data`` of that
module is in ``gather.py``.

Each function dispatches on the tensors' device, as ``megakernel.mega_render``
does: CUDA tensors go to the hand kernels (``csrc/tile_kernels.cu``), CPU
tensors to the plain torch version beside them, and nothing else decides; a
build or launch that fails raises.  Each wrapper call counts one launch.

``closest_hit_spheres_tiles``: per tile, its rays walk the tile's
depth-sorted 128-wide candidate chunks front to back and stop at the first
chunk whose ``zmin`` is not below the max over the rays of min(best_t, tcap).
The rays of a tile share that exit in slices of at most ``SLICE`` rays
(equal slices, as the TPU wrapper cuts its ray blocks); the exit is
conservative, so the slicing moves no result, but the kernel and the plain
version use the same one and so walk the same chunks.  Among equal t the
earlier chunk wins, then the lower lane.  On the card the kernel is bound by
issuing its sphere tests and by the rays' loads and stores (64 bytes a ray);
it tests the slices whose rays share one origin (the perspective camera)
from staged ray-independent terms, fills its warps with four rays a thread,
writes the misses of a slice that reaches no chunk without reading its
rays, and loads chunk c + 1 while chunk c is tested (the source's note).

``shadow_filter_tiles``: a ray with ``lit = 0`` gets 1.0; a lit ray is
blocked (0.0) when a record of its light-grid cell has r > 0, s2 = r^2 -
(du^2 + dv^2) > 0 and ck + sqrt(s2) > tau + eps.  The records are the port's
compact CSR rows (``accel.build_light_records``), each cell's by descending
far key, so a walk stops at its first occluder or once key <= tau + eps.  The
test is the megakernel's primary-light sweep (``megakernel._shadow_blocked``):
the square root is avoided by comparing s2 with (tau + eps - ck)^2.  On the
card the walks bound it (a few to 2,500 records a lit ray); the kernel
checks each lit ray's cell header first, walks the rays of a block with 32
walks or more in place (a warp's rays share a cell, one broadcast read a
record) and queues the rest of the walks in a scratch buffer for persistent
blocks, where a thread walks the first 32 records and a warp the rest.
"""

from __future__ import annotations

import ctypes

import torch

from . import megakernel as _mk
from .megakernel import CH, _check

__all__ = [
    "closest_hit_spheres_tiles", "closest_hit_spheres_tiles_plain",
    "closest_hit_spheres_tiles_cuda", "shadow_filter_tiles",
    "shadow_filter_tiles_plain", "shadow_filter_tiles_cuda", "kernel_attrs",
    "launches", "reset_launches", "SLICE",
]

SLICE = 2048     # most rays of a tile that share one early exit (one block)

# hand-kernel launches since the last reset_launches(), by wrapper
launches = {"closest_hit_spheres_tiles": 0, "shadow_filter_tiles": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _slices(R: int) -> list:
    n = -(-R // SLICE)
    return [(g * R // n, (g + 1) * R // n) for g in range(n)]


def _check_hit_args(o, d, tcap, zmin, chunk_data):
    nb, R = o.shape[0], o.shape[1]
    dev = o.device
    f32 = torch.float32
    _check(o, "o", f32, 3, dev)
    _check(d, "d", f32, 3, dev)
    _check(tcap, "tcap", f32, 2, dev)
    _check(zmin, "zmin", f32, 2, dev)
    _check(chunk_data, "chunk_data", f32, 4, dev)
    nchunks = chunk_data.shape[1]
    if (tuple(o.shape) != (nb, R, 3) or tuple(d.shape) != (nb, R, 3)
            or tuple(tcap.shape) != (nb, R)):
        raise ValueError(f"o, d must be (nb, R, 3) and tcap (nb, R), got "
                         f"{tuple(o.shape)}, {tuple(d.shape)}, {tuple(tcap.shape)}")
    if tuple(chunk_data.shape) != (nb, nchunks, 8, CH):
        raise ValueError(f"chunk_data must be ({nb}, nchunks, 8, {CH}), got "
                         f"{tuple(chunk_data.shape)}")
    if tuple(zmin.shape) != (nb, nchunks):
        raise ValueError(f"zmin must be {(nb, nchunks)}, got {tuple(zmin.shape)}")
    return nb, R, nchunks


def closest_hit_spheres_tiles_plain(o, d, tcap, zmin, chunk_data,
                                    eps: float = 4e-4):
    """Plain torch version: ``best_t`` (nb, R) (1e18 on a miss) and the
    winner's record ``rec`` (nb, R, 8) [cx, cy, cz, r, rgba] (zeros on a
    miss).  Tiles go through in batches that keep each (tiles, rays, CH)
    temporary within the megakernel's element budget."""
    nb, R, nchunks = _check_hit_args(o, d, tcap, zmin, chunk_data)
    dev = o.device
    best_t = torch.empty((nb, R), dtype=torch.float32, device=dev)
    rec = torch.empty((nb, R, 8), dtype=torch.float32, device=dev)
    for lo, hi in _slices(R):
        batch = max(1, _mk._PLAIN_ELEMS // ((hi - lo) * CH))
        for t0 in range(0, nb, batch):
            t1 = min(nb, t0 + batch)
            tiles = torch.arange(t0, t1, device=dev)
            bt, bidx = _mk._closest_hit(
                chunk_data, zmin, tiles,
                tuple(o[t0:t1, lo:hi, i] for i in range(3)),
                tuple(d[t0:t1, lo:hi, i] for i in range(3)),
                tcap[t0:t1, lo:hi], eps, False, stable=False)
            slot = bidx.clamp(min=0)
            won = chunk_data[tiles[:, None], slot // CH, :, slot % CH]
            best_t[t0:t1, lo:hi] = bt
            rec[t0:t1, lo:hi] = torch.where((bidx >= 0)[..., None], won, 0.0)
    return best_t, rec


def closest_hit_spheres_tiles_cuda(o, d, tcap, zmin, chunk_data,
                                   eps: float = 4e-4):
    """Launch the hand kernel on CUDA tensors (contiguous f32)."""
    from ._build import load_tile_kernels

    if o.device.type != "cuda":
        raise ValueError(f"closest_hit_spheres_tiles_cuda needs CUDA tensors, "
                         f"got {o.device}")
    nb, R, nchunks = _check_hit_args(o, d, tcap, zmin, chunk_data)
    dev = o.device
    best_t = torch.empty((nb, R), dtype=torch.float32, device=dev)
    rec = torch.empty((nb, R, 8), dtype=torch.float32, device=dev)
    if nb == 0 or R == 0:
        return best_t, rec
    lib = load_tile_kernels()
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):   # the launch goes to the tensors' card
        rc = lib.closest_hit_spheres_launch(
            ptr(o.data_ptr()), ptr(d.data_ptr()), ptr(tcap.data_ptr()),
            ptr(zmin.data_ptr()), ptr(chunk_data.data_ptr()),
            ptr(best_t.data_ptr()), ptr(rec.data_ptr()), nb, R, nchunks, eps,
            ptr(torch.cuda.current_stream(dev).cuda_stream),
        )
    if rc != 0:
        raise RuntimeError(f"closest_hit_spheres_tiles kernel launch failed: "
                           f"CUDA error {rc}")
    launches["closest_hit_spheres_tiles"] += 1
    return best_t, rec


def closest_hit_spheres_tiles(o, *args, **kwargs):
    """Chunked sphere closest hit over all tiles.

    o, d: (nb, R, 3); tcap: (nb, R); zmin: (nb, nchunks); chunk_data:
    (nb, nchunks, 8, 128), all f32.  Returns ``best_t`` (nb, R) and the
    winner's record (nb, R, 8).  The kernel on CUDA tensors, its plain
    version on CPU tensors."""
    if o.device.type == "cuda":
        return closest_hit_spheres_tiles_cuda(o, *args, **kwargs)
    if o.device.type == "cpu":
        return closest_hit_spheres_tiles_plain(o, *args, **kwargs)
    raise ValueError(f"no closest-hit path for device {o.device}")


def kernel_attrs(R: int = 3328) -> dict:
    """Each hand kernel's registers a thread, local (spill) bytes a
    thread, static shared bytes and the blocks an SM holds at once (the CUDA
    occupancy calculator), the closest hit's for tiles of R rays: {name:
    dict}.  Needs the card."""
    from ._build import load_tile_kernels

    lib = load_tile_kernels()
    attrs = {}
    for which, name in enumerate(("closest_hit", "shadow_filter", "shadow_walk")):
        out = (ctypes.c_int * 4)()
        rc = lib.tile_kernels_attrs(which, R, ctypes.c_void_p(ctypes.addressof(out)))
        if rc != 0:
            raise RuntimeError(f"tile_kernels_attrs failed: CUDA error {rc}")
        attrs[name] = dict(registers=out[0], local_bytes=out[1],
                           static_smem=out[2], blocks_per_sm=out[3])
    return attrs


def _check_shadow_args(uvt, cellxy, lit, lrec, offs, cnt, grid_n: int):
    dev = uvt.device
    f32, i32 = torch.float32, torch.int32
    _check(uvt, "uvt", f32, 3, dev)
    _check(cellxy, "cellxy", i32, 3, dev)
    _check(lit, "lit", i32, 2, dev)
    _check(lrec, "lrec", f32, 2, dev)
    _check(offs, "offs", i32, 1, dev)
    _check(cnt, "cnt", i32, 1, dev)
    nb, R = lit.shape
    if tuple(uvt.shape) != (nb, R, 3) or tuple(cellxy.shape) != (nb, R, 2):
        raise ValueError(f"uvt must be ({nb}, {R}, 3) and cellxy ({nb}, {R}, 2), "
                         f"got {tuple(uvt.shape)}, {tuple(cellxy.shape)}")
    if lrec.shape[1] != 8:
        raise ValueError(f"lrec must be (M, 8), got {tuple(lrec.shape)}")
    ncells = grid_n * grid_n
    if tuple(offs.shape) != (ncells,) or tuple(cnt.shape) != (ncells,):
        raise ValueError(f"offs and cnt must be ({ncells},), got "
                         f"{tuple(offs.shape)}, {tuple(cnt.shape)}")
    return nb, R


def shadow_filter_tiles_plain(uvt, cellxy, lit, lrec, offs, cnt, grid_n: int,
                              eps: float = 4e-4) -> torch.Tensor:
    """Plain torch version: ``filt`` (nb, R) f32 in {0, 1}.  The lit rays
    walk their cells in batches that keep each (rays, step, 8) gather within
    the megakernel's element budget."""
    nb, R = _check_shadow_args(uvt, cellxy, lit, lrec, offs, cnt, grid_n)
    filt = torch.ones(nb * R, dtype=torch.float32, device=uvt.device)
    sel = torch.nonzero(lit.reshape(-1) > 0).flatten()
    batch = max(1, _mk._PLAIN_ELEMS // (_mk._SHADOW_STEP * 8))
    for s0 in range(0, sel.shape[0], batch):
        part = sel[s0:s0 + batch]
        u, v, tau = uvt.reshape(-1, 3)[part].unbind(1)
        gx, gy = cellxy.reshape(-1, 2)[part].clamp(0, grid_n - 1).unbind(1)
        cell = gy.to(torch.int64) * grid_n + gx
        filt[part] = 1.0 - _mk._shadow_blocked(lrec, offs, cnt, None, u, v,
                                               tau, cell, eps)
    return filt.view(nb, R)


def shadow_filter_tiles_cuda(uvt, cellxy, lit, lrec, offs, cnt, grid_n: int,
                             eps: float = 4e-4) -> torch.Tensor:
    """Launch the hand kernel on CUDA tensors (contiguous f32 / i32)."""
    from ._build import load_tile_kernels

    if uvt.device.type != "cuda":
        raise ValueError(f"shadow_filter_tiles_cuda needs CUDA tensors, got "
                         f"{uvt.device}")
    nb, R = _check_shadow_args(uvt, cellxy, lit, lrec, offs, cnt, grid_n)
    dev = uvt.device
    filt = torch.empty((nb, R), dtype=torch.float32, device=dev)
    if nb * R == 0:
        return filt
    if lrec.shape[0] == 0:   # every cell is empty; a valid pointer all the same
        lrec = torch.zeros((1, 8), dtype=torch.float32, device=dev)
    # the walk queue: its count, then the rays that need a walk
    scratch = torch.empty(nb * R + 1, dtype=torch.int32, device=dev)
    lib = load_tile_kernels()
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        rc = lib.shadow_filter_launch(
            ptr(uvt.data_ptr()), ptr(cellxy.data_ptr()), ptr(lit.data_ptr()),
            ptr(lrec.data_ptr()), ptr(offs.data_ptr()), ptr(cnt.data_ptr()),
            ptr(filt.data_ptr()), ptr(scratch.data_ptr()), nb * R, grid_n, eps,
            ptr(torch.cuda.current_stream(dev).cuda_stream),
        )
    if rc != 0:
        raise RuntimeError(f"shadow_filter_tiles kernel launch failed: CUDA "
                           f"error {rc}")
    launches["shadow_filter_tiles"] += 1
    return filt


def shadow_filter_tiles(uvt, *args, **kwargs) -> torch.Tensor:
    """Binary shadow transmission for all tiles.

    uvt: (nb, R, 3) f32 per-ray light-space (u, v, tau); cellxy: (nb, R, 2)
    i32 light cells; lit: (nb, R) i32 (1 = test me); lrec: (M, 8) f32 CSR
    records; offs, cnt: (grid_n^2,) i32.  Returns ``filt`` (nb, R) in
    {0.0, 1.0}.  The kernel on CUDA tensors, its plain version on CPU
    tensors."""
    if uvt.device.type == "cuda":
        return shadow_filter_tiles_cuda(uvt, *args, **kwargs)
    if uvt.device.type == "cpu":
        return shadow_filter_tiles_plain(uvt, *args, **kwargs)
    raise ValueError(f"no shadow-filter path for device {uvt.device}")
