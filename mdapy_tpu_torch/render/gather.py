"""Per-tile candidate records for the render kernel.

Port of ``mdapy_tpu/render/pallas_kernels.py``: ``pack_sphere_table`` (:41),
``gather_chunk_data`` (:46) and ``gather_chunk_data_banded`` (:72).

``gather_chunk_data`` dispatches on the ids' device, as the other kernels'
wrappers do: on a CUDA card the hand kernel (``csrc/chunk_gather.cu``)
takes every gather, with the table cast to float32 and the ids to int64
where they are not; on the CPU ``gather_chunk_data_plain``, a row gather, a
where and a transpose in torch ops, takes it.  A build or launch that fails
raises.  Both give the same bytes.  On the card the gather is bound by its
bytes (32 out and 8 in a slot); the kernel writes the transposed layout
directly, a warp's 512 contiguous bytes a field (the source's note).  Each
kernel call counts one launch in ``launches``, which is always on; the
tracing counter ``accel.gather_launches`` mirrors it while a recording is
open.
"""

from __future__ import annotations

import ctypes

import torch

from .. import tracing

__all__ = ["pack_sphere_table", "gather_chunk_data", "gather_chunk_data_banded",
           "gather_chunk_data_plain", "gather_chunk_data_cuda", "launches",
           "reset_launches"]

# hand-kernel launches since the last reset_launches()
launches = {"chunk_gather": 0}


def reset_launches() -> None:
    launches["chunk_gather"] = 0


def pack_sphere_table(centers, radii, colors) -> torch.Tensor:
    """Scene-constant packed (n, 8) record table [cx, cy, cz, r, rgba]."""
    return torch.cat([centers, radii[:, None], colors], dim=1)


def gather_chunk_data_plain(sph_chunks, table) -> torch.Tensor:
    """The gather in torch ops, on the ids' device: (nb, nchunks, CH) ids
    -> (nb, nchunks, 8, CH) f32 records; padded slots (id -1) get r = -1.
    The CPU's path, and the kernel's oracle on the card."""
    rec = table.to(torch.float32)[sph_chunks.clamp(min=0)]   # (nb, nchunks, CH, 8)
    rec[..., 3] = torch.where(sph_chunks >= 0, rec[..., 3], -1.0)
    return rec.transpose(-1, -2).contiguous()


def gather_chunk_data_cuda(sph_chunks, table) -> torch.Tensor:
    """Launch the hand kernel on CUDA ids and a table on the same card.  The
    table is cast to float32 and the ids to int64 as the plain version does;
    ids that are not contiguous, or a table that is not a 16-byte aligned
    contiguous one, are copied first."""
    from ._build import load_chunk_gather

    if not sph_chunks.is_cuda:
        raise ValueError(f"gather_chunk_data_cuda needs CUDA ids, got them on "
                         f"{sph_chunks.device}")
    if table.device != sph_chunks.device:
        raise ValueError(f"the table is on {table.device}, the ids on "
                         f"{sph_chunks.device}")
    if sph_chunks.ndim != 3 or table.ndim != 2 or table.shape[1] != 8:
        raise ValueError(f"ids must be (nb, nchunks, CH) and the table (n, 8), "
                         f"got {tuple(sph_chunks.shape)} and {tuple(table.shape)}")
    ids = sph_chunks.to(torch.int64).contiguous()
    table = table.to(torch.float32)
    if not table.is_contiguous() or table.data_ptr() % 16:
        table = table.clone(memory_format=torch.contiguous_format)
    nb, nchunks, ch = ids.shape
    out = torch.empty((nb, nchunks, 8, ch), dtype=torch.float32, device=ids.device)
    if ids.numel() == 0:
        return out
    lib = load_chunk_gather()
    ptr = ctypes.c_void_p
    with torch.cuda.device(ids.device):   # the launch goes to the ids' card
        rc = lib.chunk_gather_launch(
            ptr(ids.data_ptr()), ptr(table.data_ptr()), table.shape[0],
            ptr(out.data_ptr()), ids.numel(), ch,
            ptr(torch.cuda.current_stream(ids.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"chunk_gather kernel launch failed: CUDA error {rc}")
    launches["chunk_gather"] += 1
    tracing.count("accel.gather_launches", 1)
    return out


def gather_chunk_data(sph_chunks, centers, radii, colors, table=None):
    """(nb, nchunks, CH) ids -> (nb, nchunks, 8, CH) f32 records
    [cx, cy, cz, r, rgba] as rows; padded slots (id -1) get r = -1.  The
    kernel for CUDA ids, the plain version on the CPU."""
    if table is None:
        table = pack_sphere_table(centers, radii, colors)
    out = (gather_chunk_data_cuda(sph_chunks, table) if sph_chunks.is_cuda
           else gather_chunk_data_plain(sph_chunks, table))
    tracing.count("accel.gather_bytes", out.nbytes)
    return out


def gather_chunk_data_banded(sph_chunks, centers, radii, colors,
                             band_bytes: int = 1 << 30):
    """``gather_chunk_data`` with a bounded peak: the records of one band of
    tiles at a time, written into one result, so the peak is the result and
    one band's gather (the plain gather holds the gathered rows and their
    transpose, over twice the result).  Equal to ``gather_chunk_data``;
    records that fit in one band, and every gather on the card (the kernel
    holds nothing beside the result), are gathered in one shot."""
    nb, nchunks, ch = sph_chunks.shape
    table = pack_sphere_table(centers, radii, colors)
    rows = max(1, min(nb, band_bytes // max(nchunks * 8 * ch * 4, 1)))
    if rows == nb or sph_chunks.is_cuda:
        return gather_chunk_data(sph_chunks, centers, radii, colors,
                                 table=table)
    out = torch.empty((nb, nchunks, 8, ch), dtype=torch.float32,
                      device=sph_chunks.device)
    for b0 in range(0, nb, rows):
        b1 = min(nb, b0 + rows)
        out[b0:b1] = gather_chunk_data(sph_chunks[b0:b1], centers, radii,
                                       colors, table=table)
    return out
