"""Per-tile candidate records for the render kernel.

Port of ``mdapy_tpu/render/pallas_kernels.py``: ``pack_sphere_table`` (:41),
``gather_chunk_data`` (:46) and ``gather_chunk_data_banded`` (:72).  These
are plain gathers in both packages, not kernels.
"""

from __future__ import annotations

import torch

from .. import tracing

__all__ = ["pack_sphere_table", "gather_chunk_data", "gather_chunk_data_banded"]


def pack_sphere_table(centers, radii, colors) -> torch.Tensor:
    """Scene-constant packed (n, 8) record table [cx, cy, cz, r, rgba]."""
    return torch.cat([centers, radii[:, None], colors], dim=1)


def gather_chunk_data(sph_chunks, centers, radii, colors, table=None):
    """(nb, nchunks, CH) ids -> (nb, nchunks, 8, CH) f32 records
    [cx, cy, cz, r, rgba] as rows; padded slots (id -1) get r = -1."""
    if table is None:
        table = pack_sphere_table(centers, radii, colors)
    rec = table.to(torch.float32)[sph_chunks.clamp(min=0)]   # (nb, nchunks, CH, 8)
    rec[..., 3] = torch.where(sph_chunks >= 0, rec[..., 3], -1.0)
    out = rec.transpose(-1, -2).contiguous()
    tracing.count("accel.gather_bytes", out.nbytes)
    return out


def gather_chunk_data_banded(sph_chunks, centers, radii, colors,
                             band_bytes: int = 1 << 30):
    """``gather_chunk_data`` with a bounded peak: the records of one band of
    tiles at a time, written into one result, so the peak is the result and
    one band's gather (the one-shot gather holds the gathered rows and
    their transpose, over twice the result).  Equal to ``gather_chunk_data``; records that fit in one band
    are gathered in one shot."""
    nb, nchunks, ch = sph_chunks.shape
    table = pack_sphere_table(centers, radii, colors)
    rows = max(1, min(nb, band_bytes // max(nchunks * 8 * ch * 4, 1)))
    if rows == nb:
        return gather_chunk_data(sph_chunks, centers, radii, colors,
                                 table=table)
    out = torch.empty((nb, nchunks, 8, ch), dtype=torch.float32,
                      device=sph_chunks.device)
    for b0 in range(0, nb, rows):
        b1 = min(nb, b0 + rows)
        out[b0:b1] = gather_chunk_data(sph_chunks[b0:b1], centers, radii,
                                       colors, table=table)
    return out
