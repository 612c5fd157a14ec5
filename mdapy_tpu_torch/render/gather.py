"""Per-tile candidate records for the render kernel.

Port of ``mdapy_tpu/render/pallas_kernels.py``: ``pack_sphere_table`` (:41)
and ``gather_chunk_data`` (:46).  These are plain gathers in both packages,
not kernels.
"""

from __future__ import annotations

import torch

__all__ = ["pack_sphere_table", "gather_chunk_data"]


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
    return rec.transpose(-1, -2).contiguous()
