"""Common-neighbor-analysis signatures as dense tensors.

The port of ``mdapy_tpu/analysis/cna_core.py``: ``bond_matrix`` (:20),
``_max_chain_length`` (:40) and ``cna_signatures`` (:63).  Per atom and
neighbor ni: the number of common neighbors, the bonds among them and the
most bonds in one connected piece of that bond graph (at most ``nn``
nodes), by min-label propagation over ``nn`` rounds, as ``fori_loop(0,
nn)`` runs them.
"""

from __future__ import annotations

import torch

from .common import min_image

__all__ = ["bond_matrix", "cna_signatures"]


def bond_matrix(pos, verlet, nn: int, matrix, inv, boundary, cutoff_sq):
    """(n, nn, nn) bool: are neighbors ni1, ni2 of each atom bonded?

    ``cutoff_sq`` is a float or a per-atom (n,) tensor."""
    pj = pos[verlet[:, :nn].clamp(min=0).long()]           # (n, nn, 3)
    disp = min_image(pj[:, :, None, :] - pj[:, None, :, :], matrix, inv,
                     boundary)
    d2 = torch.sum(disp * disp, dim=-1)
    if torch.is_tensor(cutoff_sq) and cutoff_sq.dim() > 0:
        cutoff_sq = cutoff_sq[:, None, None]
    eye = torch.eye(nn, dtype=torch.bool, device=pos.device)
    return (d2 <= cutoff_sq) & ~eye


def _max_chain_length(B, cn):
    """Most bonds in one connected piece of each common-neighbor bond
    graph.  B: (..., nn, nn) symmetric bonds among the common neighbors,
    cn: (..., nn) the common-neighbor mask.

    Labels are node ids (uint8 when nn < 255, to keep the (..., nn, nn)
    rounds small); after nn rounds each piece carries its least id, and a
    piece's bonds are half the degrees of its nodes (integer sums)."""
    nn = B.shape[-1]
    dtype = torch.uint8 if nn < 255 else torch.int64
    ids = torch.arange(nn, dtype=dtype, device=B.device)
    none = torch.tensor(nn, dtype=dtype, device=B.device)
    labels = torch.where(cn, ids, none)
    for _ in range(nn):
        adjacent = torch.where(B, labels[..., None, :], none).amin(dim=-1)
        labels = torch.minimum(labels, adjacent)
    deg = B.sum(dim=-1)                                      # int64
    counts = torch.zeros(*labels.shape[:-1], nn + 1, dtype=deg.dtype,
                         device=B.device)
    counts.scatter_add_(-1, labels.long(), deg)
    return counts[..., :nn].amax(dim=-1) // 2


def cna_signatures(bonded, nn: int):
    """Per (atom, neighbor ni): (numCommonNeighbors, numNeighborBonds,
    maxChainLength), the CNA triplet.  ``bonded``: (n, nn, nn) bool."""
    cn = bonded                           # cn[i, ni, :]: common nbrs of (i, ni)
    ncn = cn.sum(dim=-1)
    B = bonded[:, None, :, :] & cn[:, :, :, None] & cn[:, :, None, :]
    upper = torch.ones(nn, nn, dtype=torch.bool, device=bonded.device).triu(1)
    nbonds = (B & upper).sum(dim=(-2, -1))
    return ncn, nbonds, _max_chain_length(B, cn)
