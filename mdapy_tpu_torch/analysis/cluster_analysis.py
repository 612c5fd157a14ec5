"""Connected-component cluster labels over the neighbor graph.

The port of ``mdapy_tpu/analysis/cluster_analysis.py``: clusters of atoms
linked within rc (a float, or a per-type-pair dict like {'1-1': 1.5}),
with 1-based ids in the order of each cluster's first atom.  The JAX class
finds the components with scipy on the host (:27, :97) and renumbers them
in a Python loop over the atoms (:99-106); here the components come from
min-label propagation with pointer jumping on the device, the counterpart
of ``connected_components_jax`` (:40-62).  Each component then carries its
smallest atom index, so ``torch.unique(return_inverse=True)`` + 1 gives the
same ids as the first-occurrence loop.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from ..core.box import init_box
from ..core.device import resolve_device
from ..neighbor.neighbor import neighbor_tensors

__all__ = ["ClusterAnalysis", "connected_components"]


def connected_components(verlet, bonded):
    """0-based labels, each component's smallest atom index, from a masked
    neighbor list (tensors; the bonds must be symmetric).  One host
    synchronisation a round, to see whether the labels still change."""
    n = verlet.shape[0]
    labels = torch.arange(n, device=verlet.device)
    j = torch.where(bonded, verlet, 0).long()
    while True:
        neigh = torch.where(bonded, labels[j], n)
        new = torch.minimum(labels, neigh.amin(dim=1))
        new = new[new]                       # pointer jump
        if torch.equal(new, labels):
            return labels
        labels = new


class ClusterAnalysis:
    """``device`` is "cuda" (default) or "cpu"."""

    def __init__(self, pos, box, rc: Union[float, Dict] = 5.0, types=None,
                 max_neigh=None, device="cuda"):
        self.pos = np.ascontiguousarray(pos, dtype=np.float64)
        self.box = init_box(box)
        self.rc = rc
        self.types = None if types is None else np.asarray(types, dtype=np.int32)
        self.max_neigh = max_neigh
        self.device = resolve_device(device, "ClusterAnalysis")
        self.particleClusters = None
        self.cluster_number = 0

    def compute(self):
        dev = self.device
        if np.isscalar(self.rc):
            rmax = float(self.rc)
            cut = None
        else:
            # dict {'1-1': 1.5} or {(1,1): 1.5}
            if self.types is None:
                raise ValueError("Per-type-pair cutoffs require a type array")
            ntypes = int(self.types.max())
            cut = np.zeros((ntypes, ntypes))
            for key, val in self.rc.items():
                a, b = key if isinstance(key, tuple) else key.split("-")
                cut[int(a) - 1, int(b) - 1] = cut[int(b) - 1, int(a) - 1] = float(val)
            rmax = float(cut.max())
        verlet, dist, _ = neighbor_tensors(self.pos, self.box, rmax,
                                           self.max_neigh, device=dev)
        valid = verlet >= 0
        if cut is None:
            bonded = valid & (dist <= rmax)
        else:
            t = torch.as_tensor(self.types, device=dev).long() - 1
            cut_t = torch.as_tensor(cut, device=dev)
            pair_rc = cut_t[t[:, None], t[torch.where(valid, verlet, 0).long()]]
            bonded = valid & (dist <= pair_rc)
        labels = connected_components(verlet, bonded)
        ids, inverse = torch.unique(labels, return_inverse=True)
        self.particleClusters = (inverse + 1).int().cpu().numpy()
        self.cluster_number = int(ids.numel())
        return self

    def get_size_of_cluster(self, cluster_id: int) -> int:
        return int(np.sum(self.particleClusters == cluster_id))
