"""Void detection via empty-cell-grid filling + clustering.

The port of ``mdapy_tpu/analysis/void_analysis.py``: overlay a grid of cell
size rc, mark the cells that hold no atom, and cluster adjacent empty cells
(6-connectivity, periodic wrap along periodic axes); ``void_number`` is the
cluster count, ``void_volume`` = n_empty_cells * rc^3.  The cell fill and
the clustering run on ``device`` (the card unless the caller passes
``device="cpu"``): the JAX class's scipy ``connected_components`` (:42-67)
becomes the port's min-label propagation (``cluster_analysis.
connected_components``) over the empty cells' 6-neighbor table, and the
components are numbered in the order of their smallest cell index, as
scipy numbers them, so ``void_labels`` equals the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .cluster_analysis import connected_components

__all__ = ["VoidAnalysis"]


class VoidAnalysis:
    """``system`` is anything with ``.pos`` and ``.box``; ``device`` is
    "cuda" (default) or "cpu"."""

    def __init__(self, system, rc: float = 5.0, device="cuda"):
        self.system = system
        self.rc = float(rc)
        self.device = resolve_device(device, "VoidAnalysis")
        self.void_number = 0
        self.void_volume = 0.0

    def compute(self):
        dev = self.device
        box = self.system.box
        pos = torch.as_tensor(np.asarray(self.system.pos, dtype=np.float64),
                              device=dev)
        inv = torch.tensor(np.asarray(box.inverse_box), device=dev)
        frac = (pos - torch.tensor(np.asarray(box.origin), device=dev)) @ inv
        per = box.boundary.astype(bool)
        frac = torch.where(torch.as_tensor(per, device=dev),
                           frac - torch.floor(frac), frac)
        thickness = box.get_thickness()
        nc = np.maximum(1, (thickness / self.rc).astype(int))
        nc_t = torch.as_tensor(nc, device=dev)
        idx = torch.minimum(torch.clamp((frac * nc_t).to(torch.int64), min=0),
                            nc_t - 1)
        flat = (idx[:, 0] * nc[1] + idx[:, 1]) * nc[2] + idx[:, 2]
        filled = torch.zeros(int(np.prod(nc)), dtype=torch.bool, device=dev)
        filled[flat] = True
        empty = torch.nonzero(~filled).squeeze(1)          # flat ids, ascending
        n_empty = int(empty.numel())
        if n_empty == 0:
            self.void_number = 0
            self.void_volume = 0.0
            return self
        # each empty cell's six neighbors among the empty cells (-1: none)
        cell_id = torch.full((int(np.prod(nc)),), -1, dtype=torch.int64, device=dev)
        cell_id[empty] = torch.arange(n_empty, device=dev)
        cells = torch.stack([empty // (nc[1] * nc[2]), (empty // nc[2]) % nc[1],
                             empty % nc[2]], dim=1)
        nbrs = []
        for axis in range(3):
            for sgn in (1, -1):
                shifted = cells.clone()
                shifted[:, axis] += sgn
                if per[axis]:
                    shifted[:, axis] %= int(nc[axis])
                ok = (shifted[:, axis] >= 0) & (shifted[:, axis] < int(nc[axis]))
                sflat = (shifted[:, 0] * nc[1] + shifted[:, 1]) * nc[2] + shifted[:, 2]
                nbrs.append(torch.where(ok, cell_id[torch.where(ok, sflat, 0)], -1))
        verlet = torch.stack(nbrs, dim=1)
        labels = connected_components(verlet, verlet >= 0)
        ids, ranks = torch.unique(labels, return_inverse=True)
        self.void_number = int(ids.numel())
        self.void_volume = float(n_empty * self.rc**3)
        self.void_labels = ranks.to(torch.int32).cpu().numpy()
        return self
