"""N-dimensional spatial binning of per-atom properties.

The port of ``mdapy_tpu/analysis/spatial_binning.py``: bin atoms along
x/y/z (or any combination) with a fixed bin width (orthogonal boxes only)
and aggregate named columns with mean/sum/min/max/sum-per-volume/count, on
``device`` (the card unless the caller passes ``device="cpu"``).  Counts
are an integer ``torch.bincount``; a bin's float sum is a row sum over its
atoms taken in a stable sorted order (``common.segment_sum``), where the
JAX class calls ``np.bincount(weights=...)`` (:63-72), so the card repeats
every sum bit for bit; min and max scatter (``scatter_reduce``), which does
not depend on order.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

from ..core.device import resolve_device
from .common import segment_sum

__all__ = ["SpatialBinning"]

_AXES = {"x": 0, "y": 1, "z": 2}


class SpatialBinning:
    """``data`` is an ``AtomFrame`` or a dict of columns (with x, y, z);
    ``device`` is "cuda" (default) or "cpu"."""

    def __init__(self, data, box, direction: str = "x", bin_width: float = 5.0,
                 device="cuda"):
        self.data = data
        self.box = box
        if box.triclinic:
            raise ValueError("SpatialBinning supports orthogonal boxes only")
        direction = direction.lower()
        if not set(direction) <= set("xyz") or len(direction) == 0:
            raise ValueError("direction must combine 'x','y','z'")
        self.direction = direction
        self.axes = [_AXES[c] for c in direction]
        self.bin_width = float(bin_width)
        self.device = resolve_device(device, "SpatialBinning")
        self.result = {}
        self.coor = None

    def compute(self, names: Union[str, List[str]], operations: Union[str, List[str]] = "mean"):
        if isinstance(names, str):
            names = [names]
        if isinstance(operations, str):
            operations = [operations] * len(names)
        dev = self.device
        lengths = np.diag(self.box.matrix)
        origin = self.box.origin
        nbins = [max(1, int(np.ceil(lengths[a] / self.bin_width))) for a in self.axes]
        flat = torch.zeros(len(self.data["x"]), dtype=torch.int64, device=dev)
        for a, nb in zip(self.axes, nbins):
            coord = torch.as_tensor(np.asarray(self.data["xyz"[a]], dtype=np.float64),
                                    device=dev)
            k = ((coord - origin[a]) / self.bin_width).to(torch.int64)
            flat = flat * nb + torch.clamp(k, 0, nb - 1)
        total = int(np.prod(nbins))
        binvol = self.bin_width ** len(self.axes) * np.prod(
            [lengths[a] for a in range(3) if a not in self.axes]
        )
        self.coor = [
            origin[a] + (np.arange(nb) + 0.5) * self.bin_width
            for a, nb in zip(self.axes, nbins)
        ]
        counts_i = torch.bincount(flat, minlength=total)
        counts = counts_i.to(torch.float64)
        order = None
        for name, op in zip(names, operations):
            v = torch.as_tensor(np.asarray(self.data[name], dtype=np.float64),
                                device=dev)
            if op == "count":
                out = counts
            elif op in ("sum", "mean", "sum/binvol"):
                if order is None:
                    order = torch.sort(flat, stable=True).indices
                s = segment_sum(v[order], counts_i)
                if op == "sum":
                    out = s
                elif op == "mean":
                    out = torch.where(counts == 0, 0.0, s / counts)
                else:
                    out = s / binvol
            elif op in ("min", "max"):
                fill = np.inf if op == "min" else -np.inf
                out = torch.full((total,), fill, dtype=torch.float64, device=dev)
                out = out.scatter_reduce(0, flat, v, "amin" if op == "min" else "amax")
                out = torch.where(torch.isfinite(out), out, 0.0)
            else:
                raise ValueError(f"Unknown operation {op!r}")
            self.result[f"{name}_{op}"] = out.cpu().numpy().reshape(nbins)
        return self
