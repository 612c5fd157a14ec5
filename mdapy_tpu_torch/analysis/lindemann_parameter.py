"""Lindemann index over a trajectory (global + per-atom, incremental Welford).

The port of ``mdapy_tpu/analysis/lindemann_parameter.py``: q_ij =
sqrt(<r_ij^2> - <r_ij>^2) / <r_ij>, the Lindemann index the mean over
pairs, with the JAX running mean and M2 recurrence frame by frame on (n, n)
float64 tensors on ``device`` (the card unless the caller passes
``device="cpu"``), so memory stays O(N^2), not O(frames * N^2).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["LindemannParameter"]


class LindemannParameter:
    """``device`` is "cuda" (default) or "cpu"."""

    def __init__(self, pos_list: np.ndarray, only_global: bool = False,
                 device="cuda"):
        self.pos_list = np.ascontiguousarray(pos_list, dtype=np.float64)
        assert self.pos_list.ndim == 3
        self.only_global = bool(only_global)
        self.device = resolve_device(device, "LindemannParameter")
        self.lindemann_frame = None
        self.lindemann_atom = None
        self.lindemann_trj = None

    def compute(self):
        dev = self.device
        nframe, n, _ = self.pos_list.shape
        mean = torch.zeros((n, n), dtype=torch.float64, device=dev)
        m2 = torch.zeros((n, n), dtype=torch.float64, device=dev)
        frames = torch.zeros(nframe, dtype=torch.float64, device=dev)
        iu = torch.triu_indices(n, n, offset=1, device=dev)
        for f in range(nframe):
            pos = torch.as_tensor(self.pos_list[f], device=dev)
            diff = pos[:, None, :] - pos[None, :, :]
            rij = torch.sqrt(torch.sum(diff * diff, dim=2))
            del diff
            k = f + 1
            delta = rij - mean
            mean += delta / k
            m2 += delta * (rij - mean)
            if k > 1:
                q = _ratio(m2 / k, mean)
                frames[f] = q[iu[0], iu[1]].mean()
        self.lindemann_frame = frames.cpu().numpy()
        self.lindemann_trj = float(self.lindemann_frame[-1])
        if not self.only_global:
            q = _ratio(m2 / nframe, mean)
            q.fill_diagonal_(0.0)
            self.lindemann_atom = (q.sum(dim=1) / (n - 1)).cpu().numpy()
        return self


def _ratio(var, mean):
    """sqrt(var) / mean, 0 where it is not finite."""
    q = torch.sqrt(var) / mean
    return torch.where(torch.isfinite(q), q, 0.0)
