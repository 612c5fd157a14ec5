"""Warren-Cowley short-range-order parameter matrix.

The port of ``mdapy_tpu/analysis/warren_cowley_parameter.py``: alpha_ab =
1 - P(b | neighbor of a) / c_b from the neighbor list.  The (a, b) pair
counts are an integer ``torch.bincount`` over the list on ``device`` (the
card unless the caller passes ``device="cpu"``), where the JAX class adds
floats with ``np.add.at`` (:36); counts are exact either way, so alpha
equals the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["WarrenCowleyParameter"]


class WarrenCowleyParameter:
    """``verlet_list`` may be a numpy array or a tensor."""

    def __init__(self, types, verlet_list, neighbor_number, elements=None,
                 device="cuda"):
        self.types = np.asarray(types, dtype=np.int64)
        self.verlet_list = verlet_list
        self.neighbor_number = neighbor_number
        labels = self.types if elements is None else np.asarray(elements)
        self._labels = labels
        # sorted distinct labels and each atom's index among them, as the
        # JAX class's lookup table gives them
        uniq, idx = np.unique(labels, return_inverse=True)
        self.elements = uniq.tolist()
        self.Ntype = len(uniq)
        self.type_idx = idx.astype(np.int64)
        self.device = resolve_device(device, "WarrenCowleyParameter")
        self.wcp = None

    def compute(self):
        n = len(self.type_idx)
        nt = self.Ntype
        dev = self.device
        verlet = torch.as_tensor(self.verlet_list, device=dev)
        tidx = torch.as_tensor(self.type_idx, device=dev)
        valid = verlet >= 0
        tj = tidx[torch.where(valid, verlet, 0).long()]
        flat = torch.where(valid, tidx[:, None] * nt + tj, nt * nt)
        counts = torch.bincount(flat.reshape(-1), minlength=nt * nt + 1)
        pair_counts = counts[:-1].view(nt, nt).cpu().numpy().astype(np.float64)
        conc = np.bincount(self.type_idx, minlength=nt) / n
        # probability of a b-neighbor around an a-atom
        tot_a = pair_counts.sum(axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            p = pair_counts / tot_a[:, None]
            alpha = 1.0 - p / conc[None, :]
        alpha[~np.isfinite(alpha)] = 0.0
        self.wcp = alpha
        self.WCP = alpha  # reference-API name (warren_cowley_parameter.py:193)
        return self

    def plot(self, fig=None, ax=None):
        import matplotlib.pyplot as plt

        if fig is None and ax is None:
            fig, ax = plt.subplots()
        im = ax.imshow(self.wcp, cmap="coolwarm")
        ax.set_xticks(range(self.Ntype))
        ax.set_yticks(range(self.Ntype))
        ax.set_xticklabels([str(e) for e in self.elements])
        ax.set_yticklabels([str(e) for e in self.elements])
        plt.colorbar(im, ax=ax)
        return fig, ax
