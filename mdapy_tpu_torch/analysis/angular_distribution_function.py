"""Angular distribution function for element triplets A-B-C (A central).

The port of ``mdapy_tpu/analysis/angular_distribution_function.py``
(``_adf_one`` :113): for each central atom of type A, its B neighbors
within [rAB_min, rAB_max] and C neighbors within [rAC_min, rAC_max] form
angles at A, binned over [0, 180] degrees and counted in integers; a
same-type pair (B == C) counts once (kk > jj).  Rows go in chunks of
``common.CHUNK_BYTES``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from ..core.box import init_box
from ..core.device import resolve_device
from ..neighbor.neighbor import neighbor_tensors
from .common import box_tensors, min_image, row_chunks

__all__ = ["AngularDistributionFunction"]


class AngularDistributionFunction:
    """Precomputed lists may be numpy arrays or tensors; ``device`` is
    "cuda" (default) or "cpu"."""

    def __init__(
        self,
        pos,
        box,
        rc_dict: Dict[str, List[float]],
        nbin: int = 100,
        types=None,
        elements=None,
        verlet_list=None,
        distance_list=None,
        neighbor_number=None,
        device="cuda",
    ):
        self.pos = np.ascontiguousarray(pos, dtype=np.float64)
        self.box = init_box(box)
        self.rc_dict = dict(rc_dict)
        self.nbin = int(nbin)
        if elements is not None:
            labels = np.asarray(elements).astype(str)
        elif types is not None:
            labels = np.asarray(types)
        else:
            raise ValueError("ADF requires types or elements")
        # sorted distinct labels and each atom's index among them, as the
        # JAX class's loop over the atoms gives them
        uniq, idx = np.unique(labels, return_inverse=True)
        self.ele_unique = uniq.tolist()
        self.type_idx = idx.astype(np.int32)
        lut = {e: i for i, e in enumerate(self.ele_unique)}
        pair_list, rc_list = [], []
        for key, rcs in self.rc_dict.items():
            a, b, c = [p.strip() for p in key.split("-")]

            def to_idx(s):
                if s in lut:
                    return lut[s]
                # integer type labels passed as strings
                try:
                    return lut[int(s)]
                except (ValueError, KeyError):
                    raise KeyError(f"Unknown species {s!r} in rc_dict")

            pair_list.append([to_idx(a), to_idx(b), to_idx(c)])
            rc_list.append([float(v) for v in rcs])
        self.pair_list = np.asarray(pair_list, dtype=np.int32)
        self.rc_list = np.asarray(rc_list, dtype=np.float64)
        self._nlist = (verlet_list, distance_list, neighbor_number)
        self.device = resolve_device(device, "AngularDistributionFunction")
        self.bond_angle_distribution = None
        self.r_angle = None

    def compute(self):
        dev = self.device
        verlet, dist, _ = self._nlist
        if verlet is None:
            rmax = float(self.rc_list[:, [1, 3]].max())
            verlet, dist, _ = neighbor_tensors(self.pos, self.box, rmax,
                                               device=dev)
        verlet = torch.as_tensor(verlet, device=dev)
        dist = torch.as_tensor(dist, dtype=torch.float64, device=dev)
        m, inv, b = box_tensors(self.box, dev)
        pos = torch.as_tensor(self.pos, device=dev)
        type_idx = torch.as_tensor(self.type_idx, device=dev)
        hists = []
        for (ta, tb, tc), rcs in zip(self.pair_list.tolist(),
                                     self.rc_list.tolist()):
            hists.append(_adf_one(pos, verlet, dist, type_idx, m, inv, b,
                                  ta, tb, tc, rcs, self.nbin))
        self.bond_angle_distribution = torch.stack(hists).cpu().numpy()
        dth = 180.0 / self.nbin
        self.r_angle = (np.arange(self.nbin) + 0.5) * dth
        return self

    def plot_bond_angle_distribution(self, fig=None, ax=None):
        import matplotlib.pyplot as plt

        if fig is None and ax is None:
            fig, ax = plt.subplots()
        for p, key in enumerate(self.rc_dict):
            ax.plot(self.r_angle, self.bond_angle_distribution[p], "o-", label=key)
        ax.legend()
        ax.set_xlabel(r"$\theta$ (deg)")
        ax.set_ylabel("count")
        return fig, ax


def angle_bins(unit, nbin: int):
    """(n, M, M) bin of the angle between each two unit bonds, by
    floor(theta / (180 / nbin)), at most nbin - 1."""
    cosang = torch.clamp(torch.einsum("imx,inx->imn", unit, unit), -1.0, 1.0)
    theta = torch.arccos(cosang) * (180.0 / math.pi)
    return torch.clamp((theta / (180.0 / nbin)).to(torch.int32), max=nbin - 1)


def _adf_one(pos, verlet, dist, type_idx, matrix, inv, boundary,
             ta: int, tb: int, tc: int, rcs, nbin: int):
    n, M = verlet.shape
    rab0, rab1, rac0, rac1 = rcs
    mm = torch.arange(M, device=pos.device)
    if tb == tc:
        order_ok = mm[:, None] < mm[None, :]
    else:
        order_ok = mm[:, None] != mm[None, :]
    hist = torch.zeros(nbin + 1, dtype=torch.int64, device=pos.device)
    for s, e in row_chunks(n, M * M * 8 * 4 + M * 3 * 8 * 4):
        vl, dl = verlet[s:e], dist[s:e]
        ok = vl >= 0
        j = vl.clamp(min=0).long()
        tj = type_idx[j]
        central = (type_idx[s:e] == ta)[:, None]
        okB = ok & (tj == tb) & (dl >= rab0) & (dl <= rab1) & central
        okC = ok & (tj == tc) & (dl >= rac0) & (dl <= rac1) & central
        disp = min_image(pos[j] - pos[s:e, None, :], matrix, inv, boundary)
        unit = disp / torch.clamp(dl, min=1e-30)[..., None]
        pair_ok = okB[:, :, None] & okC[:, None, :] & order_ok
        sel = torch.where(pair_ok, angle_bins(unit, nbin), nbin)
        hist += torch.bincount(sel.reshape(-1), minlength=nbin + 1)
    return hist[:nbin]
