"""Radial distribution function g(r), total and partials.

The port of ``mdapy_tpu/analysis/radial_distribution_function.py``:
normalization g_total = hist_all / shell_vol_frac / N^2, g_ab = (hist_ab +
hist_ba) / (n_a n_b) / shell / (2 if a != b else 1).  Two routes, chosen by
the reference's auto rule (:70-77, system.py:2275-2291): the Verlet route
(``_bin_pairs`` :149) bins a neighbor list, and the streaming route
(``_stream_bin`` :170), taken when rc >= the least periodic thickness / 3,
bins blocked all-pairs distances of the centres against the image-replicated
atom set, so no list of O(N x max_neigh) is stored.  Both count in integers
(``torch.bincount``).  Known deviation of the streaming route, as in the
JAX package: two distinct atoms at exactly coincident coordinates are
excluded (self-pairs are found by zero distance).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.box import init_box
from ..core.device import resolve_device
from ..neighbor.neighbor import neighbor_tensors, replicate_for_small_box
from .common import box_tensors, min_image, row_chunks

__all__ = ["RadialDistributionFunction"]


class RadialDistributionFunction:
    """Precomputed lists may be numpy arrays or tensors; ``device`` is
    "cuda" (default) or "cpu"."""

    def __init__(
        self,
        pos=None,
        box=None,
        rc: float = 5.0,
        nbin: int = 100,
        types=None,
        elements=None,
        streaming: Optional[bool] = None,
        verlet_list=None,
        distance_list=None,
        neighbor_number=None,
        device="cuda",
    ):
        self.pos = np.ascontiguousarray(pos, dtype=np.float64)
        self.box = init_box(box)
        self.rc = float(rc)
        self.nbin = int(nbin)
        self.N = len(self.pos)
        self.vol = abs(self.box.volume)
        labels = types if elements is None else elements
        if labels is None:
            labels = np.zeros(self.N, dtype=np.int32)
        # sorted distinct labels and each atom's index among them, as the
        # JAX class's loop over the atoms gives them
        uniq, idx = np.unique(np.asarray(labels), return_inverse=True)
        self.elements = uniq.tolist()
        self.Ntype = len(uniq)
        self.type_idx = idx.astype(np.int32)
        self.streaming = streaming
        self._precomputed = (verlet_list, distance_list, neighbor_number)
        self.device = resolve_device(device, "RadialDistributionFunction")
        self.r = None
        self.g_total = None
        self.g_partial: Dict[Tuple, np.ndarray] = {}

    def _auto_streaming(self) -> bool:
        """Stream when the Verlet list would be prohibitively wide: rc >=
        the least periodic thickness / 3 (system.py:2275-2291)."""
        thick = self.box.get_thickness()
        per = self.box.boundary == 1
        if not per.any():
            return False
        return self.rc >= float(thick[per].min()) / 3.0

    def compute(self):
        verlet, dist, _ = self._precomputed
        streaming = self.streaming
        if verlet is not None:
            streaming = False
        elif streaming is None:
            streaming = self._auto_streaming()
        edges = np.linspace(0, self.rc, self.nbin + 1)
        const = (4.0 * np.pi / 3.0 * (edges[1:] ** 3 - edges[:-1] ** 3)) / self.vol
        self.r = (edges[1:] + edges[:-1]) / 2

        dev = self.device
        type_idx = torch.as_tensor(self.type_idx, device=dev)
        if streaming:
            counts = self._stream_counts(type_idx)
        else:
            if verlet is None:
                verlet, dist, _ = neighbor_tensors(self.pos, self.box, self.rc,
                                                   device=dev)
            counts = _bin_pairs(
                torch.as_tensor(verlet, device=dev),
                torch.as_tensor(dist, dtype=torch.float64, device=dev),
                type_idx, self.rc, self.nbin, self.Ntype)
        counts = counts.cpu().numpy().astype(np.float64)
        total = counts.sum(axis=(0, 1))
        self.g_total = total / const / self.N**2
        nper = np.bincount(self.type_idx, minlength=self.Ntype)
        for a in range(self.Ntype):
            for b in range(a, self.Ntype):
                raw = counts[a, b] if a == b else counts[a, b] + counts[b, a]
                if nper[a] > 0 and nper[b] > 0:
                    g_ab = raw / (nper[a] * nper[b]) / const
                    if a != b:
                        g_ab = g_ab * 0.5
                else:
                    g_ab = np.zeros_like(self.r)
                self.g_partial[(self.elements[a], self.elements[b])] = g_ab
        return self

    def _stream_counts(self, type_idx):
        """The reference's ``_rdf_streaming`` (radial_distribution_function.cpp:323)."""
        dev = self.device
        pos_c, box_c, n_images = replicate_for_small_box(self.pos, self.box,
                                                         self.rc)
        m, inv, b = box_tensors(box_c, dev)
        return _stream_bin(torch.as_tensor(self.pos, device=dev),
                           torch.as_tensor(pos_c, device=dev), type_idx,
                           type_idx.repeat(n_images), m, inv, b, self.rc,
                           self.nbin, self.Ntype)

    def plot(self, fig=None, ax=None):
        import matplotlib.pyplot as plt

        if fig is None and ax is None:
            fig, ax = plt.subplots()
        ax.plot(self.r, self.g_total, "o-", ms=3)
        ax.set_xlabel(r"r ($\AA$)")
        ax.set_ylabel("g(r)")
        ax.set_xlim(0, self.rc)
        return fig, ax


def _bin_pairs(verlet, dist, type_idx, rc: float, nbin: int, ntype: int):
    """(type_i, type_j, bin) int64 counts over the Verlet list."""
    n, M = verlet.shape
    dr = rc / nbin
    sentinel = ntype * ntype * nbin
    hist = torch.zeros(sentinel + 1, dtype=torch.int64, device=dist.device)
    for s, e in row_chunks(n, M * 8 * 6):
        vl, dl = verlet[s:e], dist[s:e]
        ok = (vl >= 0) & (dl < rc)
        k = torch.clamp((dl / dr).to(torch.int32), 0, nbin - 1)
        tj = type_idx[vl.clamp(min=0).long()]
        flat = (type_idx[s:e, None].long() * ntype + tj) * nbin + k
        flat = torch.where(ok, flat, sentinel)
        hist += torch.bincount(flat.reshape(-1), minlength=sentinel + 1)
    return hist[:-1].view(ntype, ntype, nbin)


def _stream_bin(pos, pos_all, type_idx, type_all, matrix, inv, boundary,
                rc: float, nbin: int, ntype: int):
    """Blocked all-pairs (centre block x the whole image set) binning: the
    Verlet route's counts over an exact list, with an O(block x N) working
    set.  Self-pairs (zero distance at the identity image) are excluded;
    periodic self-images within rc count, as the replicated list does.  The
    squared norm is summed in the written order, each term its own op, so
    the card and the CPU give every distance of an orthogonal box bit for
    bit, and a perfect lattice's pairs at exactly rc (rc = L/2 in Debye
    S(k)) or on a bin edge fall on the same side on both; the JAX package's
    jit fuses the sum into FMAs and may put them on the other (ROADMAP
    C15)."""
    n, n_all = pos.shape[0], pos_all.shape[0]
    dr = rc / nbin
    sentinel = ntype * ntype * nbin
    hist = torch.zeros(sentinel + 1, dtype=torch.int64, device=pos.device)
    for s, e in row_chunks(n, n_all * 8 * 16):
        disp = min_image(pos_all[None, :, :] - pos[s:e, None, :], matrix, inv,
                         boundary)
        x, y, z = disp.unbind(-1)
        dist = torch.sqrt((x * x + y * y) + z * z)
        ok = (dist < rc) & (dist > 0.0)
        k = torch.clamp((dist / dr).to(torch.int32), 0, nbin - 1)
        flat = (type_idx[s:e, None].long() * ntype + type_all[None, :]) * nbin + k
        flat = torch.where(ok, flat, sentinel)
        hist += torch.bincount(flat.reshape(-1), minlength=sentinel + 1)
    return hist[:-1].view(ntype, ntype, nbin)
