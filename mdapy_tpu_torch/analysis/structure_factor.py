"""Static structure factor S(k): Debye (RDF sin-transform) + direct modes.

The port of ``mdapy_tpu/analysis/structure_factor.py`` (Faber-Ziman
partials; X-ray (Cromer-Mann), neutron (NIST lengths) and electron
(Mott-Bethe) weighted totals; ``get_pdf_from_sk``; ``plot``), in float64
torch ops on ``device`` (the card unless the caller passes
``device="cpu"``).

* Debye mode integrates the port's ``RadialDistributionFunction`` (its
  integer pair counts) against sin(k r), with the optional Lorch window, by
  ``torch.trapezoid`` (:74-107).
* Direct mode enumerates the non-negative-index reciprocal lattice in
  (k_min, k_max] as ``_k_points`` does (:110-129, host numpy), replicates
  boxes of fewer than 200 atoms as the JAX class does (:140-162), and sums
  F_alpha(k) = sum exp(i k.r) / sqrt(N) in chunks of k-points as row sums
  of cos and sin over each species' atoms (the atoms sorted by species, so
  each species is a block of columns).  The k-points are sorted by their
  bin (``_get_bin``) first, so each spherical bin's sum is a row sum over
  its k-points in a fixed order (``common.segment_sum``), where the JAX
  class adds them with ``np.add.at`` (:187-193, :209-212): no float atomics,
  and the card repeats its sums bit for bit.  ``kpts @ pos.T`` stays a
  ``torch.matmul``.

The form factors, the weighted totals and ``get_pdf_from_sk`` act on the
binned (nbins,) curves and stay host numpy copies (:220-277).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.box import Box, init_box
from ..core.device import resolve_device
from ..core.elements import atomic_numbers
from ..core._scattering_tables import NEUTRON_FORM_FACTOR, XRAY_FORM_FACTOR
from .common import row_chunks, segment_sum
from .radial_distribution_function import RadialDistributionFunction

__all__ = ["StructureFactor"]

_BOHR_RADIUS_A = 0.529177210903
TWO_PI = 2.0 * np.pi


class StructureFactor:
    """``device`` is "cuda" (default) or "cpu"."""

    def __init__(
        self,
        pos,
        box,
        k_min: float = 0.5,
        k_max: float = 12.0,
        nbins: int = 200,
        cal_partial: bool = False,
        atomic_form_factors: bool = False,
        mode: str = "debye",
        rc: Optional[float] = None,
        nbin_rdf: int = 200,
        window: bool = False,
        types=None,
        elements=None,
        device="cuda",
    ):
        self.pos = np.ascontiguousarray(pos, dtype=np.float64)
        self.box = init_box(box)
        self.k_min = float(k_min)
        self.k_max = float(k_max)
        self.nbins = int(nbins)
        self.atomic_form_factors = bool(atomic_form_factors)
        self.cal_partial = bool(cal_partial) or self.atomic_form_factors
        if mode == "rdf":
            mode = "debye"
        assert mode in ("debye", "direct")
        self.mode = mode
        self.rc = rc
        self.nbin_rdf = int(nbin_rdf)
        self.window = bool(window)
        labels = types if elements is None else elements
        self._labels = None if labels is None else np.asarray(labels)
        self.device = resolve_device(device, "StructureFactor")
        self.Sk = None
        self.Sk_partial: Optional[Dict[Tuple, np.ndarray]] = None

    def compute(self):
        if self.mode == "debye":
            self._compute_debye()
        else:
            self._compute_direct()
        if self.atomic_form_factors:
            self.Sk_xray = self.get_xray_structure_factor()
        return self

    # ------------------------------------------------------------------
    def _compute_debye(self):
        L_max = float(max(np.linalg.norm(self.box.matrix[i]) for i in range(3)))
        rc = L_max / 2.0 if self.rc is None else float(self.rc)
        self.k = np.linspace(self.k_min, self.k_max, self.nbins)
        if self.k_min == 0.0:
            self.k[0] = self.k[1] / 1000.0
        rdf = RadialDistributionFunction(
            self.pos, self.box, rc, self.nbin_rdf,
            types=self._labels, device=self.device,
        ).compute()
        self._rdf = rdf
        self.r = rdf.r
        elements = list(rdf.elements)
        rho = len(self.pos) / abs(self.box.volume)
        nper = np.bincount(rdf.type_idx, minlength=len(elements))
        c = nper / len(self.pos)
        self._uniele = elements
        self._concentrations = c
        self.density = self.num_density = rho

        dev = self.device
        r = torch.as_tensor(rdf.r, device=dev)
        k = torch.as_tensor(self.k, device=dev)
        w = torch.sinc(2.0 * r / L_max) if self.window else torch.ones_like(r)
        sin_kr = torch.sin(torch.outer(k, r))
        pairs = [(la, elements[b]) for a, la in enumerate(elements)
                 for b in range(a, len(elements))]
        g = torch.as_tensor(np.stack([rdf.g_partial[p] for p in pairs]
                                     + [rdf.g_total]), device=dev)
        integrand = sin_kr[None] * (r * (g - 1.0) * w)[:, None, :]
        integral = torch.trapezoid(integrand, x=r, dim=2)
        sk = (1.0 + 4.0 * np.pi * rho / k * integral).cpu().numpy()
        partial = {p: sk[i] for i, p in enumerate(pairs)}
        self.Sk = sk[-1]
        self._Sk_partial_internal = partial
        if self.cal_partial:
            self.Sk_partial = partial

    # ------------------------------------------------------------------
    def _k_points(self, box) -> np.ndarray:
        """Non-negative-index reciprocal lattice points with |k| in
        [k_min, k_max] (structure_factor.cpp:120-216)."""
        m = box.matrix
        recip = 2.0 * np.pi * np.linalg.inv(m).T
        # cpp builds b_i = 2π (a_j x a_k)/V — that's the rows of inv(m).T * 2π
        bx, by, bz = recip[0], recip[1], recip[2]
        q_max = self.k_max / TWO_PI
        Nx = int(np.ceil(q_max / (np.linalg.norm(bx) / TWO_PI)))
        Ny = int(np.ceil(q_max / (np.linalg.norm(by) / TWO_PI)))
        Nz = int(np.ceil(q_max / (np.linalg.norm(bz) / TWO_PI)))
        i, j, l = np.meshgrid(
            np.arange(Nx), np.arange(Ny), np.arange(Nz), indexing="ij"
        )
        pts = (
            i.reshape(-1, 1) * bx[None] + j.reshape(-1, 1) * by[None] + l.reshape(-1, 1) * bz[None]
        )
        q2 = np.sum(pts * pts, axis=1) / (TWO_PI**2)
        keep = (q2 <= (self.k_max / TWO_PI) ** 2) & (q2 >= (self.k_min / TWO_PI) ** 2)
        return pts[keep]

    def _compute_direct(self):
        edges = np.linspace(self.k_min, self.k_max, self.nbins + 1)
        self.k = (edges[1:] + edges[:-1]) / 2.0
        pos = self.pos
        box = self.box
        labels = self._labels
        # small systems: replicate until >= 200 atoms (reference behaviour)
        n = len(pos)
        repeat = [1, 1, 1]
        if n < 200 and np.sum(box.boundary) > 0:
            while np.prod(repeat) * n < 200:
                for i in range(3):
                    if box.boundary[i] == 1:
                        repeat[i] += 1
        if sum(repeat) != 3:
            shifts = np.array(
                [
                    ix * box.matrix[0] + iy * box.matrix[1] + iz * box.matrix[2]
                    for ix in range(repeat[0])
                    for iy in range(repeat[1])
                    for iz in range(repeat[2])
                ]
            )
            pos = (pos[None] + shifts[:, None]).reshape(-1, 3)
            if labels is not None:
                labels = np.tile(labels, len(shifts))
            box = Box(box.matrix * np.array(repeat)[:, None], box.boundary, box.origin)
        kpts = self._k_points(box)
        kmag = np.linalg.norm(kpts, axis=1)
        N_total = len(pos)
        rho = N_total / abs(box.volume)
        self.density = self.num_density = rho
        bin_idx = self._get_bin(kmag)
        order = np.argsort(bin_idx, kind="stable")
        counts = np.bincount(bin_idx, minlength=self.nbins)
        self.k_point_number = len(kpts)
        if self.cal_partial:
            if labels is None:
                raise ValueError("cal_partial requires types/elements")
            # sorted distinct labels and each atom's index among them, as
            # the JAX class's lookup table gives them
            uniq, tid = np.unique(labels, return_inverse=True)
            uniele = uniq.tolist()
            nt = len(uniele)
            c = np.bincount(tid, minlength=nt) / N_total
            self._uniele = uniele
            self._concentrations = c
        else:
            tid = np.zeros(N_total, dtype=np.int64)
            nt = 1
        F = self._amplitudes(kpts[order], pos, tid, nt)   # (nt, 2, nk)
        re, im = F[:, 0], F[:, 1]
        dev = self.device
        counts_t = torch.as_tensor(counts, device=dev)
        counts_f = counts_t.to(torch.float64)
        if self.cal_partial:
            AL = re[:, None] * re[None, :] + im[:, None] * im[None, :]
            partial_AL = (segment_sum(AL, counts_t) / counts_f).cpu().numpy()
            partial = {}
            for ia, sa in enumerate(uniele):
                for ib in range(ia, nt):
                    sb = uniele[ib]
                    if ia == ib:
                        partial[(sa, sb)] = (partial_AL[ia, ib] - c[ia]) / c[ia] ** 2 + 1.0
                    else:
                        partial[(sa, sb)] = partial_AL[ia, ib] / (c[ia] * c[ib]) + 1.0
            self.Sk_partial = partial
            self._Sk_partial_internal = partial
            self.Sk = partial_AL.sum(axis=(0, 1))
        else:
            S = re[0] * re[0] + im[0] * im[0]
            self.Sk = (segment_sum(S, counts_t) / counts_f).cpu().numpy()

    def _amplitudes(self, kpts: np.ndarray, pos: np.ndarray, tid: np.ndarray,
                    nt: int):
        """(nt, 2, nk) real and imaginary F_alpha(k) / sqrt(N) on the
        device: the phases of a chunk of k-points against every atom, their
        cosines and sines summed over each species' block of atoms."""
        dev = self.device
        n = len(pos)
        sort = np.argsort(tid, kind="stable")
        block = np.r_[0, np.cumsum(np.bincount(tid, minlength=nt))]
        pos_t = torch.as_tensor(pos[sort], device=dev)
        k_t = torch.as_tensor(kpts, device=dev)
        F = torch.empty((nt, 2, len(kpts)), dtype=torch.float64, device=dev)
        self.chunk_rows = 0
        for s, e in row_chunks(len(kpts), n * 8 * 3):
            self.chunk_rows = max(self.chunk_rows, e - s)
            phase = k_t[s:e] @ pos_t.T
            for part, trig in ((0, torch.cos), (1, torch.sin)):
                v = trig(phase)
                for a in range(nt):
                    F[a, part, s:e] = v[:, block[a]:block[a + 1]].sum(dim=1)
                del v
            del phase
        return F / np.sqrt(n)

    def _get_bin(self, kmag):
        b = ((kmag - self.k_min) / (self.k_max - self.k_min) * self.nbins).astype(int)
        return np.clip(b, 0, self.nbins - 1)

    # ------------------------------------------------------------------
    def _xray_form_factor(self, element):
        para = XRAY_FORM_FACTOR[element]
        f = np.zeros_like(self.k)
        for i in range(4):
            f += para[2 * i] * np.exp(-para[2 * i + 1] * (self.k / (4.0 * np.pi)) ** 2)
        return f + para[-1]

    def _neutron_form_factor(self, element):
        b = NEUTRON_FORM_FACTOR[element]
        return np.full_like(
            self.k, b, dtype=np.complex128 if isinstance(b, complex) else np.float64
        )

    def _electron_form_factor(self, element):
        Z = atomic_numbers[element]
        fx = self._xray_form_factor(element)
        return (Z - fx) / (8.0 * np.pi**2 * _BOHR_RADIUS_A * self.k**2)

    def _weighted_total(self, kind):
        partial = self.Sk_partial or getattr(self, "_Sk_partial_internal", None)
        if partial is None:
            raise RuntimeError("Run compute() with cal_partial=True first")
        c = self._concentrations
        elements = self._uniele
        ff = {
            "xray": self._xray_form_factor,
            "neutron": self._neutron_form_factor,
            "electron": self._electron_form_factor,
        }[kind]
        f = [ff(e) for e in elements]
        norm = sum(c[i] * f[i] for i in range(len(elements)))
        total = np.zeros_like(f[0])
        for (a, b), A_ab in partial.items():
            ia, ib = elements.index(a), elements.index(b)
            multi = 1.0 if ia == ib else 2.0
            total = total + multi * c[ia] * c[ib] * f[ia] * f[ib] * A_ab
        out = total / norm**2
        return np.real(out) if np.iscomplexobj(out) else out

    def get_xray_structure_factor(self):
        return self._weighted_total("xray")

    def get_neutron_structure_factor(self):
        return self._weighted_total("neutron")

    def get_electron_structure_factor(self):
        return self._weighted_total("electron")

    def get_pdf_from_sk(self, r=None):
        """g(r) back-transform of S(k) (structure_factor.py:511-560)."""
        if r is None:
            r = np.linspace(0.5, 10.0, 200)
        rho = self.density
        k = self.k
        integrand = k[None, :] * (self.Sk[None, :] - 1.0) * np.sin(
            np.outer(r, k)
        )
        g = 1.0 + np.trapezoid(integrand, x=k, axis=1) / (2.0 * np.pi**2 * rho * r)
        return r, g

    def plot(self, fig=None, ax=None, partial=False):
        import matplotlib.pyplot as plt

        if fig is None and ax is None:
            fig, ax = plt.subplots()
        ax.plot(self.k, self.Sk, "-")
        if partial and self.Sk_partial:
            for key, v in self.Sk_partial.items():
                ax.plot(self.k, v, "--", label=str(key))
            ax.legend()
        ax.set_xlabel(r"k ($\AA^{-1}$)")
        ax.set_ylabel("S(k)")
        return fig, ax
