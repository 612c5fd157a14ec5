"""Steinhardt bond-orientational order parameters q_l (with w_l, averaged
and weighted variants) and the solid-liquid classifier.

The port of ``mdapy_tpu/analysis/steinhardt_bond_orientation.py``:
``_ylm_block`` (:64, the associated-Legendre m-recurrences with the
Y_{l,-m} = (-1)^m conj(Y_lm) fold), ``_qlm_for_l`` (:267),
``_average_qlm`` (:287), the w_l and w_l-hat sums (:215-237) and
``_solid_liquid`` (:249).  Per atom: qlm = sum_j w_ij Y_lm(r_ij) / sum_j
w_ij, optionally averaged over the atom and its listed neighbors, q_l =
sqrt(4 pi / (2l+1) sum_m |qlm|^2), w_l by the Clebsch-Gordan triple sum /
sqrt(2l+1), w_l-hat scaled by (qnormfac / q_l)^3; solid-liquid by s_ij = 4
pi / 13 Re(q6m_i . conj(q6m_j)) / (Q6_i Q6_j) > threshold, at least n_bond
solid bonds, isolated solid atoms removed.  The JAX package sums w_l and
classifies on the host in numpy; here both run on the device, the triple
sum over the (m1, m2) terms at once.

With ``use_voronoi`` the lists are the Voronoi neighbors of
``analysis/voronoi.py`` (the native engine on the host, its rows compacted
on the device), weighted by their face areas under ``use_weight`` (JAX
:166-176); a Voronoi row's slots are those below its own count (JAX
:189-193).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.box import init_box
from ..core.device import resolve_device
from ..neighbor.knn import knn_tensors
from ..neighbor.neighbor import neighbor_tensors
from .common import box_tensors, neighbor_disp, row_chunks

__all__ = ["SteinhardtBondOrientation"]


def clebsch_gordan_list(l: int) -> np.ndarray:
    """CG coefficients in the kernel's (m1, m2) iteration order.  A copy of
    ``mdapy_tpu/analysis/steinhardt_bond_orientation.py:38-61``."""
    f = math.factorial
    out = []
    for m1 in range(2 * l + 1):
        aa2 = m1 - l
        for m2 in range(max(0, l - m1), min(2 * l + 1, 3 * l - m1 + 1)):
            bb2 = m2 - l
            m = aa2 + bb2 + l
            sums = 0.0
            for z in range(max(0, max(-aa2, bb2)), min(l, min(l - aa2, l + bb2)) + 1):
                ifac = -1 if z % 2 else 1
                sums += ifac / (
                    f(z) * f(l - z) * f(l - aa2 - z)
                    * f(l + bb2 - z) * f(aa2 + z) * f(-bb2 + z)
                )
            cc2 = m - l
            sfaccg = math.sqrt(
                f(l + aa2) * f(l - aa2) * f(l + bb2)
                * f(l - bb2) * f(l + cc2) * f(l - cc2)
                * (2 * l + 1)
            )
            dcg = math.sqrt(f(l) ** 3 / f(3 * l + 1))
            out.append(sums * dcg * sfaccg)
    return np.asarray(out)


def _triples(l: int):
    """(m1, m2, m3) of the w_l sum, in ``clebsch_gordan_list``'s order."""
    return [(m1, m2, m1 + m2 - l) for m1 in range(2 * l + 1)
            for m2 in range(max(0, l - m1), min(2 * l + 1, 3 * l - m1 + 1))]


def _ylm_block(l: int, costheta, expphi_r, expphi_i):
    """Y_lm for m = -l..l as (real, imag) tensors shaped (..., 2l+1)."""
    x = costheta
    sqx = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))
    plm = []                                     # P_l^m for m = 0..l
    for m in range(l + 1):
        p = torch.ones_like(x)
        for i in range(1, m + 1):
            p = p * (2 * i - 1) * sqx
        pm1 = torch.zeros_like(x)
        for i in range(m + 1, l + 1):
            p, pm1 = ((2 * i - 1) * x * p - (i + m - 1) * pm1) / (i - m), p
        plm.append(p)
    out_r = [None] * (2 * l + 1)
    out_i = [None] * (2 * l + 1)
    out_r[l] = math.sqrt((2 * l + 1) / (4 * math.pi)) * plm[0]
    out_i[l] = torch.zeros_like(x)
    em_r, em_i = expphi_r, expphi_i
    for m in range(1, l + 1):
        fac = 1.0
        for i in range(l - m + 1, l + m + 1):
            fac *= i
        pref = math.sqrt((2 * l + 1) / (4 * math.pi * fac))
        c_r = pref * plm[m] * em_r
        c_i = pref * plm[m] * em_i
        out_r[l + m] = c_r
        out_i[l + m] = c_i
        sgn = -1.0 if m % 2 else 1.0
        out_r[l - m] = sgn * c_r
        out_i[l - m] = -sgn * c_i
        em_r, em_i = (em_r * expphi_r - em_i * expphi_i,
                      em_r * expphi_i + em_i * expphi_r)
    return torch.stack(out_r, dim=-1), torch.stack(out_i, dim=-1)


def bond_angles(disp, rmag):
    """cos(theta) and the unit (cos phi, sin phi) of (..., 3) bonds of
    length ``rmag``; a bond along z takes phi = 0."""
    costheta = disp[..., 2] / rmag
    rxy = torch.sqrt(disp[..., 0] ** 2 + disp[..., 1] ** 2)
    small = rxy < 1e-15
    safe = torch.where(small, 1.0, rxy)
    er = torch.where(small, 1.0, disp[..., 0] / safe)
    ei = torch.where(small, 0.0, disp[..., 1] / safe)
    return costheta, er, ei


class SteinhardtBondOrientation:
    """API parity: reference steinhardt_bond_orientation.py.  Precomputed
    lists may be numpy arrays or tensors; ``device`` is "cuda" (default)
    or "cpu"."""

    def __init__(
        self,
        pos,
        box,
        llist: Sequence[int] = (4, 6),
        nnn: int = 12,
        rc: float = -1.0,
        average: bool = False,
        wl: bool = False,
        wlhat: bool = False,
        use_voronoi: bool = False,
        use_weight: bool = False,
        weight: Optional[np.ndarray] = None,
        identify_liquid: bool = False,
        threshold: float = 0.7,
        n_bond: int = 7,
        max_neigh: Optional[int] = None,
        a_face_area_threshold: float = -1.0,
        r_face_area_threshold: float = -1.0,
        verlet_list=None,
        distance_list=None,
        neighbor_number=None,
        face_areas=None,
        device="cuda",
    ):
        self.pos = np.ascontiguousarray(pos, dtype=np.float64)
        self.box = init_box(box)
        self.llist = [int(l) for l in llist]
        self.nnn = int(nnn)
        self.rc = float(rc)
        self.average = bool(average)
        self.wl = bool(wl)
        self.wlhat = bool(wlhat)
        self.use_voronoi = bool(use_voronoi)
        self.use_weight = bool(use_weight)
        self.weight = weight
        self.identify_liquid = bool(identify_liquid)
        self.threshold = float(threshold)
        self.n_bond = int(n_bond)
        self.max_neigh = max_neigh
        self.a_face_area_threshold = float(a_face_area_threshold)
        self.r_face_area_threshold = float(r_face_area_threshold)
        self._nlist = (verlet_list, distance_list, neighbor_number)
        self._face_areas = face_areas
        self.device = resolve_device(device, "SteinhardtBondOrientation")
        self.qnarray = None
        self.solidliquid = None
        self.nbond = None

    @property
    def out_names(self):
        names = [f"ql{l}" for l in self.llist]
        if self.wl:
            names += [f"wl{l}" for l in self.llist]
        if self.wlhat:
            names += [f"whl{l}" for l in self.llist]
        return names

    def compute(self):
        dev = self.device
        n = len(self.pos)
        verlet, dist, nn = self._nlist
        weight = self.weight
        if verlet is None:
            if self.use_voronoi:
                from .voronoi import VoronoiAnalysis

                vor = VoronoiAnalysis(self.pos, self.box, device=dev)
                vor.compute_neighbors(self.a_face_area_threshold,
                                      self.r_face_area_threshold)
                verlet, dist, nn, areas = vor.tensors
                if self.use_weight and weight is None:
                    weight = areas
            elif self.nnn > 0:
                verlet, dist = knn_tensors(self.pos, self.box, self.nnn,
                                           device=dev)
                nn = torch.full((n,), self.nnn, dtype=torch.int32, device=dev)
            else:
                if self.rc <= 0:
                    raise ValueError("Provide nnn > 0 or rc > 0")
                verlet, dist, nn = neighbor_tensors(
                    self.pos, self.box, self.rc, self.max_neigh, device=dev)
        verlet = torch.as_tensor(verlet, device=dev)
        dist = torch.as_tensor(dist, dtype=torch.float64, device=dev)
        rc_eff = self.rc if self.rc > 0 else 1e30
        if self.use_weight and weight is None:
            raise ValueError("use_weight=True requires weight (or use_voronoi)")
        m, inv, b = box_tensors(self.box, dev)
        pos = torch.as_tensor(self.pos, device=dev)

        slot = torch.arange(verlet.shape[1], device=dev)[None, :]
        if not self.use_voronoi and self.nnn > 0:
            slot_ok = (verlet >= 0) & (slot < self.nnn)
        else:
            nn = torch.as_tensor(nn, device=dev)
            slot_ok = (verlet >= 0) & (slot < nn[:, None])
        weight = (torch.as_tensor(weight, dtype=torch.float64, device=dev)
                  if self.use_weight else None)

        qlms = []
        for l in self.llist:
            qr, qi = _qlm_for_l(pos, verlet, dist, slot_ok, weight, m, inv, b,
                                l, rc_eff)
            if self.average:
                qr, qi = _average_qlm(qr, qi, verlet, slot_ok)
            qlms.append((qr, qi))

        cols, qn_per_l = [], []
        for l, (qr, qi) in zip(self.llist, qlms):
            qnorm = math.sqrt(4 * math.pi / (2 * l + 1))
            qn = qnorm * torch.sqrt((qr**2 + qi**2).sum(dim=1))
            cols.append(qn)
            qn_per_l.append(qn)
        if self.wl or self.wlhat:
            wl_cols, wlhat_cols = [], []
            for l, (qr, qi), qn in zip(self.llist, qlms, qn_per_l):
                wlf = _wl(l, qr, qi) / math.sqrt(2 * l + 1)
                if self.wl:
                    wl_cols.append(wlf)
                if self.wlhat:
                    fac = (math.sqrt(4 * math.pi / (2 * l + 1)) / qn) ** 3
                    fac = torch.where(torch.isfinite(fac), fac, 0.0)
                    wlhat_cols.append(wlf * fac)
            cols += wl_cols + wlhat_cols
        self.qnarray = torch.stack(cols, dim=1).cpu().numpy()

        if self.identify_liquid:
            if 6 not in self.llist:
                raise ValueError("identify_liquid requires l=6 in llist")
            i6 = self.llist.index(6)
            qr, qi = qlms[i6]
            solid, nbond = _solid_liquid(verlet, dist, slot_ok, qr, qi,
                                         qn_per_l[i6], rc_eff, self.threshold,
                                         self.n_bond)
            self.solidliquid = solid.cpu().numpy()
            self.nbond = nbond.cpu().numpy()
        return self


def _wl(l: int, qr, qi):
    """sum over the (m1, m2) terms of cg * Re(q_m1 q_m2 conj(q_m3))."""
    m1, m2, m3 = (torch.tensor(c, device=qr.device)
                  for c in zip(*_triples(l)))
    cg = torch.as_tensor(clebsch_gordan_list(l), device=qr.device)
    ar, ai, br, bi = qr[:, m1], qi[:, m1], qr[:, m2], qi[:, m2]
    pr, pi = ar * br - ai * bi, ar * bi + ai * br
    return torch.sum((pr * qr[:, m3] + pi * qi[:, m3]) * cg, dim=1)


def _qlm_for_l(pos, verlet, dist, slot_ok, weight, matrix, inv, boundary,
               l: int, rc_eff: float):
    n, M = verlet.shape
    qr = torch.empty(n, 2 * l + 1, dtype=pos.dtype, device=pos.device)
    qi = torch.empty_like(qr)
    for s, e in row_chunks(n, M * (2 * l + 1) * 8 * 8 + M * 3 * 8 * 4):
        d = dist[s:e]
        disp = neighbor_disp(pos, verlet[s:e], matrix, inv, boundary, s)
        ok = slot_ok[s:e] & (d > 1e-15) & (d <= rc_eff)
        costheta, er, ei = bond_angles(disp, torch.clamp(d, min=1e-30))
        yr, yi = _ylm_block(l, costheta, er, ei)          # (c, M, 2l+1)
        w = torch.ones_like(d) if weight is None else weight[s:e]
        w = torch.where(ok, w, 0.0)
        wsum = torch.sum(w, dim=1)
        qr[s:e] = torch.sum(w[..., None] * yr, dim=1) / wsum[:, None]
        qi[s:e] = torch.sum(w[..., None] * yi, dim=1) / wsum[:, None]
    return qr, qi


def _average_qlm(qr, qi, verlet, slot_ok):
    """The atom and all its listed neighbors (no rc filter, kernel parity)."""
    j = verlet.clamp(min=0).long()
    cnt = (1 + torch.sum(slot_ok, dim=1)).double()
    ar = qr + torch.sum(torch.where(slot_ok[..., None], qr[j], 0.0), dim=1)
    ai = qi + torch.sum(torch.where(slot_ok[..., None], qi[j], 0.0), dim=1)
    return ar / cnt[:, None], ai / cnt[:, None]


def _solid_liquid(verlet, dist, slot_ok, qr, qi, q6, rc_eff: float,
                  threshold: float, n_bond: int):
    j = torch.where(slot_ok, verlet, 0).long()
    ok = slot_ok & (dist <= rc_eff)
    num = (torch.einsum("im,ikm->ik", qr, qr[j])
           + torch.einsum("im,ikm->ik", qi, qi[j]))
    sij = num / q6[:, None] / q6[j] * 4 * np.pi / 13.0
    sij = torch.where(torch.isfinite(sij), sij, 0.0)
    nbond = (ok & (sij > threshold)).sum(dim=1).int()
    solid = (nbond >= n_bond).int()
    # remove isolated solid atoms
    neigh_solid = torch.where(slot_ok, solid[j], 0).amax(dim=1)
    solid = torch.where((solid == 1) & (neigh_solid == 0), 0, solid).int()
    return solid, nbond
