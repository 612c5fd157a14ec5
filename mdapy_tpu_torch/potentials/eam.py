"""EAM (eam.alloy / setfl) potential in torch ops, with LAMMPS's spline.

The port of ``mdapy_tpu/potentials/eam.py``: ``lammps_spline_coeffs`` (:33),
``spline_eval`` (:53), ``EAM`` (:77: ``_read_eam_alloy`` :90,
``write_eam_alloy`` :139, ``calculate`` :239), ``_eam_force_fast`` (:448),
``EAMAverage`` (:570) and ``EAMGenerator`` (:602).  The uniform cubic
Hermite spline with LAMMPS's finite-difference node derivatives, the r*phi
(z2r) pair channel, the two-pass density/embedding and pair-force
evaluation, per-atom virials with the 0.5 pair factor, the Voigt stress.

The force path keeps ``_eam_force_fast``'s two passes over row blocks of
the Verlet list:

  * pass 1 gathers each neighbor's position and type once (one row of a
    packed (N, 4) table) and evaluates every channel that depends on
    geometry alone (the pair density, z2r, both rho' derivatives), staging
    the displacement and the per-pair force factors w0, wj and wi;
  * pass 2 gathers only dF[j] and closes the dF_i / dF_j chain.

Each spline evaluation reads its bracketing node's row of a flat (rows, 4)
table [y_m, y_{m+1} - y_m, fp_m, fp_{m+1}] by a direct gather.  Every output
is a row sum over an atom's own neighbors, with no ``index_add_`` and no
atomics, so forces are deterministic on the card.  Not ported: the TPU's
one-hot MXU lookup (``_node_lookup`` :371, the bf16 weight pieces of
``_eval_tables`` :167-237, ``MDAPY_TPU_EAM_MXU``) and ``defer_check``
(:279-333).  The type cache hashes the whole element array (ROADMAP C3; the
JAX package samples it).  Calculators run on the card unless built with
``device="cpu"``; everything is float64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..neighbor.neighbor import neighbor_search_device, replicate_for_small_box
from .calculator import CalculatorMP

__all__ = ["EAM", "EAMAverage", "EAMGenerator", "lammps_spline_coeffs",
           "spline_eval"]


def lammps_spline_coeffs(y: np.ndarray) -> np.ndarray:
    """Node derivatives (in normalized coordinate) of the LAMMPS spline.

    fp[0] = y1-y0; fp[1] = (y2-y0)/2;
    fp[m] = ((y[m-2]-y[m+2]) + 8(y[m+1]-y[m-1]))/12;
    fp[n-2] = (y[n-1]-y[n-3])/2; fp[n-1] = y[n-1]-y[n-2]."""
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[-1]
    fp = np.empty_like(y)
    fp[..., 0] = y[..., 1] - y[..., 0]
    fp[..., 1] = 0.5 * (y[..., 2] - y[..., 0])
    fp[..., 2 : n - 2] = (
        (y[..., 0 : n - 4] - y[..., 4:n]) + 8.0 * (y[..., 3 : n - 1] - y[..., 1 : n - 3])
    ) / 12.0
    fp[..., n - 2] = 0.5 * (y[..., n - 1] - y[..., n - 3])
    fp[..., n - 1] = y[..., n - 1] - y[..., n - 2]
    return fp


def spline_eval(y, fp, h, x, idx=()):
    """Evaluate (f, df/dx) of the LAMMPS spline at the tensor ``x``; x is
    clamped to the table.

    y/fp are tensors of shape ``idx_dims + (ntab,)``; ``idx`` is a tuple of
    integer tensors (broadcast-compatible with x) selecting the leading
    table dims per point.  Only the two bracketing nodes are gathered per
    point."""
    n = y.shape[-1]
    m = torch.clamp(torch.floor(x / h).long(), 0, n - 2)
    dx = torch.clamp(x - m.to(x.dtype) * h, 0.0, h)
    idx = tuple(idx)
    ym = y[idx + (m,)]
    return _hermite((ym, y[idx + (m + 1,)] - ym, fp[idx + (m,)],
                     fp[idx + (m + 1,)]), dx, h)


def _hermite(nodes, dx, h):
    """(f, df) of the LAMMPS cubic from node data (y_m, y_{m+1}-y_m, fp_m,
    fp_{m+1}); dx in [0, h] is the offset inside the interval."""
    y0, dy, f0, f1 = nodes
    b = f0 / h
    c = (3.0 * dy - 2.0 * f0 - f1) / (h * h)
    d = (f0 + f1 - 2.0 * dy) / (h * h * h)
    f = y0 + dx * (b + dx * (c + dx * d))
    df = b + dx * (2.0 * c + 3.0 * dx * d)
    return f, df


def _rows(flat, row):
    """The four node values of each entry of ``row`` in a flat (rows, 4)
    table, as a tuple of tensors shaped like ``row``."""
    r = flat[row]
    return r[..., 0], r[..., 1], r[..., 2], r[..., 3]


def _content_key(elems: np.ndarray) -> int:
    """A hash of every entry of the element column (ROADMAP C3)."""
    if elems.dtype == object:
        return hash(tuple(elems.tolist()))
    return hash((elems.dtype.str, elems.shape, elems.tobytes()))


class EAM(CalculatorMP):
    """eam.alloy (setfl) potential, on the card unless ``device="cpu"``."""

    def __init__(self, filename: str, device="cuda"):
        super().__init__()
        self.device = resolve_device(device, "EAM")
        self.filename = filename
        self._read_eam_alloy()
        self._set_spline_coeffs()

    def _set_spline_coeffs(self) -> None:
        self._F_fp = lammps_spline_coeffs(self.F_rho)
        self._rho_fp = lammps_spline_coeffs(self.rho_r)
        self._z2r_fp = lammps_spline_coeffs(self._rphi_r)
        self._tab_cache = None

    # -- parsing -----------------------------------------------------------
    def _read_eam_alloy(self) -> None:
        with open(self.filename) as f:
            lines = f.readlines()
        self.header = lines[:3]
        line4 = lines[3].split()
        self.Nelements = int(line4[0])
        self.elements_list = line4[1 : 1 + self.Nelements]
        line5 = lines[4].split()
        self.nrho = int(line5[0])
        self.drho = float(line5[1])
        self.nr = int(line5[2])
        self.dr = float(line5[3])
        self.rc = float(line5[4])
        self.r = np.arange(self.nr) * self.dr
        self.rho = np.arange(self.nrho) * self.drho

        idx = [5]

        def read_section(count: int) -> np.ndarray:
            out = np.empty(count)
            got = 0
            while got < count and idx[0] < len(lines):
                toks = lines[idx[0]].split("#")[0].split()
                for t in toks:
                    if got >= count:
                        break
                    out[got] = float(t)
                    got += 1
                idx[0] += 1
            if got < count:
                raise ValueError(f"EAM file truncated: wanted {count}, got {got}")
            return out

        self.F_rho = np.zeros((self.Nelements, self.nrho))
        self.rho_r = np.zeros((self.Nelements, self.nr))
        for e in range(self.Nelements):
            idx[0] += 1  # per-element info line
            self.F_rho[e] = read_section(self.nrho)
            self.rho_r[e] = read_section(self.nr)
        self._rphi_r = np.zeros((self.Nelements, self.Nelements, self.nr))
        for i in range(self.Nelements):
            for j in range(i + 1):
                self._rphi_r[i, j] = read_section(self.nr)
                if i != j:
                    self._rphi_r[j, i] = self._rphi_r[i, j]
        self._set_phi()

    def _set_phi(self) -> None:
        self.phi_r = np.zeros_like(self._rphi_r)
        self.phi_r[:, :, 1:] = self._rphi_r[:, :, 1:] / self.r[1:]
        self.phi_r[:, :, 0] = self.phi_r[:, :, 1]

    def write_eam_alloy(self, output_name: Optional[str] = None) -> str:
        """Write the tables back in setfl format."""
        from ..core.elements import atomic_masses, atomic_numbers

        if output_name is None:
            output_name = "".join(self.elements_list) + ".eam.alloy"
        with open(output_name, "w") as f:
            for ln in self.header:
                f.write(ln if ln.endswith("\n") else ln + "\n")
            f.write(f"    {self.Nelements} " + " ".join(self.elements_list) + "\n")
            f.write(
                f"{self.nrho} {self.drho:.16E} {self.nr} {self.dr:.16E} {self.rc:.10f}\n"
            )

            def dump(arr):
                for k in range(0, len(arr), 5):
                    f.write(" ".join(f"{v: .16E}" for v in arr[k : k + 5]) + "\n")

            for e, name in enumerate(self.elements_list):
                z = atomic_numbers.get(name, 0)
                f.write(f"{z} {atomic_masses[z]:.6f} 0.0 none\n")
                dump(self.F_rho[e])
                dump(self.rho_r[e])
            for i in range(self.Nelements):
                for j in range(i + 1):
                    dump(self._rphi_r[i, j])
        return output_name

    # -- evaluation --------------------------------------------------------
    def _tables(self):
        """Flat (rows, 4) node tables on the device: rows [y_m, y_{m+1} - y_m,
        fp_m, fp_{m+1}] per (group, node), the interval's difference taken in
        float64 here, as ``_eval_tables`` packs them."""
        if self._tab_cache is None:
            def pack(y, fp):
                rows = np.stack([y[..., :-1], np.diff(y, axis=-1),
                                 fp[..., :-1], fp[..., 1:]], axis=-1)
                return torch.tensor(rows.reshape(-1, 4), dtype=torch.float64,
                                    device=self.device)

            self._tab_cache = (pack(self.rho_r, self._rho_fp),
                               pack(self._rphi_r, self._z2r_fp),
                               pack(self.F_rho, self._F_fp))
        return self._tab_cache

    def _types(self, system) -> np.ndarray:
        """Each atom's index in ``elements_list``, cached on the system and
        keyed by the content of the whole element column, so an in-place
        species edit anywhere re-types the atoms."""
        elems = np.asarray(system.data["element"])
        ckey = (system.N, tuple(self.elements_list), _content_key(elems))
        cached = getattr(system, "_eam_type_cache", None)
        if cached is not None and cached[0] == ckey:
            return cached[1]
        uniq, inv = np.unique(elems.astype(str), return_inverse=True)
        for e in uniq.tolist():
            if e not in self.elements_list:
                raise ValueError(
                    f"{e} not supported by this EAM potential "
                    f"({self.elements_list})"
                )
        lutv = np.array([self.elements_list.index(e) for e in uniq.tolist()],
                        np.int64)
        types = lutv[inv.reshape(-1)]
        try:
            system._eam_type_cache = (ckey, types)
        except AttributeError:
            pass
        return types

    def calculate(self, system) -> None:
        types = self._types(system)
        old_n = system.N
        pos, box, n_images = replicate_for_small_box(system.pos, system.box, self.rc)
        if n_images > 1:
            types = np.tile(types, n_images)
        # the box is already enlarged, so indices refer to the replicated set
        pos_d, verlet_d, _, _ = neighbor_search_device(pos, box, self.rc,
                                                      device=self.device)
        energy, force, virial = eam_force(
            pos_d, torch.as_tensor(types, device=self.device), verlet_d, box,
            self._tables(), self.drho, self.dr, self.rc, self.nr, self.nrho,
            self.Nelements)
        # stress assembled on the device (Voigt, as stress_from_virials)
        vsum = virial.sum(dim=0).reshape(3, 3)
        stress = (-0.5 * (vsum + vsum.T) / abs(box.volume)).reshape(-1)[
            [0, 4, 8, 5, 2, 1]]
        self.results["energies"] = energy[:old_n]
        self.results["forces"] = force[:old_n]
        self.results["virials"] = virial[:old_n]
        self.results["stress"] = stress

    def plot(self, fig=None, ax=None):
        import matplotlib.pyplot as plt

        if fig is None:
            fig, ax = plt.subplots(1, 3, figsize=(12, 3.2))
        for e, name in enumerate(self.elements_list):
            ax[0].plot(self.rho, self.F_rho[e], label=name)
            ax[1].plot(self.r, self.rho_r[e], label=name)
            ax[2].plot(self.r[1:], self.phi_r[e, e, 1:], label=name)
        ax[0].set_xlabel(r"$\rho$"); ax[0].set_ylabel(r"F($\rho$) (eV)")
        ax[1].set_xlabel(r"r ($\AA$)"); ax[1].set_ylabel(r"$\rho$(r)")
        ax[2].set_xlabel(r"r ($\AA$)"); ax[2].set_ylabel(r"$\phi$(r) (eV)")
        ax[2].set_ylim(-1, 5)
        for a in ax:
            a.legend(fontsize=7)
        return fig, ax


def eam_block(n: int, M: int) -> int:
    """Rows a block: about 2^23 pair slots, a power of two in [128, 16384]."""
    target = max(1, (1 << 23) // max(M, 1))
    b = 1 << max(0, (min(n, target) - 1)).bit_length()
    return max(128, min(b, 16384))


def eam_pass1(pack, rows_i, vb, matrix, inv, boundary, rho_flat, z2r_flat,
              dr: float, rc: float, nr: int, nt: int):
    """Pass 1 over one row block: (rho_i, e_pair) per row and the staged
    (ddx, ddy, ddz, w0, wj, wi) per pair slot.  ``pack`` is the (N, 4)
    position + type table, ``rows_i`` this block's rows of it, ``vb`` its
    Verlet rows."""
    okb = vb >= 0
    nbr = pack[torch.clamp(vb, min=0).long()]        # one (B, M, 4) gather
    cx = nbr[..., 0] - rows_i[:, 0, None]
    cy = nbr[..., 1] - rows_i[:, 1, None]
    cz = nbr[..., 2] - rows_i[:, 2, None]
    fa = cx * inv[0, 0] + cy * inv[1, 0] + cz * inv[2, 0]
    fb = cx * inv[0, 1] + cy * inv[1, 1] + cz * inv[2, 1]
    fc = cx * inv[0, 2] + cy * inv[1, 2] + cz * inv[2, 2]
    fa = fa - torch.round(fa) * boundary[0]
    fb = fb - torch.round(fb) * boundary[1]
    fc = fc - torch.round(fc) * boundary[2]
    ddx = fa * matrix[0, 0] + fb * matrix[1, 0] + fc * matrix[2, 0]
    ddy = fa * matrix[0, 1] + fb * matrix[1, 1] + fc * matrix[2, 1]
    ddz = fa * matrix[0, 2] + fb * matrix[1, 2] + fc * matrix[2, 2]
    d = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
    okb = okb & (d <= rc)
    d0 = torch.where(okb, d, 0.0)
    m = torch.clamp(torch.floor(d0 / dr).long(), 0, nr - 2)
    dx = torch.clamp(d0 - m.to(d0.dtype) * dr, 0.0, dr)
    tj = nbr[..., 3].long()
    ti = rows_i[:, 3, None].long()

    rho_ij, drho_j = _hermite(_rows(rho_flat, tj * (nr - 1) + m), dx, dr)
    _, drho_i = _hermite(_rows(rho_flat, ti * (nr - 1) + m), dx, dr)
    z2, dz2 = _hermite(_rows(z2r_flat, (ti * nt + tj) * (nr - 1) + m), dx, dr)

    rinv = 1.0 / torch.where(okb, d0, 1.0)
    phi = z2 * rinv
    dphi = (dz2 - phi) * rinv
    rho_i = torch.where(okb, rho_ij, 0.0).sum(dim=1)
    e_pair = torch.where(okb, 0.5 * phi, 0.0).sum(dim=1)
    # staged force factors: w = w0 + dF_i*wj + dF_j*wi (pass 2)
    w0 = torch.where(okb, dphi * rinv, 0.0)
    wj = torch.where(okb, drho_j * rinv, 0.0)
    wi = torch.where(okb, drho_i * rinv, 0.0)
    return rho_i, e_pair, (ddx, ddy, ddz, w0, wj, wi)


def eam_embed(rho, types, F_flat, drho: float, nrho: int):
    """(F_i, dF_i) per atom; F extrapolates linearly beyond the table, as
    LAMMPS does (pair_eam.cpp: "if (rho > rhomax) phi += fp * (rho -
    rhomax)")."""
    mrho = torch.clamp(torch.floor(rho / drho).long(), 0, nrho - 2)
    dxr = torch.clamp(rho - mrho.to(rho.dtype) * drho, 0.0, drho)
    F, dF = _hermite(_rows(F_flat, types * (nrho - 1) + mrho), dxr, drho)
    rho_max = (nrho - 1) * drho
    return torch.where(rho > rho_max, F + dF * (rho - rho_max), F), dF


def eam_pass2(vb, dF, dF_b, staged):
    """Pass 2 over one row block: forces (B, 3) and per-atom virials (B, 9)
    as row sums; the one gather is dF[j]."""
    ddx, ddy, ddz, w0, wj, wi = staged
    dFj = dF[torch.clamp(vb, min=0).long()]
    w = w0 + dF_b[:, None] * wj + dFj * wi
    wx, wy, wz = w * ddx, w * ddy, w * ddz
    force = torch.stack([wx.sum(1), wy.sum(1), wz.sum(1)], dim=-1)
    comps = ((ddx, wx), (ddx, wy), (ddx, wz),
             (ddy, wx), (ddy, wy), (ddy, wz),
             (ddz, wx), (ddz, wy), (ddz, wz))
    virial = torch.stack([-0.5 * (a * b).sum(1) for a, b in comps], dim=-1)
    return force, virial


def eam_force(pos, types, verlet, box, tables, drho: float, dr: float,
              rc: float, nr: int, nrho: int, nt: int):
    """Per-atom energies (N,), forces (N, 3) and virials (N, 9) of the EAM
    over the Verlet list ``verlet`` (int32, -1 padded) in the cell ``box``.

    The full symmetric chain phi' + dF_i rho_j' + dF_j rho_i' is applied per
    pair, so no reverse-pair permutation is needed and every output is a
    sum over the atom's own row."""
    n, M = verlet.shape
    dev, dt = pos.device, pos.dtype
    matrix = torch.tensor(box.matrix, dtype=dt, device=dev)
    inv = torch.tensor(box.inverse_box, dtype=dt, device=dev)
    boundary = torch.tensor(box.boundary, dtype=dt, device=dev)
    rho_flat, z2r_flat, F_flat = tables
    pack = torch.cat([pos, types[:, None].to(dt)], dim=1)
    block = eam_block(n, M)
    spans = [(s, min(n, s + block)) for s in range(0, n, block)]
    rho = torch.empty(n, dtype=dt, device=dev)
    e_pair = torch.empty(n, dtype=dt, device=dev)
    staged = []
    for s, e in spans:
        rho[s:e], e_pair[s:e], st = eam_pass1(
            pack, pack[s:e], verlet[s:e], matrix, inv, boundary, rho_flat,
            z2r_flat, dr, rc, nr, nt)
        staged.append(st)
    F, dF = eam_embed(rho, types, F_flat, drho, nrho)
    force = torch.empty(n, 3, dtype=dt, device=dev)
    virial = torch.empty(n, 9, dtype=dt, device=dev)
    for (s, e), st in zip(spans, staged):
        force[s:e], virial[s:e] = eam_pass2(verlet[s:e], dF, dF[s:e], st)
    return F + e_pair, force, virial


class EAMAverage(EAM):
    """A-atom average potential for high-entropy alloys: the concentration-
    weighted tables appended as element "A"."""

    def __init__(self, filename: str, concentration, device="cuda"):
        super().__init__(filename, device=device)
        conc = np.asarray(concentration, dtype=np.float64)
        assert len(conc) == self.Nelements and abs(conc.sum() - 1.0) < 1e-6
        self.concentration = conc
        F_avg = np.sum(conc[:, None] * self.F_rho, axis=0, keepdims=True)
        rho_avg = np.sum(conc[:, None] * self.rho_r, axis=0, keepdims=True)
        z2_avg = np.einsum("i,j,ijr->r", conc, conc, self._rphi_r)[None, None]
        ne = self.Nelements + 1
        newF = np.concatenate([self.F_rho, F_avg], axis=0)
        newrho = np.concatenate([self.rho_r, rho_avg], axis=0)
        newz2 = np.zeros((ne, ne, self.nr))
        newz2[: ne - 1, : ne - 1] = self._rphi_r
        newz2[ne - 1, ne - 1] = z2_avg[0, 0]
        for i in range(ne - 1):
            cross = np.sum(conc[:, None] * self._rphi_r[i], axis=0)
            newz2[i, ne - 1] = newz2[ne - 1, i] = cross
        self.F_rho, self.rho_r, self._rphi_r = newF, newrho, newz2
        self.Nelements = ne
        self.elements_list = self.elements_list + ["A"]
        self._set_phi()
        self._set_spline_coeffs()


class EAMGenerator:
    """Generate eam.alloy files with the Zhou-Johnson-Wadley
    parameterisation (PRB 69, 144113 (2004)), profiles evaluated on
    vectorised r / rho grids.  A host copy of ``eam.py:602-733``; the file
    it writes is the JAX package's byte for byte."""

    DEFAULT_NR = 2000
    DEFAULT_NRHO = 2000
    DEFAULT_RST = 0.5

    def __init__(self, elements_list, output_filename=None,
                 nr=DEFAULT_NR, nrho=DEFAULT_NRHO, rst=DEFAULT_RST):
        from ._zjw04_params import ZJW04_PARAMS

        for e in elements_list:
            if e not in ZJW04_PARAMS:
                raise ValueError(
                    f"Element '{e}' is not supported. Supported elements: "
                    f"{', '.join(ZJW04_PARAMS)}"
                )
        self.elements_list = list(elements_list)
        self.n_elements = len(elements_list)
        self.nr, self.nrho, self.rst = int(nr), int(nrho), float(rst)
        self.output_filename = output_filename or (
            "".join(elements_list) + ".eam.alloy"
        )
        p = np.array([ZJW04_PARAMS[e] for e in elements_list], dtype=np.float64)
        (self.re, self.fe, self.rhoe, self.rhos, self.alpha, self.beta,
         self.A, self.B, self.kappa, self.lam, self.Fi0, self.Fi1, self.Fi2,
         self.Fi3, self.Fm0, self.Fm1, self.Fm2, self.Fm3, self.eta, self.Fn,
         zahl, self.atomic_mass, self.Fm4, self.beta1, self.lam1,
         rhol, rhoh) = p.T
        self.atomic_number = zahl.astype(np.int32)
        self.lattice_constant = np.sqrt(2.0) * self.re
        self.rhoin = rhol * self.rhoe
        self.rhoout = rhoh * self.rhoe
        self.rc = np.sqrt(10.0) / 2.0 * self.lattice_constant.max()
        self.dr = self.rc / (self.nr - 1.0)
        self._tabulate()
        self._write()

    # ----- ZJW functional forms (vectorised over the r grid) -------------
    def _f_density(self, it, r):
        return (self.fe[it] * np.exp(-self.beta1[it] * (r / self.re[it] - 1.0))
                / (1.0 + (r / self.re[it] - self.lam1[it]) ** 20))

    def _phi_same(self, it, r):
        x = r / self.re[it]
        psi1 = self.A[it] * np.exp(-self.alpha[it] * (x - 1.0)) / (
            1.0 + (x - self.kappa[it]) ** 20)
        psi2 = self.B[it] * np.exp(-self.beta[it] * (x - 1.0)) / (
            1.0 + (x - self.lam[it]) ** 20)
        return psi1 - psi2

    def _phi(self, it1, it2, r):
        if it1 == it2:
            return self._phi_same(it1, r)
        fa, fb = self._f_density(it1, r), self._f_density(it2, r)
        pa, pb = self._phi_same(it1, r), self._phi_same(it2, r)
        return 0.5 * (fb / fa * pa + fa / fb * pb)

    def _embed(self, it, rho):
        Fm3 = np.where(rho < self.rhoe[it], self.Fm3[it], self.Fm4[it])
        xin = rho / self.rhoin[it] - 1.0
        xe = rho / self.rhoe[it] - 1.0
        xs = rho / np.maximum(self.rhos[it], 1e-300)
        inner = (self.Fi0[it] + self.Fi1[it] * xin + self.Fi2[it] * xin ** 2
                 + self.Fi3[it] * xin ** 3)
        mid = (self.Fm0[it] + self.Fm1[it] * xe + self.Fm2[it] * xe ** 2
               + Fm3 * xe ** 3)
        with np.errstate(divide="ignore", invalid="ignore"):
            outer = (self.Fn[it] * (1.0 - self.eta[it] * np.log(xs))
                     * xs ** self.eta[it])
        outer = np.where(np.isfinite(outer), outer, inner)
        return np.where(rho < self.rhoin[it], inner,
                        np.where(rho < self.rhoout[it], mid, outer))

    def _tabulate(self):
        nt = self.n_elements
        r = np.maximum(np.arange(self.nr) * self.dr, self.rst)
        self.rho_table = np.zeros((self.nr, nt))
        self.rphi_table = np.zeros((self.nr, nt, nt))
        for i1 in range(nt):
            self.rho_table[:, i1] = self._f_density(i1, r)
            for i2 in range(i1 + 1):
                rphi = r * self._phi(i1, i2, r)
                self.rphi_table[:, i1, i2] = rphi
                self.rphi_table[:, i2, i1] = rphi
        rhom = max(float(self.rho_table.max()), 2.0 * float(self.rhoe.max()),
                   100.0)
        self.drho = rhom / (self.nrho - 1.0)
        rho_grid = np.arange(self.nrho) * self.drho
        self.embedding = np.column_stack(
            [self._embed(it, rho_grid) for it in range(nt)]
        )

    def _write(self):
        import datetime

        def dump(f, arr):
            for idx, v in enumerate(arr):
                if idx % 5 == 0:
                    if idx > 0:
                        f.write("\n")
                    f.write(" ")
                f.write(f"{v:.16E} ")
            f.write("\n")

        with open(self.output_filename, "w") as f:
            f.write(f" eam/alloy {self.n_elements}")
            for e in self.elements_list:
                f.write(f" {e}")
            # the JAX package's generator line, so both write the same file
            f.write("\n Generated by mdapy_tpu EAMGenerator "
                    f"({datetime.datetime.now():%Y-%m-%d %H:%M:%S})\n")
            f.write(" CITATION: X. W. Zhou, R. A. Johnson, H. N. G. Wadley, "
                    "Phys. Rev. B, 69, 144113 (2004)\n")
            f.write(f"    {self.n_elements} ")
            for e in self.elements_list:
                f.write(f"{e} ")
            f.write("\n")
            f.write(f" {self.nrho} {self.drho:.16E} {self.nr} "
                    f"{self.dr:.16E} {self.rc:.16E}\n")
            for i in range(self.n_elements):
                f.write(f" {self.atomic_number[i]} {self.atomic_mass[i]:.10f} "
                        f"{self.lattice_constant[i]:.6f} fcc\n")
                dump(f, self.embedding[:, i])
                dump(f, self.rho_table[:, i])
            for i in range(self.n_elements):
                for j in range(i + 1):
                    dump(f, self.rphi_table[:, i, j])
