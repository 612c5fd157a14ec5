"""NEP (neuroevolution potential, GPUMD) in torch ops: forward and autograd
forces.

The port of ``mdapy_tpu/potentials/nep.py`` without its charge models:
``NEP`` (:81: ``_parse`` :88, ``_types`` :222, ``_compact_tables`` :230,
``_prepare_device`` :267, ``calculate`` :282, ``get_descriptors`` :384,
``get_latent_space`` :387), ``_chebyshev_basis`` (:441), ``_angular_s``
(:452), ``_q_from_s`` (:482), ``_block_q`` (:523), ``_zbl_energy_oh``
(:570), ``_block_e`` (:595), ``_gather_disp`` (:606), ``_map_blocks``
(:635), ``_nep_force_fast`` (:653), ``_nep_descriptor_fast`` (:694) and
``_ann_energy`` (:739).  NEP3/NEP4/NEP5, with and without ZBL: Chebyshev
radial basis with the cosine cutoff, the angular descriptor through the
real solid-harmonic accumulators (Z_COEFFICIENT tables, C3B/C4B/C5B
contractions), a single-hidden-layer tanh ANN per type, q_scaler, the ZBL
screened-Coulomb channel.  A flexible-ZBL file parses (its ``zbl_para``
kept) and, as in the JAX package, evaluates without the ZBL channel.

Forces and virials come as in the JAX package: per row block, the
autograd gradient of the block's energy with respect to its (B, M)
displacement components (``torch.autograd.grad``), then
``pairops.pair_forces_virials`` over the reverse-pair permutation: gathers
and row sums, never a backward through a gather of positions (whose
``index_add_`` would sum in another order on every run).  Blocks hold
about 2^21 pair slots, so one block's autograd graph fits the card.

Not ported: qNEP (the ``nep4_charge*`` models, :324-360 and :780-966,
ROADMAP A9), whose files raise ``NotImplementedError``; the knobs
``MDAPY_TPU_NEP_BLOCK`` and ``MDAPY_TPU_NEP_VALIDATE`` (the neighbor list's
symmetry is held by tests, ROADMAP C4).  Calculators run on the card unless
built with ``device="cpu"``; everything is float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..neighbor.neighbor import neighbor_search_device, replicate_for_small_box
from .calculator import CalculatorMP, _FrameView
from .pairops import pair_forces_virials, reverse_permutation_device

__all__ = ["NEP"]

# ---------------------------------------------------------------------------
# constants from the NEP descriptor definition (GPUMD), as nep.py:49-78
# ---------------------------------------------------------------------------

C3B = np.array([
    0.238732414637843, 0.119366207318922, 0.119366207318922, 0.099471839432435, 0.596831036594608,
    0.596831036594608, 0.149207759148652, 0.149207759148652, 0.139260575205408, 0.104445431404056,
    0.104445431404056, 1.044454314040563, 1.044454314040563, 0.174075719006761, 0.174075719006761,
    0.011190581936149, 0.223811638722978, 0.223811638722978, 0.111905819361489, 0.111905819361489,
    1.566681471060845, 1.566681471060845, 0.195835183882606, 0.195835183882606,
])
C4B = np.array([-0.007499480826664, -0.134990654879954, 0.067495327439977,
                0.404971964639861, -0.809943929279723])
C5B = np.array([0.026596810706114, 0.053193621412227, 0.026596810706114])

Z_COEFF = {
    1: np.array([[0.0, 1.0], [1.0, 0.0]]),
    2: np.array([[-1.0, 0.0, 3.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]),
    3: np.array([[0.0, -3.0, 0.0, 5.0], [-1.0, 0.0, 5.0, 0.0],
                 [0.0, 1.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]]),
    4: np.array([
        [3.0, 0.0, -30.0, 0.0, 35.0], [0.0, -3.0, 0.0, 7.0, 0.0],
        [-1.0, 0.0, 7.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0, 0.0],
        [1.0, 0.0, 0.0, 0.0, 0.0]]),
}
K_C_SP = 14.399645
ZBL_PARA = (0.18175, 3.1998, 0.50986, 0.94229, 0.28022, 0.4029, 0.02817, 0.20162)
NEP_ELEMENTS = [
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg", "Al", "Si", "P", "S",
    "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge",
    "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm", "Sm", "Eu", "Gd",
    "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu",
]


class NEPStatic(NamedTuple):
    """The model's shape and cutoffs, which the descriptor code branches on."""
    rc_radial: float
    rc_angular: float
    basis_r: int
    basis_a: int
    nmax_r: int
    nmax_a: int
    L_max: int
    L4: bool
    L5: bool
    zbl: bool
    zbl_inner: float
    zbl_outer: float


class NEP(CalculatorMP):
    """A NEP3/4/5 model file (with or without ZBL), on the card unless
    ``device="cpu"``."""

    def __init__(self, filename: str, device="cuda"):
        super().__init__()
        self.device = resolve_device(device, "NEP")
        self.filename = filename
        self._parse(filename)

    # ------------------------------------------------------------------
    def _parse(self, filename: str) -> None:
        with open(filename) as f:
            tokens_iter = iter([ln.split() for ln in f if ln.split()])

        head = next(tokens_iter)
        self.model_name = head[0]
        base = head[0]
        if "_charge" in base:
            raise NotImplementedError(
                f"{base!r} is a qNEP (charge) model; the port does not run "
                "qNEP yet (ROADMAP A9)")
        if base in ("nep3", "nep", "nep3_zbl", "nep_zbl"):
            self.version = 3
        elif base in ("nep4", "nep4_zbl"):
            self.version = 4
        elif base in ("nep5", "nep5_zbl"):
            self.version = 5
        else:
            raise ValueError(f"Unsupported NEP model {head[0]!r}")
        self.zbl_enabled = base.endswith("_zbl")
        self.num_types = int(head[1])
        self.elements_list = head[2 : 2 + self.num_types]
        self.atomic_numbers = np.array(
            [NEP_ELEMENTS.index(e) for e in self.elements_list], dtype=np.int32
        )
        self.zbl_flexibled = False
        self.zbl_rc_inner = self.zbl_rc_outer = 0.0
        if self.zbl_enabled:
            t = next(tokens_iter)
            self.zbl_rc_inner = float(t[1])
            self.zbl_rc_outer = float(t[2])
            if self.zbl_rc_inner == 0 and self.zbl_rc_outer == 0:
                self.zbl_flexibled = True
        t = next(tokens_iter)  # cutoff
        if len(t) == 5:
            self.rc_radial = float(t[1])
            self.rc_angular = float(t[2])
        else:
            self.rc_radial = max(float(v) for v in t[1:-2:2])
            self.rc_angular = max(float(v) for v in t[2:-2:2])
        t = next(tokens_iter)  # n_max
        self.n_max_radial = int(t[1])
        self.n_max_angular = int(t[2])
        t = next(tokens_iter)  # basis_size
        self.basis_size_radial = int(t[1])
        self.basis_size_angular = int(t[2])
        t = next(tokens_iter)  # l_max
        self.L_max = int(t[1])
        self.L4 = int(t[2]) == 2
        self.L5 = int(t[3]) == 1
        self.num_L = self.L_max + int(self.L4) + int(self.L5)
        t = next(tokens_iter)  # ANN
        self.num_neurons = int(t[1])
        self.dim_radial = self.n_max_radial + 1
        self.dim_angular = (self.n_max_angular + 1) * self.num_L
        self.dim = self.dim_radial + self.dim_angular

        nt = self.num_types
        if self.version == 3:
            num_ann = (self.dim + 2) * self.num_neurons + 1
        elif self.version == 4:
            num_ann = (self.dim + 2) * self.num_neurons * nt + 1
        else:
            num_ann = ((self.dim + 2) * self.num_neurons + 1) * nt + 1
        num_c = nt * nt * (
            (self.n_max_radial + 1) * (self.basis_size_radial + 1)
            + (self.n_max_angular + 1) * (self.basis_size_angular + 1)
        )
        params = np.array(
            [float(next(tokens_iter)[0]) for _ in range(num_ann + num_c)]
        )
        self.q_scaler = np.array(
            [float(next(tokens_iter)[0]) for _ in range(self.dim)]
        )
        if self.zbl_flexibled:
            nzbl = 10 * (nt * (nt + 1) // 2)
            self.zbl_para = np.array(
                [float(next(tokens_iter)[0]) for _ in range(nzbl)]
            )

        # ANN parameter layout (GPUMD nep.cpp update_potential)
        w0 = np.zeros((nt, self.num_neurons, self.dim))
        b0 = np.zeros((nt, self.num_neurons))
        w1 = np.zeros((nt, self.num_neurons))
        p = 0
        for tt in range(nt):
            if tt > 0 and self.version == 3:
                p -= (self.dim + 2) * self.num_neurons
            w0[tt] = params[p : p + self.num_neurons * self.dim].reshape(
                self.num_neurons, self.dim
            )
            p += self.num_neurons * self.dim
            b0[tt] = params[p : p + self.num_neurons]
            p += self.num_neurons
            w1[tt] = params[p : p + self.num_neurons]
            p += self.num_neurons
            if self.version == 5:
                p += 1
        self.b1 = float(params[p])
        cparams = params[num_ann:]
        nr = (self.n_max_radial + 1) * (self.basis_size_radial + 1)
        self.c_radial = cparams[: nr * nt * nt].reshape(
            self.n_max_radial + 1, self.basis_size_radial + 1, nt, nt
        )
        self.c_angular = cparams[nr * nt * nt :].reshape(
            self.n_max_angular + 1, self.basis_size_angular + 1, nt, nt
        )
        self.w0, self.b0, self.w1 = w0, b0, w1

    # ------------------------------------------------------------------
    def _types(self, system) -> np.ndarray:
        elems = np.asarray(system.data["element"]).astype(str)
        uniq, inv = np.unique(elems, return_inverse=True)
        lut = {e: i for i, e in enumerate(self.elements_list)}
        for e in uniq.tolist():
            if e not in lut:
                raise ValueError(f"{e} not in NEP elements {self.elements_list}")
        return np.array([lut[e] for e in uniq.tolist()], np.int64)[inv.reshape(-1)]

    def _compact_tables(self, types: np.ndarray):
        """The model's tables cut to the element types present, on the
        device: a universal NEP on a system of a few elements mixes only
        those types in every per-pair contraction, and the descriptor does
        not change.  Returns (types_compact, consts)."""
        present = np.unique(types)
        remap = np.full(self.num_types, -1, np.int64)
        remap[present] = np.arange(len(present))
        key = tuple(present.tolist())
        cache = getattr(self, "_compact_cache", None)
        if cache is None or cache[0] != key:
            sl = present

            def dev(a):
                return torch.tensor(np.asarray(a), device=self.device)

            consts = (
                dev(self.c_radial[:, :, sl][:, :, :, sl]),
                dev(self.c_angular[:, :, sl][:, :, :, sl]),
                dev(self.w0[sl]), dev(self.b0[sl]), dev(self.w1[sl]),
                self.b1, dev(self.q_scaler),
                dev(self.atomic_numbers[sl].astype(np.int64)),
            )
            self._compact_cache = (key, consts)
        return remap[types], self._compact_cache[1]

    def _prepare_device(self, system):
        """Positions and the Verlet list on the device (the types on the
        host)."""
        types = self._types(system)
        old_n = system.N
        rc = max(self.rc_radial, self.rc_angular)
        pos, box, n_images = replicate_for_small_box(system.pos, system.box, rc)
        if n_images > 1:
            types = np.tile(types, n_images)
        pos_d, verlet_d, _, _ = neighbor_search_device(pos, box, rc,
                                                      device=self.device)
        return pos_d, box, types, verlet_d, old_n

    def calculate(self, system, box=None) -> None:
        if box is not None:  # the reference's calculate(data, box)
            system = _FrameView(system, box)
        pos_d, box, types, verlet_d, old_n = self._prepare_device(system)
        types_c, consts = self._compact_tables(types)
        rev_d, _ = reverse_permutation_device(verlet_d)
        e, F, V, dEdeps = nep_force(
            pos_d, torch.as_tensor(types_c, device=self.device), verlet_d,
            rev_d, box, consts, self._static())
        # stress = (dE/deps)/V symmetrized, Voigt [xx,yy,zz,yz,xz,xy]
        sig = 0.5 * (dEdeps + dEdeps.T) / abs(box.volume)
        self.results["energies"] = e[:old_n]
        self.results["forces"] = F[:old_n]
        self.results["stress"] = sig.reshape(-1)[[0, 4, 8, 5, 2, 1]]
        # exact per-atom virials (half-pair convention, sums to -dE/deps)
        self.results["virials"] = V[:old_n]

    def _descriptor_like(self, system, latent: bool) -> np.ndarray:
        pos_d, box, types, verlet_d, old_n = self._prepare_device(system)
        types_c, consts = self._compact_tables(types)
        q = nep_descriptor(pos_d, torch.as_tensor(types_c, device=self.device),
                           verlet_d, box, consts, self._static(), latent)
        return q[:old_n].cpu().numpy()

    def get_descriptors(self, system) -> np.ndarray:
        return self._descriptor_like(system, latent=False)

    def get_latent_space(self, system) -> np.ndarray:
        return self._descriptor_like(system, latent=True)

    def _static(self) -> NEPStatic:
        return NEPStatic(
            rc_radial=self.rc_radial,
            rc_angular=self.rc_angular,
            basis_r=self.basis_size_radial,
            basis_a=self.basis_size_angular,
            nmax_r=self.n_max_radial,
            nmax_a=self.n_max_angular,
            L_max=self.L_max,
            L4=self.L4,
            L5=self.L5,
            zbl=self.zbl_enabled and not self.zbl_flexibled,
            zbl_inner=self.zbl_rc_inner,
            zbl_outer=self.zbl_rc_outer,
        )


def _chebyshev_basis(d, rc: float, kmax: int):
    """fn_k(d) for k = 0..kmax with the NEP cosine cutoff (GPUMD find_fn):
    (..., kmax + 1)."""
    fc = torch.where(d < rc, 0.5 * torch.cos(np.pi * d / rc) + 0.5, 0.0)
    x = 2.0 * (d / rc - 1.0) ** 2 - 1.0
    fns = [torch.ones_like(x), x]
    for _ in range(2, kmax + 1):
        fns.append(2.0 * x * fns[-1] - fns[-2])
    fn = torch.stack(fns[: kmax + 1], dim=-1)
    return (fn + 1.0) * 0.5 * fc[..., None]


def _angular_basis(dispc, d, L_max: int):
    """Per L = 1..L_max, the list of (zf, re, im) factors of the solid
    harmonics' m = 0..L components (re, im None at m = 0), so that the s
    accumulators of a radial channel g are sum_m g * zf * (1, re, im)."""
    dsafe = torch.clamp(d, min=1e-30)
    x, y, z = (c / dsafe for c in dispc)
    out = []
    for L in range(1, L_max + 1):
        zc = Z_COEFF[L]
        zpow = [torch.ones_like(z)]
        for _ in range(L):
            zpow.append(zpow[-1] * z)
        re, im = x, y
        comps = []
        for m in range(0, L + 1):
            zf = sum(float(zc[m][n2]) * zpow[n2]
                     for n2 in range(L - m + 1) if zc[m][n2] != 0.0)
            comps.append((zf, None, None) if m == 0 else (zf, re, im))
            if m > 0:
                re, im = re * x - im * y, re * y + im * x
        out.append(comps)
    return out


def _angular_s(basis, gn):
    """Accumulated s components per atom for one radial channel ``gn`` (B,
    M): a list over L of (B, 2L+1) blocks, in the packed m order."""
    out = []
    for comps in basis:
        cols = []
        for zf, re, im in comps:
            zg = zf * gn
            if re is None:
                cols.append(zg.sum(dim=1))
            else:
                cols.append((zg * re).sum(dim=1))
                cols.append((zg * im).sum(dim=1))
        out.append(torch.stack(cols, dim=-1))
    return out


def _q_from_s(s_blocks, L_max: int, L4: bool, L5: bool):
    """q values per atom for one n-channel: (B, num_L)."""
    qs = []
    for L in range(1, L_max + 1):
        s = s_blocks[L - 1]
        start = L * L - 1
        c = torch.as_tensor(C3B[start : start + 2 * L + 1], dtype=s.dtype,
                            device=s.device)
        qs.append(c[0] * s[:, 0] ** 2 + 2.0 * (c[1:] * s[:, 1:] ** 2).sum(dim=1))
    if L4:
        s = s_blocks[1]  # the L = 2 block
        c4 = C4B.tolist()
        qs.append(
            c4[0] * s[:, 0] ** 3
            + c4[1] * s[:, 0] * (s[:, 1] ** 2 + s[:, 2] ** 2)
            + c4[2] * s[:, 0] * (s[:, 3] ** 2 + s[:, 4] ** 2)
            + c4[3] * s[:, 3] * (s[:, 2] ** 2 - s[:, 1] ** 2)
            + c4[4] * s[:, 1] * s[:, 2] * s[:, 4]
        )
    if L5:
        s = s_blocks[0]  # the L = 1 block
        c5 = C5B.tolist()
        s0sq = s[:, 0] ** 2
        s12 = s[:, 1] ** 2 + s[:, 2] ** 2
        qs.append(c5[0] * s0sq**2 + c5[1] * s0sq * s12 + c5[2] * s12**2)
    return torch.stack(qs, dim=-1)


def block_q(dispc, ti, tj, ok, c_radial, c_angular, st: NEPStatic):
    """NEP descriptor q of one row block.

    dispc: 3-tuple of (B, M) minimum-image displacement components (padded
    slots (1, 0, 0)); ti (B,) and tj (B, M) compact types; ok (B, M) the
    valid slots.  The radial channel sums per neighbor type first and mixes
    with c_radial[:, :, ti, :]; the angular one mixes per pair through a
    one-hot product over the compact types.  Returns (q (B, dim), d (B, M))."""
    dx, dy, dz = dispc
    d = torch.sqrt(dx * dx + dy * dy + dz * dz)
    nt = c_radial.shape[-1]
    ohj = torch.nn.functional.one_hot(tj, nt).to(d.dtype)       # (B, M, t)

    okr = ok & (d < st.rc_radial)
    fn_r = _chebyshev_basis(d, st.rc_radial, st.basis_r)         # (B, M, k+1)
    # per-type radial sums S[b,t,k] = sum_m [tj=t] fn_k(r_bm)
    S = torch.einsum("bmt,bmk->btk", torch.where(okr[..., None], ohj, 0.0), fn_r)
    q_radial = torch.einsum("nkbt,btk->bn", c_radial[:, :, ti, :], S)

    oka = ok & (d < st.rc_angular)
    fn_a = _chebyshev_basis(d, st.rc_angular, st.basis_a)        # (B, M, ka+1)
    na1, ka1 = st.nmax_a + 1, st.basis_a + 1
    cA_i = c_angular[:, :, ti, :].permute(2, 0, 1, 3)           # (B, na+1, ka+1, t)
    v = torch.matmul(cA_i.reshape(-1, na1 * ka1, nt), ohj.transpose(1, 2))
    gn_a = torch.einsum("bnkm,bmk->bnm", v.reshape(-1, na1, ka1, v.shape[-1]), fn_a)
    basis = _angular_basis(dispc, d, st.L_max)
    q_ang = []
    for na in range(na1):
        gna = torch.where(oka, gn_a[:, na, :], 0.0)
        q_ang.append(_q_from_s(_angular_s(basis, gna), st.L_max, st.L4, st.L5))
    # layout: q[dim_radial + l * (nmax_a+1) + n] (GPUMD find_q)
    q_ang = torch.stack(q_ang, dim=1).transpose(1, 2).reshape(d.shape[0], -1)
    return torch.cat([q_radial, q_ang], dim=1), d


def _zbl_energy(d, ok, ti, tj, atomic_numbers, st: NEPStatic):
    """Per-atom ZBL energy of one row block (the universal ZBL with the NEP
    cutoff between zbl_inner and zbl_outer)."""
    zi = (atomic_numbers[ti] + 1).to(d.dtype)                   # (B,)
    zj = (atomic_numbers[tj] + 1).to(d.dtype)                   # (B, M)
    okz = ok & (d < st.zbl_outer) & (d > 1e-6)
    a_inv = (zi[:, None] ** 0.23 + zj**0.23) * 2.134563
    zizj = K_C_SP * zi[:, None] * zj
    x = d * a_inv
    p = ZBL_PARA
    phi = (p[0] * torch.exp(-p[1] * x) + p[2] * torch.exp(-p[3] * x)
           + p[4] * torch.exp(-p[5] * x) + p[6] * torch.exp(-p[7] * x))
    f = zizj * phi / torch.clamp(d, min=1e-30)
    r1, r2 = st.zbl_inner, st.zbl_outer
    pi_factor = np.pi / (r2 - r1)
    fc = torch.where(d < r1, 1.0, torch.where(
        d < r2, torch.cos(pi_factor * (d - r1)) * 0.5 + 0.5, 0.0))
    return torch.where(okz, 0.5 * f * fc, 0.0).sum(dim=1)


def _ann_energy(q_scaled, types, w0, b0, w1, b1):
    """(per-atom energies, hidden layer) of the type-wise tanh ANN."""
    h = torch.tanh(torch.einsum("ind,id->in", w0[types], q_scaled) - b0[types])
    return (w1[types] * h).sum(dim=1) - b1, h


def block_energy(dispc, ti, tj, ok, consts, st: NEPStatic):
    """Per-atom energies of one row block."""
    c_radial, c_angular, w0, b0, w1, b1, q_scaler, atomic_numbers = consts
    q, d = block_q(dispc, ti, tj, ok, c_radial, c_angular, st)
    e, _ = _ann_energy(q * q_scaler[None], ti, w0, b0, w1, b1)
    if st.zbl:
        e = e + _zbl_energy(d, ok, ti, tj, atomic_numbers, st)
    return e


def gather_disp(pos, types, verlet, box):
    """Neighbor displacements by per-component gathers: ((dx, dy, dz) (N, M)
    minimum-image components, padded slots (1, 0, 0); tj (N, M); ok (N, M))."""
    dev, dt = pos.device, pos.dtype
    matrix = torch.tensor(box.matrix, dtype=dt, device=dev)
    inv = torch.tensor(box.inverse_box, dtype=dt, device=dev)
    boundary = torch.tensor(box.boundary, dtype=dt, device=dev)
    ok = verlet >= 0
    j = torch.clamp(verlet, min=0).long()
    cx = pos[:, 0][j] - pos[:, 0, None]
    cy = pos[:, 1][j] - pos[:, 1, None]
    cz = pos[:, 2][j] - pos[:, 2, None]
    tj = types[j]
    fa = cx * inv[0, 0] + cy * inv[1, 0] + cz * inv[2, 0]
    fb = cx * inv[0, 1] + cy * inv[1, 1] + cz * inv[2, 1]
    fc = cx * inv[0, 2] + cy * inv[1, 2] + cz * inv[2, 2]
    fa = fa - torch.round(fa) * boundary[0]
    fb = fb - torch.round(fb) * boundary[1]
    fc = fc - torch.round(fc) * boundary[2]
    dx = fa * matrix[0, 0] + fb * matrix[1, 0] + fc * matrix[2, 0]
    dy = fa * matrix[0, 1] + fb * matrix[1, 1] + fc * matrix[2, 1]
    dz = fa * matrix[0, 2] + fb * matrix[1, 2] + fc * matrix[2, 2]
    return (torch.where(ok, dx, 1.0), torch.where(ok, dy, 0.0),
            torch.where(ok, dz, 0.0)), tj, ok


def nep_block(n: int, M: int) -> int:
    """Rows a block: about 2^21 pair slots, a power of two in [128, 8192]."""
    target = max(1, (1 << 21) // max(M, 1))
    b = 1 << max(0, (min(n, target) - 1)).bit_length()
    return max(128, min(b, 8192))


def nep_force(pos, types, verlet, rev, box, consts, st: NEPStatic):
    """Energies (N,), forces (N, 3), per-atom virials (N, 9) and dE/deps
    (3, 3).  A block's energy depends only on its own displacement rows, so
    its gradient is block-local: ``torch.autograd.grad`` per block, with
    respect to the (B, M) displacement components."""
    n, M = verlet.shape
    disp0, tj, ok = gather_disp(pos, types, verlet, box)
    e_atoms = torch.empty(n, dtype=pos.dtype, device=pos.device)
    J = tuple(torch.empty_like(c) for c in disp0)
    block = nep_block(n, M)
    for s in range(0, n, block):
        e = min(n, s + block)
        dc = tuple(c[s:e].detach().requires_grad_(True) for c in disp0)
        with torch.enable_grad():
            eb = block_energy(dc, types[s:e], tj[s:e], ok[s:e], consts, st)
            grads = torch.autograd.grad(eb.sum(), dc)
        e_atoms[s:e] = eb.detach()
        for c in range(3):
            J[c][s:e] = grads[c]
    F, V, dEdeps = pair_forces_virials(disp0, J, verlet, rev, ok)
    return e_atoms, F, V, dEdeps


def nep_descriptor(pos, types, verlet, box, consts, st: NEPStatic,
                   latent: bool = False):
    """Per-atom scaled descriptors (N, dim), or with ``latent`` the ANN's
    weighted hidden layer (N, neurons)."""
    c_radial, c_angular, w0, b0, w1, b1, q_scaler, _ = consts
    n, M = verlet.shape
    disp0, tj, ok = gather_disp(pos, types, verlet, box)
    block = nep_block(n, M)
    out = []
    for s in range(0, n, block):
        e = min(n, s + block)
        q, _ = block_q(tuple(c[s:e] for c in disp0), types[s:e], tj[s:e],
                       ok[s:e], c_radial, c_angular, st)
        qs = q * q_scaler[None]
        if latent:
            _, h = _ann_energy(qs, types[s:e], w0, b0, w1, b1)
            qs = w1[types[s:e]] * h
        out.append(qs)
    return torch.cat(out, dim=0)
