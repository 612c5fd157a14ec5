"""NEP (neuroevolution potential, GPUMD) in torch ops: forward and autograd
forces, and the qNEP charge models.

The port of ``mdapy_tpu/potentials/nep.py``: ``NEP`` (:81: ``_parse`` :88,
``_types`` :222, ``_compact_tables`` :230, ``_prepare_device`` :267,
``calculate`` :282, ``_calculate_qnep`` :324, ``get_charges`` :350,
``get_bec`` :360, ``get_descriptors`` :384, ``get_latent_space`` :387),
``_chebyshev_basis`` (:441), ``_angular_s`` (:452), ``_q_from_s`` (:482),
``_block_q`` (:523), ``_zbl_energy_oh`` (:570), ``_block_e`` (:595),
``_gather_disp`` (:606), ``_map_blocks`` (:635), ``_nep_force_fast``
(:653), ``_nep_descriptor_fast`` (:694), ``_ann_energy`` (:739) and the
qNEP machinery (:748-966: ``_ewald_nvecs``, ``_recip_pe``, ``_real_pe``,
``_qnep_energy_atoms``, ``_qnep_bec``, ``_qnep_compute``).  NEP3/NEP4/NEP5,
with and without ZBL: Chebyshev radial basis with the cosine cutoff, the
angular descriptor through the real solid-harmonic accumulators
(Z_COEFFICIENT tables, C3B/C4B/C5B contractions), a single-hidden-layer
tanh ANN per type, q_scaler, the ZBL screened-Coulomb channel.  A
flexible-ZBL file parses (its ``zbl_para`` kept) and, as in the JAX
package, evaluates without the ZBL channel.  ``nep4_charge1/2/3`` models
add a charge head, zero-mean charges, an Ewald electrostatic energy (mode
1: reciprocal + real-space erfc + self-energy; mode 2: reciprocal only;
mode 3: shifted real-space only) and Born effective charges
(``qnep_compute``).

Forces and virials come as in the JAX package: per row block, the
autograd gradient of the block's energy with respect to its (B, M)
displacement components (``torch.autograd.grad``), then
``pairops.pair_forces_virials`` over the reverse-pair permutation: gathers
and row sums, never a backward through a gather of positions (whose
``index_add_`` would sum in another order on every run).  Blocks hold
about 2^21 pair slots, so one block's autograd graph fits the card.  The
reciprocal sum goes in chunks of k-vectors whose graphs live one at a time.

Not ported: the knobs ``MDAPY_TPU_NEP_BLOCK`` and ``MDAPY_TPU_NEP_VALIDATE``
(the neighbor list's symmetry is held by tests, ROADMAP C4).  Calculators
run on the card unless built with ``device="cpu"``; everything is float64.
"""

from __future__ import annotations

import math
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
    charge_mode: int = 0
    alpha_q: float = 0.0
    charge_A: float = 0.0
    charge_B: float = 0.0


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
        self.charge_mode = 0
        if "_charge" in base:
            base, _, cm = base.rpartition("_charge")
            self.charge_mode = int(cm)
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
        if self.charge_mode > 0:
            # the charge head (w1 doubles) and sqrt(eps_inf)
            num_ann += self.num_neurons * nt + 1
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
        w1c = np.zeros((nt, self.num_neurons))
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
            if self.charge_mode > 0:
                w1c[tt] = params[p : p + self.num_neurons]
                p += self.num_neurons
            if self.version == 5:
                p += 1
        self.sqrt_epsilon_inf = 1.0
        if self.charge_mode > 0:
            self.sqrt_epsilon_inf = float(params[p])
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
        self.w0, self.b0, self.w1, self.w1c = w0, b0, w1, w1c

        # electrostatic constants of the charge models (NEPCPU nep.cpp:2156-2166)
        if self.charge_mode > 0:
            rc = self.rc_radial
            self.alpha_q = math.pi / rc  # "a good value"
            self.two_alpha_over_sqrt_pi = 2.0 * self.alpha_q / math.sqrt(math.pi)
            A = math.erfc(math.pi) / (rc * rc)
            A += self.two_alpha_over_sqrt_pi * math.exp(-math.pi * math.pi) / rc
            self.charge_A = A
            self.charge_B = -math.erfc(math.pi) / rc - A * rc

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
        if self.charge_mode > 0:
            self._calculate_qnep(system)
            return
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

    def _calculate_qnep(self, system) -> None:
        """Energies, forces, stress, virials, charges and BEC of a
        nep4_charge* model (the JAX package's ``_calculate_qnep``)."""
        pos_d, box, types, verlet_d, old_n = self._prepare_device(system)
        types_c, consts = self._compact_tables(types)
        w1c = torch.tensor(self.w1c[np.unique(types)], device=self.device)
        rev_d, _ = reverse_permutation_device(verlet_d)
        nvec = ewald_nvecs(np.asarray(box.matrix, np.float64), self.alpha_q)
        n_total = pos_d.shape[0]
        energies, forces, dEdeps, charges, bec = qnep_compute(
            pos_d, torch.as_tensor(types_c, device=self.device), verlet_d,
            rev_d, box, nvec, consts, w1c, self.sqrt_epsilon_inf, self._static())
        sig = 0.5 * (dEdeps + dEdeps.T) / abs(box.volume)
        self.results["energies"] = energies[:old_n]
        self.results["forces"] = forces[:old_n]
        self.results["stress"] = sig.reshape(-1)[[0, 4, 8, 5, 2, 1]]
        # the global virial shared evenly, as the JAX package tiles it
        self.results["virials"] = (-dEdeps.reshape(1, 9) / n_total).expand(
            old_n, 9).contiguous()
        self.results["charges"] = charges[:old_n]
        self.results["bec"] = bec[:old_n]

    def get_charges(self, system, box=None) -> np.ndarray:
        """Per-atom (zero-mean) charges; qNEP only (reference nep.py:327)."""
        if box is not None:
            system = _FrameView(system, box)
        if self.charge_mode == 0:
            raise ValueError("charges require a qNEP (nep4_charge*) model.")
        self._ensure(system)
        return self._fetch("charges")

    def get_bec(self, system, box=None) -> np.ndarray:
        """Per-atom Born effective charges (N, 9); qNEP only
        (reference nep.py:350)."""
        if box is not None:
            system = _FrameView(system, box)
        if self.charge_mode == 0:
            raise ValueError("BEC requires a qNEP (nep4_charge*) model.")
        self._ensure(system)
        return self._fetch("bec")

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
            charge_mode=self.charge_mode,
            alpha_q=getattr(self, "alpha_q", 0.0),
            charge_A=getattr(self, "charge_A", 0.0),
            charge_B=getattr(self, "charge_B", 0.0),
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


# ---------------------------------------------------------------------------
# qNEP: the charge models (nep4_charge1/2/3)
# ---------------------------------------------------------------------------

# bytes of one (atoms, k-vectors) float64 matrix of a reciprocal-sum chunk;
# a chunk's forward and backward hold a few of them
RECIP_CHUNK_BYTES = 1 << 29
TWO_PI_NEP = 6.2831853  # NEPCPU's truncated 2 pi, kept for parity


def ewald_nvecs(matrix: np.ndarray, alpha: float) -> np.ndarray:
    """Integer reciprocal-lattice triples of the Ewald half-space sphere.

    A host copy of the JAX package's ``_ewald_nvecs`` (nep.py:780-815), the
    mirror of EwaldNep::find_k_and_G (ewald_nep.cpp:167-237): half-space n1
    >= 0 with the (n1==0, n2<0) / (n1==n2==0, n3<=0) rows dropped, |k|^2 <
    (2*pi*alpha)^2.  The G weights are recomputed with the strain, so that
    the virial differentiates through them."""
    two_pi = TWO_PI_NEP
    a1, a2, a3 = matrix[0], matrix[1], matrix[2]
    det = float(np.linalg.det(matrix))
    b1 = np.cross(a2, a3) * (two_pi / det)
    b2 = np.cross(a3, a1) * (two_pi / det)
    b3 = np.cross(a1, a2) * (two_pi / det)
    volume_k = two_pi**3 / abs(det)
    n1_max = int(alpha * two_pi * np.linalg.norm(np.cross(b2, b3)) / volume_k)
    n2_max = int(alpha * two_pi * np.linalg.norm(np.cross(b3, b1)) / volume_k)
    n3_max = int(alpha * two_pi * np.linalg.norm(np.cross(b1, b2)) / volume_k)
    ksq_max = two_pi * two_pi * alpha * alpha
    g1, g2, g3 = np.meshgrid(
        np.arange(0, n1_max + 1),
        np.arange(-n2_max, n2_max + 1),
        np.arange(-n3_max, n3_max + 1),
        indexing="ij",
    )
    nvec = np.stack([g1.ravel(), g2.ravel(), g3.ravel()], axis=1)
    n1, n2, n3 = nvec[:, 0], nvec[:, 1], nvec[:, 2]
    keep = ~(
        ((n1 == 0) & (n2 == 0) & (n3 == 0))
        | ((n1 == 0) & (n2 < 0))
        | ((n1 == 0) & (n2 == 0) & (n3 < 0))
    )
    nvec = nvec[keep]
    k = nvec @ np.stack([b1, b2, b3])
    nvec = nvec[np.sum(k * k, axis=1) < ksq_max]
    return np.ascontiguousarray(nvec, dtype=np.int32)


def recip_chunk(n: int) -> int:
    """k-vectors a chunk of the reciprocal sum over ``n`` atoms takes."""
    return max(1, RECIP_CHUNK_BYTES // (8 * max(n, 1)))


def recip_sum(pos, matrix, qbar, nvec, alpha: float):
    """The reciprocal-space Ewald sum at fixed charges (the JAX package's
    ``_recip_pe``, nep.py:818-838; ewald_nep.cpp:73-141), in chunks of
    k-vectors: (per-atom energies (n,), potentials dE/dq (n,), dE/dpos (n,
    3), dE/deps (3, 3)).

    pe_i = K_C q_i sum_k G_k Re[S(k) e^{ik.r_i}], with G_k carrying the
    factor 2 of the suppressed -k half; the energy is K_C sum_k G_k |S_k|^2.
    Each chunk builds k from ``matrix @ strain`` and its (n, chunk) phases,
    takes its gradients with respect to the positions and a virtual strain
    with ``torch.autograd.grad`` at once and frees them: no chunk's graph
    outlives it."""
    n, dev, dt = pos.shape[0], pos.device, pos.dtype
    mat = torch.tensor(np.asarray(matrix), dtype=dt, device=dev)
    nv = torch.as_tensor(nvec, dtype=dt, device=dev)
    P = pos.detach().requires_grad_(True)
    eps = torch.zeros((3, 3), dtype=dt, device=dev, requires_grad=True)
    eye = torch.eye(3, dtype=dt, device=dev)
    alpha_factor = 0.25 / (alpha * alpha)
    pe = torch.zeros(n, dtype=dt, device=dev)
    phi = torch.zeros(n, dtype=dt, device=dev)
    g_pos = torch.zeros((n, 3), dtype=dt, device=dev)
    g_eps = torch.zeros((3, 3), dtype=dt, device=dev)
    step = recip_chunk(n)
    for c0 in range(0, nv.shape[0], step):
        with torch.enable_grad():
            strain = eye + eps
            m = mat @ strain
            f = TWO_PI_NEP / torch.linalg.det(m)
            b = torch.stack([torch.linalg.cross(m[1], m[2]),
                             torch.linalg.cross(m[2], m[0]),
                             torch.linalg.cross(m[0], m[1])]) * f
            k = nv[c0:c0 + step] @ b
            ksq = (k * k).sum(dim=1)
            G = 2.0 * torch.abs(f) / ksq * torch.exp(-ksq * alpha_factor)
            kr = (P @ strain) @ k.T                                # (n, chunk)
            c, s = torch.cos(kr), torch.sin(kr)
            S_re = qbar @ c
            S_im = -(qbar @ s)
            energy = K_C_SP * (G * (S_re * S_re + S_im * S_im)).sum()
            gp, ge = torch.autograd.grad(energy, (P, eps))
        with torch.no_grad():
            u = c @ (G * S_re) - s @ (G * S_im)
            pe += K_C_SP * qbar * u
            phi += 2.0 * K_C_SP * u
            g_pos += gp
            g_eps += ge
        del kr, c, s
    return pe, phi, g_pos, g_eps


def real_sum(qbar, dispc, ok, verlet, st: NEPStatic):
    """The real-space sum at fixed charges (the JAX package's ``_real_pe``,
    nep.py:841-862): charge mode 1, 0.5 q_i q_j erfc(alpha r)/r pairs and
    the Gaussian self-energy (NEPCPU nep.cpp:1108-1193); mode 3, the shifted
    erfc/r + A r + B without it (nep.cpp:1028-1108).  Returns (per-atom
    energies (n,), potentials dE/dq (n,), the pair gradient dE/d(disp), a
    3-tuple of (n, M)).  The pair terms are elementwise and the potentials
    row sums: q_j phi(r_ij) summed over i's row, which by the list's
    symmetry is i's share of both halves of every pair."""
    qj = torch.where(ok, qbar[torch.clamp(verlet, min=0).long()], 0.0)
    dc = tuple(c.detach().requires_grad_(True) for c in dispc)
    with torch.enable_grad():
        d = torch.sqrt(dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2])
        okq = ok & (d < st.rc_radial)
        phi_r = torch.special.erfc(st.alpha_q * d) / torch.clamp(d, min=1e-30)
        if st.charge_mode == 3:
            phi_r = phi_r + st.charge_A * d + st.charge_B
        pair = torch.where(okq, 0.5 * (qbar[:, None] * qj) * phi_r, 0.0)
        grads = torch.autograd.grad(K_C_SP * pair.sum(), dc)
    with torch.no_grad():
        pe = pair.sum(dim=1)
        pot = torch.where(okq, qj * phi_r, 0.0).sum(dim=1)
        if st.charge_mode == 1:
            self_term = 2.0 * st.alpha_q / np.sqrt(np.pi)
            pe = pe - 0.5 * self_term * qbar * qbar
            pot = pot - self_term * qbar
    return K_C_SP * pe, K_C_SP * pot, grads


def qnep_compute(pos, types, verlet, rev, box, nvec, consts, w1c,
                 sqrt_eps: float, st: NEPStatic):
    """Energies (n,), forces (n, 3), dE/deps (3, 3), zero-mean charges (n,)
    and Born effective charges (n, 9) of a charge model (the JAX package's
    ``_qnep_compute``, ``_qnep_energy_atoms`` and ``_qnep_bec``,
    nep.py:865-964).

    The JAX package differentiates the whole energy at once, with the
    charges' mean held constant (``stop_gradient``: the reference chains
    dE/dq through the raw charges).  Here the same gradient comes in parts:
    per row block, the short-range energy's and the raw charges' gradients
    with respect to the block's displacements (a charge depends only on its
    own atom's rows); then the electrostatic sums at the fixed zero-mean
    charges, which give each atom's potential phi_i = dE/dq_i and the
    sums' own gradients; the pair gradient J = dE_short/d(disp) + phi_i
    dq_i/d(disp) + dE_real/d(disp) goes through ``pair_forces_virials``,
    and the reciprocal sum adds its position and strain gradients.  The BEC
    pair sum goes through the reverse permutation as a row sum, not a
    scatter:

        BEC_i = sqrt(eps_inf) [ q_i I + sum_m 0.5 r_im (x) dq_i/dr_im
                                 - sum_m 0.5 r_jm' (x) dq_j/dr_jm' ]

    with (j, m') the reverse pair of (i, m)."""
    c_radial, c_angular, w0, b0, w1, b1, q_scaler, atomic_numbers = consts
    n, M = verlet.shape
    dev, dt = pos.device, pos.dtype
    disp0, tj, ok = gather_disp(pos, types, verlet, box)
    e_short = torch.empty(n, dtype=dt, device=dev)
    charge = torch.empty(n, dtype=dt, device=dev)
    Je = tuple(torch.empty_like(c) for c in disp0)
    Jq = tuple(torch.empty_like(c) for c in disp0)
    block = nep_block(n, M)
    for s in range(0, n, block):
        e = min(n, s + block)
        dc = tuple(c[s:e].detach().requires_grad_(True) for c in disp0)
        ti = types[s:e]
        with torch.enable_grad():
            q, d = block_q(dc, ti, tj[s:e], ok[s:e], c_radial, c_angular, st)
            eb, h = _ann_energy(q * q_scaler[None], ti, w0, b0, w1, b1)
            if st.zbl:
                eb = eb + _zbl_energy(d, ok[s:e], ti, tj[s:e], atomic_numbers, st)
            qb = (w1c[ti] * h).sum(dim=1)
            ge = torch.autograd.grad(eb.sum(), dc, retain_graph=True)
            gq = torch.autograd.grad(qb.sum(), dc)
        e_short[s:e] = eb.detach()
        charge[s:e] = qb.detach()
        for c in range(3):
            Je[c][s:e] = ge[c]
            Jq[c][s:e] = gq[c]
    qbar = charge - charge.mean()

    energies = e_short
    phi = torch.zeros(n, dtype=dt, device=dev)
    J = Je
    if st.charge_mode in (1, 2):
        pe_k, phi_k, g_pos, g_eps = recip_sum(pos, box.matrix, qbar, nvec,
                                              st.alpha_q)
        energies = energies + pe_k
        phi = phi + phi_k
    if st.charge_mode in (1, 3):
        pe_r, phi_r, J_real = real_sum(qbar, disp0, ok, verlet, st)
        energies = energies + pe_r
        phi = phi + phi_r
        J = tuple(a + b for a, b in zip(J, J_real))
    J = tuple(a + phi[:, None] * b for a, b in zip(J, Jq))
    forces, _, dEdeps = pair_forces_virials(disp0, J, verlet, rev, ok)
    if st.charge_mode in (1, 2):
        forces = forces - g_pos
        dEdeps = dEdeps + g_eps

    bec = born_charges(disp0, Jq, qbar, verlet, rev, ok, sqrt_eps)
    return energies, forces, dEdeps, qbar, bec


def born_charges(disp, Jq, qbar, verlet, rev, ok, sqrt_eps: float):
    """Born effective charges (n, 9) from the charges' pair gradients
    ``Jq`` (a 3-tuple of (n, M)): the pair terms 0.5 r_a (dq/dr)_b, their
    row sums, less their sums over the reverse pairs (gathers, no
    scatter)."""
    M = verlet.shape[1]
    flat = torch.clamp(verlet.long(), min=0) * M + rev
    cols = []
    for a in range(3):
        da = torch.where(ok, disp[a], 0.0)
        for b in range(3):
            pair = 0.5 * da * Jq[b]
            back = torch.where(ok, pair.reshape(-1)[flat], 0.0)
            cols.append(pair.sum(dim=1) - back.sum(dim=1)
                        + (qbar if a == b else 0.0))
    return torch.stack(cols, dim=1) * sqrt_eps
