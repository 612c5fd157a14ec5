"""Bond-stiffness-vs-length fitting (ATAT *fitsvsl* method).

A host copy of ``mdapy_tpu/potentials/bond_stiffness.py`` (the whole file,
:1-454).  Fits per-(element-pair, neighbor-shell) polynomials k_l(r),
k_t(r) of the longitudinal / transverse harmonic spring constants from
single-atom displacement force probes, following the published method (van
de Walle & Ceder, Rev. Mod. Phys. 74, 11 (2002); Wu, Ceder & van de Walle,
PRB 67, 134103 (2003)), with the reference's constructor surface,
attributes and the ATAT ``slspring.out`` output format.

The bond graph is a struct-of-arrays built from the port's neighbor list on
the system's device; the OLS design matrix is assembled with one vectorized
scatter-add over all (bond, probe) combinations, and the per-bond
projection observations come from one batched force-probe tensor.  The
probes (n * 3 * 2 force calls a strain, in the order ``(atom * 3 + axis) *
nsigns + sign``) go through the port's ``System.update_pos`` and
``get_force``, so the forces run on the calculator's device; the strained
copies are port ``System``s on the system's device, and ``bond_table`` is
the port's ``AtomFrame``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["BondStiffness"]


class _BondGraph:
    """Unique bonds of a configuration as flat arrays.

    Fields: ``src``/``dst`` (B,) primary-cell atom indices, ``vec`` (B, 3)
    cartesian bond vectors src->dst, ``length`` (B,).  Every geometric
    (i, j, image) instance appears exactly once: central-image pairs keep
    only dst > src; ghost-image pairs (from small-box replication) keep
    both directions since they encode distinct images.
    """

    def __init__(self, system, rc: float):
        from ..neighbor.neighbor import neighbor_search, replicate_for_small_box

        pos_r, box_r, _ = replicate_for_small_box(system.pos, system.box, rc)
        verlet, dist, nn = neighbor_search(pos_r, box_r, rc,
                                           device=system.device)
        n = system.N
        slots = np.arange(verlet.shape[1])[None, :]
        in_range = (
            (verlet[:n] >= 0)
            & (slots < nn[:n, None])
            & (dist[:n] <= rc + 1e-9)
        )
        row, col = np.nonzero(in_range)
        ghost = verlet[row, col]
        primary = ghost % n
        keep = (ghost >= n) | (primary > row)
        row, col = row[keep], col[keep]
        ghost, primary = ghost[keep], primary[keep]
        delta = pos_r[ghost] - pos_r[row]
        # fold across the (possibly replicated) periodic cell
        frac = delta @ np.linalg.inv(box_r.matrix)
        frac -= np.round(frac) * box_r.boundary
        self.vec = frac @ box_r.matrix
        self.src = row.astype(np.int64)
        self.dst = primary.astype(np.int64)
        self.length = dist[row, col]
        self.size = len(row)


def _partition_shells(lengths: np.ndarray, tol: float) -> List[float]:
    """Greedy 1-D clustering: a new shell opens when a (sorted) length sits
    more than `tol` beyond the current shell's first member; returns the
    member-mean of each shell."""
    uniq = np.unique(lengths)
    starts: List[float] = []
    for val in uniq:
        if not starts or val - starts[-1] > tol:
            starts.append(float(val))
    sums = np.zeros(len(starts))
    counts = np.zeros(len(starts))
    for val in lengths:
        for s, c in enumerate(starts):
            if abs(val - c) < tol:
                sums[s] += val
                counts[s] += 1
                break
    return list(sums / np.maximum(counts, 1))


class BondStiffness:
    """Fit k_long(r), k_trans(r) per element pair and distance shell.

    Same public surface as the reference class (required for drop-in
    parity): ``compute()`` fills ``shells``, ``k_long``, ``k_trans``,
    ``bond_table``; ``write_slspring()`` emits ATAT format.
    """

    def __init__(
        self,
        system,
        calculator,
        rc_bond: Optional[float] = None,
        shell_tol: float = 0.1,
        delta: float = 0.05,
        poly_order: int = 1,
        n_lattice: int = 3,
        max_strain: float = 0.02,
        central_diff: bool = True,
        rcond: float = 1e-6,
    ):
        if "element" not in system.data.columns:
            raise ValueError("system must have an 'element' column")
        self._sys = system
        self._calc = calculator
        self.delta = float(delta)
        self.poly_order = int(poly_order)
        self.n_lattice = int(n_lattice)
        self.max_strain = float(max_strain)
        self.central_diff = bool(central_diff)
        self.rc_bond = None if rc_bond is None else float(rc_bond)
        self.shell_tol = float(shell_tol)
        self.rcond = float(rcond)

        self.bond_table = None  # AtomFrame of per-bond observations
        self.shells: List[float] = []
        self.k_long: Dict[Tuple[str, str, int], np.ndarray] = {}
        self.k_trans: Dict[Tuple[str, str, int], np.ndarray] = {}

    # ------------------------------------------------------------ configuration
    @property
    def _signs(self):
        return (1.0, -1.0) if self.central_diff else (1.0,)

    def _shortest_bond_cutoff(self) -> float:
        from ..neighbor.neighbor import neighbor_search

        probe = min(5.0, 0.5 * float(np.min(self._sys.box.get_thickness())))
        _, dist, _ = neighbor_search(self._sys.pos, self._sys.box, probe,
                                     device=self._sys.device)
        nonzero = dist[dist > 0]
        return 1.05 * float(nonzero.min())

    def _strained_copy(self, scale: float):
        from ..core.system import System

        cols = {c: np.array(self._sys.data[c], copy=True)
                for c in self._sys.data.columns}
        for c in "xyz":
            cols[c] = cols[c] * scale
        return System(data=cols, box=self._sys.box.matrix * scale,
                      boundary=self._sys.box.boundary,
                      device=self._sys.device)

    # -------------------------------------------------------------- force probes
    def _probe_force_deltas(self, system) -> np.ndarray:
        """All single-atom displacement force responses, as one tensor
        dF[probe, atom, comp], probe = (atom * 3 + axis) * nsigns + sign."""
        system.calc = self._calc
        base = np.array(system.get_force())
        n = system.N
        signs = self._signs
        out = np.empty((n * 3 * len(signs), n, 3))
        home = system.pos
        probe = 0
        for atom in range(n):
            for axis in range(3):
                for sgn in signs:
                    moved = home.copy()
                    moved[atom, axis] += sgn * self.delta
                    system.update_pos(moved)
                    out[probe] = np.array(system.get_force()) - base
                    probe += 1
        system.update_pos(home)
        return out

    # --------------------------------------------------------- design assembly
    def _design_matrix(self, graph, col_of, lengths, n_probes,
                       n_atoms, n_cols):
        """Vectorized OLS design: A[probe, atom, comp, col].

        For a probe displacing atom p by d, a bond (i, j, u, L) in shell s
        of pair c contributes  -+ proj * L^q  to the force rows of i / j at
        column col_of[c, s] (+ q, longitudinal block then transverse block),
        where proj is the longitudinal / transverse projection of the
        relative displacement d_rel = +-d.
        """
        B = graph.size
        if B == 0:
            return np.zeros((n_probes, n_atoms, 3, n_cols))
        u = graph.vec / lengths[:, None]
        proj_l = u[:, :, None] * u[:, None, :]          # (B, 3, 3)
        proj_t = np.eye(3)[None] - proj_l
        nsigns = len(self._signs)
        ncoef = self.poly_order + 1
        powers = lengths[:, None] ** np.arange(ncoef)[None, :]  # (B, ncoef)

        A = np.zeros((n_probes, n_atoms, 3, n_cols))
        ends = (graph.src, graph.dst)
        for side in (0, 1):
            mover = ends[side]           # the probed endpoint
            rel = 1.0 if side == 0 else -1.0
            for axis in range(3):
                for si, sgn in enumerate(self._signs):
                    pid = (mover * 3 + axis) * nsigns + si
                    dl = (rel * sgn * self.delta) * proj_l[:, :, axis]  # (B,3)
                    dt = (rel * sgn * self.delta) * proj_t[:, :, axis]
                    for q in range(ncoef):
                        cl = col_of + q            # (B,) longitudinal cols
                        ct = col_of + ncoef + q    # transverse cols
                        wl = dl * powers[:, q:q + 1]
                        wt = dt * powers[:, q:q + 1]
                        for comp in range(3):
                            np.add.at(A, (pid, graph.src, comp, cl), -wl[:, comp])
                            np.add.at(A, (pid, graph.src, comp, ct), -wt[:, comp])
                            np.add.at(A, (pid, graph.dst, comp, cl), wl[:, comp])
                            np.add.at(A, (pid, graph.dst, comp, ct), wt[:, comp])
        return A

    def _bond_observations(self, graph, lengths, dF):
        """Raw per-bond stiffness estimates from every probe touching the
        bond: project the induced force on the far endpoint onto the
        longitudinal / transverse parts of the probe displacement."""
        B = graph.size
        kl = np.zeros(B)
        kt = np.zeros(B)
        nl = np.zeros(B)
        nt = np.zeros(B)
        if B == 0:
            return kl, kt
        u = graph.vec / lengths[:, None]
        nsigns = len(self._signs)
        for side, (mover, far) in enumerate(
            ((graph.src, graph.dst), (graph.dst, graph.src))
        ):
            for axis in range(3):
                ua = u[:, axis]
                for si, sgn in enumerate(self._signs):
                    pid = (mover * 3 + axis) * nsigns + si
                    d_long = (sgn * self.delta * ua)[:, None] * u   # (B, 3)
                    d_tran = -d_long.copy()
                    d_tran[:, axis] += sgn * self.delta
                    far_force = dF[pid, far]                         # (B, 3)
                    nrm_l = (d_long * d_long).sum(1)
                    nrm_t = (d_tran * d_tran).sum(1)
                    ok_l = nrm_l > 1e-12
                    ok_t = nrm_t > 1e-12
                    kl[ok_l] += ((far_force * d_long).sum(1) / np.where(
                        ok_l, nrm_l, 1.0))[ok_l]
                    kt[ok_t] += ((far_force * d_tran).sum(1) / np.where(
                        ok_t, nrm_t, 1.0))[ok_t]
                    nl += ok_l
                    nt += ok_t
        with np.errstate(invalid="ignore"):
            return (np.where(nl > 0, kl / np.maximum(nl, 1), np.nan),
                    np.where(nt > 0, kt / np.maximum(nt, 1), np.nan))

    # ------------------------------------------------------------------ compute
    def compute(self) -> "BondStiffness":
        if self.rc_bond is None:
            self.rc_bond = self._shortest_bond_cutoff()
        rc = self.rc_bond
        span = self.max_strain
        strain_samples = (
            np.zeros(1) if self.n_lattice <= 1
            else np.linspace(-span, span, self.n_lattice)
        )

        species = np.asarray(self._sys.data["element"]).astype(str)
        kinds = sorted(set(species.tolist()))
        pair_keys = [
            (a, b) for ai, a in enumerate(kinds) for b in kinds[ai:]
        ]
        pair_rank = {p: k for k, p in enumerate(pair_keys)}
        ncoef = self.poly_order + 1
        shell_stride = 2 * ncoef

        # shells come from the unstrained geometry so every strained sample
        # of a bond lands in the same shell
        eq_graph = _BondGraph(self._strained_copy(1.0), rc)
        self.shells = _partition_shells(eq_graph.length, self.shell_tol)
        centers = np.asarray(self.shells)
        n_shells = len(self.shells)
        pair_stride = n_shells * shell_stride
        n_cols = len(pair_keys) * pair_stride

        blocks_A: List[np.ndarray] = []
        blocks_y: List[np.ndarray] = []
        table: Dict[str, list] = {k: [] for k in (
            "element_a", "element_b", "shell", "r", "strain", "k_long",
            "k_trans")}

        for eps in strain_samples:
            scale = 1.0 + eps
            cfg = self._strained_copy(scale)
            graph = _BondGraph(cfg, rc)
            lengths = graph.length
            shell_id = np.argmin(
                np.abs(lengths[:, None] / scale - centers[None, :]), axis=1
            ) if graph.size else np.zeros(0, np.int64)
            ea = species[graph.src]
            eb = species[graph.dst]
            lo = np.where(ea <= eb, ea, eb)
            hi = np.where(ea <= eb, eb, ea)
            pid = np.array(
                [pair_rank[(a, b)] for a, b in zip(lo, hi)], dtype=np.int64
            ) if graph.size else np.zeros(0, np.int64)
            col_of = pid * pair_stride + shell_id * shell_stride

            dF = self._probe_force_deltas(cfg)
            n_probes = dF.shape[0]
            A = self._design_matrix(
                graph, col_of, lengths, n_probes, cfg.N, n_cols
            )
            blocks_A.append(A.reshape(n_probes * cfg.N * 3, n_cols))
            blocks_y.append(dF.reshape(-1))

            kl_obs, kt_obs = self._bond_observations(graph, lengths, dF)
            table["element_a"].extend(lo.tolist())
            table["element_b"].extend(hi.tolist())
            table["shell"].extend(shell_id.tolist())
            table["r"].extend(lengths.tolist())
            table["strain"].extend([float(eps)] * graph.size)
            table["k_long"].extend(kl_obs.tolist())
            table["k_trans"].extend(kt_obs.tolist())

        coeffs, *_ = np.linalg.lstsq(
            np.concatenate(blocks_A), np.concatenate(blocks_y),
            rcond=self.rcond,
        )
        # layout: (pair, shell, {long, trans}, coef)
        shaped = coeffs.reshape(len(pair_keys), n_shells, 2, ncoef)
        self.k_long = {
            (p[0], p[1], s): shaped[k, s, 0].copy()
            for p, k in pair_rank.items() for s in range(n_shells)
        }
        self.k_trans = {
            (p[0], p[1], s): shaped[k, s, 1].copy()
            for p, k in pair_rank.items() for s in range(n_shells)
        }

        from ..core.frame import AtomFrame

        self.bond_table = AtomFrame({
            "element_a": np.array(table["element_a"], dtype=object),
            "element_b": np.array(table["element_b"], dtype=object),
            "shell": np.array(table["shell"], dtype=np.int32),
            "r": np.array(table["r"], dtype=np.float64),
            "strain": np.array(table["strain"], dtype=np.float64),
            "k_long": np.array(table["k_long"], dtype=np.float64),
            "k_trans": np.array(table["k_trans"], dtype=np.float64),
        })
        return self

    # ------------------------------------------------------------------ outputs
    def write_slspring(self, path: str) -> None:
        """Emit ATAT ``slspring.out``: per element pair, the longitudinal
        then transverse coefficient blocks (count line + one coefficient
        per line); multi-shell runs annotate each block header."""
        if not self.k_long:
            raise RuntimeError("call compute() before write_slspring()")
        multi = len(self.shells) > 1
        chunks: List[str] = []
        for key in sorted(self.k_long):
            ea, eb, shell = key
            header = f"{ea} {eb}"
            if multi:
                header += f"    # shell {shell} d={self.shells[shell]:.4f}"
            chunks.append(header)
            for block in (self.k_long[key], self.k_trans[key]):
                chunks.append(str(len(block)))
                chunks.extend(f"{c:.5f}" for c in block)
        with open(path, "w") as fh:
            fh.write("\n".join(chunks) + "\n")

    def generate_perturbed_structures(self, output_dir: str = "train"):
        """ATAT fitsvsl -f layout: one directory per probe holding
        str_ideal.out / str_unpert.out (reference cell) and str.out (the
        perturbed cell)."""
        os.makedirs(output_dir, exist_ok=True)
        cfg = self._strained_copy(1.0)
        species = np.asarray(cfg.data["element"]).astype(str)
        cell = cfg.box.matrix
        frac_of = np.linalg.inv(cell)

        def atat_lines(pos):
            out = [f"{r[0]:.8f} {r[1]:.8f} {r[2]:.8f}" for r in cell]
            out += ["1 0 0", "0 1 0", "0 0 1"]
            frac = pos @ frac_of
            out += [
                f"{f[0]:.8f} {f[1]:.8f} {f[2]:.8f} {e}"
                for f, e in zip(frac, species)
            ]
            return "\n".join(out) + "\n"

        ideal = atat_lines(cfg.pos)
        probes = []
        for atom in range(cfg.N):
            for axis in range(3):
                for sgn in self._signs:
                    sub = os.path.join(output_dir, f"p{len(probes):05d}")
                    os.makedirs(sub, exist_ok=True)
                    with open(os.path.join(sub, "str_ideal.out"), "w") as fh:
                        fh.write(ideal)
                    with open(os.path.join(sub, "str_unpert.out"), "w") as fh:
                        fh.write(ideal)
                    moved = cfg.pos.copy()
                    moved[atom, axis] += sgn * self.delta
                    with open(os.path.join(sub, "str.out"), "w") as fh:
                        fh.write(atat_lines(moved))
                    probes.append((atom, axis, int(sgn)))
        return probes

    def plot(self, which: str = "both", ax=None, ncol: Optional[int] = None):
        """Stiffness-vs-bond-length panels, one per element pair: raw
        per-bond observations as scatter, fitted polynomials as curves."""
        if self.bond_table is None:
            raise RuntimeError("call compute() before plot()")
        if which not in ("both", "long", "trans"):
            raise ValueError("which must be 'both', 'long' or 'trans'")
        import matplotlib.pyplot as plt

        ea = np.asarray(self.bond_table["element_a"]).astype(str)
        eb = np.asarray(self.bond_table["element_b"]).astype(str)
        r = np.asarray(self.bond_table["r"])
        obs = {
            "long": np.asarray(self.bond_table["k_long"]),
            "trans": np.asarray(self.bond_table["k_trans"]),
        }
        fits = {"long": self.k_long, "trans": self.k_trans}
        marker = {"long": "o", "trans": "s"}
        style = {"long": "-", "trans": "--"}
        channels = ("long", "trans") if which == "both" else (which,)
        sh = np.asarray(self.bond_table["shell"])
        pairs = sorted(set(zip(ea, eb)))
        ncol = min(3, len(pairs)) if ncol is None else ncol
        nrow = -(-len(pairs) // ncol)
        fig, axes = plt.subplots(nrow, ncol, squeeze=False,
                                 figsize=(4 * ncol, 3 * nrow))
        axes = axes.ravel()
        for panel, (a, b) in zip(axes, pairs):
            sel = (ea == a) & (eb == b)
            for s in sorted(set(sh[sel].tolist())):
                here = sel & (sh == s)
                grid = (np.linspace(r[here].min(), r[here].max(), 50)
                        if here.any() else None)
                for ch in channels:
                    panel.plot(r[here], obs[ch][here], marker[ch], ms=3,
                               label=f"NN{s + 1} {ch}")
                    coef = fits[ch].get((a, b, int(s)))
                    if grid is not None and coef is not None:
                        curve = sum(c * grid ** q for q, c in enumerate(coef))
                        panel.plot(grid, curve, style[ch], lw=1)
            panel.set_xlabel(r"bond length ($\AA$)")
            panel.set_ylabel(r"stiffness (eV/$\AA^2$)")
            panel.set_title(f"{a}-{b}")
            panel.legend(fontsize=7)
        for panel in axes[len(pairs):]:
            panel.set_visible(False)
        return fig, axes
