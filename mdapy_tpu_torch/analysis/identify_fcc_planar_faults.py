"""Classify planar defects in FCC crystals from PTM output.

A host numpy copy of ``mdapy_tpu/analysis/identify_fcc_planar_faults.py``
(:1-126, whole): its refinement loop visits the hcp atoms in order, each
reading the codes the earlier ones set, in the JAX package too.
Fault types: 0 non-hcp, 1 isolated hcp-like, 2 intrinsic stacking fault,
3 coherent twin boundary, 4 multi-layer fault, 5 extrinsic stacking fault.

Uses the PTM hcp-template-ordered neighbour lists. With this package's hcp
template, neighbour positions 0-5 are basal (in-plane), 6-8 the layer below,
9-11 the layer above.
"""

from __future__ import annotations

import numpy as np

__all__ = ["IdentifyFccPlanarFaults"]

_BASAL = np.array([0, 1, 2, 3, 4, 5])
_OUT_NEG = np.array([6, 7, 8])
_OUT_POS = np.array([9, 10, 11])
_OUT_ALL = np.array([6, 7, 8, 9, 10, 11])


class IdentifyFccPlanarFaults:
    def __init__(self, structure_types, ptm_indices, identify_esf: bool = True):
        self.structure_types = np.asarray(structure_types, dtype=np.int32)
        self.ptm_indices = np.asarray(ptm_indices, dtype=np.int64)
        self.identify_esf = identify_esf
        self.fault_types = None

    def compute(self):
        st = self.structure_types
        pi = self.ptm_indices
        fault = np.zeros_like(st)
        hcp_idx = np.where(st == 2)[0]
        n_hcp = len(hcp_idx)
        self.fault_types = fault
        if n_hcp == 0:
            return self

        # hcp neighbour map: >=0 -> row in hcp_idx; <0 -> encoded atom index
        nbr = pi[hcp_idx]  # (n_hcp, 12)
        is_hcp_nbr = st[nbr] == 2
        rows = np.searchsorted(hcp_idx, nbr)
        rows = np.clip(rows, 0, n_hcp - 1)
        hcp_neigh = np.where(is_hcp_nbr, rows, -nbr - 1).astype(np.int64)

        basal_sets = hcp_neigh[:, _BASAL]  # (n_hcp, 6)

        def stacked(i_rows, n_rows):
            """True where hcp pairs share no basal-set entries (eclipsed)."""
            a = basal_sets[i_rows][:, :, None]
            b = basal_sets[n_rows][:, None, :]
            return ~np.any(a == b, axis=(1, 2))

        # --- initial classification -----------------------------------
        n_basal = is_hcp_nbr[:, _BASAL].sum(axis=1)
        n_pos = np.zeros(n_hcp, int)
        n_neg = np.zeros(n_hcp, int)
        for cols, acc in ((_OUT_POS, n_pos), (_OUT_NEG, n_neg)):
            for c in cols:
                sel = is_hcp_nbr[:, c]
                i_rows = np.where(sel)[0]
                if len(i_rows) == 0:
                    continue
                n_rows = hcp_neigh[i_rows, c]
                ok = stacked(i_rows, n_rows)
                acc[i_rows[ok]] += 1
        nbr_types = st[nbr]
        fcc_nbr = nbr_types == 1
        n_fcc_pos = (fcc_nbr[:, _OUT_POS] & ~is_hcp_nbr[:, _OUT_POS]).sum(axis=1)
        n_fcc_neg = (fcc_nbr[:, _OUT_NEG] & ~is_hcp_nbr[:, _OUT_NEG]).sum(axis=1)

        ft = np.ones(n_hcp, dtype=np.int32)  # isolated by default
        isf = ((n_pos != 0) & (n_neg == 0)) | ((n_pos == 0) & (n_neg != 0))
        tb = (~isf) & (n_basal >= 1) & (n_pos == 0) & (n_neg == 0) & \
             (n_fcc_pos != 0) & (n_fcc_neg != 0)
        multi = (~isf) & (~tb) & (n_pos != 0) & (n_neg != 0)
        ft[isf] = 2
        ft[tb] = 3
        ft[multi] = 4
        fault[hcp_idx] = ft

        # --- sequential refinement ------------------------------------
        for i in range(n_hcp):
            a = hcp_idx[i]
            code = fault[a]
            if code == 3 or code == 1:
                n_isf = n_twin = 0
                for c in _BASAL:
                    ni = hcp_neigh[i, c]
                    if ni >= 0 and is_hcp_nbr[i, c]:
                        nf = fault[hcp_idx[ni]]
                        if nf == 2:
                            n_isf += 1
                        elif nf == 3:
                            n_twin += 1
                if n_isf != 0 and n_twin == 0:
                    fault[a] = 2
                elif n_isf == 0 and n_twin != 0:
                    fault[a] = 3
            elif code == 4:
                for c in _OUT_ALL:
                    ni = hcp_neigh[i, c]
                    if ni >= 0 and is_hcp_nbr[i, c]:
                        na = hcp_idx[ni]
                        if fault[na] == 2:
                            fault[na] = 4

        # --- extrinsic stacking faults --------------------------------
        if self.identify_esf:
            tb_rows = np.where(fault[hcp_idx] == 3)[0]
            for i in tb_rows:
                a = hcp_idx[i]
                for j in pi[a]:
                    if st[j] != 1:
                        continue
                    second = st[pi[j]]
                    fcc_count = int((second == 1).sum())
                    hcp_count = int((second == 2).sum())
                    if 5 <= fcc_count <= 6 and 5 <= hcp_count <= 6:
                        fault[a] = 5
                        break

        self.fault_types = fault
        return self
