"""Pair-field machinery for the potentials' force path.

The port of ``mdapy_tpu/potentials/pairops.py``: ``reverse_permutation``
(:42), ``reverse_permutation_device`` (:71) and ``pair_forces_virials``
(:124).  Per-atom energies depend on positions only through each atom's own
displacement rows disp[i, m] = min_image(pos[j_im] - pos[i]), so one
backward pass of sum(E) with respect to the (N, M) displacement components
gives every pair gradient J = dE/d(disp) with dense work and no scatter-add
into (N, 3).  Forces then assemble from J by a *gather* through the
reverse-pair permutation: for a full (symmetric) Verlet list, pair (i, m)
with j = verlet[i, m] appears once in j's row as (j, rev[i, m]):

    F_i = sum_m J[i, m]  -  sum_m J[verlet[i,m], rev[i,m]]

and per-atom virials take the half-pair convention

    v_i = -0.5 * sum_m [ disp_im (x) (J_im - Jrev_im) ]

which sums to the exact global virial -sum_pairs disp (x) J.  Every output
is a row sum: gathers, never scatter-adds, so the card gives the same
forces on every run.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["reverse_permutation", "reverse_permutation_device",
           "pair_forces_virials"]


def reverse_permutation(verlet: np.ndarray) -> np.ndarray:
    """rev[i, m] = m' such that verlet[verlet[i, m], m'] == i, on the host.

    Padded slots (verlet < 0) get rev = 0 (the caller masks them with
    verlet >= 0).  Raises if the list is not symmetric."""
    n, M = verlet.shape
    i = np.repeat(np.arange(n, dtype=np.int64), M)
    j = verlet.reshape(-1).astype(np.int64)
    valid = j >= 0
    code = np.where(valid, i * n + j, -1)
    target = np.where(valid, j * n + i, -1)
    order = np.argsort(code, kind="stable")
    sorted_code = code[order]
    pos = np.searchsorted(sorted_code, target)
    pos = np.clip(pos, 0, len(sorted_code) - 1)
    hit = sorted_code[pos] == target
    if not bool(np.all(hit | ~valid)):
        bad = int(np.sum(valid & ~hit))
        raise ValueError(
            f"neighbor list is not symmetric: {bad} pairs have no reverse "
            "entry (did capacity overflow truncate rows?)"
        )
    partner = order[pos]  # flat pair index i'*M + m' of the reverse pair
    rev = np.where(valid, partner % M, 0).astype(np.int32)
    return rev.reshape(n, M)


def reverse_permutation_device(verlet: torch.Tensor):
    """rev[i, m] (see ``reverse_permutation``) on the device, by sort ranks.

    Every pair slot is sorted by its forward key i*N + j and, apart, by its
    reverse key j*N + i.  A symmetric list makes the two key multisets
    equal, so equal sorted ranks are reverse-pair partners.  Invalid (-1)
    slots get unique tail keys, equal in both orders, and pair with
    themselves.  Returns (rev (N, M) int64, bad): ``bad``, a device scalar,
    counts the ranks whose keys differ (0 for a symmetric list)."""
    n, M = verlet.shape
    flat = verlet.reshape(-1).long()
    ok = flat >= 0
    p = torch.arange(n * M, device=verlet.device)
    i = p // M
    tail = n * n + p
    fwd = torch.where(ok, i * n + flat, tail)
    back = torch.where(ok, flat * n + i, tail)
    fkey, of = torch.sort(fwd)
    rkey, orr = torch.sort(back)
    bad = (fkey != rkey).sum()
    rev = torch.empty_like(p)
    rev[orr] = of % M          # orr is a permutation: a plain write, no adds
    return torch.where(ok, rev, 0).reshape(n, M), bad


def pair_forces_virials(disp, J, verlet, rev, ok):
    """Assemble (forces (N, 3), per-atom virials (N, 9), dE/deps (3, 3)).

    disp, J: 3-tuples of (N, M) component tensors; verlet, rev: (N, M);
    ok: (N, M) bool.  All gathers and row sums."""
    M = verlet.shape[1]
    # reverse-pair gradient rows Jrev[i, m] = J[j, rev[i, m]], one flat
    # gather per component
    flat = torch.clamp(verlet.long(), min=0) * M + rev
    Jm = tuple(torch.where(ok, c, 0.0) for c in J)
    Jrev = tuple(torch.where(ok, c.reshape(-1)[flat], 0.0) for c in Jm)
    # force on atom i from pair (i, m): f_im = J_im - Jrev_im
    pairf = tuple(a - b for a, b in zip(Jm, Jrev))
    force = torch.stack([c.sum(dim=1) for c in pairf], dim=-1)
    dm = tuple(torch.where(ok, c, 0.0) for c in disp)
    v = torch.stack([-0.5 * (dm[a] * pairf[b]).sum(dim=1)
                     for a in range(3) for b in range(3)], dim=-1)
    dEdeps = torch.stack([(dm[a] * Jm[b]).sum()
                          for a in range(3) for b in range(3)]).reshape(3, 3)
    return force, v, dEdeps
