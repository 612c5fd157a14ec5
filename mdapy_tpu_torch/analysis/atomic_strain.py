"""Per-atom Green-Lagrange strain between two configurations (Shimizu,
Ogata and Li).

The port of ``mdapy_tpu/analysis/atomic_strain.py`` (``_strain`` :52): V =
sum dref dref^T, W = sum dref dcur^T (V[m,n] += ref[n] ref[m]), F = (W
V^-1)^T, eps = (F^T F - I) / 2, the von Mises shear and the hydrostatic
volumetric strain, with the optional affine remap of the current cell.  V
is inverted by the batched ``torch.linalg.inv_ex``, which, as ``jnp.linalg.inv``
on the CPU, leaves inf and nan for a singular V and does not raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.box import Box
from ..core.device import resolve_device
from .common import min_image

__all__ = ["AtomicStrain"]


class AtomicStrain:
    """``ref`` and ``current`` are system objects with ``N``, ``pos``,
    ``box`` and ``data``; ``ref`` also has ``build_neighbor(rc, max_neigh)``
    and the ``verlet_list`` it builds.  ``device`` is "cuda" (default) or
    "cpu"."""

    def __init__(self, rc: float, ref, affine: bool = False, max_neigh=None,
                 device="cuda"):
        self.ref = ref
        self.rc = float(rc)
        self.affine = bool(affine)
        self.device = resolve_device(device, "AtomicStrain")
        self.ref.build_neighbor(self.rc, max_neigh)

    def compute(self, current):
        if current.N != self.ref.N:
            raise ValueError(f"current has {current.N} atoms, the reference "
                             f"{self.ref.N}")
        dev = self.device
        cur_pos = np.asarray(current.pos, dtype=np.float64)
        cur_box = current.box
        if self.affine:
            map_matrix = np.linalg.solve(cur_box.matrix, self.ref.box.matrix)
            cur_pos = cur_pos @ map_matrix
            cur_box = Box(self.ref.box)

        def t(a):
            return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)

        shear, vol = _strain(
            torch.as_tensor(self.ref.verlet_list, device=dev),
            t(self.ref.pos), t(cur_pos),
            t(self.ref.box.matrix), t(self.ref.box.inverse_box),
            t(cur_box.matrix), t(np.linalg.inv(cur_box.matrix)),
            t(self.ref.box.boundary))
        self.shear_strain = shear.cpu().numpy()
        self.volumetric_strain = vol.cpu().numpy()
        current.data["shear_strain"] = self.shear_strain
        current.data["volumetric_strain"] = self.volumetric_strain
        return self


def _strain(verlet, ref_pos, cur_pos, ref_m, ref_inv, cur_m, cur_inv, bnd):
    ok = (verlet >= 0)[..., None]
    j = verlet.clamp(min=0).long()
    dref = min_image(ref_pos[j] - ref_pos[:, None, :], ref_m, ref_inv, bnd)
    dcur = min_image(cur_pos[j] - cur_pos[:, None, :], cur_m, cur_inv, bnd)
    dref = torch.where(ok, dref, 0.0)
    dcur = torch.where(ok, dcur, 0.0)
    # V[m,n] = sum ref[n]*ref[m]; W[m,n] = sum ref[n]*cur[m]
    V = torch.einsum("ijn,ijm->imn", dref, dref)
    W = torch.einsum("ijn,ijm->imn", dref, dcur)
    F = (W @ torch.linalg.inv_ex(V).inverse).transpose(1, 2)
    eps = 0.5 * (F.transpose(1, 2) @ F
                 - torch.eye(3, dtype=F.dtype, device=F.device)[None])
    exx, eyy, ezz = eps[:, 0, 0], eps[:, 1, 1], eps[:, 2, 2]
    exy, exz, eyz = eps[:, 0, 1], eps[:, 0, 2], eps[:, 1, 2]
    shear = torch.sqrt(
        exy**2 + exz**2 + eyz**2
        + ((exx - eyy) ** 2 + (exx - ezz) ** 2 + (eyy - ezz) ** 2) / 6.0)
    volumetric = (exx + eyy + ezz) / 3.0
    return shear, volumetric
