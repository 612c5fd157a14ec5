"""General helpers: PKA initialisation, Maxwell-Boltzmann velocities, and
multi-frame XYZ splitting.

The port of ``mdapy_tpu/utils/tool_function.py`` (:1-196): host copies of
``sort_neighbor``, ``wrap_pos``, ``replicate``, ``set_pka`` and
``split_xyz``; ``average_by_neighbor`` builds its neighbor list and sums
its rows on ``device`` (the card by default); ``generate_velocity`` draws
from ``np.random.RandomState(seed)`` where the JAX package seeds the global
generator (:141-142): the same draws, and the global state left alone.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..core.elements import atomic_masses, atomic_numbers

__all__ = [
    "set_pka",
    "generate_velocity",
    "split_xyz",
    "sort_neighbor",
    "average_by_neighbor",
    "wrap_pos",
    "replicate",
]


def sort_neighbor(verlet_list, distance_list, neighbor_number, k: int):
    """Sort each atom's first ``k`` neighbors ascending by distance,
    in place (reference tool_function.py:75 / neighbor.cpp:745)."""
    min_n = int(np.min(neighbor_number))
    assert min_n >= k, f"The min neighbor number {min_n} is lower than k {k}."
    order = np.argsort(distance_list[:, :k], axis=1, kind="stable")
    rows = np.arange(verlet_list.shape[0])[:, None]
    verlet_list[:, :k] = verlet_list[rows, order]
    distance_list[:, :k] = distance_list[rows, order]


def average_by_neighbor(pos, box, prop, average_rc: float,
                        include_self: bool = True, device="cuda") -> np.ndarray:
    """Neighborhood average of a per-atom property (reference
    tool_function.py:14 / neighbor.cpp:704), the list and the row sums on
    ``device``."""
    import torch

    from ..core.device import resolve_device
    from ..neighbor.neighbor import neighbor_tensors

    device = resolve_device(device, "average_by_neighbor")
    verlet, _, _ = neighbor_tensors(np.asarray(pos, np.float64), box,
                                    float(average_rc), device=device)
    prop = torch.as_tensor(np.asarray(prop, np.float64), device=device)
    valid = verlet >= 0
    j = torch.where(valid, verlet, 0).long()
    s = torch.where(valid, prop[j], 0.0).sum(dim=1)
    cnt = valid.sum(dim=1).double()
    if include_self:
        s = s + prop
        cnt = cnt + 1.0
    return (s / torch.clamp(cnt, min=1.0)).cpu().numpy()


def wrap_pos(pos, box) -> np.ndarray:
    """Wrap positions into the periodic box (reference tool_function.py:122)."""
    from ..core.box import init_box, wrap_positions

    box = init_box(box)
    return wrap_positions(np.asarray(pos, np.float64), box.matrix,
                          box.inverse_box, box.origin, box.boundary)


def replicate(pos, box, nx: int = 1, ny: int = 1, nz: int = 1):
    """Replicate positions/box (reference tool_function.py:141).
    Returns (pos_rep, box_rep)."""
    from ..core.box import init_box

    box = init_box(box)
    pos = np.asarray(pos, np.float64)
    shifts = [
        ix * box.matrix[0] + iy * box.matrix[1] + iz * box.matrix[2]
        for ix in range(nx) for iy in range(ny) for iz in range(nz)
    ]
    pos_rep = (pos[None] + np.asarray(shifts)[:, None]).reshape(-1, 3)
    return pos_rep, box.replicate(nx, ny, nz)

_EV_AMU_TO_A_FS = 10.18051  # sqrt(2E/m) in these units -> A/fs divisor


def set_pka(system, energy: float, direction, index: Optional[int] = None,
            element: Optional[str] = None) -> None:
    """Give one atom (the primary knock-on atom) a velocity of the given
    kinetic energy (eV) along ``direction``, then remove the centre-of-mass
    drift. Velocities are in A/fs. Operates on ``system`` in place."""
    data = system.data
    for col in ("x", "y", "z", "element", "vx", "vy", "vz"):
        if col not in data:
            raise ValueError(f"Must include '{col}' column in data.")
    direction = np.asarray(direction, dtype=float)
    if direction.shape != (3,):
        raise ValueError("Direction must be a 3D vector.")

    elems = np.asarray(data["element"]).astype(str)
    if "amass" in data:
        amass = np.asarray(data["amass"], dtype=float)
    else:
        for e in set(elems.tolist()):
            if e not in atomic_numbers:
                raise ValueError(f"Unknown element '{e}' in atomic_numbers.")
        amass = np.array([atomic_masses[atomic_numbers[e]] for e in elems])

    pos = system.pos
    if index is None:
        center = system.box.matrix.T @ np.array([0.5, 0.5, 0.5]) + system.box.origin
        d2 = np.sum((pos - center) ** 2, axis=1)
        if element is None:
            index = int(np.argmin(d2))
        else:
            if element not in set(elems.tolist()):
                raise ValueError(f"Element '{element}' not in data.")
            cand = np.where(elems == element)[0]
            index = int(cand[np.argmin(d2[cand])])
    else:
        if index < 0 or index >= system.N:
            raise ValueError(f"Index {index} out of bounds.")
        if element is not None and elems[index] != element:
            raise ValueError(f"Element at index {index} is not '{element}'.")

    speed = np.sqrt(2.0 * energy / amass[index])
    newv = speed * direction / np.linalg.norm(direction) / _EV_AMU_TO_A_FS

    vx = np.asarray(data["vx"], dtype=float).copy()
    vy = np.asarray(data["vy"], dtype=float).copy()
    vz = np.asarray(data["vz"], dtype=float).copy()
    vx[index], vy[index], vz[index] = newv
    total = amass.sum()
    vx -= (amass * vx).sum() / total
    vy -= (amass * vy).sum() / total
    vz -= (amass * vz).sum() / total
    data["vx"], data["vy"], data["vz"] = vx, vy, vz
    return index


def generate_velocity(N: int, mass, temperature: float, remove_com: bool = True,
                      seed: Optional[int] = None) -> np.ndarray:
    """Maxwell-Boltzmann velocities at ``temperature`` K (mass in g/mol,
    output in A/fs). Parity: tool_function.py:350."""
    rng = np.random.RandomState(seed)
    mass = np.atleast_1d(np.asarray(mass, dtype=float))
    if mass.size == 1:
        mass = np.full(N, mass[0])
    elif mass.size != N:
        raise ValueError(f"Mass array size {mass.size} doesn't match N={N}")
    kb = 1.380649e-23
    afu = 6.022140857e23
    mass_kg = mass / (afu * 1000.0)
    sigma = np.sqrt(kb * temperature / mass_kg) * 1e-5  # m/s -> A/fs
    vel = rng.normal(0.0, sigma[:, None], size=(N, 3))
    if remove_com:
        vel -= (vel * mass[:, None]).sum(axis=0) / mass.sum()
    return vel


def split_xyz(input_file: str, output_dir: str = "res",
              output_prefix: Optional[str] = None,
              in_memory: bool = True) -> None:
    """Split a multi-frame XYZ file into per-frame files
    ``{prefix}.{frame:06d}.xyz``."""
    if output_prefix is None:
        output_prefix = os.path.splitext(os.path.basename(input_file))[0]
    os.makedirs(output_dir, exist_ok=True)
    if in_memory:
        with open(input_file) as f:
            lines = f.read().splitlines(keepends=True)
        i, frame = 0, 0
        while i < len(lines):
            if not lines[i].strip():
                i += 1
                continue
            n = int(lines[i].split()[0])
            out = os.path.join(output_dir, f"{output_prefix}.{frame:0>6d}.xyz")
            with open(out, "w") as g:
                g.writelines(lines[i : i + 2 + n])
            i += 2 + n
            frame += 1
    else:
        with open(input_file) as f:
            frame = 0
            while True:
                line = f.readline()
                if not line:
                    break
                if not line.strip():
                    continue
                n = int(line.split()[0])
                out = os.path.join(output_dir,
                                   f"{output_prefix}.{frame:0>6d}.xyz")
                with open(out, "w") as g:
                    g.write(line)
                    for _ in range(n + 1):
                        g.write(f.readline())
                frame += 1
