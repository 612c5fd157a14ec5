"""Scene assembly: world-space primitives -> flipped, padded torch tensors.

Port of ``mdapy_tpu/render/scene.py`` (``Scene`` :41, ``build_scene`` :96,
``scene_from_arrays`` :185, ``_pad_to`` :28, ``_round_up`` :35): one sphere
per particle, and for every
bond or box edge a cylinder plus two ring caps (``add_edges`` :132).  All
coordinates are z-flipped into Tachyon space (tvec, tachyon_render.h:58), and
each kind is padded to a multiple of ``pad`` (cylinders and rings to at least
one pad block) with radius -1 slots that no ray can hit, exactly as the JAX
package pads them; the cylinder axes pad with 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing

__all__ = ["Scene", "build_scene", "scene_from_arrays"]

FLIP = np.array([1.0, 1.0, -1.0])


def _pad_to(arr: np.ndarray, n: int, fill: float = 0.0) -> np.ndarray:
    if arr.shape[0] == n:
        return arr
    pad = np.full((n - arr.shape[0],) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


@dataclass
class Scene:
    """Padded primitive tensors in flipped (Tachyon) space, on one device."""

    sph_center: torch.Tensor   # (Ns, 3)
    sph_radius: torch.Tensor   # (Ns,)   (-1 padding)
    sph_color: torch.Tensor    # (Ns, 4)
    cyl_base: torch.Tensor     # (Nc, 3)
    cyl_axis: torch.Tensor     # (Nc, 3) unnormalized, |axis| = length (1 padding)
    cyl_radius: torch.Tensor   # (Nc,)   (-1 padding)
    cyl_color: torch.Tensor    # (Nc, 4)
    ring_center: torch.Tensor  # (Nr, 3)
    ring_normal: torch.Tensor  # (Nr, 3) unit (1 padding)
    ring_rout: torch.Tensor    # (Nr,)   (-1 padding)
    ring_color: torch.Tensor   # (Nr, 4)


def build_scene(
    positions: np.ndarray,
    colors: np.ndarray,
    radii: np.ndarray,
    bond_edges=None,
    bond_colors=None,
    bond_radius: float = 0.1,
    box_edges=None,
    box_edge_radius: float = 0.05,
    box_color=(1.0, 1.0, 1.0, 1.0),
    dtype: torch.dtype = torch.float32,
    pad: int = 256,
    device="cuda",
) -> Scene:
    """One sphere per particle with alpha > 0 (tachyon_render.h:302-305), an
    fcylinder plus two ring caps per bond or box edge (caps at both ends,
    normals along -axis and +axis); z-flipped and padded to a multiple of
    ``pad``, on ``device``: the card unless the caller asks for the CPU
    (``device="cpu"``), whose tensors take the kernels' plain versions."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "build_scene(device='cuda') needs a CUDA device, and "
            "torch.cuda.is_available() is False; pass device='cpu' to build "
            "the scene for the plain torch versions on the CPU")
    positions = np.asarray(positions, dtype=np.float64) * FLIP
    colors = np.asarray(colors, dtype=np.float64)
    radii = np.asarray(radii, dtype=np.float64)

    # zero-alpha particles are skipped by the reference (tachyon_render.h:305)
    keep = colors[:, 3] > 0.0
    # per kind: [centre or base, axis or normal, radius, rgba] pieces, in
    # the order the edges are added
    cyl = [[np.zeros((0, 3))], [np.zeros((0, 3))], [np.zeros(0)], [np.zeros((0, 4))]]
    ring = [[np.zeros((0, 3))], [np.zeros((0, 3))], [np.zeros(0)], [np.zeros((0, 4))]]

    def add_edges(edges, ecolors, radius):
        edges = np.asarray(edges, dtype=np.float64) * FLIP
        a = edges[:, 0]
        b = edges[:, 1]
        axis = b - a
        ok = np.linalg.norm(axis, axis=1) > 1e-12
        a, b, axis, ecolors = a[ok], b[ok], axis[ok], ecolors[ok]
        unit = axis / np.linalg.norm(axis, axis=1)[:, None]
        k = a.shape[0]
        for lst, new in zip(cyl, (a, axis, np.full(k, radius), ecolors)):
            lst.append(new)
        # ring caps: at a with normal -axis, at b with normal +axis
        for lst, new in zip(ring, (a, -unit, np.full(k, radius), ecolors)):
            lst.append(new)
        for lst, new in zip(ring, (b, unit, np.full(k, radius), ecolors)):
            lst.append(new)

    if bond_edges is not None and len(bond_edges):
        k = len(bond_edges)
        if bond_colors is None:
            bond_colors = np.tile(np.array([0.8, 0.8, 0.8, 1.0]), (k, 1))
        bc = np.asarray(bond_colors, dtype=np.float64)
        sel = bc[:, 3] > 0.0
        add_edges(np.asarray(bond_edges)[sel], bc[sel], float(bond_radius))
    if box_edges is not None and len(box_edges):
        k = len(box_edges)
        col = np.tile(np.asarray(box_color, dtype=np.float64), (k, 1))
        add_edges(np.asarray(box_edges), col, float(box_edge_radius))
    cyl = [np.concatenate(lst, axis=0) for lst in cyl]
    ring = [np.concatenate(lst, axis=0) for lst in ring]

    ns = _round_up(int(keep.sum()), pad)
    nc = _round_up(len(cyl[0]), pad) if len(cyl[0]) else pad
    nr = _round_up(len(ring[0]), pad) if len(ring[0]) else pad
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def put(a, n, fill=0.0):
        t = torch.from_numpy(
            np.ascontiguousarray(_pad_to(a, n, fill).astype(np_dtype))
        ).to(device)
        tracing.count("scene.upload_bytes", t.nbytes)
        return t

    return Scene(
        sph_center=put(positions[keep], ns),
        sph_radius=put(radii[keep], ns, fill=-1.0),
        sph_color=put(colors[keep], ns),
        cyl_base=put(cyl[0], nc),
        cyl_axis=put(cyl[1], nc, fill=1.0),
        cyl_radius=put(cyl[2], nc, fill=-1.0),
        cyl_color=put(cyl[3], nc),
        ring_center=put(ring[0], nr),
        ring_normal=put(ring[1], nr, fill=1.0),
        ring_rout=put(ring[2], nr, fill=-1.0),
        ring_color=put(ring[3], nr),
    )


def scene_from_arrays(positions, colors, radii, dtype=None,
                      device=None) -> Scene:
    """A sphere-only Scene built with torch ops, for the differentiable path.

    Unlike ``build_scene`` (host numpy, filtering and padding), nothing
    leaves the autograd graph, so gradients flow from pixels back to
    ``positions`` (N, 3), ``radii`` (N,) and ``colors`` (N, 4).  The scene
    lies on ``device``; by default that is the device of ``positions`` when
    it is a tensor, and otherwise the card, so a CPU scene from numpy
    arrays takes ``device="cpu"``.  ``dtype`` casts the positions, and the
    rest follow them.  The cylinder and ring slots are 8 dummy rows of
    radius -1."""
    if device is None:
        device = (positions.device if isinstance(positions, torch.Tensor)
                  else "cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "scene_from_arrays on the card needs a CUDA device, and "
            "torch.cuda.is_available() is False; pass device='cpu' (or CPU "
            "tensors) to build the scene on the CPU")
    pos = torch.as_tensor(positions, device=device)
    if dtype is not None:
        pos = pos.to(dtype)
    dt, dev = pos.dtype, pos.device
    pos = pos * torch.as_tensor(FLIP, dtype=dt, device=dev)
    col = torch.as_tensor(colors, device=dev).to(dt)
    rad = torch.as_tensor(radii, device=dev).to(dt)
    k = 8

    def full(shape, v):
        return torch.full(shape, v, dtype=dt, device=dev)

    return Scene(
        sph_center=pos, sph_radius=rad, sph_color=col,
        cyl_base=full((k, 3), 0.0), cyl_axis=full((k, 3), 1.0),
        cyl_radius=full((k,), -1.0), cyl_color=full((k, 4), 0.0),
        ring_center=full((k, 3), 0.0), ring_normal=full((k, 3), 1.0),
        ring_rout=full((k,), -1.0), ring_color=full((k, 4), 0.0),
    )
