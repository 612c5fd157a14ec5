"""TachyonRender — user-facing renderer front end on PyTorch.

Port of ``mdapy_tpu/render/render.py`` (``TachyonRender`` :75, ``render``
:164) restricted to the ported slice: opaque spheres, one directional light
with shadows, AA, and the fast ambient occlusion of scenes above
``AO_EXACT_MAX_SPHERES`` padded spheres.  ``backend="cuda"`` runs the
acceleration builds as torch ops on the card and the frame through the hand
CUDA kernel; ``backend="cpu"`` runs the same builds on the CPU and the
kernel's plain torch version, in float32.

Fast AO (``render.py:551-637``): 2*K2 directional sky lights, K2 =
ao_samples // 2 Fibonacci hemisphere directions and their opposites, each
with its own light-grid CSR records, join the primary light in the same
launch, so one closest-hit traversal serves them all.  Their structures are
world-space and keyed by the scene alone, so a camera move reuses them.

What the slice does not cover raises ``NotImplementedError`` naming the
ROADMAP item that brings it: AO on scenes of at most
``AO_EXACT_MAX_SPHERES`` padded spheres (the exact tracer, A6), bond and
box-edge cylinders (B1d), alpha < 1 (B1e), and candidate records past the
memory budget (B1f).
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch

from .accel import build_light_bins, build_light_records, build_screen_bins
from .camera import CameraParams, auto_camera, camera_frame
from .config import RenderConfig, quantize
from .gather import gather_chunk_data
from .megakernel import (
    TILE_PX, build_mega_params, light_row, render_image_mega, stack_lights,
)
from .scene import build_scene

__all__ = ["TachyonRender", "CameraParams", "build_ao_lights", "save_image"]

LIGHT_GRID = 32        # shadow grid cells per side, as the JAX renderer uses
# bytes of (nb, nchunks, 8, 128) f32 candidate records one frame may gather;
# past it the banded variant (ROADMAP B1f) is needed
RECORD_BUDGET_BYTES = 16 << 30
# padded sphere counts up to this take the exact AO tracer (ROADMAP A6) in
# the JAX renderer; fast AO applies above it (render.py:329-333)
AO_EXACT_MAX_SPHERES = 20000


def _fib_hemisphere(k: int) -> np.ndarray:
    """k stratified unit directions on the upper hemisphere (Fibonacci)."""
    i = np.arange(k, dtype=np.float64) + 0.5
    phi = i * (np.pi * (3.0 - np.sqrt(5.0)))
    z = i / k
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def build_ao_lights(scene, ao_samples: int, ao_brightness: float,
                    rmax: float, grid: int = LIGHT_GRID) -> list:
    """The fast-AO sky lights as ``stack_lights`` extra entries
    ``(lrow, lrec, loffs, lcnt, lkmax)``: the K2 = ao_samples // 2 hemisphere
    directions, then their opposites, each of weight 4 / (2 K2) *
    ao_brightness (``render.py:569-626``)."""
    k2 = max(1, int(ao_samples) // 2)
    hemi = _fib_hemisphere(k2)
    lightcol = (4.0 / (2 * k2)) * float(ao_brightness)
    lights = []
    for dk in np.concatenate([hemi, -hemi], axis=0):
        lb = build_light_bins(scene, dk, grid=grid)
        lrec = build_light_records(lb, scene)
        lights.append((light_row(dk, lb, lightcol, rmax), *lrec))
    return lights


def save_image(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def _fingerprint(h, a: np.ndarray) -> None:
    """Feed a sample of ``a`` to the hash: head, tail and a ~256 KB stride
    sample (the JAX renderer's cache key; an in-place edit that misses every
    sampled byte is the documented hazard)."""
    b = a.reshape(-1).view(np.uint8)
    h.update(b[:4096])
    h.update(b[-4096:])
    h.update(np.ascontiguousarray(b[::max(1, b.size // 262144)]))
    h.update(str(a.shape).encode())


class TachyonRender:
    """Ray tracer with the reference renderer's look, on PyTorch.

    Parameters mirror ``mdapy_tpu.TachyonRender``; ``backend`` is "cuda"
    (the hand kernel; raises when no card is visible) or "cpu" (plain torch
    versions, f32)."""

    def __init__(
        self,
        backend: str = "cuda",
        antialiasing: bool = True,
        aa_samples: int = 12,
        ao: bool = True,
        ao_samples: int = 12,
        ao_brightness: float = 0.8,
        ao_max_dist: float = 3.402823e38,
        shadows: bool = True,
        direct_light_intensity: float = 0.9,
        background: tuple = (0.0, 0.0, 0.0),
        seed: int = 0,
    ):
        backend = backend.lower().strip()
        if backend not in ("cuda", "cpu"):
            raise ValueError(f"backend must be 'cuda' or 'cpu', got {backend!r}")
        if backend == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TachyonRender(backend='cuda') needs a CUDA device, and "
                "torch.cuda.is_available() is False"
            )
        self._backend = backend
        self._device = torch.device("cuda" if backend == "cuda" else "cpu")
        bg = tuple(float(v) for v in background)
        self._bg_a = bg[3] if len(bg) > 3 else 1.0
        self._cfg = RenderConfig(
            aa_samples=int(aa_samples),
            aa_enabled=bool(antialiasing),
            ao_samples=int(ao_samples),
            ao_enabled=bool(ao),
            shadows_enabled=bool(shadows),
            direct_light_enabled=True,
            ao_brightness=float(ao_brightness),
            ao_max_dist=float(ao_max_dist),
            direct_light_intensity=float(direct_light_intensity),
            background=bg[:3],
        )
        self._seed = int(seed)
        self._input_refs = None
        self._scene_key = None
        self._scene = None
        self._accel_key = None
        self._accel = None
        self._ao_key = None
        self._ao = None

    @property
    def backend(self) -> str:
        return self._backend

    def __repr__(self) -> str:
        return (f"TachyonRender(backend={self._backend!r}, "
                f"ao={self._cfg.ao_enabled}, aa={self._cfg.aa_enabled})")

    # ------------------------------------------------------------------
    def _scene_for(self, positions, colors, radii):
        """Scene tensors, rebuilt only when the inputs change.

        The same array objects as the last call reuse the scene with no
        hashing at all (the JAX renderer's identity fast path; the cache
        holds references, so the ids stay valid, and an in-place edit of a
        cached array is the documented hazard).  Other arrays are keyed by a
        sampled fingerprint."""
        refs = (positions, colors, radii)
        if self._input_refs is not None and all(
                a is b for a, b in zip(refs, self._input_refs)):
            return self._scene_key, self._scene
        h = hashlib.sha1()
        for a in refs:
            _fingerprint(h, a)
        key = h.hexdigest()
        if key != self._scene_key:
            if bool(np.any(colors[:, 3] < 1.0)):
                raise NotImplementedError(
                    "transparent atoms (alpha < 1) are not ported yet "
                    "(ROADMAP B1e)"
                )
            scene = build_scene(positions, colors, radii, device=self._device)
            lo = (scene.sph_center - scene.sph_radius[:, None]).min(dim=0).values
            hi = (scene.sph_center + scene.sph_radius[:, None]).max(dim=0).values
            self._scene = (scene, lo.cpu().numpy(), hi.cpu().numpy())
            self._scene_key = key
            self._accel_key = self._accel = None
        self._input_refs = refs
        return self._scene_key, self._scene

    def _ao_for(self, scene_key, scene, radii):
        """The AO sky lights, rebuilt only when the scene changes."""
        if scene_key != self._ao_key:
            cfg = self._cfg
            rmax = float(radii.max()) if len(radii) else 0.0
            self._ao = build_ao_lights(scene, cfg.ao_samples, cfg.ao_brightness,
                                       rmax, grid=LIGHT_GRID)
            self._ao_key = scene_key
        return self._ao

    def _accel_for(self, scene_key, scene, lo, hi, camera, width, height,
                   radii):
        """Per-view structures, rebuilt only when the scene or view changes."""
        key = (scene_key, repr((camera.__dict__, width, height)))
        if key == self._accel_key:
            return self._accel
        cfg = self._cfg
        frame = camera_frame(camera, width, height)
        bins = build_screen_bins(scene, frame, width, height, TILE_PX)
        nb, nchunks, ch = bins.sph_chunks.shape
        rec_bytes = nb * nchunks * ch * 32
        if rec_bytes > RECORD_BUDGET_BYTES:
            raise NotImplementedError(
                f"the frame's candidate records take {rec_bytes} bytes, past "
                f"the {RECORD_BUDGET_BYTES}-byte budget; the banded render "
                "is not ported yet (ROADMAP B1f)"
            )
        lb = build_light_bins(scene, frame["light_dir"], grid=LIGHT_GRID)
        chunk_data = gather_chunk_data(bins.sph_chunks, scene.sph_center,
                                       scene.sph_radius, scene.sph_color)
        params = build_mega_params(frame, lb, lo, hi, cfg)
        extra = (self._ao_for(scene_key, scene, radii) if cfg.ao_enabled
                 else None)
        lights = None
        if cfg.shadows_enabled or extra:
            # with AO and no shadows the primary light gets an empty CSR and
            # the sweeps stay on for the sky lights (render.py:627-637)
            primary = (build_light_records(lb, scene) if cfg.shadows_enabled
                       else (None, None, None, None))
            lights = stack_lights(params, *primary, extra_lights=extra,
                                  grid_n=LIGHT_GRID, device=self._device)
        self._accel = (frame, bins, chunk_data, lights, params)
        self._accel_key = key
        return self._accel

    def render(
        self,
        positions: np.ndarray,
        colors: np.ndarray,
        radii: np.ndarray,
        camera: Optional[CameraParams] = None,
        bond_edges: Optional[np.ndarray] = None,
        bond_colors: Optional[np.ndarray] = None,
        bond_radius: float = 0.1,
        bond_color: tuple = (0.8, 0.8, 0.8, 1.0),
        box_edges: Optional[np.ndarray] = None,
        box_edge_radius: float = 0.05,
        box_color: tuple = (1.0, 1.0, 1.0, 1.0),
        width: int = 800,
        height: int = 600,
        output_figure: Optional[str] = None,
        transparent: bool = False,
        device_output: bool = False,
    ):
        """Render spheres -> (H, W, 4) uint8 RGBA numpy (truncating quantizer).

        ``device_output=True`` returns the rounded (H, W, 3) uint8 frame as
        a tensor on the render device, with no host round trip — the serving
        path when the consumer lives on the device."""
        positions = np.ascontiguousarray(positions, dtype=np.float64)
        colors = np.ascontiguousarray(colors, dtype=np.float32)
        radii = np.ascontiguousarray(radii, dtype=np.float32)
        if positions.ndim != 2 or positions.shape[1] != 3:
            raise ValueError(f"positions must be (N,3), got {positions.shape}")
        if colors.ndim != 2 or colors.shape[1] != 4:
            raise ValueError(f"colors must be (N,4), got {colors.shape}")
        if radii.ndim != 1:
            raise ValueError(f"radii must be (N,), got {radii.shape}")
        if (bond_edges is not None and len(bond_edges)) or (
                box_edges is not None and len(box_edges)):
            raise NotImplementedError(
                "bond and box-edge cylinders are not ported yet (ROADMAP B1d)"
            )
        if camera is None:
            camera = auto_camera(
                positions, max_radius=float(radii.max()) if len(radii) else 0.0)

        cfg = self._cfg
        scene_key, (scene, lo, hi) = self._scene_for(positions, colors, radii)
        if cfg.ao_enabled and scene.sph_center.shape[0] <= AO_EXACT_MAX_SPHERES:
            raise NotImplementedError(
                f"ambient occlusion on {scene.sph_center.shape[0]} padded "
                f"spheres (at most {AO_EXACT_MAX_SPHERES}) takes the exact AO "
                "tracer, which is not ported yet (ROADMAP A6); pass ao=False"
            )
        frame, bins, chunk_data, lights, params = self._accel_for(
            scene_key, scene, lo, hi, camera, int(width), int(height), radii)
        S = (cfg.aa_samples if cfg.aa_enabled else 0) + 1
        img_f = render_image_mega(
            chunk_data, bins.sph_zmin, lights, params, self._seed,
            S=S, width=int(width), height=int(height),
            tiles_x=bins.tiles_x, tiles_y=bins.tiles_y, grid_n=LIGHT_GRID,
            eps=cfg.eps, perspective=bool(frame["perspective"]),
            shadows=lights is not None, quantized=device_output,
        )
        if device_output:
            return img_f

        img = np.empty((height, width, 4), dtype=np.uint8)
        img[:, :, :3] = quantize(img_f).cpu().numpy()
        img[:, :, 3] = np.uint8(max(0.0, min(1.0, self._bg_a)) * 255.0 + 0.5)
        if transparent:
            bg = np.array(cfg.background, dtype=np.float32) * 255.0
            diff = np.abs(img[:, :, :3].astype(np.float32) - bg).max(axis=2)
            img[:, :, 3] = np.where(diff < 1.5, 0, 255).astype(np.uint8)
        if output_figure is not None:
            save_image(output_figure, img)
            return None
        return img
