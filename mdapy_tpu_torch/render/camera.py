"""Camera model — exact Tachyon CPU conventions (numpy host code).

Port of ``mdapy_tpu/render/camera.py``.  That module imports no jax itself,
but importing it runs ``mdapy_tpu/render/__init__.py``, which loads the JAX
renderer; the port keeps its own copy so ``mdapy_tpu_torch`` never imports
jax.

Replicates the reference chain render.py CameraParams -> tachyon_render.h
setupCamera -> Tachyon camera.c:40-184 *by construction*:

  * every world-space vector entering the renderer is z-flipped first
    (the ``tvec`` convention of tachyon_render.h:58)
  * basis: view = normalize(dir); right = normalize(up x view);
    up2 = normalize(view x right)                     (camera.c:40-49)
  * image plane: px = (W/H)/zoom, py = 1/zoom; rays start at the *lower-left
    corner* and use integer pixel coordinates with no half-pixel offset
    (camera.c:55-59, 126-176; trace.c:373-383)
  * perspective zoom = 0.5/tan(fov/2); orthographic zoom = 0.5/fov with the
    camera plane shifted by (znear - 1e-9) (tachyon_render.h:243-265)
  * scanlines are generated bottom-up and flipped at the end
    (tachyon_render.h:219-235)
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

__all__ = ["CameraParams", "preset_camera", "auto_camera", "camera_frame", "PRESET_VIEWS"]

FLIP = np.array([1.0, 1.0, -1.0])


class CameraParams:
    """OVITO ViewProjectionParameters-compatible camera.

    Perspective: ``field_of_view`` is the vertical angle in radians.
    Orthographic: ``field_of_view`` is the viewport half-height in world
    units.  Parity: reference render.py:76-138.
    """

    def __init__(
        self,
        is_perspective: bool = True,
        field_of_view: float = math.radians(40),
        position: Tuple[float, float, float] = (0.0, 0.0, 50.0),
        direction: Tuple[float, float, float] = (0.0, 0.0, -1.0),
        up: Tuple[float, float, float] = (0.0, 1.0, 0.0),
        znear: float = 0.0,
        dof_enabled: bool = False,
        dof_focal_len: float = 40.0,
        dof_aperture: float = 0.01,
    ):
        self.is_perspective = bool(is_perspective)
        self.field_of_view = float(field_of_view)
        self.position = tuple(float(v) for v in position)
        self.direction = tuple(float(v) for v in direction)
        self.up = tuple(float(v) for v in up)
        self.znear = float(znear)
        self.dof_enabled = bool(dof_enabled)
        self.dof_focal_len = float(dof_focal_len)
        self.dof_aperture = float(dof_aperture)

    def __repr__(self):
        mode = "perspective" if self.is_perspective else "orthographic"
        fov = (
            math.degrees(self.field_of_view)
            if self.is_perspective
            else self.field_of_view
        )
        unit = "deg" if self.is_perspective else "world units"
        return f"CameraParams({mode}, fov={fov:.1f}{unit}, pos={self.position})"


def _normalize(v):
    return v / np.linalg.norm(v)


def camera_frame(cam: CameraParams, width: int, height: int):
    """Host-side camera setup in flipped (Tachyon) space.

    Returns a dict of numpy arrays consumed by the tracer:
      origin (3,), lowleft (3,), iplaneright (3,), iplaneup (3,),
      view (3,), light_dir (3,) [the stored N-dot direction],
      perspective flag.

    Ray for pixel (x, y_bottom_up):
      perspective: o = origin, d = normalize(lowleft + x*ipr + y*ipu)
      orthographic: o = lowleft + x*ipr + y*ipu, d = view
    """
    pos = np.asarray(cam.position, dtype=np.float64)
    direction = np.asarray(cam.direction, dtype=np.float64)
    up_in = np.asarray(cam.up, dtype=np.float64)

    # light direction is computed in *unflipped* space (tachyon_render.h:268-283)
    d0 = _normalize(direction)
    r0 = _normalize(np.cross(d0, _normalize(up_in)))
    u0 = _normalize(np.cross(r0, d0))
    wl = r0 * 0.2 + u0 * (-0.2) + d0 * (-1.0)
    # rt_directional_light normalizes then negates (api.c:1077, light.c newdirectionallight)
    light_dir = -_normalize(wl * FLIP)

    # flipped camera vectors (tvec convention)
    posf = pos * FLIP
    dirf = _normalize(direction * FLIP)
    upf = _normalize(up_in * FLIP)

    if cam.is_perspective:
        zoom = 0.5 / math.tan(cam.field_of_view * 0.5)
        origin = posf
    else:
        zoom = 0.5 / cam.field_of_view
        origin = posf + dirf * (cam.znear - 1e-9)

    # tachyon camera.c:40-49 — right = up x view, up2 = view x right
    view = dirf
    right = _normalize(np.cross(upf, view))
    up2 = _normalize(np.cross(view, right))

    sx, sy = float(width), float(height)
    px = (sx / sy) / zoom  # aspectratio = 1.0 (scene default)
    py = 1.0 / zoom
    ipr = px * right / sx
    ipu = py * up2 / sy

    if cam.is_perspective:
        lowleft = view + (-0.5 * px) * right + (-0.5 * py) * up2
    else:
        lowleft = origin + (-0.5 * px) * right + (-0.5 * py) * up2

    return {
        "origin": origin,
        "lowleft": lowleft,
        "iplaneright": ipr,
        "iplaneup": ipu,
        "view": view,
        "light_dir": light_dir,
        "perspective": cam.is_perspective,
    }


# ---------------------------------------------------------------------------
# Preset cameras (parity: reference render.py:586-760)
# ---------------------------------------------------------------------------

PRESET_VIEWS = (
    "perspective",
    "orthographic",
    "top",
    "bottom",
    "front",
    "back",
    "left",
    "right",
)


def _bbox(positions: np.ndarray, max_radius: float = 0.0):
    pmin = positions.min(axis=0)
    pmax = positions.max(axis=0)
    center = (pmin + pmax) * 0.5
    half = (pmax - pmin) * 0.5 + max_radius
    return center, half, pmin, pmax


def auto_camera(positions: np.ndarray, max_radius: float = 0.0) -> CameraParams:
    """Perspective camera auto-fit (parity: render.py:564)."""
    return preset_camera("perspective", positions, max_radius=max_radius)


def preset_camera(
    view: str,
    positions: np.ndarray,
    fov_deg: float = 40.0,
    margin: float = 1.0,
    max_radius: float = 0.0,
) -> CameraParams:
    """OVITO-style preset viewports (parity: render.py:586-760)."""
    view = view.lower().strip()
    if view not in PRESET_VIEWS:
        raise ValueError(f"Unknown view '{view}'. Choose from: {PRESET_VIEWS}")

    positions = np.asarray(positions, dtype=np.float64)
    center, half, pmin, pmax = _bbox(positions, max_radius)

    if view in ("perspective", "orthographic"):
        d = np.array([-1.0, -1.0, -1.0]) / np.sqrt(3.0)
        up = np.array([0.0, 0.0, 1.0])
        screen_half = float(np.linalg.norm(half))
        cam_dist = screen_half * 3.0 + margin * 2.0
        if view == "perspective":
            fov = math.radians(fov_deg)
            dist = (screen_half + margin) / math.tan(fov * 0.5)
            dist = max(dist, cam_dist)
            return CameraParams(
                is_perspective=True,
                field_of_view=fov,
                position=tuple(center - d * dist),
                direction=tuple(d),
                up=tuple(up),
            )
        return CameraParams(
            is_perspective=False,
            field_of_view=screen_half + margin,
            position=tuple(center - d * cam_dist),
            direction=tuple(d),
            up=tuple(up),
        )

    VIEW_DEFS = {
        "top": ((0, 0, -1), (0, 1, 0), 0, 1),
        "bottom": ((0, 0, +1), (0, 1, 0), 0, 1),
        "front": ((0, +1, 0), (0, 0, 1), 0, 2),
        "back": ((0, -1, 0), (0, 0, 1), 0, 2),
        "left": ((+1, 0, 0), (0, 0, 1), 1, 2),
        "right": ((-1, 0, 0), (0, 0, 1), 1, 2),
    }
    direction, up_vec, ax_h, ax_v = VIEW_DEFS[view]
    direction = np.array(direction, dtype=float)
    up_vec = np.array(up_vec, dtype=float)
    fov_ortho = float(max(half[ax_v], half[ax_h])) + margin
    depth_axis = int(np.argmax(np.abs(direction)))
    depth_span = float(half[depth_axis])
    cam_dist = depth_span + float(np.linalg.norm(half)) + 1.0
    cam_pos = center - direction * cam_dist
    return CameraParams(
        is_perspective=False,
        field_of_view=fov_ortho,
        position=tuple(cam_pos),
        direction=tuple(direction),
        up=tuple(up_vec),
    )
