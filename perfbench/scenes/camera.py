"""The preset perspective camera and turns of it about its up axis.

A camera is a dict with the fields of the renderer's camera parameters:
``is_perspective``, ``field_of_view`` (radians, vertical), ``position``,
``direction`` and ``up``.  The arithmetic is OVITO's preset viewport as
mdapy's renderer computes it (``preset_camera("perspective", ...)``): the
view along -(1, 1, 1), z up, far enough back that the bounding box grown
by the largest radius fits the field of view."""

from __future__ import annotations

import math

import numpy as np


def preset_perspective(positions: np.ndarray, max_radius: float,
                       fov_deg: float = 40.0, margin: float = 1.0) -> dict:
    pos = np.asarray(positions, np.float64)
    pmin, pmax = pos.min(axis=0), pos.max(axis=0)
    center = 0.5 * (pmin + pmax)
    half = 0.5 * (pmax - pmin) + float(max_radius)
    d = np.array([-1.0, -1.0, -1.0]) / np.sqrt(3.0)
    screen_half = float(np.linalg.norm(half))
    fov = math.radians(fov_deg)
    dist = max((screen_half + margin) / math.tan(0.5 * fov),
               screen_half * 3.0 + margin * 2.0)
    return {"is_perspective": True, "field_of_view": fov,
            "position": tuple(float(v) for v in center - d * dist),
            "direction": tuple(float(v) for v in d),
            "up": (0.0, 0.0, 1.0), "center": tuple(float(v) for v in center)}


def _rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rotation matrix by ``angle`` radians about the unit vector ``axis``."""
    k = axis / np.linalg.norm(axis)
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + math.sin(angle) * kx + (1.0 - math.cos(angle)) * kx @ kx


def turned(camera: dict, degrees: float) -> dict:
    """``camera`` turned by ``degrees`` about its up axis through the scene's
    centre: the position orbits the centre, the direction turns with it."""
    rot = _rotation(np.asarray(camera["up"], np.float64), math.radians(degrees))
    center = np.asarray(camera["center"], np.float64)
    pos = center + rot @ (np.asarray(camera["position"]) - center)
    direction = rot @ np.asarray(camera["direction"])
    return dict(camera, position=tuple(float(v) for v in pos),
                direction=tuple(float(v) for v in direction))
