"""Static render settings and the host-side quantizer.

Port of ``mdapy_tpu/render/tracer.py``: ``RenderConfig`` (:38) and
``quantize`` (:379).  The host path truncates (Tachyon imageio.c:174-186)
while the device serving path of ``render_image_mega`` rounds; each entry
point keeps its own rule so both match the JAX package (ROADMAP fault C5).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["RenderConfig", "quantize"]


class RenderConfig(NamedTuple):
    """Static render settings (field for field as in the JAX package)."""

    aa_samples: int = 12          # extra jittered samples (total = aa+1)
    aa_enabled: bool = True
    ao_samples: int = 12
    ao_enabled: bool = True
    shadows_enabled: bool = True
    direct_light_enabled: bool = True
    ao_brightness: float = 0.8
    ao_max_dist: float = 3.402823e38
    direct_light_intensity: float = 0.9
    background: tuple = (0.0, 0.0, 0.0)
    eps: float = 4e-4             # Tachyon EPSILON (float build, tachyon.h:905)
    transparency: bool = False    # enable transparency peeling
    max_trans: int = 4            # peeling budget when transparency on


def quantize(img_f: torch.Tensor) -> torch.Tensor:
    """float RGB -> uint8 with Tachyon's truncating conversion (imageio.c:174)."""
    q = torch.trunc(img_f.to(torch.float64) * 255.0)
    return q.clamp(0.0, 255.0).to(torch.uint8)
