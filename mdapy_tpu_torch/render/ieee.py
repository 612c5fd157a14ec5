"""The correctly rounded square root of the render code, on every device.

On a CUDA card ``torch.sqrt`` of float32 is the correctly rounded root
(IEEE 754), as the hand kernels' ``sqrtf`` is.  On the CPU ``torch.sqrt``
goes to MKL's vector math (``at::vml::vsqrt``), which is within an ulp but
not correctly rounded (one ulp off on 0.64 % of random float32 inputs), and
which was seen, rarely and only with several threads, to return roots good
to 12 bits for one thread's share of a call (ROADMAP C9: the first
``mega_render_plain`` of a process, in 2 of 60 processes at 8 threads).
``sqrt`` refines the CPU's float32 roots in float64 and rounds them once.
"""

from __future__ import annotations

import math

import torch

__all__ = ["sqrt"]


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 tensor.

    On the CPU, every finite positive element's root is taken again in
    float64 and refined by two Newton steps, y = (y + x / y) / 2, from any
    start within 2^-12 of it: the float64 root then lies within 2^-50 of
    the exact one, closer than any float32 root comes to a rounding
    boundary, so the one rounding to float32 is the correct one.  Other
    devices and dtypes take ``torch.sqrt`` as it is."""
    if x.device.type != "cpu" or x.dtype != torch.float32:
        return torch.sqrt(x)
    out = torch.sqrt(x).contiguous()
    flat, xs = out.view(-1), x.reshape(-1)
    sel = torch.nonzero((xs > 0.0) & (xs < math.inf)).flatten()
    if sel.numel():
        xd = xs[sel].double()
        y = torch.sqrt(xd)
        for _ in range(2):
            y = 0.5 * (y + xd / y)
        flat[sel] = y.float()
    return out
