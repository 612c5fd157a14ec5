"""The image out: the frame's float RGB to the (H, W, 4) uint8 RGBA image.

``image_out_rgba(img_f, alpha_byte, bg)`` dispatches on the frame's
device, as the other kernels' wrappers do: a CUDA frame goes to the hand
kernel (``csrc/image_out.cu``, float32: every route renders in float32 on
the card), a CPU frame, float32 or float64, to ``image_out_plain``, and
nothing else decides; a build or launch that fails raises.  Each kernel
call counts one launch.

Per pixel: RGB is ``config.quantize`` (Tachyon's truncating conversion,
the product taken in float64); alpha is ``alpha_byte``, or with ``bg``
given (the transparent background: its RGB times 255 in float32) 0 where
the quantized RGB lies within 1.5 of ``bg`` in every channel and 255
elsewhere, compared in float32.  Both paths give the same bytes.  On the
card the pass is bound by its bytes (12 in and 4 out a pixel); the
kernel loads four pixels' 48 bytes and stores their 16 as full 16-byte
accesses (the source's note).
"""

from __future__ import annotations

import ctypes
import mmap

import numpy as np
import torch

from .. import tracing
from .config import quantize

__all__ = ["image_out_rgba", "image_out_plain", "image_out_rgba_cuda",
           "host_image", "launches", "reset_launches"]

# hand-kernel launches since the last reset_launches()
launches = {"image_out_rgba": 0}


def reset_launches() -> None:
    launches["image_out_rgba"] = 0


def _check(img_f: torch.Tensor, bg) -> None:
    if img_f.ndim != 3 or img_f.shape[2] != 3:
        raise ValueError(f"img_f must be (H, W, 3), got {tuple(img_f.shape)}")
    if img_f.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"img_f must be float32 or float64, got {img_f.dtype}")
    if bg is not None and np.shape(bg) != (3,):
        raise ValueError(f"bg must hold 3 values, got shape {np.shape(bg)}")


def image_out_plain(img_f: torch.Tensor, alpha_byte: int, bg=None) -> torch.Tensor:
    """The image out in torch ops, on the frame's device: (H, W, 4) uint8."""
    _check(img_f, bg)
    rgb = quantize(img_f)
    if bg is None:
        alpha = torch.full(rgb.shape[:2] + (1,), int(alpha_byte),
                           dtype=torch.uint8, device=rgb.device)
    else:
        bg = torch.as_tensor(np.asarray(bg, np.float32), device=rgb.device)
        diff = (rgb.to(torch.float32) - bg).abs().amax(dim=2, keepdim=True)
        alpha = torch.where(diff < 1.5, 0, 255).to(torch.uint8)
    return torch.cat([rgb, alpha], dim=2)


def image_out_rgba_cuda(img_f: torch.Tensor, alpha_byte: int, bg=None) -> torch.Tensor:
    """Launch the hand kernel on a float32 CUDA frame; a frame that is
    not contiguous is copied to one first."""
    from ._build import load_image_out

    if img_f.device.type != "cuda":
        raise ValueError(f"image_out_rgba_cuda needs a CUDA tensor, got {img_f.device}")
    _check(img_f, bg)
    if img_f.dtype != torch.float32:
        raise ValueError(f"image_out_rgba_cuda needs a float32 frame, got {img_f.dtype}")
    if not 0 <= int(alpha_byte) <= 255:
        raise ValueError(f"alpha_byte must lie in [0, 255], got {alpha_byte}")
    img_f = img_f if img_f.is_contiguous() else img_f.contiguous()
    h, w = img_f.shape[:2]
    out = torch.empty((h, w, 4), dtype=torch.uint8, device=img_f.device)
    if h * w == 0:
        return out
    lib = load_image_out()
    bg3 = (0.0, 0.0, 0.0) if bg is None else [float(v) for v in np.asarray(bg, np.float32)]
    ptr = ctypes.c_void_p
    with torch.cuda.device(img_f.device):   # the launch goes to the frame's card
        rc = lib.image_out_rgba_launch(
            ptr(img_f.data_ptr()), ptr(out.data_ptr()), h * w, int(alpha_byte),
            int(bg is not None), *bg3,
            ptr(torch.cuda.current_stream(img_f.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"image_out_rgba kernel launch failed: CUDA error {rc}")
    launches["image_out_rgba"] += 1
    return out


def image_out_rgba(img_f: torch.Tensor, alpha_byte: int, bg=None) -> torch.Tensor:
    """(H, W, 3) float RGB -> (H, W, 4) uint8 RGBA on the frame's device:
    the kernel for a CUDA frame, its plain version for a CPU frame."""
    if img_f.device.type == "cuda":
        return image_out_rgba_cuda(img_f, alpha_byte, bg)
    if img_f.device.type == "cpu":
        return image_out_plain(img_f, alpha_byte, bg)
    raise ValueError(f"no image-out path for device {img_f.device}")


def host_image(rgba: torch.Tensor) -> np.ndarray:
    """The image as a fresh host array that the caller owns, in one
    contiguous copy from the card, counted as ``image_out.fetch_bytes``
    (a CPU image is returned as it is: nothing is copied or counted).

    A fresh array this large (36 MB at 3000x3000) may be newly mapped,
    and then faulting its pages in during the copy took 12-18 ms on an
    H100 machine's host, against ~3 ms into mapped memory (PERF.md §7).
    So one byte of each page is written first, while the card may still
    be rendering the frame, and the copy then lands in mapped memory."""
    if rgba.device.type == "cpu":
        return rgba.numpy()
    img = np.empty(tuple(rgba.shape), dtype=np.uint8)
    img.reshape(-1)[::mmap.PAGESIZE] = 0
    torch.from_numpy(img).copy_(rgba)
    tracing.count("image_out.fetch_bytes", img.nbytes)
    return img

