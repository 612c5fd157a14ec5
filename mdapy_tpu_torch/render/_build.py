"""Build and bind the hand CUDA kernels at first use.

``nvcc`` compiles each source of ``mdapy_tpu_torch/csrc/`` (``mega_render.cu``,
``tile_kernels.cu``, ``image_out.cu``, ``chunk_gather.cu``) for ``sm_90a`` into a shared library
with a plain C interface, which ``ctypes`` loads.  A library lands in
``mdapy_tpu_torch/_build/`` (git-ignored) under a name that hashes the
source, the headers it includes and the flags, so an edited source or header
rebuilds and an unchanged one is reused.  ``load_all`` starts every build at
once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

__all__ = ["KernelLibrary", "load_all", "load_mega_render",
           "load_tile_kernels", "load_image_out", "load_chunk_gather",
           "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
]

_c = ctypes
_MEGA_ARGTYPES = (
    [_c.c_void_p] * 13                                 # params, lparams .. occ, out
    + [_c.c_int] * 5                                   # ntiles, tile0, nchunks, tiles_x, S
    + [_c.c_uint, _c.c_int, _c.c_int, _c.c_int]        # seed, grid_n, nlights, nocc
    + [_c.c_float, _c.c_float]                         # eps, inv_s
    + [_c.c_int, _c.c_int, _c.c_int]                   # perspective, shadows, other
    + [_c.c_int, _c.c_int, _c.c_void_p, _c.c_void_p]   # peel, n_peel, state, stream
)
_ATTRS_ARGTYPES = [_c.c_int] * 7 + [_c.c_void_p]       # flags, S, nlights, out
_HIT_ARGTYPES = (
    [_c.c_void_p] * 7                                  # o, d, tcap, zmin, chunks, best_t, rec
    + [_c.c_int, _c.c_int, _c.c_int, _c.c_float, _c.c_void_p]   # nb, R, nchunks, eps, stream
)
_IMAGE_OUT_ARGTYPES = (
    [_c.c_void_p, _c.c_void_p, _c.c_longlong]          # in, out, n_px
    + [_c.c_int, _c.c_int]                             # alpha_byte, transparent
    + [_c.c_float] * 3 + [_c.c_void_p]                 # bg0, bg1, bg2, stream
)
_CHUNK_GATHER_ARGTYPES = (
    [_c.c_void_p, _c.c_void_p, _c.c_longlong]          # ids, table, n_rows
    + [_c.c_void_p, _c.c_longlong, _c.c_int, _c.c_void_p]   # out, n_slots, ch, stream
)
_SHADOW_ARGTYPES = (
    [_c.c_void_p] * 8                                  # uvt, cellxy, lit, lrec, offs, cnt, filt, scratch
    + [_c.c_longlong, _c.c_int, _c.c_float, _c.c_void_p]        # n, grid_n, eps, stream
)
# headers every source includes; they enter each library's digest
_HEADERS = ("render_common.cuh",)
# library -> (source, {entry point: argtypes})
_LIBRARIES = {
    "mega_render": ("mega_render.cu", {"mega_render_launch": _MEGA_ARGTYPES,
                                       "mega_render_attrs": _ATTRS_ARGTYPES}),
    "tile_kernels": ("tile_kernels.cu", {
        "closest_hit_spheres_launch": _HIT_ARGTYPES,
        "shadow_filter_launch": _SHADOW_ARGTYPES,
        "tile_kernels_attrs": [_c.c_int, _c.c_int, _c.c_void_p],   # which, R, out
    }),
    "image_out": ("image_out.cu", {
        "image_out_rgba_launch": _IMAGE_OUT_ARGTYPES,
    }),
    "chunk_gather": ("chunk_gather.cu", {
        "chunk_gather_launch": _CHUNK_GATHER_ARGTYPES,
    }),
}


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    log: str              # nvcc / ptxas output of the build

    def __getattr__(self, name):
        return getattr(self.lib, name)


_loaded: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and /usr/local/cuda/bin)")


def _build(src: Path, stem: str) -> tuple:
    digest = hashlib.sha256(
        src.read_bytes() + b"".join((CSRC / h).read_bytes() for h in _HEADERS)
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"{stem}_{digest}.so"
    log_path = so.with_suffix(".log")
    if so.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return so, 0.0, log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, so)
    return so, seconds, log


def _load(stem: str, built=None) -> KernelLibrary:
    if stem not in _loaded:
        source, entries = _LIBRARIES[stem]
        so, seconds, log = built or _build(CSRC / source, stem)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[stem] = KernelLibrary(lib, so, seconds, log)
    return _loaded[stem]


def load_mega_render() -> KernelLibrary:
    """Build (if needed) and load the render megakernel's library."""
    return _load("mega_render")


def load_tile_kernels() -> KernelLibrary:
    """Build (if needed) and load the tiled tracer's kernels (the chunked
    sphere closest hit and the shadow filter)."""
    return _load("tile_kernels")


def load_image_out() -> KernelLibrary:
    """Build (if needed) and load the image out's RGBA kernel."""
    return _load("image_out")


def load_chunk_gather() -> KernelLibrary:
    """Build (if needed) and load the per-tile sphere records' gather."""
    return _load("chunk_gather")


def load_all() -> dict:
    """Build every library, one nvcc per source and all started together,
    and load them: {name: KernelLibrary}."""
    with ThreadPoolExecutor(len(_LIBRARIES)) as pool:
        builds = {stem: pool.submit(_build, CSRC / source, stem)
                  for stem, (source, _) in _LIBRARIES.items()
                  if stem not in _loaded}
    return {stem: _load(stem, builds[stem].result() if stem in builds else None)
            for stem in _LIBRARIES}
