"""Build and bind the hand CUDA kernel at first use.

``nvcc`` compiles ``mdapy_tpu_torch/csrc/mega_render.cu`` for ``sm_90a`` into
a shared library with a plain C interface, which ``ctypes`` loads.  The
library lands in ``mdapy_tpu_torch/_build/`` (git-ignored) under a name that
hashes the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["KernelLibrary", "load_mega_render", "NVCC_FLAGS"]

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
    + [_c.c_int, _c.c_int, _c.c_int, _c.c_void_p]      # perspective, shadows, other, stream
)


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
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
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


def load_mega_render() -> KernelLibrary:
    """Build (if needed) and load the render kernel's library."""
    if "mega_render" not in _loaded:
        so, seconds, log = _build(CSRC / "mega_render.cu", "mega_render")
        lib = ctypes.CDLL(str(so))
        fn = lib.mega_render_launch
        fn.argtypes = _MEGA_ARGTYPES
        fn.restype = ctypes.c_int
        _loaded["mega_render"] = KernelLibrary(lib, so, seconds, log)
    return _loaded["mega_render"]
