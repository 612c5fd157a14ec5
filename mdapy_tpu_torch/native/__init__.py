"""The host's native (C++) pieces, built with g++ at first use.

The port of ``mdapy_tpu/native/__init__.py`` (``load_library`` :21-42) for
the one source the port has so far, ``table_parser.cpp`` (the columnar
parser of dump and XYZ bodies).  A library lands in
``mdapy_tpu_torch/_build/`` (git-ignored) under a name that hashes the
source and the flags, so an edited source rebuilds and an unchanged one is
reused; a failed build raises with the compiler's output.  Loaded through
ctypes; nothing here runs at import time.
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

__all__ = ["NativeLibrary", "load_library", "GXX_FLAGS"]

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
# no -march=native: a library built on one host must load on another
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp"]


@dataclass
class NativeLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused

    def __getattr__(self, name):
        return getattr(self.lib, name)


_cache: dict = {}


def load_library(name: str) -> NativeLibrary:
    """Compile ``<name>.cpp`` with g++ into ``_build/`` unless a build of
    the same source and flags is there, and dlopen it."""
    if name in _cache:
        return _cache[name]
    src = _HERE / f"{name}.cpp"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}_{digest}.so"
    seconds = 0.0
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found on PATH; it builds {src.name}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([gxx, *GXX_FLAGS, str(src), "-o", str(tmp)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = NativeLibrary(ctypes.CDLL(str(so)), so, seconds)
    _cache[name] = lib
    return lib
