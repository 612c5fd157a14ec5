"""The host's native (C++) pieces, built with g++ at first use.

The port of ``mdapy_tpu/native/__init__.py`` (``load_library`` :21-42) for
the port's copies of the JAX package's four sources: ``table_parser.cpp``
(the columnar parser of dump and XYZ bodies), ``ptm_engine.cpp``
(polyhedral template matching), ``voro_engine.cpp`` (Voronoi cells) and
``sqs_engine.cpp`` (the SQS Monte Carlo).  A library lands in
``mdapy_tpu_torch/_build/`` (git-ignored) under a name that hashes the
source and the flags, so an edited source rebuilds and an unchanged one is
reused; a failed build raises with the compiler's output, and no caller
falls back to another route.  Each build compiles into a temporary named
by the process id, so two processes that build the same source at once do
not write one file (the JAX package's fixed ``<name>.so.tmp`` can race:
ROADMAP C17).  Loaded through ctypes; nothing here runs at import time.

The flags leave out the JAX package's ``-march=native``: a library built
on one host must load on another.  On a host with FMA that flag lets g++
contract ``a*b + c``, so the JAX package's engines can differ from these
in the last bits of PTM's RMSD and quaternions, Voronoi's volumes and
areas, and SQS's objective (ROADMAP C16).
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
