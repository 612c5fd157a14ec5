"""Parallel gzip compression (pigz-style).

A host copy of ``mdapy_tpu/utils/pigz.py`` (:1-62, whole; parity:
reference pigz.py, compress_file). Chunks the input, compresses
chunks in a process pool as independent gzip members, and concatenates —
multi-member gzip streams are valid per RFC 1952 and decompress with any
gzip reader. Small files fall back to single-process compression.
"""

from __future__ import annotations

import gzip
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

__all__ = ["compress_file"]

_BLOCKSIZE = 512 * 1024
_SMALL_MB = 5


def _compress_chunk(data: bytes) -> bytes:
    return gzip.compress(data, compresslevel=6)


def compress_file(input_file: str, output_file: str = None) -> str:
    """Compress ``input_file`` to gzip using all available cores.

    Returns the output path. Raises FileNotFoundError for a missing input
    and ValueError if the input already ends in .gz."""
    if not os.path.exists(input_file):
        raise FileNotFoundError(f"Input file not found: {input_file}")
    if str(input_file).endswith(".gz"):
        raise ValueError("Input file is already .gz")
    output_file = output_file or input_file + ".gz"

    size_mb = os.path.getsize(input_file) / (1024 * 1024)
    if size_mb < _SMALL_MB:
        with open(input_file, "rb") as fin, open(output_file, "wb") as fout:
            fout.write(gzip.compress(fin.read(), compresslevel=6))
        return output_file

    from .parallel import get_num_threads

    workers = max(1, get_num_threads())
    # spawn, not fork: the host process is multithreaded (torch) and fork of a
    # threaded process can deadlock in the child.
    ctx = multiprocessing.get_context("spawn")
    with open(input_file, "rb") as fin, open(output_file, "wb") as fout, \
            ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        futures = []
        max_inflight = workers * 4
        while True:
            chunk = fin.read(_BLOCKSIZE)
            if not chunk:
                break
            futures.append(pool.submit(_compress_chunk, chunk))
            if len(futures) >= max_inflight:
                fout.write(futures.pop(0).result())
        for fut in futures:
            fout.write(fut.result())
    return output_file
