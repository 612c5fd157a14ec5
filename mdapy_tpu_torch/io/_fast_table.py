"""ctypes bridge to the native columnar table parser.

The port of ``mdapy_tpu/io/_fast_table.py`` (``parse_block`` :50,
``skip_rows`` :115) over the port's copy of ``native/table_parser.cpp``:
OpenMP threads and ``std::from_chars`` parse whole file bodies into
preallocated column matrices without materializing per-line Python strings.
A body that is not a uniform table makes the native call decline (None),
and the caller parses it with numpy (``load_save._parse_table``).

Unlike the JAX package, a failed g++ build raises (``native.load_library``)
instead of falling back without a word, and ``routes`` counts which route
parsed each table since the last ``reset_routes()``: "native" here, "numpy"
in the caller's fallback.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import numpy as np

from ..utils.parallel import get_num_threads

__all__ = ["parse_block", "skip_rows", "routes", "reset_routes", "STR_COLS"]

# Column names whose tokens are strings, not numbers (fixed-width parsed).
STR_COLS = frozenset({"element", "species", "name", "label", "symbol"})
STR_WIDTH = 15

# tables parsed since the last reset_routes(), by route
routes = {"native": 0, "numpy": 0}

_lib = None


def reset_routes() -> None:
    for k in routes:
        routes[k] = 0


def _get_lib():
    global _lib
    if _lib is None:
        from ..native import load_library

        lib = load_library("table_parser")
        ll = ctypes.c_longlong
        lib.parse_table_mixed.restype = ll
        lib.parse_table_mixed.argtypes = [
            ctypes.c_void_p, ll, ll,  # text, nbytes, ncols
            ctypes.c_void_p, ctypes.c_void_p,  # is_str, slot
            ll, ll, ll, ll,  # n_num, n_str, str_width, max_rows
            ctypes.c_void_p, ctypes.c_void_p,  # out_num, out_str
            ctypes.c_int,  # num_threads
        ]
        lib.skip_rows.restype = ll
        lib.skip_rows.argtypes = [ctypes.c_void_p, ll, ll, ll]
        _lib = lib
    return _lib


def parse_block(
    raw: bytes,
    offset: int,
    names: List[str],
    nrows: int,
    str_cols=STR_COLS,
    end: Optional[int] = None,
) -> Optional[Dict[str, np.ndarray]]:
    """Parse ``nrows`` table rows from ``raw[offset:end]`` into named columns.

    Returns None (the caller falls back) when the body is not a uniform
    table of the expected shape."""
    if nrows < 0:
        return None
    lib = _get_lib()
    stop = len(raw) if end is None else end
    ncols = len(names)
    if ncols == 0:
        return {} if nrows == 0 else None
    is_str = np.array([1 if n in str_cols else 0 for n in names], np.int8)
    slot = np.zeros(ncols, np.int32)
    n_num = n_str = 0
    for j in range(ncols):
        if is_str[j]:
            slot[j] = n_str
            n_str += 1
        else:
            slot[j] = n_num
            n_num += 1
    # Column-major outputs (column stride = nrows): each parsed column is a
    # contiguous zero-copy slice, no per-column gather afterwards.
    out_num = np.empty((max(n_num, 1), max(nrows, 1)), np.float64)
    out_str = np.zeros(
        (max(n_str, 1), max(nrows, 1)) if n_str else (1, 1),
        dtype=f"S{STR_WIDTH}",
    )
    buf = np.frombuffer(raw, np.uint8)
    rc = lib.parse_table_mixed(
        buf.ctypes.data + offset,
        stop - offset,
        ncols,
        is_str.ctypes.data,
        slot.ctypes.data,
        n_num,
        n_str,
        STR_WIDTH,
        nrows,
        out_num.ctypes.data,
        out_str.ctypes.data,
        get_num_threads(),
    )
    if rc != nrows:
        return None
    cols: Dict[str, np.ndarray] = {}
    for j, n in enumerate(names):
        if is_str[j]:
            cols[n] = out_str[slot[j], :nrows].astype(str)
        else:
            cols[n] = out_num[slot[j], :nrows]
    routes["native"] += 1
    return cols


def skip_rows(raw: bytes, begin: int, nrows: int) -> int:
    """Byte offset just past the ``nrows``-th non-empty line from ``begin``.

    Returns -1 if the buffer ends first."""
    buf = np.frombuffer(raw, np.uint8)
    return int(_get_lib().skip_rows(buf.ctypes.data, len(raw), begin, nrows))
