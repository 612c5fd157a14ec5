"""The host-side parallelism knob ``MDAPY_NUM_THREADS``.

A host copy of ``mdapy_tpu/utils/parallel.py`` (``get_num_threads``
:22-46).  It sets the thread count of the host's parallel pieces, here the
native table parser (``io/_fast_table.py``); the card's work is not
governed by it.  ``OMP_NUM_THREADS`` is never mutated: other OpenMP users
(torch, scipy) in the same process must be unaffected.
"""

from __future__ import annotations

import os
import warnings

__all__ = ["get_num_threads"]


def get_num_threads() -> int:
    """Resolve the thread count for any host-side parallel region.

    Reads ``MDAPY_NUM_THREADS``; must be a positive integer if set. Warns on
    oversubscription. Falls back to ``os.cpu_count()`` when unset.
    """
    env = os.environ.get("MDAPY_NUM_THREADS")
    ncpu = os.cpu_count() or 1
    if env is not None:
        try:
            n = int(env)
        except ValueError:
            raise ValueError(
                f"MDAPY_NUM_THREADS must be a positive integer, got {env!r}"
            ) from None
        if n <= 0:
            raise ValueError(f"MDAPY_NUM_THREADS must be > 0, got {n}")
        if n > ncpu:
            warnings.warn(
                f"MDAPY_NUM_THREADS={n} exceeds cpu_count()={ncpu}; "
                "oversubscription usually hurts performance.",
                stacklevel=2,
            )
        return n
    return ncpu
