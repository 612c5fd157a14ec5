"""AtomFrame — a lightweight column store for per-atom data.

A host copy of ``mdapy_tpu/core/frame.py`` (``AtomFrame`` :20-155): a dict
of contiguous numpy columns with the slice of DataFrame behaviour the
package needs (named columns, row filtering, column add and replace,
concatenation, tiling) and strict length checks.  ``to_pandas`` keeps its
lazy import: pandas is optional.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Union

import numpy as np

__all__ = ["AtomFrame"]


class AtomFrame:
    """Immutable-ish mapping of column name -> 1-D (or 2-D) numpy array."""

    def __init__(self, data: Optional[Mapping[str, np.ndarray]] = None):
        self._cols: Dict[str, np.ndarray] = {}
        self._n = 0
        if data:
            for k, v in data.items():
                self._set(k, v)

    # -- internals ----------------------------------------------------------
    def _set(self, name: str, value) -> None:
        arr = np.ascontiguousarray(value)
        if arr.ndim == 0:
            raise ValueError(f"Column {name!r} must be at least 1-D")
        if self._cols and arr.shape[0] != self._n:
            raise ValueError(
                f"Column {name!r} has {arr.shape[0]} rows, frame has {self._n}"
            )
        if not self._cols:
            self._n = arr.shape[0]
        self._cols[name] = arr

    # -- mapping protocol ---------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, key: Union[str, List[str]]):
        if isinstance(key, str):
            return self._cols[key]
        return AtomFrame({k: self._cols[k] for k in key})

    def __setitem__(self, name: str, value) -> None:
        self._set(name, value)

    def __delitem__(self, name: str) -> None:
        del self._cols[name]

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return iter(self._cols)

    @property
    def nrows(self) -> int:
        return self._n

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def get(self, name: str, default=None):
        return self._cols.get(name, default)

    def items(self):
        return self._cols.items()

    # -- transforms ---------------------------------------------------------
    def copy(self) -> "AtomFrame":
        return AtomFrame({k: v.copy() for k, v in self._cols.items()})

    def shallow_copy(self) -> "AtomFrame":
        return AtomFrame(dict(self._cols))

    def with_columns(self, **cols) -> "AtomFrame":
        out = self.shallow_copy()
        for k, v in cols.items():
            out._set(k, v)
        return out

    def select(self, names: Iterable[str]) -> "AtomFrame":
        return AtomFrame({k: self._cols[k] for k in names})

    def drop(self, names: Iterable[str]) -> "AtomFrame":
        names = set([names] if isinstance(names, str) else names)
        return AtomFrame({k: v for k, v in self._cols.items() if k not in names})

    def filter(self, mask_or_idx) -> "AtomFrame":
        """Row subset by boolean mask or integer index array."""
        sel = np.asarray(mask_or_idx)
        return AtomFrame({k: v[sel] for k, v in self._cols.items()})

    def take(self, idx) -> "AtomFrame":
        return self.filter(np.asarray(idx, dtype=np.int64))

    def sort(self, by: str, descending: bool = False) -> "AtomFrame":
        order = np.argsort(self._cols[by], kind="stable")
        if descending:
            order = order[::-1]
        return self.take(order)

    @staticmethod
    def concat(frames: List["AtomFrame"]) -> "AtomFrame":
        if not frames:
            return AtomFrame()
        keys = frames[0].columns
        for f in frames[1:]:
            if f.columns != keys:
                # allow any order but same set
                if set(f.columns) != set(keys):
                    raise ValueError("Cannot concat frames with different columns")
        return AtomFrame(
            {k: np.concatenate([f[k] for f in frames], axis=0) for k in keys}
        )

    def tile(self, reps: int) -> "AtomFrame":
        return AtomFrame(
            {
                k: np.tile(v, (reps,) + (1,) * (v.ndim - 1))
                for k, v in self._cols.items()
            }
        )

    # -- interop ------------------------------------------------------------
    def to_dict(self) -> Dict[str, np.ndarray]:
        return dict(self._cols)

    def to_pandas(self):
        import pandas as pd

        flat = {}
        for k, v in self._cols.items():
            if v.ndim == 1:
                flat[k] = v
            else:
                for j in range(v.shape[1]):
                    flat[f"{k}_{j}"] = v[:, j]
        return pd.DataFrame(flat)

    def __repr__(self) -> str:
        cols = ", ".join(
            f"{k}:{v.dtype}{'' if v.ndim == 1 else v.shape[1:]}"
            for k, v in self._cols.items()
        )
        return f"AtomFrame({self._n} rows; {cols})"
