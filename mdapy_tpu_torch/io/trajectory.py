"""Multi-frame trajectory container + unwrap tooling.

A host copy of ``mdapy_tpu/io/trajectory.py`` (whole): ``Trajectory``
(:87, the multi-frame dump and XYZ readers over the native table parser,
the list API with fancy indexing, ``save`` with vacuum padding),
``XYZTrajectory`` (:375) and ``unwrap_trajectory`` (:432, the three unwrap
paths of the reference's unwrap_trajectory.py: xu/yu/zu rename, image
flags with each frame's own box, minimum-image scan).  A trajectory read
from a file makes its frames ``System``s on ``device`` (the card by
default); ``unwrap_trajectory`` keeps the first frame's device.
"""

from __future__ import annotations

import warnings
from typing import Iterable, List, Optional, Sequence

import numpy as np

from ..core.box import Box
from ..core.frame import AtomFrame
from .load_save import (
    _open_text,
    parse_dump_frame,
    parse_xyz_frame,
    _xyz_parse_body,
    _xyz_properties_schema,
    _parse_xyz_comment,
    write_dump,
    write_xyz,
)

__all__ = ["Trajectory", "XYZTrajectory", "unwrap_trajectory"]


def _infer_trajectory_format(filename: str) -> str:
    name = str(filename)
    if name.endswith(".gz"):
        name = name[:-3]
    low = name.lower()
    if low.endswith(".xyz"):
        return "xyz"
    if low.endswith(".dump") or low.endswith(".lammpstrj"):
        return "dump"
    raise ValueError(
        f"Cannot infer trajectory format from '{filename}'; pass format='xyz' or 'dump'."
    )


def _read_lines(filename: str) -> List[str]:
    with _open_text(filename) as f:
        return f.read().splitlines()


def _split_dump_frames(lines: List[str]) -> List[List[str]]:
    starts = [i for i, ln in enumerate(lines) if ln.startswith("ITEM: TIMESTEP")]
    frames = []
    for k, s in enumerate(starts):
        e = starts[k + 1] if k + 1 < len(starts) else len(lines)
        frames.append(lines[s:e])
    return frames


def _has_cell(info: dict) -> bool:
    lat = info.get("Lattice", info.get("lattice"))
    if lat is None:
        return False
    try:
        return np.fromiter(str(lat).split(), dtype=np.float64).size == 9
    except ValueError:
        return False


def _xyz_frame_offsets(lines: List[str]) -> List[int]:
    offsets = []
    i, n = 0, len(lines)
    while i < n:
        if not lines[i].strip():
            i += 1
            continue
        natoms = int(lines[i].split()[0])
        offsets.append(i)
        i += 2 + natoms
    return offsets


class Trajectory:
    """A list of :class:`System` frames with unified multi-frame IO.

    Read from a `.dump` / `.lammpstrj` / `.xyz` (optionally `.gz`) file,
    or wrap an in-memory list via ``systems=[...]``. Supports the python
    list API plus numpy-style fancy indexing (int arrays, boolean masks).
    """

    _forced_format: Optional[str] = None

    def __init__(
        self,
        filename: Optional[str] = None,
        systems: Optional[Iterable] = None,
        format: Optional[str] = None,
        fast_mode: bool = False,
        verbose: bool = True,
        device="cuda",
    ):
        self._unwrap_method: Optional[str] = None
        if systems is not None:
            self._frames = list(systems)
            return
        if filename is None:
            self._frames = []
            return
        try:
            inferred = _infer_trajectory_format(filename)
        except ValueError:
            inferred = None
        fmt = format or inferred or self._forced_format
        if fmt is None:
            raise ValueError(
                f"Cannot infer trajectory format from '{filename}'; "
                "pass format='xyz' or 'dump'."
            )
        if self._forced_format is not None and fmt != self._forced_format:
            raise ValueError(f"{type(self).__name__} only reads {self._forced_format}")
        if fmt == "dump":
            if fast_mode:
                raise ValueError(
                    "fast_mode is not supported for LAMMPS dump trajectories; "
                    "the serial reader is already vectorised per frame. "
                    "Drop the fast_mode flag."
                )
            self._frames = self._read_dump(filename, verbose, device)
        elif fmt == "xyz":
            self._frames = self._read_xyz(filename, fast_mode, verbose, device)
        else:
            raise ValueError(f"Unknown trajectory format {fmt!r}")

    # ------------------------------------------------------------------ read
    @staticmethod
    def _read_dump(filename: str, verbose: bool, device) -> List:
        from ..core.system import System
        from .load_save import _read_bytes, parse_dump_bytes

        # Columnar fast path: walk the raw buffer frame by frame through the
        # native table parser; each frame's body is bounded by skip_rows so
        # multi-frame files stay O(file) total.
        raw = _read_bytes(filename)
        frames: List = []
        pos, nb = 0, len(raw)
        fast_ok = True
        k = 0
        while pos < nb:
            while pos < nb and raw[pos] in b" \t\r\n":
                pos += 1
            if pos >= nb:
                break
            out = parse_dump_bytes(raw, pos)
            if out is None:
                fast_ok = False
                break
            frame, box, ginfo, end = out
            frames.append(System(data=frame, box=box, global_info=ginfo,
                                 device=device))
            k += 1
            if verbose:
                print(f"[dump.serial] frame {k} ({frame.nrows} atoms)")
            pos = end
        if fast_ok:
            return frames

        lines = _read_lines(filename)
        chunks = _split_dump_frames(lines)
        frames = []
        for k, chunk in enumerate(chunks):
            frame, box, ginfo = parse_dump_frame(chunk)
            frames.append(System(data=frame, box=box, global_info=ginfo,
                                 device=device))
            if verbose:
                print(f"[dump.serial] frame {k + 1}/{len(chunks)} ({frame.nrows} atoms)")
        return frames

    @staticmethod
    def _read_xyz(filename: str, fast_mode: bool, verbose: bool, device) -> List:
        from ..core.system import System

        lines = _read_lines(filename)
        offsets = _xyz_frame_offsets(lines)
        frames: List = []
        if not fast_mode:
            for k, off in enumerate(offsets):
                frame, box, ginfo = parse_xyz_frame(lines, off)
                frames.append(System(data=frame, box=box, global_info=ginfo,
                                     device=device))
                if verbose:
                    print(f"[xyz.serial] frame {k + 1}/{len(offsets)} ({frame.nrows} atoms)")
            return frames
        # fast path: group consecutive frames sharing a Properties schema and
        # parse their concatenated bodies in one vectorised pass.
        metas = []  # (offset, natoms, schema-key or None)
        for off in offsets:
            natoms = int(lines[off].split()[0])
            comment = lines[off + 1] if off + 1 < len(lines) else ""
            info = _parse_xyz_comment(comment)
            pv = info.get("Properties", info.get("properties"))
            if _has_cell(info) or ":" in str(pv or ""):
                key = str(pv or "species:S:1:pos:R:3")
            else:
                key = None
            metas.append((off, natoms, key))
        parsed_cols = {}  # frame index -> cols dict
        i = 0
        while i < len(metas):
            j = i
            key = metas[i][2]
            while j < len(metas) and metas[j][2] == key and key is not None:
                j += 1
            if key is None:
                j = i + 1
            group = metas[i:j]
            body: List[str] = []
            counts = []
            for off, natoms, _ in group:
                body.extend(lines[off + 2 : off + 2 + natoms])
                counts.append(natoms)
            if key is None:
                names, dtypes = ["element", "x", "y", "z"], ["S", "R", "R", "R"]
            else:
                names, dtypes = _xyz_properties_schema(key)
            try:
                cols = _xyz_parse_body(body, names, dtypes)
            except Exception:
                cols = None  # non-uniform body; fall back per frame
            if cols is None:
                for k in range(i, j):
                    parsed_cols[k] = None
            else:
                splits = np.cumsum(counts)[:-1]
                per = {c: np.split(v, splits) for c, v in cols.items()}
                for local, k in enumerate(range(i, j)):
                    parsed_cols[k] = {c: per[c][local] for c in per}
            i = j
        for k, (off, natoms, key) in enumerate(metas):
            if parsed_cols[k] is None:
                frame, box, ginfo = parse_xyz_frame(lines, off)
                frames.append(System(data=frame, box=box, global_info=ginfo,
                                     device=device))
                continue
            # rebuild box/global_info from the comment, reuse parsed columns
            comment = lines[off + 1] if off + 1 < len(lines) else ""
            info = _parse_xyz_comment(comment)
            cols = parsed_cols[k]
            ginfo = {}
            if key is not None:
                from .load_save import _maybe_number

                for kk, vv in info.items():
                    if kk not in ("Lattice", "lattice", "Properties", "properties", "pbc", "Origin"):
                        ginfo[kk] = _maybe_number(vv)
            if _has_cell(info):
                lat = np.fromiter(str(info.get("Lattice", info.get("lattice"))).split(), dtype=np.float64)
                boundary = [1, 1, 1]
                if "pbc" in info:
                    boundary = [
                        1 if t in ("T", "True", "1") else 0 for t in str(info["pbc"]).split()
                    ]
                origin = np.zeros(3)
                if "Origin" in info:
                    origin = np.fromiter(str(info["Origin"]).split(), dtype=np.float64)
                box = Box(lat.reshape(3, 3), boundary, origin)
            else:
                pos = np.column_stack([cols["x"], cols["y"], cols["z"]])
                lo, hi = pos.min(0) - 5.0, pos.max(0) + 5.0
                box = Box(np.diag(hi - lo), [0, 0, 0], lo)
            from .load_save import _normalize_types

            frames.append(
                System(data=AtomFrame(_normalize_types(dict(cols))), box=box,
                       global_info=ginfo, device=device)
            )
        if verbose:
            print(f"[xyz.fast] read {len(frames)} frames")
        return frames

    # -------------------------------------------------------------- list API
    def __len__(self) -> int:
        return len(self._frames)

    def __iter__(self):
        return iter(self._frames)

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return self._frames[int(key)]
        if isinstance(key, slice):
            return self._wrap(self._frames[key])
        arr = np.asarray(key)
        if arr.dtype == bool:
            if arr.shape != (len(self._frames),):
                raise IndexError(
                    f"boolean mask length {arr.size} does not match trajectory "
                    f"length {len(self._frames)}"
                )
            return self._wrap([f for f, m in zip(self._frames, arr) if m])
        if arr.dtype.kind in "iu":
            n = len(self._frames)
            out = []
            for idx in arr.ravel().tolist():
                if idx < -n or idx >= n:
                    raise IndexError(f"index {idx} is out of bounds for length {n}")
                out.append(self._frames[idx])
            return self._wrap(out)
        raise TypeError(f"Invalid trajectory index {key!r}")

    def _wrap(self, frames: List) -> "Trajectory":
        out = type(self)(systems=frames)
        out._unwrap_method = self._unwrap_method
        return out

    def append(self, system) -> None:
        self._frames.append(system)

    def extend(self, systems: Iterable) -> None:
        self._frames.extend(systems)

    def insert(self, idx: int, system) -> None:
        self._frames.insert(idx, system)

    def pop(self, idx: int = -1):
        return self._frames.pop(idx)

    def get_atoms_count(self) -> np.ndarray:
        return np.array([s.N for s in self._frames], dtype=np.int64)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({len(self)} frames)"

    # ------------------------------------------------------------------ save
    def save(
        self,
        filename: str,
        format: Optional[str] = None,
        mode: str = "w",
        frames: Optional[Sequence[int]] = None,
        vacuum: float = 0.0,
    ) -> None:
        if vacuum < 0:
            raise ValueError("vacuum must be >= 0")
        fmt = format or self._forced_format or _infer_trajectory_format(filename)
        systems = self._frames if frames is None else [self._frames[i] for i in frames]
        if fmt == "dump":
            if vacuum > 0:
                warnings.warn(
                    "vacuum padding is ignored for LAMMPS dump output "
                    "(dump already requires an explicit box)",
                    UserWarning,
                )
            for k, s in enumerate(systems):
                ts = int(s.global_info.get("timestep", k))
                write_dump(
                    filename, s.data, s.box, timestep=ts,
                    mode=mode if k == 0 else "a",
                )
        elif fmt == "xyz":
            for k, s in enumerate(systems):
                data, box = s.data, s.box
                if vacuum > 0 and not all(box.boundary):
                    data, box = _pad_vacuum(data, box, vacuum)
                classical = False
                write_xyz(
                    filename, data, box, classical, s.global_info,
                    mode=mode if k == 0 else "a",
                )
        else:
            raise ValueError(f"Unknown trajectory format {fmt!r}")

    # ---------------------------------------------------------------- unwrap
    def unwrap(self) -> "Trajectory":
        return unwrap_trajectory(self)


class XYZTrajectory(Trajectory):
    """XYZ-only trajectory (same list API/container as :class:`Trajectory`)."""

    _forced_format = "xyz"


def _pad_vacuum(data: AtomFrame, box: Box, vacuum: float):
    """Pad open axes of an orthogonal box by ``vacuum`` (atoms centred),
    marking padded axes periodic. Works on copies; input untouched."""
    m = box.matrix.copy()
    origin = box.origin.copy()
    boundary = list(box.boundary)
    cols = {c: np.array(data[c], copy=True) for c in data.columns}
    shift = np.zeros(3)
    for ax, name in enumerate("xyz"):
        if boundary[ax]:
            continue
        m[ax, ax] += vacuum
        shift[ax] = vacuum / 2.0 - origin[ax]
        origin[ax] = 0.0
        boundary[ax] = 1
    cols["x"] = cols["x"] + shift[0]
    cols["y"] = cols["y"] + shift[1]
    cols["z"] = cols["z"] + shift[2]
    return AtomFrame(cols), Box(m, boundary, origin)


# ---------------------------------------------------------------------------
# unwrap
# ---------------------------------------------------------------------------

_CARRY_COLS = ("id", "type", "element")


def _canonical_order(system) -> np.ndarray:
    if "id" in system.data:
        return np.argsort(np.asarray(system.data["id"]), kind="stable")
    return np.arange(system.N)


def _tilt_flip_between(prev_mat: np.ndarray, mat: np.ndarray) -> bool:
    """Heuristic for a LAMMPS triclinic cell flip between two frames.

    LAMMPS clamps each tilt factor (xy, xz, yz) to +-half the relevant edge;
    drifting past the clamp re-folds the cell, jumping the tilt by ~one full
    edge length. A jump > 0.7 of the edge cannot be thermal box breathing
    (parity: reference unwrap_trajectory.py:116-137).
    """
    ax, by = prev_mat[0, 0], prev_mat[1, 1]
    if ax <= 0 or by <= 0:
        return False
    for (i, j), denom in (((1, 0), ax), ((2, 0), ax), ((2, 1), by)):
        if abs(mat[i, j] - prev_mat[i, j]) / denom > 0.7:
            return True
    return False


def unwrap_trajectory(traj: Trajectory) -> Trajectory:
    """Unwrap PBC-wrapped coordinates across a trajectory.

    Priority (reference unwrap_trajectory.py):
      1. ``xu/yu/zu`` columns present in every frame -> direct rename.
      2. ``ix/iy/iz`` image flags -> combine with each frame's own cell
         (handles NPT box breathing).
      3. Minimum-image scan of consecutive displacements (periodic axes
         only), tracking atoms by ``id`` when present.

    Output frames carry only id/type/element + unwrapped x/y/z, emitted in
    ascending-id order.
    """
    from ..core.system import System

    frames = list(traj)
    if not frames:
        out = Trajectory(systems=[])
        out._unwrap_method = None
        return out
    n0 = frames[0].N
    for f in frames:
        if f.N != n0:
            raise ValueError("All frames must have the same number of atoms")
    bnd0 = tuple(frames[0].box.boundary)
    for f in frames[1:]:
        if tuple(f.box.boundary) != bnd0:
            warnings.warn(
                "PBC flags change between frames; using frame 0's flags",
                RuntimeWarning,
            )
            break

    have_id = all("id" in f.data for f in frames)
    orders = [_canonical_order(f) for f in frames]
    if have_id:
        ids0 = np.asarray(frames[0].data["id"])[orders[0]]
        for f, o in zip(frames[1:], orders[1:]):
            if not np.array_equal(np.asarray(f.data["id"])[o], ids0):
                raise ValueError("Frames have different id set")

    if all(all(c in f.data for c in ("xu", "yu", "zu")) for f in frames):
        method = "unwrapped"
        unwrapped = [
            np.column_stack([f.data["xu"], f.data["yu"], f.data["zu"]])[o]
            for f, o in zip(frames, orders)
        ]
    elif all(all(c in f.data for c in ("ix", "iy", "iz")) for f in frames):
        method = "image"
        unwrapped = []
        for f, o in zip(frames, orders):
            img = np.column_stack([f.data["ix"], f.data["iy"], f.data["iz"]]).astype(float)
            unwrapped.append((f.pos + img @ f.box.matrix)[o])
    else:
        method = "min_image"
        periodic = np.asarray(bnd0, dtype=float)
        prev_wrapped = frames[0].pos[orders[0]]
        cur = prev_wrapped.copy()
        unwrapped = [cur]
        prev_mat = np.asarray(frames[0].box.matrix, dtype=float)
        flip_warned = False
        for f, o in zip(frames[1:], orders[1:]):
            mat = np.asarray(f.box.matrix, dtype=float)
            if not flip_warned and _tilt_flip_between(prev_mat, mat):
                warnings.warn(
                    "unwrap_trajectory: possible LAMMPS triclinic cell flip "
                    "between consecutive frames; the minimum-image heuristic "
                    "cannot follow the re-folded tilt — re-dump with image "
                    "flags (dump_modify pbc yes) for a reliable unwrap.",
                    RuntimeWarning,
                )
                flip_warned = True
            prev_mat = mat
            wrapped = f.pos[o]
            disp = wrapped - prev_wrapped
            inv = np.linalg.inv(f.box.matrix)
            # only the integer image shift goes through the cell matrix, so
            # non-crossing displacements stay bit-exact
            shift = np.round(disp @ inv) * periodic
            cur = cur + (disp - shift @ f.box.matrix)
            unwrapped.append(cur)
            prev_wrapped = wrapped

    device = getattr(frames[0], "device", "cuda")
    out_frames = []
    for f, o, pos in zip(frames, orders, unwrapped):
        cols = {}
        for c in _CARRY_COLS:
            if c in f.data:
                cols[c] = np.asarray(f.data[c])[o]
        cols["x"], cols["y"], cols["z"] = pos[:, 0], pos[:, 1], pos[:, 2]
        out_frames.append(
            System(data=AtomFrame(cols), box=f.box,
                   global_info=dict(f.global_info), device=device)
        )
    out = Trajectory(systems=out_frames)
    out._unwrap_method = method
    return out
