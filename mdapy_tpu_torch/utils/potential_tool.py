"""Potential-development tooling.

The port of ``mdapy_tpu/utils/potential_tool.py`` (:1-343): RMSE, GPUMD
thermo reader, NEP training plots, FCC stacking-fault energies, equation
of state, PCA, farthest-point sampling, and MTP-cfg / VASP-OUTCAR ->
extended-XYZ converters for GPUMD training sets.  Host copies, apart from
two changes: ``read_thermo`` returns the port's ``AtomFrame`` with the 18
columns, not a pandas ``DataFrame`` (pandas is optional, and absent on the
card's machine), and the stacking-fault and EOS helpers build the port's
``System`` on the calculator's device and evaluate the port's
calculators.
"""

from __future__ import annotations

import os
import re
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

__all__ = [
    "rmse", "read_thermo", "plot_nep_train", "get_sfe_fcc",
    "get_average_sfe_fcc_hea", "get_eos", "PCA", "fps_sample", "cfg2xyz",
    "read_OUTCAR", "outcar2xyz", "outcars2xyz", "run_gpumd",
]

_THERMO_COLS = "T K U Pxx Pyy Pzz Pyz Pxz Pxy ax ay az bx by bz cx cy cz".split()


def rmse(predictions: np.ndarray, targets: np.ndarray) -> float:
    return float(np.sqrt(((np.asarray(predictions) - np.asarray(targets)) ** 2).mean()))


def read_thermo(path: str):
    """GPUMD thermo.out -> AtomFrame with the 18 canonical columns (one row
    a line; ``.to_pandas()`` gives the JAX package's DataFrame)."""
    from ..core.frame import AtomFrame

    arr = np.atleast_2d(np.loadtxt(Path(path, "thermo.out")))
    return AtomFrame({c: arr[:, i] for i, c in enumerate(_THERMO_COLS)})


def run_gpumd(path: str, gpumd_exe: str = "gpumd"):
    """Run GPUMD in ``path`` (requires the external gpumd binary)."""
    return subprocess.run([gpumd_exe], cwd=path, check=True)


def plot_nep_train(path: str, outname: Optional[str] = None,
                   figdpi: int = 300, **kargs):
    """NEP training dashboard: 3 parity panels + loss curves.

    Reads GPUMD's training outputs (loss.out and *_train.out, whose column
    layout — predicted components first, DFT reference after — is fixed by
    the GPUMD file format)."""
    from .plotset import save_figure, set_figure

    def parity_panel(ax, table, width, quantity, rms_factor, rms_unit):
        ref = table[:, width:2 * width].ravel()
        pred = table[:, :width].ravel()
        score = rmse(ref, pred) * rms_factor
        ax.plot(ref, pred, "o", label=f"RMSE={score:.{1 if rms_factor > 1 else 2}f} {rms_unit}")
        ax.set_xlabel(f"DFT {quantity}")
        ax.set_ylabel(f"NEP {quantity}")
        ax.legend()
        # square the axes around y=x with a 5% margin
        bounds = (*ax.get_xlim(), *ax.get_ylim())
        lo, hi = min(bounds), max(bounds)
        margin = 0.05 * abs(hi - lo)
        window = [lo - margin, hi + margin]
        ax.plot(window, window, "grey")
        ax.set_xlim(window)
        ax.set_ylim(window)

    fig, axes = set_figure(figsize=(16, 14), figdpi=figdpi, nrow=2, ncol=2,
                           **kargs)
    panels = (
        (axes[0][0], "energy_train.out", 1, "energy (eV/atom)", 1000, "meV"),
        (axes[0][1], "force_train.out", 3, r"force (eV/$\AA$)", 1000,
         r"meV/$\AA$"),
        (axes[1][0], "stress_train.out", 6, "stress (GPa)", 1, "GPa"),
    )
    for ax, fname, width, quantity, factor, unit in panels:
        parity_panel(ax, np.loadtxt(Path(path, fname)), width, quantity,
                     factor, unit)

    loss = np.loadtxt(Path(path, "loss.out"))
    loss_ax = axes[1][1]
    for col, tag in ((1, "Total"), (4, "E-train"), (5, "F-train"),
                     (6, "V-train")):
        loss_ax.plot(loss[:, 0], loss[:, col], label=tag)
    loss_ax.set_xlabel("Generation")
    loss_ax.set_ylabel("Loss")
    loss_ax.set_xscale("log")
    loss_ax.set_yscale("log")
    loss_ax.legend()
    if outname is not None:
        save_figure(fig, outname)
    return fig, axes


def _sfe_of(system, calc, a: float) -> float:
    """Shift the top half of a (112)x(-110)x(111) slab by a/sqrt(6) and
    return the energy difference per fault area in mJ/m^2."""
    from ..core.box import Box

    system.calc = calc
    bnd = list(system.box.boundary)
    bnd[2] = 0
    system._box = Box(system.box.matrix, bnd, system.box.origin)
    e1 = system.get_energy()
    z = np.asarray(system.data["z"])
    LZ = z.max() - z.min()
    pos = system.pos
    pos[:, 0] = np.where(z > LZ / 2, pos[:, 0] + a / 6 ** 0.5, pos[:, 0])
    system.update_pos(pos)
    system.wrap_pos()
    system.calc.results = {}
    e2 = system.get_energy()
    area_factor = system.box.matrix[0, 0] * system.box.matrix[1, 1] / 16021.7662
    return (e2 - e1) / area_factor


def _device_of(calc):
    """The device a helper builds its systems on: the calculator's."""
    return getattr(calc, "device", "cuda")


def get_sfe_fcc(name: str, a: float, calc) -> float:
    """Intrinsic stacking fault energy of an FCC crystal, in mJ/m^2.  The
    slab is built on the calculator's device."""
    from ..build.lattice import build_crystal

    system = build_crystal(name, "fcc", a, nx=3, ny=3, nz=4,
                           miller1=[1, 1, 2], miller2=[1, -1, 0],
                           miller3=[1, 1, -1], device=_device_of(calc))
    return _sfe_of(system, calc, a)


def get_average_sfe_fcc_hea(N: int, element_list: List[str],
                            element_ratio: List[float], a: float,
                            calc) -> np.ndarray:
    """Running-average SFE over N random HEA samples -> (N-1, 2) array of
    [i, mean(sfe[:i])].  The slabs are built on the calculator's device."""
    from ..build.lattice import build_hea

    sfe = []
    for seed in range(1, N + 1):
        system = build_hea(element_list, element_ratio, "fcc", a,
                           nx=3, ny=3, nz=4, miller1=[1, 1, 2],
                           miller2=[1, -1, 0], miller3=[1, 1, -1],
                           random_seed=seed, device=_device_of(calc))
        sfe.append(_sfe_of(system, calc, a))
    return np.array([[i, np.mean(sfe[:i])] for i in range(1, len(sfe))])


def get_eos(system, scale_start: float, scale_end: float, num: int) -> np.ndarray:
    """Isotropic-scaling equation of state -> (num, 2) array of
    [volume/atom, energy/atom], each scaled copy on ``system``'s device."""
    assert 0 < scale_start < scale_end
    from ..core.system import System

    out = []
    for s in np.linspace(scale_start, scale_end, num):
        cols = {c: np.array(system.data[c], copy=True)
                for c in system.data.columns}
        for c in "xyz":
            cols[c] = cols[c] * s
        cur = System(data=cols, box=system.box.matrix * s,
                     boundary=system.box.boundary, device=system.device)
        cur.calc = system.calc
        cur.calc.results = {}
        out.append([abs(cur.box.volume) / cur.N, cur.get_energy() / cur.N])
    system.calc.results = {}
    return np.array(out)


class PCA:
    """Eigendecomposition PCA with sklearn-style deterministic signs."""

    def __init__(self, n_components: int):
        self.n_components = n_components
        self.explained_variance = None
        self.explained_variance_ratio = None

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=float)
        Xc = X - X.mean(axis=0)
        evals, evecs = np.linalg.eigh(np.cov(Xc.T))
        order = np.argsort(evals)[::-1]
        evals, evecs = evals[order], evecs[:, order]
        comp = evecs[:, : self.n_components]
        self.explained_variance = evals[: self.n_components]
        self.explained_variance_ratio = evals[: self.n_components] / evals.sum()
        max_abs = np.argmax(np.abs(comp), axis=0)
        comp = comp * np.sign(comp[max_abs, np.arange(self.n_components)])
        return Xc @ comp


def fps_sample(n_sample: int, descriptors: np.ndarray,
               start_idx: int = 0) -> np.ndarray:
    """Farthest-point sampling of descriptor rows (active learning)."""
    descriptors = np.asarray(descriptors)
    assert descriptors.ndim == 2, "Only support 2-D ndarray."
    n_points = descriptors.shape[0]
    assert 0 < n_sample <= n_points
    assert 0 <= start_idx < n_points
    sampled = [start_idx]
    min_d = np.full(n_points, np.inf)
    cur = start_idx
    for _ in range(n_sample - 1):
        d = np.linalg.norm(descriptors - descriptors[cur], axis=1)
        min_d = np.minimum(min_d, d)
        cur = int(np.argmax(min_d))
        sampled.append(cur)
    return np.array(sampled, np.int32)


def cfg2xyz(file_list: Union[List[str], str], type_dict: Dict[int, str],
            output_name: str = "train.xyz", f_max: float = 25.0) -> None:
    """MTP cfg frames -> extended XYZ (energy/force/virial), filtering
    frames whose max |force| exceeds ``f_max``."""
    if isinstance(file_list, str):
        file_list = [file_list]
    with open(output_name, "a") as op:
        for cfg in file_list:
            with open(cfg) as fh:
                frames = fh.read().split("BEGIN_CFG")[1:]
            for frame in frames:
                lines = frame.split("\n")
                N = int(lines[2].strip())
                box = []
                for ln in lines[4:7]:
                    box.extend(ln.split())
                tpf = [ln.split()[1:] for ln in lines[8 : 8 + N]]
                forces = np.array(tpf)[:, -3:].astype(float)
                if np.abs(forces).max() > f_max:
                    continue
                energy = lines[8 + N + 1].strip()
                vxx, vyy, vzz, vyz, vxz, vxy = lines[8 + N + 3].strip().split()
                op.write(f"{N}\n")
                lat = " ".join(box)
                op.write(
                    f'Lattice="{lat}" energy={energy} '
                    f'virial="{vxx} {vxy} {vxz} {vxy} {vyy} {vyz} '
                    f'{vxz} {vyz} {vzz}" '
                    "properties=species:S:1:pos:R:3:force:R:3\n"
                )
                for row in tpf:
                    op.write(f"{type_dict[int(row[0])]} {' '.join(row[1:])}\n")


def read_OUTCAR(filename: str) -> Union[Dict, bool]:
    """Parse a single-point VASP OUTCAR; False if not converged.

    Regex-driven section scanner.  The VASP text markers are fixed format;
    the returned dict keeps the contract the xyz converters expect
    (lattice / pos_force / virial as whitespace-joined strings, capability
    parity with reference potential_tool.py:507)."""
    text = Path(filename).read_text()
    if "aborting loop because EDIFF is reached" not in text:
        return False
    lines = text.split("\n")

    natom = int(re.search(r"number of ions\s+NIONS\s*=\s*(\d+)", text).group(1))
    # last SCF step's total energy / last ISIF setting win
    energy = float(
        re.findall(r"free\s+energy\s+TOTEN\s*=\s*([-+0-9.Ee]+)", text)[-1]
    )
    isif = re.findall(r"\bISIF\s*=\s*(-?\d+)", text)

    counts = re.findall(r"ions per type\s*=\s*((?:\d+\s*)+)", text)
    per_kind = [int(t) for t in counts[-1].split()] if counts else []
    kinds: List[str] = []
    for m in re.finditer(r"POTCAR:\s+\S+\s+(\S+)", text):
        k = m.group(1).split("_")[0]
        if k not in kinds:
            kinds.append(k)
    symbols = [k for k, c in zip(kinds, per_kind) for _ in range(c)]

    # "VOLUME and BASIS-vectors" block: direct lattice rows are lines 5-7
    # after the marker; columns can fuse on sign, so split glued negatives
    block = text.split("VOLUME and BASIS-vectors are now", 1)[1].split("\n")
    cell: List[str] = []
    for row in block[5:8]:
        row = re.sub(r"(?<=\d)-", " -", row)
        cell.extend(row.split()[:3])

    force_rows: List[str] = []
    marks = [i for i, ln in enumerate(lines) if "TOTAL-FORCE (eV/Angst)" in ln]
    if marks:
        top = marks[-1] + 2  # skip the dashed rule under the header
        force_rows = [
            " ".join(lines[j].split()) for j in range(top, top + natom)
        ]

    virial = None
    if isif and int(isif[-1]) != 0:
        tot = re.findall(
            r"FORCE on cell =-STRESS[\s\S]*?Total\s+([-\d.\s]+)", text
        )[-1]
        xx, yy, zz, xy, yz, zx = tot.split()[:6]
        full = ((xx, xy, zx), (xy, yy, yz), (zx, yz, zz))
        virial = " ".join(v for row in full for v in row)

    return {
        "Natom": natom,
        "lattice": " ".join(cell),
        "energy": energy,
        "pos_force": force_rows,
        "symbols": symbols,
        "virial": virial,
    }


def outcar2xyz(outcar_list: Union[List[str], str],
               output_path: str = "train.xyz", mode: str = "w",
               print_no_converge: bool = True) -> None:
    """Single-point VASP OUTCARs -> extended XYZ training frames."""
    if isinstance(outcar_list, str):
        outcar_list = [outcar_list]
    assert mode in ("w", "a"), "Only support w or a mode."
    not_converged = []
    with open(output_path, mode) as out_f:
        for outcar in outcar_list:
            data = read_OUTCAR(outcar)
            if not data:
                not_converged.append(outcar)
                continue
            out_f.write(f"{data['Natom']}\n")
            props = "Properties=species:S:1:pos:R:3:forces:R:3"
            if data["virial"] is not None:
                out_f.write(
                    f'energy={data["energy"]:.6f} Lattice="{data["lattice"]}" '
                    f'virial="{data["virial"]}" {props} pbc="T T T"\n'
                )
            else:
                out_f.write(
                    f'energy={data["energy"]:.6f} Lattice="{data["lattice"]}" '
                    f'{props} pbc="T T T"\n'
                )
            for symbol, pf in zip(data["symbols"], data["pos_force"]):
                out_f.write(f"{symbol} {pf}\n")
    if not_converged and print_no_converge:
        for f in not_converged:
            print(f"{f} is not converged!")


def outcars2xyz(outcar_list: Union[List[str], str],
                output_path: str = "train.xyz", mode: str = "w",
                print_no_converge: bool = True) -> None:
    """Alias of :func:`outcar2xyz` (multi-file input)."""
    outcar2xyz(outcar_list, output_path, mode, print_no_converge)
