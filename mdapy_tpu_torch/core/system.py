"""System — the central data hub (frame + box + cached neighbors + calc).

A host copy of ``mdapy_tpu/core/system.py`` (``System`` :34-984):
constructor routes (filename / frame+box / pos+box / ase / ovito), the box
setter's cache invalidation, ``update_pos``, ``update_box(scale_pos)``,
``wrap_pos``, ``replicate``, ``align_to_lammps``, the writers,
``build_neighbor`` and ``build_nearest_neighbor`` (through the port's
``neighbor_search`` and ``knn_search``), ``create_bonds``,
``delete_overlap``, ``average_by_neighbor``, the calculator accessors, and
the ``cal_*`` analyses.  Per-atom data lives in an ``AtomFrame`` (numpy
columns).

``System`` takes ``device`` (the card by default; without one it raises
unless ``device="cpu"``), and every neighbor build and analysis it starts
runs there.  Each ``cal_*`` calls the port's class on the system's device
and stores its columns as the JAX package does.  PTM's matching, the
Voronoi cells and the planar faults run on the host (the native engines
and numpy), their neighbor lists on the device.

``cal_chemical_species`` gives the JAX method's dict, formulas,
``most_common`` order and ``mol_id`` from a grouped count (the labels
sorted once, (label, element) pairs counted by an integer ``bincount``, one
formula string a distinct composition), where the JAX method visits every
atom once a molecule (``mdapy_tpu/core/system.py:948-955``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np

from .box import Box, init_box
from .device import resolve_device
from .elements import atomic_masses, atomic_numbers, symbols_to_numbers, vdw_radii
from .frame import AtomFrame

__all__ = ["System"]


class System:
    def __init__(
        self,
        filename: Optional[str] = None,
        fmt: Optional[str] = None,
        data: Optional[Union[AtomFrame, Dict[str, np.ndarray]]] = None,
        box=None,
        pos: Optional[np.ndarray] = None,
        type_list: Optional[np.ndarray] = None,
        element_list=None,
        boundary=None,
        origin=None,
        global_info: Optional[dict] = None,
        ase_atom=None,
        ovito_atom=None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device, "System")
        self.global_info: dict = dict(global_info or {})
        if ase_atom is not None:
            from ..io.load_save import BuildSystem

            frame, bx, ginfo = BuildSystem.from_ase(ase_atom)
            data, box = frame, bx
        elif ovito_atom is not None:
            from ..io.load_save import BuildSystem

            frame, bx, ginfo = BuildSystem.from_ovito(ovito_atom)
            self.global_info.update(ginfo)
            data, box = frame, bx
        if filename is not None:
            from ..io.load_save import BuildSystem

            frame, bx, ginfo = BuildSystem.from_file(filename, fmt)
            self._data = frame
            self._box = bx if boundary is None else Box(bx, boundary)
            self.global_info.update(ginfo)
            self.filename = filename
        elif data is not None:
            self._data = data if isinstance(data, AtomFrame) else AtomFrame(data)
            if box is None:
                raise ValueError("data requires an explicit box")
            self._box = init_box(box, boundary, origin)
            self.filename = None
        elif pos is not None:
            pos = np.ascontiguousarray(pos, dtype=np.float64)
            n = pos.shape[0]
            cols = {
                "id": np.arange(1, n + 1, dtype=np.int32),
                "type": (
                    np.asarray(type_list, dtype=np.int32)
                    if type_list is not None
                    else np.ones(n, dtype=np.int32)
                ),
                "x": pos[:, 0],
                "y": pos[:, 1],
                "z": pos[:, 2],
            }
            if element_list is not None:
                cols["element"] = np.asarray(element_list, dtype=object)
            self._data = AtomFrame(cols)
            if box is None:
                raise ValueError("pos requires an explicit box")
            self._box = init_box(box, boundary, origin)
            self.filename = None
        else:
            raise ValueError("Provide filename, data, or pos")
        if "id" not in self._data:
            self._data["id"] = np.arange(1, self._data.nrows + 1, dtype=np.int32)
        if "type" not in self._data:
            if "element" in self._data:
                elems = np.asarray(self._data["element"]).astype(str)
                uniq = sorted(set(elems), key=list(elems).index)
                tmap = {e: i + 1 for i, e in enumerate(uniq)}
                self._data["type"] = np.array([tmap[e] for e in elems], dtype=np.int32)
            else:
                self._data["type"] = np.ones(self._data.nrows, dtype=np.int32)
        self._clear_cache()
        self._calc = None

    # ------------------------------------------------------------------ state
    def _clear_cache(self) -> None:
        self.verlet_list: Optional[np.ndarray] = None
        self.distance_list: Optional[np.ndarray] = None
        self.neighbor_number: Optional[np.ndarray] = None
        self.rc: float = 0.0
        self.bond: Optional[np.ndarray] = None
        self._compute_cache: dict = {}

    @property
    def data(self) -> AtomFrame:
        return self._data

    @property
    def box(self) -> Box:
        return self._box

    @property
    def N(self) -> int:
        return self._data.nrows

    def __len__(self) -> int:
        return self.N

    def __repr__(self) -> str:
        return f"System({self.N} atoms; columns={self._data.columns})\n{self._box!r}"

    @property
    def pos(self) -> np.ndarray:
        return np.column_stack([self._data["x"], self._data["y"], self._data["z"]])

    def get_positions(self) -> np.ndarray:
        return self.pos

    @property
    def vel(self) -> Optional[np.ndarray]:
        if "vx" in self._data:
            return np.column_stack(
                [self._data["vx"], self._data["vy"], self._data["vz"]]
            )
        return None

    def get_velocities(self) -> AtomFrame:
        """Velocity columns as a frame (parity: system.py:479)."""
        assert "vx" in self._data, "data must contain vx, vy, vz columns."
        return self._data.select(["vx", "vy", "vz"])

    @property
    def calc(self):
        """Attached calculator (parity: system.py:248-258)."""
        return self._calc

    @calc.setter
    def calc(self, value):
        from ..potentials.calculator import CalculatorMP

        if not isinstance(value, CalculatorMP):
            raise TypeError(
                f"calc must be CalculatorMP, instead of {type(value).__name__}"
            )
        value.results = {}
        self._calc = value

    def set_element(self, element) -> None:
        """Assign element names: one symbol for all atoms, or per-atom list
        (parity: system.py:333-377)."""
        if isinstance(element, str):
            elems = np.full(self.N, element, dtype=object)
        else:
            assert len(element) == self.N, (
                f"Length of element ({len(element)}) must equal the atom "
                f"number ({self.N})."
            )
            elems = np.asarray(element, dtype=object)
        self._data["element"] = elems
        self._clear_cache()

    def set_type_by_element(self, element_list) -> None:
        """Assign 1-based types from the index of each atom's element in
        ``element_list`` (parity: system.py:379-432)."""
        assert "element" in self._data, "Data must contain element column."
        elems = np.asarray(self._data["element"]).astype(str)
        lut = {e: i for i, e in enumerate(element_list, start=1)}
        missing = set(elems.tolist()) - set(lut)
        assert not missing, (
            f"element_list must include elements {sorted(missing)} "
            "(seen in data['element'])."
        )
        self._data["type"] = np.array([lut[e] for e in elems], dtype=np.int32)
        self._clear_cache()

    def set_pka(
        self,
        energy: float,
        direction: np.ndarray,
        index: Optional[int] = None,
        element: Optional[str] = None,
        factor: float = 1.0,
    ) -> None:
        """Assign PKA kinetic energy/direction for cascade setup
        (parity: system.py:503-561; velocity units A/fs via ``factor``).
        A copy of ``mdapy_tpu/core/system.py:203-221``."""
        from ..utils.tool_function import set_pka as _set_pka

        for c in ("vx", "vy", "vz"):
            assert c in self._data, f"data must contain {c}."
            self._data[c] = np.asarray(self._data[c], np.float64) * factor
        try:
            _set_pka(self, energy, direction, index=index, element=element)
        finally:
            for c in ("vx", "vy", "vz"):
                self._data[c] = np.asarray(self._data[c], np.float64) / factor

    # ------------------------------------------------------------- mutation
    def update_data(self, data: Union[AtomFrame, Dict[str, np.ndarray]]) -> None:
        """Replace per-atom data; invalidates neighbor caches (system.py:686)."""
        self._data = data if isinstance(data, AtomFrame) else AtomFrame(data)
        self._clear_cache()

    def update_box(self, box, scale_pos: bool = False) -> None:
        """Replace the box; optionally remap fractional positions (system.py:750)."""
        new_box = init_box(box, self._box.boundary, None)
        if scale_pos:
            frac = (self.pos - self._box.origin) @ self._box.inverse_box
            new_pos = frac @ new_box.matrix + new_box.origin
            self.update_pos(new_pos)
        self._box = new_box
        self._clear_cache()

    def update_pos(self, pos: np.ndarray) -> None:
        pos = np.ascontiguousarray(pos, dtype=np.float64)
        self._data["x"], self._data["y"], self._data["z"] = (
            pos[:, 0].copy(),
            pos[:, 1].copy(),
            pos[:, 2].copy(),
        )
        self._clear_cache()

    def wrap_pos(self) -> None:
        """Wrap positions into the primary cell (system.py:854)."""
        self.update_pos(self._box.wrap(self.pos))

    def replicate(self, nx: int = 1, ny: int = 1, nz: int = 1) -> None:
        """In-place supercell replication (system.py:890 / repeat_cell.cpp:65)."""
        reps = int(nx) * int(ny) * int(nz)
        if reps == 1:
            return
        pos = self.pos
        n = pos.shape[0]
        shifts = []
        for ix in range(nx):
            for iy in range(ny):
                for iz in range(nz):
                    shifts.append(
                        ix * self._box.matrix[0]
                        + iy * self._box.matrix[1]
                        + iz * self._box.matrix[2]
                    )
        shifts = np.array(shifts)
        new_pos = (pos[None] + shifts[:, None]).reshape(-1, 3)
        frame = self._data.tile(reps)
        frame["x"], frame["y"], frame["z"] = new_pos[:, 0], new_pos[:, 1], new_pos[:, 2]
        frame["id"] = np.arange(1, n * reps + 1, dtype=np.int32)
        self._data = frame
        self._box = self._box.replicate(nx, ny, nz)
        self._clear_cache()

    # ------------------------------------------------------------------ I/O
    def write_dump(self, filename: str, timestep: int = 0, compress: bool = False):
        from ..io.load_save import write_dump

        write_dump(filename, self._data, self._box, timestep, compress)

    def write_xyz(self, filename: str, classical: bool = False, **kw):
        from ..io.load_save import write_xyz

        write_xyz(filename, self._data, self._box, classical, self.global_info, **kw)

    def write_poscar(self, filename: str, direct: bool = True):
        from ..io.load_save import write_poscar

        write_poscar(filename, self._data, self._box, direct)

    def write_data(self, filename: str, data_format: str = "atomic", **kw):
        from ..io.load_save import write_data

        write_data(filename, self._data, self._box, data_format, **kw)

    def write_mp(self, filename: str):
        from ..io.load_save import write_mp

        write_mp(filename, self._data, self._box, self.global_info)

    def to_ovito(self):
        """Convert to an ovito DataCollection (parity: system.py:891 /
        load_save.py:1435; requires the optional ``ovito`` package)."""
        try:
            from ovito.data import DataCollection
        except ImportError as err:  # pragma: no cover - optional dep
            raise ImportError(
                "to_ovito requires the optional 'ovito' package. "
                "See https://www.ovito.org/manual/python/introduction/installation.html"
            ) from err
        dc = DataCollection()
        cell = dc.create_cell(
            matrix=self._box.matrix.T, pbc=[bool(p) for p in self._box.boundary]
        )
        cell[:, 3] = self._box.origin
        particles = dc.create_particles(count=self.N)
        particles.create_property("Position", data=self.pos)
        if "element" in self._data:
            types = particles.create_property("Particle Type")
            with types as tarray:
                for i, sym in enumerate(
                    np.asarray(self._data["element"]).astype(str)
                ):
                    tarray[i] = types.add_type_name(sym, particles).id
        elif "type" in self._data:
            particles.create_property(
                "Particle Type", data=np.asarray(self._data["type"])
            )
        else:
            particles.create_property(
                "Particle Type", data=np.ones(self.N, np.int32)
            )
        if all(c in self._data for c in ("vx", "vy", "vz")):
            particles.create_property("Velocity", data=self.vel)
        if all(c in self._data for c in ("fx", "fy", "fz")):
            particles.create_property(
                "Force",
                data=np.column_stack(
                    [self._data["fx"], self._data["fy"], self._data["fz"]]
                ),
            )
        skip = {"x", "y", "z", "element", "type", "vx", "vy", "vz", "fx", "fy", "fz"}
        for name in self._data.columns:
            if name in skip:
                continue
            try:
                particles.create_property(name, data=np.asarray(self._data[name]))
            except Exception:
                pass
        for key, value in self.global_info.items():
            try:
                dc.attributes[key] = value
            except Exception:
                pass
        return dc

    def to_ase(self):
        """Convert to ase.Atoms (parity: load_save.py:1378)."""
        from ase import Atoms

        kw = {}
        if "element" in self._data:
            kw["symbols"] = list(np.asarray(self._data["element"]).astype(str))
        atoms = Atoms(
            positions=self.pos,
            cell=self._box.matrix,
            pbc=[bool(b) for b in self._box.boundary],
            **kw,
        )
        return atoms

    def align_to_lammps(self) -> None:
        """Rotate system into LAMMPS lower-triangular cell convention."""
        new_box, rotation = self._box.align_to_lammps_box()
        new_pos = (self.pos - self._box.origin) @ rotation + new_box.origin
        self._box = new_box
        self.update_pos(new_pos)

    # ----------------------------------------------------- compute view
    def _compute_view(self, rc: float) -> Tuple[np.ndarray, Box, int]:
        """(pos_replicated, box_replicated, n_images) for min-image safety.

        Parity: system.py:765 (_get_compute_view).  Image 0 first, so
        per-atom results for rows [0, N) map 1:1 to original atoms and
        neighbor indices map back via ``% N``.
        """
        from ..neighbor.neighbor import replicate_for_small_box

        return replicate_for_small_box(self.pos, self._box, rc)

    # ----------------------------------------------------- neighbors & bonds
    def build_neighbor(self, rc: float = 5.0, max_neigh: Optional[int] = None):
        """Fixed-radius Verlet list (system.py:1108). Results cached on self."""
        from ..neighbor.neighbor import neighbor_search

        self.verlet_list, self.distance_list, self.neighbor_number = neighbor_search(
            self.pos, self._box, rc, max_neigh, device=self.device
        )
        self.rc = float(rc)
        return self.verlet_list, self.distance_list, self.neighbor_number

    def build_nearest_neighbor(self, k: int = 12):
        """k-NN sorted by distance (system.py:1226)."""
        from ..neighbor.knn import knn_search

        verlet, dist = knn_search(self.pos, self._box, k, device=self.device)
        self.verlet_list, self.distance_list = verlet, dist
        self.neighbor_number = np.full(self.N, k, dtype=np.int32)
        self.rc = 0.0
        return verlet, dist

    def build_voronoi_neighbor(
        self,
        a_face_area_threshold: float = -1.0,
        r_face_area_threshold: float = -1.0,
    ) -> None:
        """Voronoi neighbors + shared-face properties (system.py:1168).

        Sets ``voro_verlet_list`` (N, max_neigh; -1 padded),
        ``voro_distance_list``, ``voro_face_area`` and
        ``voro_neighbor_number``.  Faces with area below
        max(a_threshold, cell_total_area * r_threshold) are dropped.  A copy
        of ``mdapy_tpu/core/system.py:415-432``; the rows are compacted on
        the system's device."""
        from ..analysis.voronoi import VoronoiAnalysis

        vor = VoronoiAnalysis(self.pos, self._box, device=self.device)
        vor.compute_neighbors(a_face_area_threshold, r_face_area_threshold)
        self.voro_verlet_list = vor.verlet_list
        self.voro_distance_list = vor.distance_list
        self.voro_face_area = vor.face_areas
        self.voro_neighbor_number = vor.neighbor_number

    def _nlist(self, rc: float, max_neigh: Optional[int] = None):
        """Reuse cached Verlet list when it covers rc, else rebuild.

        Pattern of system.py:1378-1382 / 1449-1455."""
        if (
            self.verlet_list is None
            or self.rc < rc
            or self.rc == 0.0
        ):
            self.build_neighbor(rc, max_neigh)
        return self.verlet_list, self.distance_list, self.neighbor_number

    def _normalize_bond_cutoff(self, rc) -> np.ndarray:
        """scalar | {(ti,tj)|('El','El'): rc} | matrix -> per-type-pair matrix.

        Parity: system.py:1265 (_normalize_bond_cutoff)."""
        ntypes = int(self._data["type"].max())
        if np.isscalar(rc):
            return np.full((ntypes, ntypes), float(rc))
        if isinstance(rc, dict):
            mat = np.zeros((ntypes, ntypes))
            elem2type: Dict[str, int] = {}
            if "element" in self._data:
                elems = np.asarray(self._data["element"]).astype(str)
                types = self._data["type"]
                for e, t in zip(elems, types):
                    elem2type.setdefault(e, int(t))
            for key, val in rc.items():
                a, b = key if isinstance(key, tuple) else key.split("-")
                ta = int(a) if not isinstance(a, str) or a.isdigit() else elem2type[a]
                tb = int(b) if not isinstance(b, str) or b.isdigit() else elem2type[b]
                mat[ta - 1, tb - 1] = mat[tb - 1, ta - 1] = float(val)
            return mat
        mat = np.asarray(rc, dtype=np.float64)
        if mat.shape != (ntypes, ntypes):
            raise ValueError(f"Cutoff matrix must be ({ntypes},{ntypes})")
        return mat

    def create_bonds(self, rc=2.0, max_neigh: Optional[int] = None) -> np.ndarray:
        """Bond pairs (i<j, deduped) from per-type-pair cutoffs.

        Parity: system.py:1333 + src/build_bond.cpp:10."""
        cut = self._normalize_bond_cutoff(rc)
        rmax = float(cut.max())
        if rmax <= 0:
            raise ValueError("All bond cutoffs are zero")
        verlet, dist, nn = self._nlist(rmax, max_neigh)
        types = self._data["type"]
        valid = verlet >= 0
        j = np.where(valid, verlet, 0)
        ti = np.repeat(types[:, None] - 1, verlet.shape[1], axis=1)
        tj = types[j] - 1
        pair_rc = cut[ti, tj]
        keep = valid & (dist <= pair_rc) & (dist > 1e-12)
        ii, slot = np.nonzero(keep)
        jj = verlet[ii, slot]
        a = np.minimum(ii, jj)
        b = np.maximum(ii, jj)
        bonds = np.unique(np.column_stack([a, b]), axis=0).astype(np.int32)
        self.bond = bonds
        return bonds

    def delete_overlap(self, rc: float = 0.1, max_neigh: Optional[int] = None) -> int:
        """Remove the larger-index atom of each pair closer than rc.

        Parity: system.py:1414 (sequential sweep semantics :1470-1479 —
        an atom is deleted only if it overlaps a *surviving* lower-index
        atom)."""
        verlet, dist, nn = self._nlist(rc, max_neigh)
        n = self.N
        valid = (verlet >= 0) & (dist < rc)
        # The sequential sweep's survivor set is the unique fixed point of
        #   keep[j] = not exists i<j with pair(i,j) and keep[i]
        # (a DAG recurrence ordered by atom index).  Jacobi-iterate it
        # vectorized: each round kills every atom whose lower-index partner
        # is currently alive; converges in <= max overlap-chain depth rounds.
        ii, slot = np.nonzero(valid)
        jj = verlet[ii, slot]
        off = ii != jj
        lo = np.minimum(ii, jj)[off]
        hi = np.maximum(ii, jj)[off]
        keep = np.ones(n, dtype=bool)
        for _ in range(n):
            dead = np.zeros(n, dtype=bool)
            dead[hi[keep[lo]]] = True
            new_keep = ~dead
            if np.array_equal(new_keep, keep):
                break
            keep = new_keep
        removed = int(n - keep.sum())
        if removed:
            self._data = self._data.filter(keep)
            self._data["id"] = np.arange(1, self._data.nrows + 1, dtype=np.int32)
            self._clear_cache()
        return removed

    # ------------------------------------------------- calculator accessors
    def get_energies(self) -> np.ndarray:
        self._require_calc()
        return self.calc.get_energies(self)

    def get_energy(self) -> float:
        self._require_calc()
        return self.calc.get_energy(self)

    def get_force(self) -> np.ndarray:
        self._require_calc()
        return self.calc.get_forces(self)

    def get_stress(self) -> np.ndarray:
        self._require_calc()
        return self.calc.get_stress(self)

    def get_virials(self) -> np.ndarray:
        self._require_calc()
        return self.calc.get_virials(self)

    def _require_calc(self) -> None:
        if self.calc is None:
            raise RuntimeError("Assign a calculator first: system.calc = EAM(...)")

    # ------------------------------------------------------------ analyses
    # Each cal_* mirrors the reference signature (SURVEY.md Appendix A) and
    # attaches its result columns onto self.data.

    def cal_polyhedral_template_matching(
        self,
        structure: str = "fcc-hcp-bcc",
        rmsd_threshold: float = 0.1,
        return_ordering: bool = False,
        return_rmsd: bool = False,
        return_atomic_distance: bool = False,
        return_orientation: bool = False,
        identify_fcc_planar_faults: bool = False,
        identify_esf: bool = True,
    ) -> np.ndarray:
        """PTM structure types -> self.data['ptm'] (reference system.py:1863).

        Codes: 0=Other 1=FCC 2=HCP 3=BCC 4=ICO 5=SC 6=DCUB 7=DHEX 8=Graphene.
        A copy of ``mdapy_tpu/core/system.py:560-614``; the neighbors are
        found on the system's device.
        """
        from ..analysis.ptm import PolyhedralTemplateMatching

        ptm = PolyhedralTemplateMatching(
            structure, self.pos, self._box, rmsd_threshold,
            types=self._data["type"], device=self.device,
        )
        ptm.compute()
        out = ptm.output
        self._data["ptm"] = out[:, 0].astype(np.int32)
        if return_ordering:
            self._data["ordering"] = out[:, 1]
        if return_rmsd:
            self._data["rmsd"] = out[:, 2]
        if return_atomic_distance:
            self._data["interatomic_distance"] = out[:, 3]
        if return_orientation:
            self._data["qx"] = out[:, 5]
            self._data["qy"] = out[:, 6]
            self._data["qz"] = out[:, 7]
            self._data["qw"] = out[:, 4]
        if identify_fcc_planar_faults:
            from ..analysis.identify_fcc_planar_faults import (
                IdentifyFccPlanarFaults,
            )

            ifpt = IdentifyFccPlanarFaults(
                out[:, 0].astype(np.int32),
                np.ascontiguousarray(ptm.ptm_indices[:, 1:13]),
                identify_esf,
            )
            ifpt.compute()
            self._data["pft"] = ifpt.fault_types[: self.N]
        return self._data["ptm"]

    def cal_centro_symmetry_parameter(self, N: int = 12) -> np.ndarray:
        from ..analysis.centro_symmetry_parameter import CentroSymmetryParameter

        calc = CentroSymmetryParameter(self.pos, self._box, N, device=self.device)
        calc.compute()
        self._data["csp"] = calc.csp
        return calc.csp

    def cal_common_neighbor_analysis(self, rc: Optional[float] = None) -> np.ndarray:
        from ..analysis.common_neighbor_analysis import CommonNeighborAnalysis

        calc = CommonNeighborAnalysis(self.pos, self._box, rc, device=self.device)
        calc.compute()
        self._data["cna"] = calc.cna
        return calc.cna

    def cal_ackland_jones_analysis(self) -> np.ndarray:
        from ..analysis.ackland_jones_analysis import AcklandJonesAnalysis

        calc = AcklandJonesAnalysis(self.pos, self._box, device=self.device)
        calc.compute()
        self._data["aja"] = calc.aja
        return calc.aja

    def cal_common_neighbor_parameter(
        self, rc: float = 3.0, max_neigh: Optional[int] = None
    ) -> np.ndarray:
        from ..analysis.common_neighbor_parameter import CommonNeighborParameter

        verlet, dist, nn = self._nlist(rc, max_neigh)
        calc = CommonNeighborParameter(self.pos, self._box, rc, verlet, dist, nn,
                                       device=self.device)
        calc.compute()
        self._data["cnp"] = calc.cnp
        return calc.cnp

    def cal_identify_diamond_structure(self) -> np.ndarray:
        from ..analysis.identify_diamond_structure import IdentifyDiamondStructure

        calc = IdentifyDiamondStructure(self.pos, self._box, device=self.device)
        calc.compute()
        self._data["ids"] = calc.ids
        return calc.ids

    def _elements_or_none(self):
        if "element" in self._data:
            return np.asarray(self._data["element"]).astype(str)
        return None

    def cal_radial_distribution_function(
        self,
        rc: float = 5.0,
        nbin: int = 100,
        max_neigh: Optional[int] = None,
        streaming: Optional[bool] = None,
    ):
        from ..analysis.radial_distribution_function import RadialDistributionFunction

        calc = RadialDistributionFunction(
            self.pos,
            self._box,
            rc,
            nbin,
            types=self._data["type"],
            elements=self._elements_or_none(),
            streaming=streaming,
            device=self.device,
        )
        calc.compute()
        return calc

    def cal_steinhardt_bond_orientation(
        self,
        llist=(4, 6),
        nnn: int = 12,
        rc: float = -1.0,
        average: bool = False,
        wl: bool = False,
        wlhat: bool = False,
        use_voronoi: bool = False,
        use_weight: bool = False,
        weight=None,
        identify_liquid: bool = False,
        threshold: float = 0.7,
        n_bond: int = 7,
        max_neigh: Optional[int] = None,
        a_face_area_threshold: float = -1.0,
        r_face_area_threshold: float = -1.0,
    ):
        from ..analysis.steinhardt_bond_orientation import SteinhardtBondOrientation

        calc = SteinhardtBondOrientation(
            self.pos,
            self._box,
            llist=llist,
            nnn=nnn,
            rc=rc,
            average=average,
            wl=wl,
            wlhat=wlhat,
            use_voronoi=use_voronoi,
            use_weight=use_weight,
            weight=weight,
            identify_liquid=identify_liquid,
            threshold=threshold,
            n_bond=n_bond,
            max_neigh=max_neigh,
            a_face_area_threshold=a_face_area_threshold,
            r_face_area_threshold=r_face_area_threshold,
            device=self.device,
        )
        calc.compute()
        for i, l in enumerate(calc.out_names):
            self._data[l] = calc.qnarray[:, i]
        if identify_liquid:
            self._data["solidliquid"] = calc.solidliquid
            self._data["nbond"] = calc.nbond
        return calc.qnarray

    def cal_structure_entropy(
        self,
        rc: float = 5.0,
        sigma: float = 0.2,
        use_local_density: bool = False,
        average_rc: float = 0.0,
        max_neigh: Optional[int] = None,
    ) -> np.ndarray:
        from ..analysis.structure_entropy import StructureEntropy

        verlet, dist, nn = self._nlist(rc, max_neigh)
        calc = StructureEntropy(
            self.pos, self._box, rc, sigma, use_local_density, verlet, dist, nn,
            device=self.device,
        )
        calc.compute()
        self._data["entropy"] = calc.entropy
        if average_rc > 0:
            self._data["entropy_ave"] = self.average_by_neighbor(
                average_rc, "entropy", output_name="entropy_ave"
            )
        return calc.entropy

    def cal_atomic_temperature(
        self, rc: float = 5.0, factor: float = 1.0, max_neigh: Optional[int] = None
    ) -> np.ndarray:
        from ..analysis.atomic_temperature import AtomicTemperature

        verlet, dist, nn = self._nlist(rc, max_neigh)
        if self.vel is None:
            raise ValueError("Atomic temperature requires vx/vy/vz columns")
        if "element" in self._data:
            uniq, inv = np.unique(np.asarray(self._data["element"]).astype(str),
                                  return_inverse=True)
            amass = np.array([atomic_masses[atomic_numbers[e]] for e in uniq])[inv]
        else:
            raise ValueError("Atomic temperature requires an element column")
        # user velocities are A/fs (times `factor`); the kernel works in A/ps
        # (reference atomic_temperature.py:102-108 applies the same 1e3).
        calc = AtomicTemperature(amass, self.vel * (1e3 * factor), verlet, nn,
                                 device=self.device)
        calc.compute()
        self._data["atomic_temp"] = calc.T
        return calc.T

    def cal_warren_cowley_parameter(
        self, rc: float = 3.0, max_neigh: Optional[int] = None
    ):
        from ..analysis.warren_cowley_parameter import WarrenCowleyParameter

        verlet, dist, nn = self._nlist(rc, max_neigh)
        calc = WarrenCowleyParameter(
            self._data["type"], verlet, nn, elements=self._elements_or_none(),
            device=self.device,
        )
        calc.compute()
        return calc

    def cal_cluster_analysis(self, rc=5.0, max_neigh: Optional[int] = None) -> int:
        from ..analysis.cluster_analysis import ClusterAnalysis

        calc = ClusterAnalysis(self.pos, self._box, rc, types=self._data["type"],
                               max_neigh=max_neigh, device=self.device)
        calc.compute()
        self._data["cluster_id"] = calc.particleClusters
        return calc.cluster_number

    def cal_atomic_strain(self, ref_system, rc: float = 5.0, affine: bool = False):
        from ..analysis.atomic_strain import AtomicStrain

        calc = AtomicStrain(rc, ref_system, affine=affine, device=self.device)
        calc.compute(self)
        return calc

    def cal_voronoi_volume(self):
        """Per-atom Voronoi volume, face count and cavity radius (a copy of
        ``mdapy_tpu/core/system.py:805-813``; the native engine on the
        host)."""
        from ..analysis.voronoi import VoronoiAnalysis

        calc = VoronoiAnalysis(self.pos, self._box, device=self.device)
        calc.compute()
        self._data["volume"] = calc.volume
        self._data["neighbor_number"] = calc.neighbor_number
        self._data["cavity_radius"] = calc.cavity_radius
        return calc

    def cal_chill_plus(self, cutoff: float = 3.5) -> np.ndarray:
        from ..analysis.chill_plus import ChillPlus

        calc = ChillPlus(self.pos, self._box, cutoff, device=self.device)
        calc.compute()
        self._data["chill_plus"] = calc.chill_plus
        return calc.chill_plus

    def cal_bond_analysis(
        self, rc: float = 3.0, nbin: int = 100, max_neigh: Optional[int] = None
    ):
        from ..analysis.bond_analysis import BondAnalysis

        verlet, dist, nn = self._nlist(rc, max_neigh)
        calc = BondAnalysis(self.pos, self._box, rc, nbin, verlet, dist, nn,
                            device=self.device)
        calc.compute()
        return calc

    def cal_angular_distribution_function(
        self, rc_dict, nbin: int = 100, max_neigh: Optional[int] = None
    ):
        from ..analysis.angular_distribution_function import (
            AngularDistributionFunction,
        )

        calc = AngularDistributionFunction(
            self.pos,
            self._box,
            rc_dict,
            nbin,
            types=self._data["type"],
            elements=self._elements_or_none(),
            device=self.device,
        )
        calc.compute()
        return calc

    def cal_structure_factor(
        self,
        k_min: float = 0.5,
        k_max: float = 12.0,
        nbins: int = 200,
        cal_partial: bool = False,
        mode: str = "debye",
        rc: Optional[float] = None,
        nbin_rdf: int = 200,
        window: bool = False,
    ):
        from ..analysis.structure_factor import StructureFactor

        calc = StructureFactor(
            self.pos,
            self._box,
            k_min=k_min,
            k_max=k_max,
            nbins=nbins,
            cal_partial=cal_partial,
            mode=mode,
            rc=rc,
            nbin_rdf=nbin_rdf,
            window=window,
            types=self._data["type"],
            elements=self._elements_or_none(),
            device=self.device,
        )
        calc.compute()
        return calc

    def average_by_neighbor(
        self,
        average_rc: float,
        property_name: str,
        include_self: bool = True,
        output_name: Optional[str] = None,
        max_neigh: Optional[int] = None,
    ) -> np.ndarray:
        """Neighborhood average of a per-atom column (system.py:2363)."""
        verlet, dist, nn = self._nlist(average_rc, max_neigh)
        prop = np.asarray(self._data[property_name], dtype=np.float64)
        valid = verlet >= 0
        j = np.where(valid, verlet, 0)
        s = np.where(valid, prop[j], 0.0).sum(axis=1)
        cnt = valid.sum(axis=1).astype(np.float64)
        if include_self:
            s = s + prop
            cnt = cnt + 1.0
        out = s / np.maximum(cnt, 1.0)
        name = output_name or f"{property_name}_ave"
        self._data[name] = out
        return out

    def cal_void_analysis(self, rc: float = 5.0):
        from ..analysis.void_analysis import VoidAnalysis

        calc = VoidAnalysis(self, rc, device=self.device)
        calc.compute()
        return calc

    def cal_chemical_species(
        self,
        search_species=None,
        element_list=None,
        check_most: int = 10,
        add_mol_id: bool = False,
        scale: float = 0.6,
    ):
        """Molecular-formula counting via vdW-radius connectivity (system.py:2575)."""
        from collections import Counter

        import torch

        from ..analysis.cluster_analysis import connected_components

        if element_list is None:
            if "element" not in self._data:
                raise ValueError("Requires element column or element_list")
            element_list = np.asarray(self._data["element"]).astype(str)
        # sorted distinct symbols (the formulas' order) and each atom's index
        symbols, code = np.unique(np.asarray(element_list).astype(str),
                                  return_inverse=True)
        radii = (vdw_radii[symbols_to_numbers(symbols)] * scale)[code]
        rmax = float(2.0 * radii.max())
        verlet, dist, nn = self._nlist(rmax)
        dev = self.device
        verlet = torch.as_tensor(verlet, device=dev)
        dist = torch.as_tensor(dist, device=dev)
        radii_t = torch.as_tensor(radii, device=dev)
        valid = verlet >= 0
        j = torch.where(valid, verlet, 0).long()
        pair_cut = radii_t[:, None] + radii_t[j]
        bonded = valid & (dist <= pair_cut) & (dist > 1e-12)
        labels = connected_components(verlet, bonded)
        # molecules numbered by their smallest atom, as np.unique orders the
        # JAX method's labels; (molecule, element) pairs counted in integers
        ids, mol = torch.unique(labels, return_inverse=True)
        n_mol, n_sym = int(ids.numel()), len(symbols)
        comp = torch.bincount(mol * n_sym + torch.as_tensor(code, device=dev),
                              minlength=n_mol * n_sym).view(n_mol, n_sym)
        kinds, first, kind_of = np.unique(comp.cpu().numpy(), axis=0,
                                          return_index=True, return_inverse=True)
        kind_of = kind_of.reshape(-1)
        kind_count = np.bincount(kind_of, minlength=len(kinds))
        formula_of_kind = [
            "".join(f"{e}{k if k > 1 else ''}" for e, k in zip(symbols, row) if k)
            for row in kinds
        ]
        # a formula enters the counter at its first molecule, as in the JAX
        # loop over the molecules, so most_common breaks ties the same way
        counts = Counter()
        for kind in np.argsort(first, kind="stable"):
            counts[formula_of_kind[kind]] += int(kind_count[kind])

        def _canonical(f: str) -> str:
            # 'OH2' and 'H2O' both normalize to the alphabetical form the
            # counter produces (reference system.py:2668-2706 regex-parses
            # and sorts user formulas the same way)
            import re

            c = Counter()
            for el, num in re.findall(r"([A-Z][a-z]?)(\d*)", f):
                if el:
                    c[el] += int(num) if num else 1
            return "".join(
                f"{e}{c[e] if c[e] > 1 else ''}" for e in sorted(c)
            )

        if add_mol_id and search_species:
            # mol_id = zero-based index into search_species, -1 if the atom's
            # molecule is not a searched formula (reference system.py:2610-2615).
            formula_to_mid = {
                _canonical(f): i for i, f in enumerate(search_species)
            }
            kind_mid = np.array([formula_to_mid.get(f, -1) for f in formula_of_kind],
                                dtype=np.int32)
            self._data["mol_id"] = kind_mid[kind_of][mol.cpu().numpy()]
        if search_species:
            return {k: counts.get(_canonical(k), 0) for k in search_species}
        return dict(counts.most_common(check_most))

