"""mdapy_tpu_torch — the port of ``mdapy_tpu`` to PyTorch and CUDA.

The port stands beside the JAX package, which stays the reference it is
tested against, and does all that the JAX package does:

* the renderer (``TachyonRender.render`` and ``render_system``) on every
  route the JAX renderer takes, its frames drawn by hand CUDA kernels for
  the H100 (``csrc/mega_render.cu``, ``csrc/tile_kernels.cu``) or by the
  exact tracer in torch ops;
* the neighbor engine (``Box``, ``Neighbor``, ``NearestNeighbor``): cell
  lists, Verlet lists and k-nearest neighbors in torch ops;
* the potentials' force path: ``EAM`` (with ``EAMAverage`` and
  ``EAMGenerator``), ``NEP`` (NEP3/4/5, with ZBL) and the ``FIRE``
  minimizer, in float64;
* the structure analyses that the JAX package computes through jax (CSP,
  CNA, Ackland-Jones, diamond, CNP, Steinhardt, Chill+, entropy, RDF, ADF,
  bonds, clusters, atomic strain, Wigner-Seitz), in float64 torch ops;
* the qNEP charge models (``nep4_charge1/2/3``, with their Ewald sums and
  Born effective charges) and ``Spline``;
* ``System`` with its file I/O (dump, XYZ, POSCAR, LAMMPS data, mp; the
  native table parser built with g++ at first use) and trajectories;
* the crystal builders (``build_crystal``, ``build_hea``,
  ``orthogonal_cell``, ``CreatePolycrystal``), host numpy copies whose
  overlap filter runs on the device;
* the host analyses: structure factor, Warren-Cowley, atomic temperature,
  MSD, Lindemann, spatial binning and voids, in float64 torch ops, and
  ``System.cal_chemical_species``;
* the native engines, host C++ built with g++ at first use and called
  through ctypes: polyhedral template matching (its neighbors found on the
  device) with the FCC planar faults, Voronoi cells and neighbors (their
  rows compacted on the device, for Steinhardt's ``use_voronoi``), and
  ``SQS``;
* the elastic stacks and the wrappers: 0 K elastic constants
  (``get_elastic_constant``, relaxed with ``FIRE``), ``BondStiffness``,
  ``QHAElastic``, ``MDElastic``, ``LammpsPotential``, ``LammpsRunner`` and
  ``NEP4ASE`` (which need phonopy, LAMMPS and ASE);
* scale-out over ``torch.distributed``: ``render.distributed`` and
  ``render.multihost`` render a frame in bands of tile rows, one band a
  rank (NCCL on the cards, gloo on the CPU), and reduce the exact tracer's
  gradients over the mesh;
* the rest of the public surface: the tool functions (``set_pka``,
  ``generate_velocity``, ``split_xyz``), the potential tools (EOS,
  stacking-fault energies, thermo and OUTCAR readers, PCA, FPS), the
  parallel gzip, the plot settings, and ``Phonon`` and ``View`` (which
  need phonopy and k3d).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, or ``backend="cpu"`` for the renderer).  This package
imports torch and never jax, nor anything of the JAX package.

Imports are lazy, in the style of ``mdapy_tpu/__init__.py``.
"""

__version__ = "0.1.0"

# name -> (module, attribute)
_LAZY = {
    "TachyonRender": (".render.render", "TachyonRender"),
    "CameraParams": (".render.camera", "CameraParams"),
    "preset_camera": (".render.camera", "preset_camera"),
    "auto_camera": (".render.camera", "auto_camera"),
    "Box": (".core.box", "Box"),
    "Neighbor": (".neighbor.neighbor", "Neighbor"),
    "NearestNeighbor": (".neighbor.knn", "NearestNeighbor"),
    "EAM": (".potentials.eam", "EAM"),
    "EAMAverage": (".potentials.eam", "EAMAverage"),
    "EAMGenerator": (".potentials.eam", "EAMGenerator"),
    "NEP": (".potentials.nep", "NEP"),
    "FIRE": (".potentials.minimizer", "FIRE"),
    "get_elastic_constant": (".potentials.elastic", "get_elastic_constant"),
    "BondStiffness": (".potentials.bond_stiffness", "BondStiffness"),
    "LammpsPotential": (".potentials.lammps", "LammpsPotential"),
    "LammpsRunner": (".potentials.lammps", "LammpsRunner"),
    "NEP4ASE": (".potentials.nep4ase", "NEP4ASE"),
    "MDElastic": (".potentials.md_elastic", "MDElastic"),
    "QHAElastic": (".potentials.qha_elastic", "QHAElastic"),
    "CentroSymmetryParameter": (".analysis.centro_symmetry_parameter", "CentroSymmetryParameter"),
    "CommonNeighborAnalysis": (".analysis.common_neighbor_analysis", "CommonNeighborAnalysis"),
    "AcklandJonesAnalysis": (".analysis.ackland_jones_analysis", "AcklandJonesAnalysis"),
    "CommonNeighborParameter": (".analysis.common_neighbor_parameter", "CommonNeighborParameter"),
    "IdentifyDiamondStructure": (".analysis.identify_diamond_structure", "IdentifyDiamondStructure"),
    "RadialDistributionFunction": (".analysis.radial_distribution_function", "RadialDistributionFunction"),
    "SteinhardtBondOrientation": (".analysis.steinhardt_bond_orientation", "SteinhardtBondOrientation"),
    "StructureEntropy": (".analysis.structure_entropy", "StructureEntropy"),
    "AtomicStrain": (".analysis.atomic_strain", "AtomicStrain"),
    "ClusterAnalysis": (".analysis.cluster_analysis", "ClusterAnalysis"),
    "WignerSeitzAnalysis": (".analysis.wigner_seitz_defect", "WignerSeitzAnalysis"),
    "AngularDistributionFunction": (".analysis.angular_distribution_function", "AngularDistributionFunction"),
    "BondAnalysis": (".analysis.bond_analysis", "BondAnalysis"),
    "ChillPlus": (".analysis.chill_plus", "ChillPlus"),
    "System": (".core.system", "System"),
    "AtomFrame": (".core.frame", "AtomFrame"),
    "element_data": (".core.elements", None),
    "init_box": (".core.box", "init_box"),
    "BuildSystem": (".io.load_save", "BuildSystem"),
    "SaveSystem": (".io.load_save", "SaveSystem"),
    "load": (".io.load_save", "load"),
    "save": (".io.load_save", "save"),
    "Trajectory": (".io.trajectory", "Trajectory"),
    "XYZTrajectory": (".io.trajectory", "XYZTrajectory"),
    "unwrap_trajectory": (".io.trajectory", "unwrap_trajectory"),
    "Spline": (".utils.spline", "Spline"),
    "get_num_threads": (".utils.parallel", "get_num_threads"),
    "CalculatorMP": (".potentials.calculator", "CalculatorMP"),
    "AtomicTemperature": (".analysis.atomic_temperature", "AtomicTemperature"),
    "WarrenCowleyParameter": (".analysis.warren_cowley_parameter", "WarrenCowleyParameter"),
    "MeanSquaredDisplacement": (".analysis.mean_squared_displacement", "MeanSquaredDisplacement"),
    "LindemannParameter": (".analysis.lindemann_parameter", "LindemannParameter"),
    "VoidAnalysis": (".analysis.void_analysis", "VoidAnalysis"),
    "StructureFactor": (".analysis.structure_factor", "StructureFactor"),
    "SpatialBinning": (".analysis.spatial_binning", "SpatialBinning"),
    "build_crystal": (".build.lattice", "build_crystal"),
    "build_hea": (".build.lattice", "build_hea"),
    "LatticeRegistry": (".build.lattice", "LatticeRegistry"),
    "CreatePolycrystal": (".build.polycrystal", "CreatePolycrystal"),
    "orthogonal_cell": (".build.orthogonal_cell", "orthogonal_cell"),
    "PolyhedralTemplateMatching": (".analysis.ptm", "PolyhedralTemplateMatching"),
    "IdentifyFccPlanarFaults": (".analysis.identify_fcc_planar_faults", "IdentifyFccPlanarFaults"),
    # Back-compat alias (all-caps FCC spelling) for the same class.
    "IdentifyFCCPlanarFaults": (".analysis.identify_fcc_planar_faults", "IdentifyFccPlanarFaults"),
    "VoronoiAnalysis": (".analysis.voronoi", "VoronoiAnalysis"),
    "SQS": (".build.sqs", "SQS"),
    "Phonon": (".analysis.phonon", "Phonon"),
    "View": (".render.visualize", "View"),
    "set_pka": (".utils.tool_function", "set_pka"),
    "generate_velocity": (".utils.tool_function", "generate_velocity"),
    "split_xyz": (".utils.tool_function", "split_xyz"),
    "rmse": (".utils.potential_tool", "rmse"),
    "read_thermo": (".utils.potential_tool", "read_thermo"),
    "plot_nep_train": (".utils.potential_tool", "plot_nep_train"),
    "get_sfe_fcc": (".utils.potential_tool", "get_sfe_fcc"),
    "get_average_sfe_fcc_hea": (".utils.potential_tool", "get_average_sfe_fcc_hea"),
    "get_eos": (".utils.potential_tool", "get_eos"),
    "PCA": (".utils.potential_tool", "PCA"),
    "fps_sample": (".utils.potential_tool", "fps_sample"),
    "cfg2xyz": (".utils.potential_tool", "cfg2xyz"),
    "read_OUTCAR": (".utils.potential_tool", "read_OUTCAR"),
    "outcar2xyz": (".utils.potential_tool", "outcar2xyz"),
    "outcars2xyz": (".utils.potential_tool", "outcars2xyz"),
    "run_gpumd": (".utils.potential_tool", "run_gpumd"),
    "compress_file": (".utils.pigz", "compress_file"),
    "pltset": (".utils.plotset", "pltset"),
    "set_figure": (".utils.plotset", "set_figure"),
    "save_figure": (".utils.plotset", "save_figure"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module 'mdapy_tpu_torch' has no attribute {name!r}") from None
    import importlib

    module = importlib.import_module(module_name, __name__)
    value = module if attr is None else getattr(module, attr)
    globals()[name] = value
    return value


def __dir__():
    return __all__ + ["__version__"]
