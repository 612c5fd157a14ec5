#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port's main paths on one card: the
renderer, the neighbor engine, the potentials, the structure analyses, the
System with its files and the qNEP charge models, the crystal builders,
the host analyses, the native engines (PTM with the planar faults,
Voronoi, SQS), the tool functions, the elastic stacks, and the sharded
renders and train steps over ``torch.distributed`` (an NCCL world of one).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. Build the hand kernels ``mdapy_tpu_torch/csrc/mega_render.cu``,
   ``tile_kernels.cu``, ``image_out.cu`` and ``chunk_gather.cu`` from the
   sources, one nvcc each, started together,
   and print ptxas' register and shared-memory lines, and each measured
   megakernel variant's and tile kernel's registers, spill bytes and blocks
   an SM.
2. Kernel against its plain torch version, on the same CUDA tensors, on a
   2,048-atom FCC scene at 320x240: (a) perspective, S = 3, shadows;
   (b) orthographic ("top"), S = 1, shadows; (c) perspective, S = 1, no
   shadows; and with the fast-AO sky lights: (d) perspective, S = 3,
   shadows, ao_samples = 12 (13 lights); (e) orthographic, S = 1, no
   primary shadows (its empty CSR), ao_samples = 4; each case's sky
   lights, built in one batched pass, against each light built alone
   (``tests/_ao_lights.py``).  With bonds and box
   edges (cylinders and rings), on a 54-atom 3x3x3 BCC block with its
   bonds and cell, as ``TachyonRender.render`` hands them to the kernel:
   (f) perspective, S = 3, shadows; (g) orthographic, S = 1, ao_samples =
   4 (5 lights, five occluder tables); (h) a box three times the size of
   the atoms, so that some tiles hold only cylinders.  At most 4 pixels may
   differ by more than 1e-3 in a channel, and the mean difference stays
   below 1e-4.  The tiled tracer's kernels, on the 2,048-atom scene through
   ``render_image_pallas(light_records=...)``: (i) perspective, S = 3, lit
   from beside the camera; (j) orthographic, S = 1, the preset's light: the
   chunked closest hit and the shadow filter against their plain versions
   on the arguments the path gave them (max |diff| 0 of t, of the record
   and of the filter, here and in every phase that holds them), and the
   frame against the same frame with the plain versions in the
   kernels' place.  (k) the 54-atom bond scene pushed past the megakernel's
   limit through ``TachyonRender`` (``render_image_pallas``, light cells of
   three kinds), against the plain route and against ``backend="cpu"``;
   (l) its bonds and cell without atoms (``render_image_tiled``) against
   ``backend="cpu"`` (at most 0.1 % of the pixels off by more than one
   level between the card's and the CPU's torch arithmetic).  Transparency
   peeling, kernel against plain, max |diff| at most 1e-4 (0 expected): the
   2,048-atom scene with half its atoms at alpha 0.3-0.7 (seed 11),
   shadows, S = 3: (m) perspective, n_peel 4; (n) orthographic, n_peel 4;
   (o) perspective, peel1; (p) perspective, n_peel 4, ao_samples = 4 (5
   lights); (r) the opaque scene at n_peel 4 against the opaque kernel;
   (s) S = 21, whose peel state takes a device buffer, not shared memory;
   and (q) the 54-atom BCC block with its bonds at alpha 0.5 and its cell
   at 0.6, as ``TachyonRender.render`` hands them to the kernel.  (w) The
   shadow walks, kernel against plain at max |diff| 0:
   ``tests/_walk_scene.py``'s columns over target spheres,
   whose light cells hold 31-33 and 63-65 records, a transmission that
   reaches 1e-3 in mid-step, an atom at alpha 0.999995 and key stops in
   mid-step, translucent (n_peel 4 with AO 4, peel1) and opaque (with and
   without AO 4); and the 2,048-atom scene under the preset's light (warps
   with one lit lane) and lit from beside the camera (warps with all 32).
   (t) The tile kernels' edge cases, kernel against plain at max |diff| 0:
   ``tests/_tile_cases.py``'s closest-hit argument sets (R of 1, 31, 1,664,
   3,328 and 4,097; one chunk and many; rays from one origin and from
   their own; equal t across chunks and lanes; padded slots, rays with
   tcap = -1e18, a tile without a live chunk) and shadow-filter sets
   (cells of 0-200 records, occluders at records 0, 32 and last, key stops
   in mid-step, warps with no, one and 32 lit lanes, M = 0).
   The variants' registers, spills and blocks an SM print in phase 1.
3. The headline frame at full size, one light: the 1,000,188-atom FCC block
   (a = 3.615, r = 1.28), the "perspective" preset camera, 1920x1080, AA 12
   (13 samples) with primary-light shadows, through
   ``TachyonRender(backend="cuda", ao=False).render(..., device_output=True)``.
   Checks the image and that the kernel was launched; times the first frame
   (scene and accel build included) and 5 warm frames; times each layer;
   compares the kernel with its plain version on the whole frame and times
   both over a band of the frame's tile rows.
4. BASELINE config 3: a ~1M-atom Voronoi polycrystal (Cu FCC, a = 3.615, a
   230 A periodic cube, 15 grains from seed 1, built here with numpy and
   scipy), r = 1.28, copper colour, the "perspective" preset camera,
   1920x1080, through ``TachyonRender(backend="cuda", ao=True,
   ao_samples=12, aa_samples=2, background=(1, 1, 1))``: a transparent frame
   (alpha holds 0 and 255), the first frame and 5 warm
   ``device_output=True`` frames, Grays/s by the rays traced, the layers, a
   camera move that reuses the scene-keyed AO lights, peak memory, and the
   kernel against its plain version on the whole frame, both timed over a
   band of 2 tile rows.
5. BASELINE config 2: BCC Fe (a = 2.8665 A) in 6x6x6 periodic cells, 432
   atoms, bonds between the pairs closer than 2.6 A (a periodic scipy
   cKDTree), atom radius 0.5 A, bond radius 0.2 A, the default colours,
   the "perspective" preset camera, 1920x1080, AA 12 (13 samples),
   primary-light shadows: the primitive counts and the widest tile, one
   frame through ``TachyonRender.render_system`` on a stand-in system
   object, then the first frame and 5 warm ``device_output=True`` frames of
   ``render`` with the same edges, Grays/s = W*H*S*2 / warm s, the layers,
   the kernel split, and the kernel against its plain version on the whole
   frame, both timed over a band of 2 tile rows.
6. Config 3 as ``render_system`` draws it by default: the phase-4
   polycrystal with its 230 A periodic cell's 12 edges (36 primitives, 13
   lights with an occluder table each): its warm frame beside phase 4's,
   the kernel split, the light grids beside phase 4's, and the kernel
   against its plain version over a band.

7. The heavy-bond frame: BCC Fe in 7x7x7 periodic cells (686 atoms) with
   its bonds and cell, over the megakernel's 8,192 cylinders + rings, so
   ``render_system`` takes ``render_image_pallas`` in bands: 1920x1080,
   AA 12, shadows; first and 5 warm frames, Grays/s, the layers (raygen,
   chunked closest hit, cylinder/ring merge, shadow pass, shading and
   mean, host), peak memory, beside phase 5's 6x6x6 warm frame.
8. The tiled tracer's kernels at full width: the headline scene through
   ``render_image_pallas_banded(light_records=...)``: the frame beside
   phase 3's, each kernel's time and counted launches in one frame, and on
   one band each kernel against its plain version, both timed, with the
   bound of what the band's data needs (``hit_bound``, ``filt_bound``).  The
   preset's light shines along the view and lights under 1 % of the rays,
   so the shadow filter is also held, timed and bounded on the same band
   lit from beside the camera.  With AA off the megakernel and the tiled tracer draw the same
   picture by different arithmetic: at most 4 pixels in 7,680 (the CPU
   tests' bound) may differ by more than one level.

T1. The headline scene translucent, the view of a precipitate inside its
   matrix: phase 3's frame with every atom farther than 0.3 x the block's
   edge from its centre at alpha 0.3 (max_trans 4): first and 5 warm
   frames, peak memory, the kernel's full-frame time against phase 3's
   opaque one and its split, the tiles by the number of peels they ran and
   the records walked per lit ray (the plain version's counts), the kernel
   against its plain version on the whole frame and on tile rows 33-34,
   both timed, and the bound.
T2. BASELINE config 3 translucent: phase 4's polycrystal with grain 0
   opaque and the other 14 grains at alpha 0.2: warm frame beside phase
   4's, the kernel split (closest hit, primary walks, AO walks), the band.
T3. BASELINE config 2 translucent: phase 5's BCC Fe with its atoms at
   alpha 0.4 and its bonds and cell opaque, through ``render_system`` and
   ``render``: the cylinder/ring kernel with peeling at full width; warm
   frame beside phase 5's, the kernel split, the band.

B1f. The headline frame in bands of tile rows (``render_image_mega_banded``):
   the record budget ``RECORD_BUDGET_BYTES`` lowered to 17 tile rows'
   records, so its 68 tile rows take 4 bands.  At S = 1 the banded frame
   against the one-shot frame, from ``render_image_mega_banded`` (float) and through
   ``TachyonRender`` (uint8): a band moves its image-plane corner in
   float32, as the JAX package's banded render does, so at most 0.01 % of the pixels may
   differ by more than 1e-3 (a tangency flipped).  The plain version
   renders the tiles that hold those pixels again, from the one-shot
   inputs and from the band's: the kernel must equal it on both, and the
   pixels it flips are printed beside the kernel's.  At S = 13, through
   ``TachyonRender``: 4 launches a frame, the first and 5 warm frames and
   the peak beside phase 3's one-shot frame.
A6. The exact tracer (``render/tracer.py``, torch ops, float32 on the
   card) on phase 5's config 2 with ``TachyonRender``'s defaults (AO 12,
   AA 12, shadows): ``render_system`` end to end at 192x108 (route
   "exact", ``last_timings``); then rows 524-555 of the 1920x1080 frame
   timed on the card with the ray-primitive tests per second, the full
   frame reckoned from the band, the bound by fp32 operations and the
   peak; and row 539 rendered again on the CPU in float32: at most 0.1 %
   of its pixels may differ by more than 2/255.
A6g. BASELINE config 4: config 2's 432 atoms through ``scene_from_arrays``
   at 480x270, AA and AO off, shadows on; one forward and backward pass of
   a squared-error image loss against a seeded target on the card: the
   loss and every gradient finite and not all zero, and each gradient's
   cosine against the CPU's float64 one at least 0.99; ms and peak.

The neighbor engine and the potentials' force path, float64, after the
render phases (tables and model files under ``chiprun_out/smoke``):

N1. ``neighbor_search_device`` on 1,000,188 atoms of FCC Cu (a 3.615 A,
    63^3 cells, as ``bench.py:246``) at rc 5 A: warm median of 5, every
    count 42 (12 + 6 + 24 within 5 A), the cell list, the candidate gather
    with its distances and the top-k apart (CUDA events), peak, launches
    (``torch.profiler``); ``neighbor_search`` (sorted, to the host) and
    ``knn_search(k=12)`` on the same crystal; the card against the port's
    CPU on a seeded, rattled, triclinic 10,192-atom box (equal sets per
    row, distances within 1e-12 A).
E1. ``EAM.calculate`` (tables from the port's ``EAMGenerator(["Cu"])``) on
    256,000 atoms of perfect FCC Cu (40^3 cells, as ``bench.py:125``): warm
    median of 5, equal per-atom energies (std < 1e-10 eV) and forces below
    1e-10 eV/A, the neighbor build and the two passes apart, peak,
    launches; the card against the CPU on a rattled 4,000-atom Cu-Ni
    alloy within 1e-9.
F1. FIRE on E1's crystal rattled by a seeded 0.05 A: 10 steps on positions,
    then 10 with ``optimize_cell=True``, energy and max |F| per step, ms per
    step; each run lowers the energy.
P1. ``NEP.calculate`` with a seeded NEP4 + ZBL file for Cu and Ni at
    GPUMD's ``nep.in`` defaults (``tests/_nep_file.py``) on 256,000 atoms:
    warm median of 3, the descriptor call, peak, launches; the card against
    the CPU on 2,048 atoms within 1e-8 (energies, forces, virials, stress,
    descriptors).
Each timed call prints its bound: the larger of its float64 operations at
the H100's float64 peak and its bytes at the HBM rate.

The structure analyses, float64, after [P1] (each call: the warm ms,
median of 3 by the host clock bracketed by ``torch.cuda.synchronize()``,
each repeat equal bit for bit to a first call; launches and the device's
busy share from ``torch.profiler``; the peak; the float64 bound of the
analysis's own arithmetic; the card against the CPU on about 4,000 atoms of
the same structure, rattled, labels and counts equal and floats within
1e-12):

S1. The classifiers on N1's block, timed on it rattled by 0.05 A (seed
    21): ``CentroSymmetryParameter(N=12)``, ``CommonNeighborAnalysis``
    adaptive and at rc 3.0, ``AcklandJonesAnalysis``,
    ``CommonNeighborParameter`` at rc 3.0 (its list built beforehand) and
    ``SteinhardtBondOrientation`` (l 4 and 6, nnn 12, w-hat, averaged,
    solid-liquid).  On the perfect block every atom must be FCC, CSP and
    CNP below 1e-20, q4 and q6 equal at every atom and every atom solid.
S2. 1,000,000 atoms of perfect cubic diamond (50^3 cells):
    ``IdentifyDiamondStructure`` at a 5.431 A, every atom cubic diamond;
    ``ChillPlus`` on the same lattice at a 6.35 A (the O sublattice of
    cubic ice), rc 3.5, every atom cubic ice.
S3. N1's block rattled: ``RadialDistributionFunction`` (rc 5, nbin 200,
    the Verlet route), ``AngularDistributionFunction`` (Cu-Cu-Cu, 0-3 A,
    nbin 180), ``BondAnalysis`` (rc 3, nbin 180), ``StructureEntropy`` (rc
    5, sigma 0.2, with and without the local density), and the RDF's
    streaming route, which the auto rule picks on 12^3 cells at rc 15.
S4. ``ClusterAnalysis`` at rc 3.0 with 30 % of N1's atoms removed (seed
    26) and the rest rattled; ``AtomicStrain`` at rc 5 against the block
    under a 1 % shear and a 0.05 A rattle; ``WignerSeitzAnalysis`` with 1 %
    of the atoms moved onto octahedral sites.

The System, its files and qNEP, float64, after [S4] (each timed number
with the card's name and power limit):

IO1. N1's block rattled as in [S1] (seed 21), through the port's
    ``System``: written with ``write_dump``, ``write_xyz``, ``write_data``
    and as a ``.dump.gz``, each read back through ``System(filename)``;
    the g++ build of ``mdapy_tpu_torch/native/table_parser.cpp`` into
    ``mdapy_tpu_torch/_build/`` at its first use (its seconds printed; a
    failed build fails the run); each file parsed once by the native
    route (``io/_fast_table.routes``), every column and the box equal to
    what was written bit for bit; write and read ms and MB/s per format.
    The files go to a git-ignored directory of the checkout, removed at
    the end.
SY1. On that System: ``cal_centro_symmetry_parameter()``,
    ``cal_common_neighbor_analysis()``, ``cal_ackland_jones_analysis()``,
    ``cal_steinhardt_bond_orientation()`` ([S1]'s options) and
    ``build_neighbor(rc=5)``, each equal bit for bit to the direct call,
    both timed (warm medians of 3) and the System's overhead printed; then
    a 3-frame dump ``Trajectory`` of the block saved, read back and CNA run
    on each frame, every frame's labels equal to the direct call's.
Q1. qNEP on rock-salt NaCl, 12^3 conventional cells (13,824 atoms, a
    5.64 A, rattled 0.05 A): seeded ``nep4_charge1``, ``2`` and ``3``
    models at GPUMD's ``nep.in`` defaults (``tests/_nep_file.py``); per
    mode the warm ms of ``NEP.calculate`` (median of 3, every repeat equal
    bit for bit), the k-vector count and chunk, launches and busy share,
    the peak (below 40 GB), the reciprocal sum, the real-space sum and the
    BEC timed inside a call (CUDA events) with the float64 bound of the
    two sums and its share; the card against the CPU on 64 atoms within
    1e-10 (energies, forces, stress, virials, charges, BEC).  Then
    ``Spline.evaluate_torch`` on 10^7 points, orders 0-2, the card against
    the CPU within 1e-15 relative.

The builders and the host analyses, after [Q1] (host seconds for the
builders; each analysis call as in [S1]-[S4], float64, the card against the
CPU on a cut, relative where FFT or trigonometry round differently):

BL1. ``bench.py``'s scenes built by the port: ``CreatePolycrystal(
    build_crystal("Cu", "fcc", 3.615), 230.0, 15, randomseed=1).compute()``
    (``bench.py:279-281``) must give 1,030,194 atoms; again with
    ``metal_overlap_dis=2.0`` (the overlap filter on the card; the atoms
    removed, no pair left within 2 A); that first build rendered with
    ``bench_config3``'s settings (1920x1080, AA 2, AO 12, white background,
    the perspective preset, r 1.28): first frame, warm ms over 5 frames and
    Grays/s counted as traced, W*H*(2S+K) (this is ``bench.py``'s scene,
    not phase 4's ``voronoi_polycrystal``); ``build_hea`` of CoNiCrFeMn at
    136^3 cells (``bench.py:368-371``) must give 10,061,824 atoms with
    each element's count by ``build_hea_fromsystem``'s floor rule;
    ``orthogonal_cell`` of a Miller-oriented HCP build.
S5. S(k) on the perfect lattice of 32,000 atoms of CoNiCrFeMn (20^3
    cells, a 3.59 A, seed 1): Debye at its defaults (rc = L/2, the RDF's
    streaming route) with its 15 partials and the X-ray, neutron and
    electron totals (two calls of ~5 s, the second timed and equal to the
    first bit for bit; no profile: cut from five calls to make room for
    [EL1]-[D2]), the card against the CPU on 4,000 atoms both rattled
    and perfect (pairs at exactly rc, ROADMAP C15); direct with partials,
    k in (0.5, 12], its k-points, chunk and the float64 bound of its
    phases and sums; Debye at rc 6 on 1,000,188 atoms (63^3 cells, the
    neighbor route).  Warren-Cowley on those
    1,000,188 atoms at rc 3.0, equal bit for bit to the CPU's count of
    the same list, every |alpha| under 0.02.  ``AtomicTemperature`` at rc
    5 on N1's block with seeded Maxwell velocities at 300 K (no net
    momentum): mean within 5 % of 300 K; then ``SpatialBinning`` of that
    block's temperatures by "xyz" at 5 A with every operation.
    ``VoidAnalysis`` at rc 4.1 on 500,000 atoms of Al with three spheres
    cut out (``tests/test_misc_fixtures.py:177-191``): 3 voids.
    ``cal_chemical_species(["H2O"], scale=0.4, add_mol_id=True)`` on a
    water box of 69^3 molecules (985,527 atoms, ``tests/_water_box.py``):
    328,509 H2O, every mol_id 0.  ``MeanSquaredDisplacement`` on 1,000
    frames x 32,000 atoms of a seeded random walk in both modes: window
    equal to the mean over every origin at four lags within 1e-9 of max
    |pos|^2, direct within 3 % of window (the walk's statistics).
    ``LindemannParameter`` on 200 frames x 5,000 atoms, ``only_global``
    and per atom, their ``lindemann_trj`` within 1e-12 relative.

The native engines (host C++ built with g++ at first use, OpenMP through
ctypes) and the tool functions, after [S5] (host seconds beside the card's
name and power limit; the block is N1's rattled by 0.05 A, seed 61):

S6. ``PolyhedralTemplateMatching`` with the default structures on the
    block: the 18 nearest neighbours on the card (``knn_tensors``, CUDA
    events), the indices' copy to the host, the displacements and the host
    engine (its OpenMP threads printed); at least 99 % of the atoms FCC
    (the second ``compute()`` and its bit-for-bit check were cut to make
    room for [EL1]-[D2]).  ``structure="all"`` on
    [S2]'s 1,000,000 atoms of diamond: every atom DCUB (6).
    ``cal_polyhedral_template_matching(identify_fcc_planar_faults=True)``
    on ``tests/_fault_stack.py``'s close-packed stack of 100 layers of
    10,000 atoms (an ISF, a twin and an ESF): every inner layer's ``pft``
    its known code.  The card against the CPU on 32,000 atoms rattled,
    "all": types and indices equal, floats within 1e-12.
V1. On the block: ``System.cal_voronoi_volume`` (the cells' volumes sum to
    the box's within 1e-9 relative), ``build_voronoi_neighbor`` (its rows
    compacted on the card) and ``SteinhardtBondOrientation(use_voronoi=
    True, use_weight=True)``, each once (the repeats and their bit-for-bit
    checks were cut to make room for [EL1]-[D2]); the Steinhardt call on
    the card against the CPU on 4,000 atoms.
Q2. ``SQS`` of a 5-element equimolar FCC ``build_hea`` (CoNiCrFeMn, a
    3.55 A, 6^3 cells, 864 atoms), ``cutoffs={2: 4.0}`` (the first two
    shells), 8 replicas x 10^6 steps: host seconds and the objective; a
    rerun with the same seed equal.
U1. ``System.set_pka`` (1000 eV) on the block with Maxwell velocities:
    one atom sped up, the centre-of-mass velocity 0 within 1e-12 A/fs;
    ``average_by_neighbor`` at rc 5 A on the card (median of 3, repeats
    bit for bit), against the CPU on 4,000 atoms within 1e-12;
    ``generate_velocity`` on 10^6 atoms, its temperature within 1 % and a
    rerun equal.

The elastic stacks and scale-out, after [U1] (float64 for EL1 and BS1,
the port's ``EAMGenerator`` tables beside [E1]'s):

EL1. ``get_elastic_constant`` at its defaults (FIRE with the cell, then 24
    deformed copies on the card, each relaxed) on the Cu unit cell and on
    its 6x6x6 perfect supercell (864 atoms), ``EAMGenerator(["Cu"])`` as
    [E1] makes it: the FIRE steps and host seconds of each; the supercell's
    tensor within 1e-4 of the cell's (the relaxations stop at fmax 1e-4,
    at residual stresses that depend on the size), cubic within 1e-6, Born
    stable; the unit cell on the CPU, the card's tensor within 1e-9 of it.
BS1. ``BondStiffness.compute`` at its defaults on a 2x2x2 FCC Al-Cu alloy
    (``build_hea``, a 3.85 A, seed 1) with ``EAMGenerator(["Al", "Cu"])``:
    579 force calls (192 probes a strain, 3 strains, with the bases), the
    shells, the k values, the ms a probe, and the card against the CPU
    within 1e-9.
D1. On an NCCL world of one (``make_mesh(1)`` starts it): phase 3's
    headline frame (1,000,188 atoms, 1920x1080, S = 13, shadows) through
    ``render_image_mega_sharded(mesh=make_mesh(1))`` and
    ``render_image_mega_hier(mesh=make_hier_mesh(1, 1))``: each equal to
    the one-shot ``render_image_mega`` frame bit for bit; their first and
    warm ms against the one-shot's (the sharded route's own work and the
    all_gather); B1's launches.
D2. [A6g]'s config-4 scene at 480x270 (float32, shadows):
    ``render_train_step`` and ``render_train_step_hier`` with
    ``remat_chunks`` 1 and 5 (270 rows do not divide by 4, which raises as
    in the JAX package) against the unsharded exact-tracer step on the
    card: the ms and peak memory of each in float32 (the loss within 1e-5
    relative; the gradients' cosines printed: float32 sums of per-pixel
    terms that cancel lose ~1e-3 when split in chunks), then each step in
    float64: the loss within 1e-5, every gradient's cosine at least 0.9999.

9. The image out at the benchmark's main path's shape (32,000 atoms,
   3000x3000, AA 20, shadows, host images through ``TachyonRender``), run
   right after phase 1: the RGBA kernel's launches a host image, the host
   image against ``image_out_plain`` byte for byte (opaque and
   transparent), the kernel's time against its bound by bytes, the plain
   version on the card, and the copy to the host (``image_out_phase``).
9g. The per-tile sphere records on the render demo's main path
   (``hea32k_noao`` through ``perfbench``'s client, 3000x3000), right
   after phase 9: the gather's launches over frames of new snapshots (one
   a frame), the last frame's records against the plain version bit for
   bit, the hand kernel ``csrc/chunk_gather.cu``'s registers and spills,
   its time by CUDA events (median of 20) against its bound by bytes, and
   the plain version's time (``chunk_gather_phase``).

Phase 8 follows phase 3 on its scene, then B1f, T1, 5, A6, A6g, T3, 7, 4,
6, T2, N1, E1, F1, P1, S1-S4, IO1, SY1, Q1, BL1, S5, S6, V1, Q2, U1, EL1,
BS1, D1 and D2.  The
headline frame, configs 2 and 3 and T1 also print the bound of the whole
frame, and T1-T3 that of their band: the tests the plain version counts
there (those the early exits leave) at the H100's fp32 peak, against the
bytes they must move at its HBM rate.

The last three lines are the kernel table (JSON), the card's name and power
limit as nvidia-smi reports them, and a JSON status line.
"""

import contextlib
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

TOL_PIXELS = 4        # pixels allowed above TOL_PIXEL_DIFF in any channel
TOL_PIXEL_DIFF = 1e-3
TOL_MEAN = 1e-4
WARM_FRAMES = 5
TOL_HIT = 0.0         # max |diff| of the closest hit's t and record
TOL_FILT = 0.0        # share of rays whose shadow filter may differ
TOL_LEVELS = 1e-3     # share of uint8 pixels off by > 1 level, card against CPU
TOL_PEEL = 1e-4       # max |diff| of a peel case, kernel against plain (0 expected)
# share of pixels over TOL_PIXEL_DIFF, the banded frame against the one-shot
# frame at S = 1: a band moves its image-plane corner in float32, which may
# flip a silhouette or a shadow at a tangency
TOL_BANDED = 1e-4


# the megakernel variants of the measured frames (kernel_attrs's flags; a
# peel variant with its state in shared memory at the frame's S and lights)
MAIN_VARIANTS = {
    "headline": dict(perspective=True, shadows=True, ao=False, other=False, peel=False),
    "config3": dict(perspective=True, shadows=True, ao=True, other=False, peel=False),
    "config2": dict(perspective=True, shadows=True, ao=False, other=True, peel=False),
    "config3_cell": dict(perspective=True, shadows=True, ao=True, other=True, peel=False),
    "T1": dict(perspective=True, shadows=True, ao=False, other=False, peel=True, S=13),
    "T2": dict(perspective=True, shadows=True, ao=True, other=False, peel=True, S=3,
               nlights=13),
    "T3": dict(perspective=True, shadows=True, ao=False, other=True, peel=True, S=13),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def fcc_block(n_cells: int, seed=None):
    """FCC block of 4 * n_cells**3 atoms; random colours from ``seed``, or
    the bench's uniform copper colour when ``seed`` is None."""
    a = 3.615
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.mgrid[0:n_cells, 0:n_cells, 0:n_cells].reshape(3, -1).T
    pos = (frac[None] + cells[:, None]).reshape(-1, 3) * a
    if seed is None:
        colors = np.tile(np.array([[0.78, 0.5, 0.2, 1.0]], np.float32),
                         (len(pos), 1))
    else:
        rng = np.random.default_rng(seed)
        colors = np.c_[rng.uniform(0.2, 1.0, (len(pos), 3)),
                       np.ones(len(pos))].astype(np.float32)
    return pos, colors, np.full(len(pos), 1.28, np.float32)


def _rotation(theta_deg, axis: int) -> np.ndarray:
    """Rotation by theta_deg degrees about coordinate axis 0, 1 or 2."""
    t = np.radians(theta_deg)
    c, s = np.cos(t), np.sin(t)
    i, j = [k for k in range(3) if k != axis]
    r = np.eye(3)
    r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
    return r


def voronoi_polycrystal(box=230.0, grains=15, seed=1, a=3.615, min_dist=2.0):
    """Periodic Voronoi polycrystal of FCC grains: one random seed point and
    one random rotation per grain (drawn from ``seed`` in that order), each
    lattice point kept by the grain whose seed is nearest (periodic), then
    one atom of each pair closer than ``min_dist`` removed.  Returns the
    positions and each atom's grain."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    seeds = rng.random((grains, 3)) * box
    theta = rng.uniform(-180.0, 180.0, (grains, 3))
    tree = cKDTree(seeds, boxsize=box)
    # each grain's reach: its farthest owned point of a coarse grid, plus
    # two grid diagonals
    ng = 48
    g = (np.arange(ng) + 0.5) * (box / ng)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    dist, owner = tree.query(grid)
    reach = np.array([dist[owner == i].max() for i in range(grains)])
    reach += 2.0 * np.sqrt(3.0) * box / ng
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    parts = []
    for i in range(grains):
        n = int(np.ceil(reach[i] / a)) + 1
        cells = np.mgrid[-n:n, -n:n, -n:n].reshape(3, -1).T
        lat = (cells[:, None] + frac[None]).reshape(-1, 3) * a
        lat = lat[np.einsum("ij,ij->i", lat, lat) <= reach[i] ** 2]
        rot = (_rotation(theta[i, 0], 0) @ _rotation(theta[i, 1], 1)
               @ _rotation(theta[i, 2], 2))
        p = np.mod(lat @ rot.T + seeds[i], box)
        p[p >= box] = 0.0
        parts.append(p[tree.query(p)[1] == i])
    pos = np.concatenate(parts)
    grain = np.concatenate([np.full(len(q), i) for i, q in enumerate(parts)])
    pairs = cKDTree(pos, boxsize=box).query_pairs(min_dist, output_type="ndarray")
    keep = np.ones(len(pos), bool)
    keep[pairs.max(axis=1)] = False
    return pos[keep], grain[keep]


def bcc_positions(n_cells: int, a: float = 2.8665) -> np.ndarray:
    """BCC block of 2 * n_cells**3 atoms in [0, n_cells * a)^3."""
    frac = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    cells = np.mgrid[0:n_cells, 0:n_cells, 0:n_cells].reshape(3, -1).T
    return (frac[None] + cells[:, None]).reshape(-1, 3) * a


class Cell:
    """A periodic cell as ``render_system`` reads it."""

    def __init__(self, lengths, origin=(0.0, 0.0, 0.0)):
        self.matrix = np.diag(np.asarray(lengths, np.float64) * np.ones(3))
        self.origin = np.asarray(origin, np.float64)
        self.boundary = np.array([1, 1, 1])


class Columns(dict):
    """Per-atom columns as ``render_system`` reads them (``.columns``)."""

    @property
    def columns(self):
        return list(self)


class StandIn:
    """The part of a System that ``render_system`` reads: positions, cell,
    atom count, per-atom columns and bonds."""

    def __init__(self, pos, cell, bond=None, element=None):
        self._pos = pos
        self.box = cell
        self.N = len(pos)
        self.bond = bond
        self.data = Columns() if element is None else Columns(
            element=np.array([element] * len(pos)))

    def get_positions(self):
        return self._pos


def bcc_system(n_cells: int, a: float = 2.8665, rc: float = 2.6) -> StandIn:
    """BCC Fe in n_cells^3 periodic cells with its bonds (pairs closer than
    rc, from a periodic cKDTree)."""
    from scipy.spatial import cKDTree

    pos = bcc_positions(n_cells, a)
    side = n_cells * a
    pairs = cKDTree(pos, boxsize=side).query_pairs(rc, output_type="ndarray")
    return StandIn(pos, Cell(side), bond=pairs.astype(np.int64), element="Fe")


# fp32 operations counted per test of each kind (the kernel's arithmetic,
# rounded): sphere candidate, cylinder/ring record, shadow cell record,
# occluder-table cull, occluder test
OPS = {"sphere": 8, "cylring": 24, "record": 8, "cull": 20, "occluder": 25}
PEAK_FP32 = 67e12     # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def bound(work: dict, nbytes: float):
    """Least time (ms) the card could take for the counted work, and what
    bounds it: operations over the fp32 peak against bytes over the HBM rate."""
    ops = sum(OPS[k] * work.get(k, 0) for k in OPS)
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops


def band_bytes(work: dict, band, other=None, lights=None) -> float:
    """Bytes the render of the tiles ``band`` = (first, end) must move, each
    input read once and the output written once: the candidate chunks its
    walks reached (a tile's deepest walk over its peels), its cyl/ring
    records, the shadow records its walks read (at most the whole CSR), the
    occluder tables, and the (tiles, 768) f32 output."""
    n = 4096 * work.get("chunk", 0) + (band[1] - band[0]) * 3072
    if other is not None:
        n += 64 * int(other.ocnt[band[0]:band[1]].sum())
        if other.occ is not None:
            n += other.occ.numel() * 4
    if lights is not None:
        n += 32 * min(work.get("record", 0), lights.lrec.shape[0])
    return n


def light_grid(lights) -> str:
    """The light grids' cell edges and mean records per non-empty cell."""
    cell = 1.0 / lights.lparams[:, 11]
    cnt = lights.lcnt[lights.lcnt > 0].float()
    return (f"cell edge {float(cell[0]):.3f} A (primary), {float(cell.mean()):.3f} A "
            f"(mean of {cell.numel()} lights), {float(cnt.mean()):.1f} records per "
            f"non-empty cell")


def frame_bound(what, work, kernel_ms, nb, other=None, lights=None):
    """Print the work the plain version counted on the whole frame and the
    bound it sets, beside the kernel's full-frame time."""
    b_ms, b_by, ops = bound(work, band_bytes(work, (0, nb), other=other,
                                             lights=lights))
    print(f"  {what} full frame: work {work}, {ops:.4g} fp32 operations, bound "
          f"{b_ms:.4f} ms by {b_by}, kernel {kernel_ms:.3f} ms (roofline share "
          f"{b_ms / kernel_ms:.2%})")


@contextlib.contextmanager
def swapped(module, **fns):
    """Put ``fns`` in the place of ``module``'s functions of those names."""
    old = {k: getattr(module, k) for k in fns}
    for k, v in fns.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


class Recorder:
    """A function that keeps each call's arguments and CUDA events."""

    def __init__(self, fn):
        self.fn, self.calls, self.events = fn, [], []

    def __call__(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kwargs)
        end.record()
        self.calls.append((args, kwargs))
        self.events.append((start, end))
        return out

    def total_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


class Stopwatch:
    """A function whose calls are timed on the host, synchronized."""

    def __init__(self, fn):
        self.fn, self.seconds = fn, 0.0

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        return out


# fp32 operations per ray x sphere test of the chunked closest hit, which
# subtracts the centre per ray (the megakernel's perspective test does not)
OPS_HIT = 16


def hit_bound(tests: int, args, best_t, rec):
    """Bound of one chunked-closest-hit call: its sphere tests at the fp32
    peak, against the bytes it must move: the rays (28 B in, 36 B out each,
    a miss writing its zeros), rows 0-3 of the chunks reached (2,048 B each,
    once per tile) and rows 4-7 (16 B) of each distinct winning record; a
    ray that misses reads no record.  Returns (ms, what bounds it, hits,
    distinct winners)."""
    o = args[0]
    nb, R = o.shape[:2]
    hit = torch.nonzero(best_t.reshape(-1) < 1e17).flatten()
    tile = (hit // R).to(torch.int32)
    winners = torch.unique(torch.cat(
        [tile[:, None], rec.reshape(-1, 8)[hit, :3].contiguous().view(torch.int32)],
        dim=1), dim=0).shape[0]
    nbytes = nb * R * (28 + 36) + 2048 * tests / (R * 128) + 16 * winners
    t_ops, t_bytes = tests * OPS_HIT / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            int(hit.numel()), winners)


def filt_bound(megakernel, args, kwargs):
    """Bound of one shadow-filter call from what this call's data needs.  A
    ray with lit = 0 reads its flag and writes its filter (8 B); a lit ray
    also reads (u, v, tau) and its cell (20 B), its cell's offset and count
    (8 B a distinct cell), and walks its cell's records to its first
    occluder or its stop.  The rays of a cell walk one list from its head,
    so the distinct records read are, per cell, its longest walk (32 B
    each); the operations are 8 per record of every walk.  Returns (ms,
    what bounds it, the counts)."""
    uvt, cellxy, lit, lrec, offs, cnt = args[:6]
    grid_n, eps = kwargs["grid_n"], kwargs["eps"]
    sel = torch.nonzero(lit.reshape(-1) > 0).flatten()
    u, v, tau = uvt.reshape(-1, 3)[sel].unbind(1)
    gx, gy = cellxy.reshape(-1, 2)[sel].clamp(0, grid_n - 1).unbind(1)
    cell = gy.to(torch.int64) * grid_n + gx
    walked = torch.zeros_like(cell)
    batch = 1 << 17
    for s0 in range(0, sel.shape[0], batch):
        s = slice(s0, s0 + batch)
        megakernel._shadow_blocked(lrec, offs, cnt, None, u[s], v[s], tau[s],
                                   cell[s], eps, walked=walked[s])
    longest = torch.zeros(grid_n * grid_n, dtype=torch.int64, device=cell.device)
    longest.scatter_reduce_(0, cell, walked, "amax")
    counts = {"rays": lit.numel(), "lit": int(sel.numel()),
              "cells": int((torch.bincount(cell, minlength=1) > 0).sum()),
              "record": int(walked.sum()), "distinct records": int(longest.sum())}
    nbytes = (8 * counts["rays"] + 20 * counts["lit"] + 8 * counts["cells"]
              + 32 * counts["distinct records"])
    t_ops = counts["record"] * OPS["record"] / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            counts)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int, warmup: int = 1, median: bool = False) -> float:
    """Mean ms a call of ``fn`` over ``reps`` calls between one pair of CUDA
    events, after ``warmup`` calls; with ``median`` the median of ``reps``
    calls, each between its own pair."""
    for _ in range(warmup):
        fn()
    if median:
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in pairs:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(out_kernel, out_plain, what: str):
    """Per-pixel (max over channels) differences of two (tiles, 768) blocks."""
    d = (out_kernel - out_plain).abs().view(-1, 3, 256).amax(dim=1)
    n_bad = int((d > TOL_PIXEL_DIFF).sum())
    mean = float((out_kernel - out_plain).abs().mean())
    max_abs = float(d.max())
    print(f"  {what}: pixels > {TOL_PIXEL_DIFF}: {n_bad} (allowed "
          f"{TOL_PIXELS}), mean |diff| {mean:.3e} (allowed {TOL_MEAN}), "
          f"max |diff| {max_abs:.3e}")
    if not bool(torch.isfinite(out_kernel).all()):
        fail(f"{what}: kernel output not finite")
    if n_bad > TOL_PIXELS or not mean < TOL_MEAN:
        fail(f"{what}: kernel disagrees with its plain version")
    return max_abs


def compare_hit(tile_kernels, args, kwargs, what: str) -> float:
    """Chunked closest hit, kernel against plain on the same CUDA tensors."""
    t_k, r_k = tile_kernels.closest_hit_spheres_tiles_cuda(*args, **kwargs)
    t_p, r_p = tile_kernels.closest_hit_spheres_tiles_plain(*args, **kwargs)
    torch.cuda.synchronize()
    err = max(float((t_k - t_p).abs().max()), float((r_k - r_p).abs().max()))
    hits = int((t_p < 1e17).sum())
    print(f"  {what}: {t_p.numel()} rays, {hits} hit, max |diff| of t and record "
          f"{err:.3e} (allowed {TOL_HIT})")
    if not bool(torch.isfinite(t_k).all()) or not err <= TOL_HIT:
        fail(f"{what}: the closest-hit kernel disagrees with its plain version")
    if hits == 0:
        fail(f"{what}: no ray hits")
    return err


def compare_filt(tile_kernels, args, kwargs, what: str) -> float:
    """Shadow filter, kernel against plain on the same CUDA tensors."""
    f_k = tile_kernels.shadow_filter_tiles_cuda(*args, **kwargs)
    f_p = tile_kernels.shadow_filter_tiles_plain(*args, **kwargs)
    torch.cuda.synchronize()
    n_bad = int((f_k != f_p).sum())
    lit = int((args[2] > 0).sum())
    print(f"  {what}: {f_p.numel()} rays, {lit} lit, {int((f_p == 0).sum())} "
          f"blocked, filters that differ {n_bad} (allowed "
          f"{int(TOL_FILT * f_p.numel())})")
    if n_bad > TOL_FILT * f_p.numel():
        fail(f"{what}: the shadow-filter kernel disagrees with its plain version")
    return float((f_k - f_p).abs().max())


def compare_images(img_a, img_b, what: str) -> float:
    """Two (H, W, 3) float frames, by compare()'s bounds."""
    d = (img_a - img_b).abs().amax(dim=-1)
    n_bad = int((d > TOL_PIXEL_DIFF).sum())
    mean = float((img_a - img_b).abs().mean())
    print(f"  {what}: pixels > {TOL_PIXEL_DIFF}: {n_bad} (allowed {TOL_PIXELS}), "
          f"mean |diff| {mean:.3e} (allowed {TOL_MEAN}), max |diff| "
          f"{float(d.max()):.3e}")
    if not bool(torch.isfinite(img_a).all()) or float(img_b.std()) < 0.02:
        fail(f"{what}: a frame is not finite or flat")
    if n_bad > TOL_PIXELS or not mean < TOL_MEAN:
        fail(f"{what}: the frames disagree")
    return float(d.max())


def compare_levels(img_a, img_b, what: str, share: float) -> int:
    """Two uint8 frames: the pixels off by more than one level, at most
    ``share`` of them."""
    a = torch.as_tensor(img_a)[..., :3].cpu().to(torch.int32)
    b = torch.as_tensor(img_b)[..., :3].cpu().to(torch.int32)
    n_bad = int(((a - b).abs().amax(dim=-1) > 1).sum())
    allowed = math.ceil(share * a.shape[0] * a.shape[1])
    print(f"  {what}: pixels off by more than one level: {n_bad} of "
          f"{a.shape[0] * a.shape[1]} (allowed {allowed})")
    if float(a.float().std()) <= 1 or n_bad > allowed:
        fail(f"{what}: the frames disagree or are flat")
    return n_bad


def prepare_sphere_frame(dev, pos, colors, radii, cam, width, height, cfg,
                         grid=32, light_dir=None):
    """The megakernel's inputs for a sphere scene, built on ``dev`` as the
    front end builds them: (frame, bins, chunk_data, lights, params); with
    ``light_dir``, the frame's light comes from there."""
    from mdapy_tpu_torch.render import megakernel
    from mdapy_tpu_torch.render import render as trender
    from mdapy_tpu_torch.render.accel import (
        build_light_bins, build_light_records, build_screen_bins,
    )
    from mdapy_tpu_torch.render.camera import camera_frame
    from mdapy_tpu_torch.render.gather import gather_chunk_data
    from mdapy_tpu_torch.render.scene import build_scene

    scene = build_scene(pos, colors, radii, device=dev)
    frame = camera_frame(cam, width, height)
    if light_dir is not None:
        frame = dict(frame, light_dir=np.asarray(light_dir, np.float64))
    bins = build_screen_bins(scene, frame, width, height)
    lb = build_light_bins(scene, frame["light_dir"], grid=grid)
    chunk_data = gather_chunk_data(bins.sph_chunks, scene.sph_center,
                                   scene.sph_radius, scene.sph_color)
    lo = (scene.sph_center - scene.sph_radius[:, None]).min(0).values
    hi = (scene.sph_center + scene.sph_radius[:, None]).max(0).values
    params = megakernel.build_mega_params(frame, lb, lo, hi, cfg)
    extra = (trender.build_ao_lights(scene, cfg.ao_samples, cfg.ao_brightness,
                                     float(radii.max()), grid=grid)
             if cfg.ao_enabled else None)
    if extra is not None:
        check_sky_lights(scene, extra, cfg, float(radii.max()), grid)
    lights = None
    if cfg.shadows_enabled or extra:
        primary = (build_light_records(lb, scene) if cfg.shadows_enabled
                   else (None, None, None, None))
        lights = megakernel.stack_lights(params, *primary, extra_lights=extra,
                                         grid_n=grid, device=dev)
    return frame, bins, chunk_data, lights, params


def check_sky_lights(scene, extra, cfg, rmax: float, grid: int) -> None:
    """The sky lights ``build_ao_lights`` built in batched passes against
    each light built alone on the same card, under ``tests/_ao_lights.py``'s
    rules, as the CPU test ``tests/test_torch_ao_batched.py`` holds them."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from _ao_lights import check_ao_lights

    try:
        n = check_ao_lights(scene, extra, cfg.ao_samples, cfg.ao_brightness,
                            rmax, grid)
    except AssertionError as err:
        fail(f"the batched sky lights differ from each light built alone: "
             f"{err!r}")
    print(f"  {len(extra)} sky lights, {n} records: the batched build equals "
          f"each light built alone")


def translucent(colors, seed: int, share: float = 0.5, lo: float = 0.3,
                hi: float = 0.7):
    """``colors`` with alpha drawn in [lo, hi) for a ``share`` of the atoms
    (from ``seed``), the rest left opaque."""
    rng = np.random.default_rng(seed)
    out = colors.copy()
    pick = rng.uniform(size=len(out)) < share
    out[pick, 3] = rng.uniform(lo, hi, int(pick.sum()))
    return out


def compare_peel(out_k, out_p, what: str) -> float:
    """A peel case, kernel against plain: max |diff| at most TOL_PEEL."""
    err = float((out_k - out_p).abs().max())
    print(f"  {what}: max |diff| {err:.3e} (allowed {TOL_PEEL})")
    if not bool(torch.isfinite(out_k).all()) or not err <= TOL_PEEL:
        fail(f"{what}: the peel kernel disagrees with its plain version")
    if float(out_p.std()) < 0.02:
        fail(f"{what}: the plain image is flat")
    return err


def drive(megakernel, frame_fn, what: str, ren):
    """The main path's run: launch counts and the peak reset, a first frame
    and WARM_FRAMES warm ones, each of which must launch the kernel once,
    and the records' gather once a view change of ``ren`` (the first frame
    at most; the warm frames keep the view).  Returns (last image, first s,
    warm s a frame, kernel launches, the first frame's launches, peak
    allocated bytes)."""
    from mdapy_tpu_torch.render import gather

    torch.cuda.reset_peak_memory_stats()
    megakernel.reset_launches()
    gather.reset_launches()
    key = ren._accel_key
    img, t_first = sync_time(frame_fn)
    first = megakernel.launches
    views = int(ren._accel_key != key)
    img, t_warm = sync_time(lambda: [frame_fn() for _ in range(WARM_FRAMES)][-1])
    if first != 1 or megakernel.launches != 1 + WARM_FRAMES:
        fail(f"{what}: {first} kernel launches in the first frame, "
             f"{megakernel.launches} in {1 + WARM_FRAMES} frames (one a frame "
             "expected)")
    if gather.launches["chunk_gather"] != views:
        fail(f"{what}: {gather.launches['chunk_gather']} launches of the "
             f"records' gather over {views} view changes (one each expected)")
    return (img, t_first, t_warm / WARM_FRAMES, megakernel.launches, first,
            torch.cuda.max_memory_allocated())


def band_check(megakernel, args, kw, frame_bins, what, other=None, lights=None):
    """Kernel against plain over the frame's 2 middle tile rows (33-34 at
    1080p), both timed, and the band's bound from the plain version's
    counts.  Returns {ms, plain_ms, bound_ms, bound_by, err}."""
    ty0 = frame_bins.tiles_y // 2 - 1
    band = (ty0 * frame_bins.tiles_x, (ty0 + 2) * frame_bins.tiles_x)
    out_k = megakernel.mega_render_cuda(*args, tiles=band, **kw)
    out_p = megakernel.mega_render_plain(*args, tiles=band, **kw)
    err = compare(out_k, out_p, f"{what} band of {band[1] - band[0]} tiles")
    ms = event_ms(lambda: megakernel.mega_render_cuda(*args, tiles=band, **kw), 10)
    plain_ms = event_ms(lambda: megakernel.mega_render_plain(*args, tiles=band, **kw), 2)
    work = megakernel.plain_work(*args, tiles=band, **kw)
    b_ms, b_by, ops = bound(work, band_bytes(work, band, other=other, lights=lights))
    print(f"  {what} band: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; work "
          f"{work}, {ops:.4g} fp32 operations, bound {b_ms:.4f} ms by {b_by} "
          f"(roofline share {b_ms / ms:.2%})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, err=err)


# fp32 operations per ray x primitive test of the exact tracer's brute
# passes, counted from its formulas (``render/tracer.py:_sph``, ``_cyl``,
# ``_ring``), rounded
OPS_EXACT = {"sphere": 24, "cylinder": 60, "ring": 26}
A6_ROWS = (524, 556)       # the timed band of config 2's 1080 rows
A6_CPU_ROWS = (539, 540)   # its row rendered again on the CPU
A6G_SIZE = (480, 270)      # config 4's frame
A6G_COS_MIN = 0.99         # least cosine of a float32 gradient against float64
B1F_BAND_ROWS = 17         # tile rows a band of the [B1f] headline frame
B1F_WITNESS_TILES = 32     # tiles of [B1f]'s flipped pixels the plain version renders


def banded_phase(pos, colors, radii, cam, card: str, one_warm_ms: float,
                 one_peak: int) -> dict:
    """[B1f] The headline frame in bands of tile rows: the record budget
    lowered to 17 tile rows' records, so 68 rows take 4 bands.  S = 1: the
    banded frame against the one-shot frame, in float (the band loop alone)
    and through ``TachyonRender``; S = 13: the warm frame, launches and
    peak beside the one-shot frame's."""
    from mdapy_tpu_torch import TachyonRender
    from mdapy_tpu_torch.render import megakernel
    from mdapy_tpu_torch.render import render as trender

    width, height = 1920, 1080
    kw = dict(camera=cam, width=width, height=height, device_output=True)
    one = TachyonRender(backend="cuda", ao=False, antialiasing=False)
    one_img = one.render(pos, colors, radii, **kw)
    frame, bins, cd, lights, params = one._accel
    nb, nchunks, ch = bins.sph_chunks.shape
    budget = trender.RECORD_BUDGET_BYTES
    trender.RECORD_BUDGET_BYTES = (B1F_BAND_ROWS * bins.tiles_x * nchunks * 8
                                   * ch * 4)
    try:
        args = dict(S=1, width=width, height=height, grid_n=32,
                    eps=one._cfg.eps, perspective=True, shadows=True)
        one_f = megakernel.render_image_mega(
            cd, bins.sph_zmin, lights, params, 0, tiles_x=bins.tiles_x,
            tiles_y=bins.tiles_y, **args)
        band_f = megakernel.render_image_mega_banded(
            one._scene[0], bins, lights, params, 0,
            max_band_bytes=trender.RECORD_BUDGET_BYTES, **args)
        d = (band_f - one_f).abs().amax(dim=-1)
        s1_max = float(d.max())
        s1_pixels = int((d > 0).sum())
        s1_over = int((d > TOL_PIXEL_DIFF).sum())
        allowed = math.floor(TOL_BANDED * d.numel())
        print(f"[B1f] {card}: the headline frame, {bins.tiles_y} tile rows in "
              f"bands of 17 (record budget {trender.RECORD_BUDGET_BYTES} "
              f"bytes): S=1 banded against one-shot max |diff| {s1_max:.3e}, "
              f"{s1_pixels} pixels differ, {s1_over} by more than "
              f"{TOL_PIXEL_DIFF} (allowed {allowed}; each band moves its "
              f"image-plane corner in float32, as the JAX banded render does)")
        if not bool(torch.isfinite(band_f).all()) or s1_over > allowed:
            fail("[B1f] the banded frame disagrees with the one-shot frame")
        witness = flip_witness(megakernel, one._scene[0], bins, cd, lights,
                               params, d, one_f, band_f, args)
        del one_f, band_f, cd, lights, bins, frame
        ren1 = TachyonRender(backend="cuda", ao=False, antialiasing=False)
        img1 = ren1.render(pos, colors, radii, **kw)
        if ren1._route_name != "mega" or ren1._accel[2] is not None:
            fail("[B1f] the front end did not render in bands")
        s1_levels = compare_levels(img1, one_img, "[B1f] S=1 through "
                                   "TachyonRender, banded against one-shot",
                                   TOL_LEVELS)
        del one, one_img, ren1, img1
        torch.cuda.empty_cache()
        ren = TachyonRender(backend="cuda", ao=False)

        def frame_once():
            return ren.render(pos, colors, radii, **kw)

        torch.cuda.reset_peak_memory_stats()
        megakernel.reset_launches()
        img, t_first = sync_time(frame_once)
        per_frame = megakernel.launches
        img, t_warm = sync_time(
            lambda: [frame_once() for _ in range(WARM_FRAMES)][-1])
        launches = megakernel.launches
        peak = torch.cuda.max_memory_allocated()
    finally:
        trender.RECORD_BUDGET_BYTES = budget
    t_warm /= WARM_FRAMES
    print(f"  S=13 banded: first frame {t_first * 1e3:.1f} ms, warm "
          f"{t_warm * 1e3:.3f} ms/frame over {WARM_FRAMES} frames against the "
          f"one-shot {one_warm_ms:.3f} ms (phase 3); peak allocated {peak} "
          f"bytes against {one_peak}; kernel launches {launches} "
          f"({per_frame} a frame)")
    if per_frame != 4 or launches != 4 * (1 + WARM_FRAMES):
        fail(f"[B1f] {per_frame} launches a frame, {launches} in all")
    if tuple(img.shape) != (height, width, 3) or not float(img.float().std()) > 1:
        fail("[B1f] the banded frame is wrong or flat")
    del ren, img
    torch.cuda.empty_cache()
    return dict(launches=launches, per_frame=per_frame, warm_ms=t_warm * 1e3,
                first_ms=t_first * 1e3, peak=peak, s1_max_abs=s1_max,
                s1_pixels=s1_pixels, s1_over=s1_over, s1_levels=s1_levels,
                **witness)


def flip_witness(megakernel, scene, bins, cd, lights, params, d, one_f,
                 band_f, args) -> dict:
    """[B1f] The pixels where the S = 1 banded frame differs from the
    one-shot frame by more than TOL_PIXEL_DIFF, rendered again by the plain
    version: on the first B1F_WITNESS_TILES tiles that hold them, the one-shot
    inputs and the band's own (its records, its moved image-plane corner,
    its seed).  The kernel's pixels must equal the plain version's on both
    (compare()), and the plain version then flips the pixels it flips: the
    flips come from the band's float32 corner, not from the kernel."""
    from mdapy_tpu_torch.render.gather import gather_chunk_data, pack_sphere_table

    tp, tiles_x = megakernel.TILE_PX, bins.tiles_x
    height = args["height"]
    flips = torch.nonzero(d > TOL_PIXEL_DIFF)
    u = height - 1 - flips[:, 0]                  # row from the frame's bottom
    tile = (u // tp) * tiles_x + flips[:, 1] // tp
    tiles = sorted(set(tile.tolist()))[:B1F_WITNESS_TILES]
    if not tiles:
        print("  flip witness: no pixel over the tolerance")
        return dict(witness_tiles=0, witness_kernel_flips=0,
                    witness_plain_flips=0, witness_both=0, witness_err=0.0)
    kw = dict(S=1, tiles_x=tiles_x, grid_n=args["grid_n"], eps=args["eps"],
              perspective=True, shadows=True)
    table = pack_sphere_table(scene.sph_center, scene.sph_radius,
                              scene.sph_color)
    rows = B1F_BAND_ROWS * tiles_x
    band_cd = {}
    k_one, p_one, k_band, p_band = [], [], [], []
    for t in tiles:
        b = t // rows
        if b not in band_cd:
            band_cd.clear()
            band_cd[b] = gather_chunk_data(
                bins.sph_chunks[b * rows:(b + 1) * rows], scene.sph_center,
                scene.sph_radius, scene.sph_color, table=table)
        p = np.asarray(params, np.float32).copy()
        p[3:6] = p[3:6] + np.float32(b * B1F_BAND_ROWS * tp) * p[9:12]
        p_one.append(megakernel.mega_render_plain(
            cd, bins.sph_zmin, lights, params, 0, tiles=(t, t + 1), **kw))
        p_band.append(megakernel.mega_render_plain(
            band_cd[b], bins.sph_zmin[b * rows:(b + 1) * rows], lights, p,
            9973 * b, tiles=(t - b * rows, t - b * rows + 1), **kw))
        # the kernel's pixels of tile t, as (1, 768) [R|G|B] rows
        ty, tx = divmod(t, tiles_x)
        uu = torch.arange(ty * tp, (ty + 1) * tp, device=d.device)
        ys = (height - 1 - uu).clamp(min=0)
        for img, out in ((one_f, k_one), (band_f, k_band)):
            blk = img[ys][:, tx * tp:(tx + 1) * tp]             # (tp, tp, 3)
            blk = torch.where((uu < height)[:, None, None], blk, 0.0)
            out.append(blk.permute(2, 0, 1).reshape(1, -1))
    band_cd.clear()
    p_one, p_band = torch.cat(p_one), torch.cat(p_band)
    live = torch.cat([(torch.arange(tp * tp, device=d.device) // tp
                       + (t // tiles_x) * tp < height).repeat(3)[None]
                      for t in tiles])
    k_one = torch.where(live, torch.cat(k_one), 0.0)
    k_band = torch.where(live, torch.cat(k_band), 0.0)
    p_one, p_band = torch.where(live, p_one, 0.0), torch.where(live, p_band, 0.0)
    err_one = compare(k_one, p_one, "[B1f] flip witness, one-shot inputs")
    err_band = compare(k_band, p_band, "[B1f] flip witness, band inputs")

    def flipped(a, b):
        return (a - b).abs().view(-1, 3, tp * tp).amax(dim=1) > TOL_PIXEL_DIFF

    fk, fp = flipped(k_band, k_one), flipped(p_band, p_one)
    n_k, n_p, n_both = int(fk.sum()), int(fp.sum()), int((fk & fp).sum())
    print(f"  flip witness: {len(tiles)} tiles holding {n_k} of the "
          f"{flips.shape[0]} pixels over {TOL_PIXEL_DIFF}; the plain version "
          f"on the same inputs flips {n_p} pixels there, {n_both} of them "
          f"the kernel's")
    return dict(witness_tiles=len(tiles), witness_kernel_flips=n_k,
                witness_plain_flips=n_p, witness_both=n_both,
                witness_err=max(err_one, err_band))


def exact_phase(fe, rad2, cam2, card: str) -> dict:
    """[A6] The exact tracer on BASELINE config 2 with ``TachyonRender``'s
    defaults (AO 12, AA 12, shadows): end to end at 192x108, then a band of
    whole rows of the 1920x1080 frame timed on the card, the full frame
    reckoned from it, and one row of it against the CPU's float32 run."""
    from mdapy_tpu_torch import TachyonRender
    from mdapy_tpu_torch.render import tracer
    from mdapy_tpu_torch.render.camera import camera_frame
    from mdapy_tpu_torch.render.scene import build_scene

    ren = TachyonRender(backend="cuda", verbosity="timing")
    small, t_small = sync_time(lambda: ren.render_system(
        fe, radii=rad2, camera=cam2, draw_bond=True, bond_radius=0.2,
        width=192, height=108))
    timings = {k: round(v * 1e3, 3) for k, v in ren.last_timings.items()}
    print(f"[A6] {card}: config 2 through TachyonRender(backend=\"cuda\") "
          f"defaults (ao={ren._cfg.ao_enabled}, ao_samples="
          f"{ren._cfg.ao_samples}, aa_samples={ren._cfg.aa_samples}) at "
          f"192x108: route {ren._route_name!r}, {t_small * 1e3:.1f} ms, "
          f"last_timings (ms) {timings}")
    if (ren._route_name != "exact" or small.shape != (108, 192, 4)
            or not float(small[..., :3].std()) > 1):
        fail("[A6] the small render_system frame is wrong, flat or off the "
             "exact route")
    scene, cfg = ren._exact_scene(), ren._cfg
    fr = camera_frame(cam2, 1920, 1080)
    cam = [fr[k] for k in ("origin", "lowleft", "iplaneright", "iplaneup",
                           "view", "light_dir")]

    def band_of(sc, rows):
        with torch.no_grad():
            return tracer.render_image(sc, *cam, cfg, 1920, 1080, True, 0,
                                       rows=rows)

    r0, r1 = A6_ROWS
    tracer.count_tests()
    torch.cuda.reset_peak_memory_stats()
    band, t_band = sync_time(lambda: band_of(scene, A6_ROWS))
    tests = tracer.count_tests()
    peak = torch.cuda.max_memory_allocated()
    n_tests = sum(tests.values())
    bound_ms = sum(tests[k] * OPS_EXACT[k] for k in tests) / PEAK_FP32 * 1e3
    reckoned_s = t_band * 1080 / (r1 - r0)
    print(f"  band of rows {r0}-{r1 - 1} ({(r1 - r0) * 1920} pixels) on the "
          f"card: {t_band * 1e3:.1f} ms, full frame reckoned from it "
          f"{reckoned_s:.1f} s; ray-primitive tests {tests} = {n_tests:.4e}, "
          f"{n_tests / t_band:.4e} tests/s; bound {bound_ms:.3f} ms by fp32 "
          f"operations (share {bound_ms / (t_band * 1e3):.3%}); peak "
          f"allocated {peak} bytes")
    if not bool(torch.isfinite(band).all()) or not float(band.std()) > 0.02:
        fail("[A6] the band is not finite or flat")
    c0, c1 = A6_CPU_ROWS
    cpu_scene = build_scene(**ren._build_args, device="cpu")
    cpu, t_cpu = sync_time(lambda: band_of(cpu_scene, A6_CPU_ROWS))
    d = (band[c0 - r0:c1 - r0].cpu() - cpu).abs().amax(dim=-1)
    n_bad = int((d > 2 / 255).sum())
    allowed = math.floor(1e-3 * d.numel())
    print(f"  rows {c0}-{c1 - 1} on the CPU in float32 ({t_cpu:.1f} s, "
          f"{torch.get_num_threads()} threads) against the card: max |diff| "
          f"{float(d.max()):.3e}, pixels over 2/255: {n_bad} of {d.numel()} "
          f"(allowed {allowed})")
    if n_bad > allowed:
        fail("[A6] the card's band disagrees with the CPU's")
    del ren, scene, band, cpu, cpu_scene
    torch.cuda.empty_cache()
    return dict(band_ms=t_band * 1e3, rows=A6_ROWS, reckoned_s=reckoned_s,
                tests=n_tests, tests_per_s=n_tests / t_band, bound_ms=bound_ms,
                peak=peak, small_ms=t_small * 1e3)


def grad_phase(fe, rad2, cam2, card: str) -> dict:
    """[A6g] BASELINE config 4: config 2's 432 atoms through
    ``scene_from_arrays`` at 480x270, AA and AO off, shadows on; one forward
    and backward pass of a squared-error image loss against a seeded target
    on the card, and the same in float64 on the CPU for the cosine."""
    from mdapy_tpu_torch.render import render as trender
    from mdapy_tpu_torch.render import tracer
    from mdapy_tpu_torch.render.camera import camera_frame
    from mdapy_tpu_torch.render.config import RenderConfig
    from mdapy_tpu_torch.render.scene import scene_from_arrays

    w, h = A6G_SIZE
    fr = camera_frame(cam2, w, h)
    cam = [fr[k] for k in ("origin", "lowleft", "iplaneright", "iplaneup",
                           "view", "light_dir")]
    cfg = RenderConfig(aa_samples=0, aa_enabled=False, ao_enabled=False,
                       shadows_enabled=True)
    inputs = (fe.get_positions(), trender._default_colors(fe), rad2)
    target = np.random.default_rng(0).uniform(0.0, 1.0, (h, w, 3))

    def step(device, dtype):
        leaves = [torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device, requires_grad=True) for a in inputs]
        img = tracer.render_image(scene_from_arrays(*leaves), *cam, cfg, w, h,
                                  True, 0)
        loss = ((img - torch.as_tensor(target, dtype=dtype, device=device)) ** 2).sum()
        loss.backward()
        return float(loss.detach()), [a.grad for a in leaves]

    torch.cuda.reset_peak_memory_stats()
    (loss, grads), t_step = sync_time(lambda: step("cuda", torch.float32))
    peak = torch.cuda.max_memory_allocated()
    ok = math.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in grads)
    nonzero = any(float(g.abs().max()) > 0 for g in grads)
    loss64, grads64 = step("cpu", torch.float64)
    cos = [float(torch.nn.functional.cosine_similarity(
        g.double().cpu().flatten(), g64.flatten(), dim=0)) for g, g64 in
        zip(grads, grads64)]
    print(f"[A6g] {card}: config 4, {len(inputs[0])} atoms, {w}x{h}, AA off, "
          f"shadows: forward + backward {t_step * 1e3:.1f} ms, peak allocated "
          f"{peak} bytes; loss {loss:.6g} (CPU float64 {loss64:.6g}); "
          f"gradients finite {ok}, non-zero {nonzero}; cosine against the "
          f"CPU float64 gradient: positions {cos[0]:.6f}, colors {cos[1]:.6f}, "
          f"radii {cos[2]:.6f}")
    if not ok or not nonzero:
        fail("[A6g] the loss or a gradient is not finite, or all are zero")
    if not min(cos) >= A6G_COS_MIN:
        fail(f"[A6g] a float32 gradient's cosine against the float64 one is "
             f"below {A6G_COS_MIN}")
    return dict(ms=t_step * 1e3, peak=peak, cos=cos)


def peel_cases(dev, card: str) -> list:
    """Phase 2 (m)-(s): transparency peeling, kernel against its plain
    version on the same CUDA tensors.  Returns the max |diff| of each."""
    from mdapy_tpu_torch import TachyonRender, preset_camera
    from mdapy_tpu_torch.render import megakernel
    from mdapy_tpu_torch.render import render as trender
    from mdapy_tpu_torch.render.config import RenderConfig
    from mdapy_tpu_torch.render.geometry import bond_edges, box_edges

    errs = []
    pos, colors, radii = fcc_block(8, seed=3)
    glass = translucent(colors, 11)
    for case, preset, aa, ao, n_peel, peel1, cols in (
            ("m", "perspective", 2, 0, 4, False, glass),
            ("n", "top", 2, 0, 4, False, glass),
            ("o", "perspective", 2, 0, 1, True, glass),
            ("p", "perspective", 2, 4, 4, False, glass),
            ("r", "perspective", 2, 0, 4, False, colors),
            ("s", "perspective", 20, 0, 4, False, glass)):
        cam = preset_camera(preset, pos, max_radius=1.28)
        cfg = RenderConfig(aa_samples=aa, aa_enabled=aa > 0, ao_enabled=ao > 0,
                           ao_samples=ao, shadows_enabled=True)
        frame, bins, cd, lights, params = prepare_sphere_frame(
            dev, pos, cols, radii, cam, 320, 240, cfg)
        S = aa + 1
        kw = dict(S=S, tiles_x=bins.tiles_x, grid_n=32, eps=cfg.eps,
                  perspective=bool(frame["perspective"]), shadows=True)
        args = (cd, bins.sph_zmin, lights, params, 0)
        nl = lights.lparams.shape[0]
        what = (f"[2{case}] {len(pos)} atoms 320x240 {preset} S={S} "
                f"lights={nl} " + ("peel1" if peel1 else f"n_peel={n_peel}"))
        megakernel.reset_launches()
        out_k = megakernel.mega_render_cuda(*args, n_peel=n_peel, peel1=peel1, **kw)
        state = 4 * (8 + (nl - 1) * 256 + 8 * S * 256)
        if megakernel.launches != 1:
            fail(f"{what}: {megakernel.launches} launches")
        if case == "r":
            # an opaque scene: the peel kernel against the opaque kernel
            out_o = megakernel.mega_render_cuda(*args, **kw)
            errs.append(compare_peel(out_k, out_o, what + ", opaque, against "
                                     "the opaque kernel"))
            continue
        out_p = megakernel.mega_render_plain(*args, n_peel=n_peel, peel1=peel1, **kw)
        torch.cuda.synchronize()
        errs.append(compare_peel(out_k, out_p, what + (
            f", peel state in a device buffer ({state} B > "
            f"{megakernel.PEEL_SMEM_BYTES} B)" if state > megakernel.PEEL_SMEM_BYTES
            else f", peel state {state} B of shared memory")))
    # (q): bonds at alpha 0.5 and the cell at 0.6 on the 54-atom BCC block,
    # as TachyonRender hands them to the kernel
    small = bcc_system(3)
    colors_b = trender._default_colors(small)
    radii_b = np.full(small.N, 0.5, np.float32)
    bonds_b, _ = bond_edges(small.get_positions(), small.box, small.bond,
                            colors_b, radii_b, 0.2)
    edges_c = box_edges(small.box)
    cam = preset_camera("perspective", np.r_[small.get_positions(), edges_c[:, 0]],
                        max_radius=0.5)
    ren = TachyonRender(backend="cuda", ao=False, aa_samples=2)
    megakernel.reset_launches()
    ren.render(small.get_positions(), colors_b, radii_b, camera=cam,
               bond_edges=bonds_b, bond_radius=0.2, bond_color=(0.8, 0.8, 0.8, 0.5),
               box_edges=edges_c, box_edge_radius=0.1,
               box_color=(1.0, 1.0, 1.0, 0.6), width=320, height=240)
    (frame, bins, cd, lights, params), other = ren._accel, ren._other
    if megakernel.launches != 1 or not ren._scene[6] or other.occ is None:
        fail(f"[2q] the translucent bond frame took {megakernel.launches} "
             f"launches, transparency {ren._scene[6]}")
    kw = dict(S=3, tiles_x=bins.tiles_x, grid_n=32, eps=ren._cfg.eps,
              perspective=True, shadows=True, other=other, n_peel=4)
    args = (cd, bins.sph_zmin, lights, params, 0)
    out_k = megakernel.mega_render_cuda(*args, **kw)
    out_p = megakernel.mega_render_plain(*args, **kw)
    errs.append(compare_peel(out_k, out_p, f"[2q] {small.N} atoms + "
                             f"{other.occ.shape[1]} cyl/rings (bonds alpha 0.5, "
                             "cell 0.6) 320x240 perspective S=3 n_peel=4"))
    print(f"  [2m-s] on {card}: peel cases max |diff| {max(errs):.3e}")
    return errs


def lit_lanes_per_warp(megakernel, fn):
    """Run ``fn`` (a plain-version render) and return, for every warp (32
    pixels of a tile, one sample) that holds a lit ray of the primary light,
    its count of lit lanes."""
    seen = []
    inner = megakernel._light_blocked

    def spy(lights, lp, l, h, sel, **kw):
        if l == 0:
            seen.append(sel.clone())
        return inner(lights, lp, l, h, sel, **kw)

    with swapped(megakernel, _light_blocked=spy):
        fn()
    # rays are (tiles, samples * 256), flattened: 32 in a row are one warp
    c = torch.cat([torch.bincount(sel // 32, minlength=1) for sel in seen])
    return c[c > 0]


def walk_cases(dev, card: str) -> list:
    """Phase 2 (w): long and short cell walks, kernel against plain (max
    |diff| 0).  The scene is ``tests/_walk_scene.py``'s, which the CPU test
    ``tests/test_torch_walks.py`` holds against the JAX package."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from _walk_scene import WALK_CASES, walk_scene
    from mdapy_tpu_torch import preset_camera
    from mdapy_tpu_torch.render import megakernel
    from mdapy_tpu_torch.render.camera import CameraParams, camera_frame
    from mdapy_tpu_torch.render.config import RenderConfig

    errs = []

    def check(args, kw, what):
        out_p = megakernel.mega_render_plain(*args, **kw)
        if float(out_p.std()) < 0.02:
            fail(f"{what}: the plain image is flat")
        out_k = megakernel.mega_render_cuda(*args, **kw)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        if not bool(torch.isfinite(out_k).all()) or err != 0.0:
            fail(f"{what}: max |diff| {err:.3e} against the plain version "
                 "(0 required)")
        errs.append(err)
        work = megakernel.plain_work(*args, **kw)
        print(f"  {what}: max |diff| 0; lit rays {work.get('lit', 0)}, "
              f"records walked {work.get('record', 0)}")
        return work

    pos, colors, radii, cam_kw, light = walk_scene()
    cam = CameraParams(**cam_kw)
    opaque = np.c_[colors[:, :3], np.ones(len(colors))].astype(np.float32)
    for label, cols, ao, peel in (
            ("translucent n_peel=4, AO 4", colors, 4, dict(n_peel=4)),
            ("translucent peel1", colors, 0, dict(peel1=True)),
            ("opaque, AO 4", opaque, 4, {}),
            ("opaque", opaque, 0, {})):
        cfg = RenderConfig(aa_samples=2, ao_enabled=ao > 0, ao_samples=ao,
                           shadows_enabled=True)
        frame, bins, cd, lights, params = prepare_sphere_frame(
            dev, pos, cols, radii, cam, 320, 240, cfg, light_dir=light)
        longest = int(lights.lcnt[0].max())
        kw = dict(S=3, tiles_x=bins.tiles_x, grid_n=32, eps=cfg.eps,
                  perspective=False, shadows=True, **peel)
        work = check((cd, bins.sph_zmin, lights, params, 0), kw,
                     f"[2w] {len(pos)} atoms, columns of {[c[0] for c in WALK_CASES]}, "
                     f"{label}, largest primary cell {longest} records")
        if longest < 65 or (peel and work.get("record", 0) < 32 * work.get("lit", 1)):
            fail(f"[2w] {label}: the walks are not long ({work})")
    # warps with one lit lane and warps with all 32 lit: the FCC block under
    # the preset's light, and lit from beside the camera
    pos, colors, radii = fcc_block(8, seed=3)
    cam = preset_camera("perspective", pos, max_radius=1.28)
    cfg = RenderConfig(aa_samples=2, ao_enabled=False, shadows_enabled=True)
    base = camera_frame(cam, 320, 240)
    right = np.asarray(base["iplaneright"], np.float64)
    side = -np.asarray(base["view"]) + 0.8 * right / np.linalg.norm(right)
    lanes = []
    for label, light in (("the preset's light", None),
                         ("lit from beside the camera", side / np.linalg.norm(side))):
        frame, bins, cd, lights, params = prepare_sphere_frame(
            dev, pos, colors, radii, cam, 320, 240, cfg, light_dir=light)
        kw = dict(S=3, tiles_x=bins.tiles_x, grid_n=32, eps=cfg.eps,
                  perspective=True, shadows=True)
        args = (cd, bins.sph_zmin, lights, params, 0)
        counts = lit_lanes_per_warp(
            megakernel, lambda: megakernel.mega_render_plain(*args, **kw))
        lanes.append(counts)
        check(args, kw, f"[2w] {len(pos)} atoms, {label}: warps with a lit "
              f"lane {counts.numel()}, with one {int((counts == 1).sum())}, "
              f"all 32 lit {int((counts == 32).sum())}")
    counts = torch.cat(lanes)
    if not (int((counts == 1).sum()) and int((counts == 32).sum())):
        fail("[2w] no warp with a single lit lane, or none with all lanes lit")
    print(f"  [2w] on {card}: walk cases max |diff| {max(errs):.3e}")
    return errs


def tile_cases(tile_kernels, dev, card: str) -> dict:
    """Phase 2 (t): the tile kernels' edge cases, kernel against plain at
    max |diff| 0.  The cases are ``tests/_tile_cases.py``'s, which the CPU
    test ``tests/test_torch_tile_cases.py`` holds against the JAX package
    and a numpy brute force."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import _tile_cases as tc

    errs = {"closest_hit_spheres_tiles": [], "shadow_filter_tiles": []}
    for name, kw in tc.HIT_CASES.items():
        args = tuple(torch.as_tensor(a, device=dev) for a in tc.hit_case(**kw))
        errs["closest_hit_spheres_tiles"].append(compare_hit(
            tile_kernels, args, dict(eps=float(tc.EPS)), f"[2t] closest hit {name}"))
    for name, kw in tc.SHADOW_CASES.items():
        args = tuple(torch.as_tensor(a, device=dev) for a in tc.shadow_case(**kw))
        errs["shadow_filter_tiles"].append(compare_filt(
            tile_kernels, args, dict(grid_n=tc.GRID, eps=float(tc.EPS)),
            f"[2t] shadow filter {name}"))
    print(f"  [2t] on {card}: {len(tc.HIT_CASES)} closest-hit and "
          f"{len(tc.SHADOW_CASES)} shadow-filter cases at max |diff| 0")
    return errs


# ---- the neighbor engine and the potentials' force path (float64) ------

PEAK_FP64 = 34e12     # H100 SXM, float64 outside the tensor cores
# float64 operations of one candidate test of the neighbor build: the
# displacement (3), to fractional (15), the minimum image (9), back (15),
# the squared distance (5), the cutoff (1); rounded
OPS_NEIGHBOR_TEST = 50
# float64 operations of one EAM pair: pass 1 (the minimum image 45, the root,
# three spline rows of 15, phi and the staged factors 15) and pass 2 (the
# factor 4, force and virial sums 24); rounded
OPS_EAM_PAIR = 130
# float64 operations of one NEP pair, forward: radial (the cutoff, 9
# Chebyshev terms, the per-type sums) and, within the angular cutoff, its
# basis, the type mixing of 5 x 9 coefficients and 5 channels' 24
# accumulators; the backward pass counted as twice the forward; rounded
OPS_NEP_RADIAL_PAIR = 80
OPS_NEP_ANGULAR_PAIR = 490
NEIGHBOR_CELLS = 63   # 1,000,188 atoms, as bench.py:246
POTENTIAL_CELLS = 40  # 256,000 atoms, as bench.py:125
TOL_NEIGHBOR_DIST = 1e-12
TOL_EAM = 1e-9
TOL_NEP = 1e-8
TOL_PERFECT = 1e-10


def f64_bound(ops: float, nbytes: float):
    """Least time (ms) for ``ops`` float64 operations and ``nbytes`` of HBM
    traffic, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_FP64 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def median_ms(fn, reps: int):
    """Median host ms of ``reps`` calls of ``fn``, each bracketed by
    ``torch.cuda.synchronize()``, after one warm-up call; and the last
    result."""
    out, _ = sync_time(fn)
    times = []
    for _ in range(reps):
        out, t = sync_time(fn)
        times.append(t * 1e3)
    return float(np.median(times)), out


def peak_of(fn):
    """Peak device bytes allocated during one call of ``fn``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


# torch.profiler on the card's machine now and then keeps a call's host
# events but none of its device records (seen on calls of a few kernels
# after a long host stretch: MSD direct, Warren-Cowley); a retake may
# catch them
PROFILE_TRIES = 5


def profile_call(fn, top: int = 6):
    """One call of ``fn`` under ``torch.profiler``: its device activities
    (kernel launches and copies), their summed device ms, and the ``top``
    kernels by device time.  Every call profiled runs on the card, so a
    profile without device records failed: it is taken again, up to
    PROFILE_TRIES times; if none records any, launches, copies and device
    ms are None (printed as not measured), never 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            break
        print(f"    torch.profiler recorded no device events (try "
              f"{attempt + 1} of {PROFILE_TRIES})")
    else:
        return {"launches": None, "copies": None, "device_ms": None,
                "top": []}
    kern = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-3
    busy = sum(e.time_range.elapsed_us() for e in dev) * 1e-3
    tops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"launches": len(kern), "copies": len(dev) - len(kern),
            "device_ms": busy, "top": [(k[:70], round(v, 3)) for k, v in tops]}


def print_call(tag: str, what: str, ms: float, prof: dict, bound_ms: float,
               by: str, peak: int, card: str) -> dict:
    share = bound_ms / ms * 100
    if prof["launches"] is None:
        why = prof.get("why", f"no device events in {PROFILE_TRIES} profiles")
        dev = f"launches and device busy not measured ({why})"
    else:
        dev = (f"{prof['launches']} kernel launches + {prof['copies']} copies, "
               f"device busy {prof['device_ms']:.3f} ms "
               f"({prof['device_ms'] / ms * 100:.1f} % of the call)")
    print(f"  {tag} {what}: {ms:.3f} ms (median), {dev}; bound {bound_ms:.4f} "
          f"ms by {by}, share {share:.3f} %; peak {peak} B; {card}")
    print(f"    top kernels (ms): {prof['top']}")
    return {"ms": ms, "launches": prof["launches"], "copies": prof["copies"],
            "device_ms": prof["device_ms"], "bound_ms": bound_ms,
            "bound_by": by, "share": share, "peak": peak}


def same_again(run, pot, tag: str) -> None:
    """Run the force call once more: energies, forces and virials must be
    the last call's bit for bit (row sums, no atomics)."""
    before = {k: pot.results[k].clone() for k in ("energies", "forces", "virials")}
    run()
    if not all(torch.equal(before[k], pot.results[k]) for k in before):
        fail(f"{tag} a second force call differs from the first")
    print(f"  {tag} a second call repeats energies, forces and virials bit for bit")


def fcc_system(n_cells: int, a: float = 3.615, rattle: float = 0.0, seed=0,
               ni_share: float = 0.0):
    """(positions, cubic periodic Box, elements) of n_cells^3 FCC cells of Cu,
    a seeded share of the atoms Ni, rattled by normal(0, ``rattle``) A."""
    from mdapy_tpu_torch.core.box import Box

    pos = fcc_block(n_cells)[0]
    rng = np.random.default_rng(seed)
    if rattle:
        pos = pos + rng.normal(0.0, rattle, pos.shape)
    elems = np.where(rng.random(len(pos)) < ni_share, "Ni", "Cu").astype(object)
    return pos, Box(np.eye(3) * n_cells * a), elems


def rows_by_index(verlet, dist, cnt):
    """Each row's first ``cnt`` (index, distance) pairs in index order, as
    two padded arrays (-1 / 0 beyond the count)."""
    verlet, dist = np.asarray(verlet), np.asarray(dist)
    live = np.arange(verlet.shape[1])[None] < np.asarray(cnt)[:, None]
    key = np.where(live, verlet, np.iinfo(np.int32).max)
    order = np.argsort(key, axis=1, kind="stable")
    return (np.where(live, np.take_along_axis(key, order, 1), -1),
            np.where(live, np.take_along_axis(dist, order, 1), 0.0))


def neighbor_phase(card: str) -> dict:
    """[N1] The neighbor engine on 1,000,188 atoms of FCC Cu at rc 5 A."""
    from mdapy_tpu_torch.core.box import Box
    from mdapy_tpu_torch.neighbor import cell_list as cl
    from mdapy_tpu_torch.neighbor.knn import knn_search
    from mdapy_tpu_torch.neighbor.neighbor import (
        CellFrame, neighbor_search, neighbor_search_device)

    rc = 5.0
    pos, box, _ = fcc_system(NEIGHBOR_CELLS)
    n = len(pos)
    run = lambda: neighbor_search_device(pos, box, rc)  # noqa: E731
    ms, (pos_d, verlet, cnt, _) = median_ms(run, 5)
    if int(cnt.min()) != 42 or int(cnt.max()) != 42:
        fail(f"[N1] neighbor counts {int(cnt.min())}-{int(cnt.max())}, not 42 "
             "for every atom (12 + 6 + 24 within 5 A)")
    cap = verlet.shape[1]
    # the parts apart, on the same cell list: CUDA events
    frame = CellFrame(pos, box, rc, pos_d.device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    cells = frame.occupancy()
    ev[1].record()
    M = int(cells[4])
    order, _, start, count, _ = cells
    chunk = cl.query_chunk(27 * M)
    cand_ms = topk_ms = 0.0
    for s in range(0, n, chunk):
        e3 = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e3[0].record()
        c, ok, d2 = cl.candidate_distances(
            frame.pos, frame.pos[s:s + chunk], s, frame.matrix, frame.inv,
            frame.origin, frame.boundary, rc, frame.ncells, order, start,
            count, M)
        e3[1].record()
        cl.select_nearest(c, ok, d2, cap)
        e3[2].record()
        e3[2].synchronize()
        cand_ms += e3[0].elapsed_time(e3[1])
        topk_ms += e3[1].elapsed_time(e3[2])
        del c, ok, d2
    cell_ms = ev[0].elapsed_time(ev[1])
    # candidates tested: each atom against every atom of its 27 cells
    cxyz = torch.stack(torch.meshgrid(
        *(torch.arange(k, device=pos_d.device) for k in frame.ncells),
        indexing="ij"),
        -1).reshape(-1, 3)
    st, st_ok = cl._stencil_cells(cxyz, frame.ncells, frame.boundary)
    per_cell = torch.where(st_ok, count[st], 0).sum(1)
    tests = int((count * per_cell).sum())
    peak = peak_of(run)
    prof = profile_call(run)
    nbytes = n * 24 + n * cap * 4 + n * 4
    b_ms, by = f64_bound(tests * OPS_NEIGHBOR_TEST, nbytes)
    print(f"[N1] {card}: neighbor_search_device, {n} atoms of FCC Cu "
          f"(a 3.615 A, {NEIGHBOR_CELLS}^3 cells), rc {rc} A, float64: every "
          f"count 42; cells {frame.ncells}, M {M}, capacity {cap}, chunks of "
          f"{chunk} rows; {tests} candidate tests")
    print(f"  parts (CUDA events, one build): cell list {cell_ms:.3f} ms, "
          f"candidate gather + distances {cand_ms:.3f} ms, top-k "
          f"{topk_ms:.3f} ms")
    out = {"device": print_call("[N1]", "neighbor_search_device", ms, prof,
                                b_ms, by, peak, card),
           "cell_ms": cell_ms, "cand_ms": cand_ms, "topk_ms": topk_ms,
           "tests": tests, "M": M, "cap": cap}
    del pos_d, verlet, cnt, frame, cells, order, start, count
    torch.cuda.empty_cache()

    host = lambda: neighbor_search(pos, box, rc)  # noqa: E731
    ms, (v_h, d_h, c_h) = median_ms(host, 3)
    if not (c_h == 42).all():
        fail("[N1] neighbor_search: a count is not 42")
    nb_h = nbytes + n * v_h.shape[1] * 8
    b_ms, by = f64_bound(tests * OPS_NEIGHBOR_TEST, nb_h)
    out["host"] = print_call("[N1]", "neighbor_search (sorted, to the host)",
                             ms, profile_call(host), b_ms, by, peak_of(host), card)
    del v_h, d_h, c_h
    knn = lambda: knn_search(pos, box, 12)  # noqa: E731
    ms, (k_i, k_d) = median_ms(knn, 3)
    if k_i.shape != (n, 12) or abs(float(k_d.max()) - 3.615 / 2**0.5) > 1e-9:
        fail("[N1] knn_search(k=12) is not the 12 nearest at a / sqrt(2)")
    out["knn"] = print_call("[N1]", "knn_search(k=12)", ms, profile_call(knn),
                            *f64_bound(0, n * 24 + n * 12 * 12), peak_of(knn),
                            card)
    del k_i, k_d
    torch.cuda.empty_cache()

    # the card against the port's CPU: a seeded, rattled, triclinic box
    rng = np.random.default_rng(9)
    cells = np.mgrid[0:14, 0:14, 0:13].reshape(3, -1).T
    frac = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    lat = ((frac[None] + cells[:, None]).reshape(-1, 3)
           / np.array([14.0, 14.0, 13.0]))
    m = np.array([[14 * 3.615, 0, 0], [6.0, 14 * 3.615, 0],
                  [-4.0, 3.0, 13 * 3.615]])
    tpos = lat @ m + rng.normal(0.0, 0.05, (len(lat), 3))
    tbox = Box(m)
    vc, dc, cc = neighbor_search(tpos, tbox, rc)
    vp, dp, cp = neighbor_search(tpos, tbox, rc, device="cpu")
    if not np.array_equal(cc, cp):
        fail("[N1] card and CPU neighbor counts differ")
    (ic, dc2), (ip, dp2) = rows_by_index(vc, dc, cc), rows_by_index(vp, dp, cp)
    if not np.array_equal(ic, ip):
        fail("[N1] card and CPU neighbor sets differ")
    err = float(np.abs(dc2 - dp2).max())
    print(f"  card against the CPU, {len(tpos)} rattled atoms in a triclinic "
          f"cell: counts and sets equal, max |distance diff| {err:.3e} A")
    if err > TOL_NEIGHBOR_DIST:
        fail(f"[N1] distances differ by {err} A")
    out["card_cpu_err"] = err
    return out


def eam_phase(card: str, outdir: Path) -> dict:
    """[E1] The EAM force call on 256,000 atoms of FCC Cu."""
    from _torch_system import StandInSystem
    from mdapy_tpu_torch.neighbor.neighbor import neighbor_search_device
    from mdapy_tpu_torch.potentials import eam as team

    cu = str(outdir / "Cu.eam.alloy")
    team.EAMGenerator(["Cu"], output_filename=cu)
    pot = team.EAM(cu)
    pos, box, elems = fcc_system(POTENTIAL_CELLS)
    system = StandInSystem(pos, box, elems)
    run = lambda: pot.calculate(system)  # noqa: E731
    ms, _ = median_ms(run, 5)
    e = pot.results["energies"]
    f = pot.results["forces"]
    same_again(run, pot, "[E1]")
    e_std, f_max = float(e.std()), float(f.abs().max())
    print(f"[E1] {card}: EAM (the port's EAMGenerator(['Cu']), rc "
          f"{pot.rc:.4f} A) on {len(pos)} atoms of perfect FCC Cu, float64: "
          f"per-atom energy {float(e.mean()):.6f} eV, std {e_std:.3e} eV, "
          f"max |F| {f_max:.3e} eV/A")
    if not (e_std < TOL_PERFECT and f_max < TOL_PERFECT):
        fail("[E1] a perfect crystal's energies differ or its forces are not 0")
    nb_ms, (pos_d, verlet, cnt, _) = median_ms(
        lambda: neighbor_search_device(pos, box, pot.rc), 5)
    types = torch.zeros(len(pos), dtype=torch.int64, device=pos_d.device)
    tabs = pot._tables()
    matrix, inv, bnd = (torch.tensor(a, dtype=torch.float64, device=pos_d.device)
                        for a in (box.matrix, box.inverse_box, box.boundary))
    pack = torch.cat([pos_d, types[:, None].double()], 1)
    n, M = verlet.shape
    block = team.eam_block(n, M)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    rho = torch.empty(n, dtype=torch.float64, device=pos_d.device)
    staged = []
    for s in range(0, n, block):
        rho[s:s + block], _, stg = team.eam_pass1(
            pack, pack[s:s + block], verlet[s:s + block], matrix, inv, bnd,
            tabs[0], tabs[1], pot.dr, pot.rc, pot.nr, 1)
        staged.append(stg)
    ev[1].record()
    _, dF = team.eam_embed(rho, types, tabs[2], pot.drho, pot.nrho)
    ev[2].record()
    for i, s in enumerate(range(0, n, block)):
        team.eam_pass2(verlet[s:s + block], dF, dF[s:s + block], staged[i])
    ev[3].record()
    ev[3].synchronize()
    p1, emb, p2 = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
    pairs = int(cnt.sum())
    del staged, pack, rho, dF
    peak = peak_of(run)
    nbytes = 2 * n * M * 4 + pairs * (32 + 8) + n * (8 + 24 + 72)
    b_ms, by = f64_bound(pairs * OPS_EAM_PAIR, nbytes)
    print(f"  neighbor build {nb_ms:.3f} ms (median of 5), capacity {M}, "
          f"{pairs} pairs; pass 1 {p1:.3f} ms, embedding {emb:.3f} ms, pass 2 "
          f"{p2:.3f} ms (CUDA events, blocks of {block} rows)")
    out = print_call("[E1]", "EAM.calculate", ms, profile_call(run), b_ms, by,
                     peak, card)
    out.update(neighbor_ms=nb_ms, pass1_ms=p1, embed_ms=emb, pass2_ms=p2,
               pairs=pairs, passes_bound_ms=f64_bound(
                   pairs * OPS_EAM_PAIR, nbytes)[0])
    del pos_d, verlet, cnt, pot, system
    torch.cuda.empty_cache()

    # the card against the CPU: a seeded, rattled Cu-Ni alloy
    cuni = str(outdir / "CuNi.eam.alloy")
    team.EAMGenerator(["Cu", "Ni"], output_filename=cuni)
    pos, box, elems = fcc_system(10, rattle=0.05, seed=4, ni_share=0.3)
    errs = []
    res = []
    for device in ("cuda", "cpu"):
        s = StandInSystem(pos, box, elems)
        s.calc = team.EAM(cuni, device=device)
        res.append((s.get_energies(), s.get_force(), s.get_virials(),
                    s.get_stress()))
    errs = [float(np.abs(a - b).max()) for a, b in zip(*res)]
    print(f"  card against the CPU, {len(pos)} rattled Cu-Ni atoms: max |diff| "
          f"energies {errs[0]:.3e}, forces {errs[1]:.3e}, virials "
          f"{errs[2]:.3e}, stress {errs[3]:.3e}")
    if max(errs) > TOL_EAM:
        fail(f"[E1] the card and the CPU differ by {max(errs)}")
    out["card_cpu_err"] = max(errs)
    return out


def fire_phase(card: str, outdir: Path) -> dict:
    """[F1] FIRE on the [E1] crystal rattled by a seeded 0.05 A."""
    from _torch_system import StandInSystem
    from mdapy_tpu_torch.potentials.eam import EAM
    from mdapy_tpu_torch.potentials.minimizer import FIRE

    pos, box, elems = fcc_system(POTENTIAL_CELLS, rattle=0.05, seed=5)

    class Timed(StandInSystem):
        stamps = []

        def update_pos(self, p):
            super().update_pos(p)
            self.stamps.append(time.perf_counter())

    system = Timed(pos, box, elems)
    system.calc = EAM(str(outdir / "Cu.eam.alloy"))
    out = {}
    for label, kw in (("positions", {}), ("positions + cell",
                                          {"optimize_cell": True})):
        e0 = system.get_energy()
        Timed.stamps = [time.perf_counter()]
        fire = FIRE(system, **kw)
        print(f"[F1] {card}: FIRE, {label}, 10 steps on {len(pos)} atoms "
              f"(EAM on the card):")
        fire.run(10, fmax=1e-12, show_process=True)
        torch.cuda.synchronize()
        steps = np.diff(Timed.stamps) * 1e3
        e1 = system.get_energy()
        print(f"  energy {e0:.6f} -> {e1:.6f} eV; ms per step: "
              f"{[round(float(t), 1) for t in steps]}, median "
              f"{float(np.median(steps)):.1f}")
        if not e1 < e0:
            fail(f"[F1] FIRE ({label}) did not lower the energy")
        out[label] = {"e0": e0, "e1": e1, "ms_per_step": float(np.median(steps))}
    return out


def nep_phase(card: str, outdir: Path) -> dict:
    """[P1] A NEP4 + ZBL force call on 256,000 atoms of Cu-Ni."""
    from _nep_file import write_nep
    from _torch_system import StandInSystem
    from mdapy_tpu_torch.potentials.nep import NEP, gather_disp

    path = write_nep(outdir / "CuNi_nep4_zbl.txt", version=4,
                     elements=("Cu", "Ni"), zbl=(1.0, 2.0), seed=7)
    pot = NEP(path)
    pos, box, elems = fcc_system(POTENTIAL_CELLS, rattle=0.05, seed=6,
                                 ni_share=0.3)
    system = StandInSystem(pos, box, elems)
    run = lambda: pot.calculate(system)  # noqa: E731
    ms, _ = median_ms(run, 3)
    e, f = pot.results["energies"], pot.results["forces"]
    same_again(run, pot, "[P1]")
    if not (torch.isfinite(e).all() and torch.isfinite(f).all()):
        fail("[P1] energies or forces not finite")
    desc = lambda: pot.get_descriptors(system)  # noqa: E731
    d_ms, q = median_ms(desc, 3)
    if q.shape != (len(pos), pot.dim) or not np.isfinite(q).all():
        fail("[P1] descriptors of the wrong shape or not finite")
    # pairs within each cutoff: what the descriptor's work needs
    pos_d, box_c, types, verlet, _ = pot._prepare_device(system)
    dispc, _, ok = gather_disp(pos_d, torch.as_tensor(types, device=pos_d.device),
                               verlet, box_c)
    d = torch.sqrt(sum(c * c for c in dispc))
    n_r = int((ok & (d < pot.rc_radial)).sum())
    n_a = int((ok & (d < pot.rc_angular)).sum())
    n, M = verlet.shape
    del dispc, d, ok, pos_d, verlet
    ops_fwd = n_r * OPS_NEP_RADIAL_PAIR + n_a * OPS_NEP_ANGULAR_PAIR
    ann = n * 2 * pot.num_neurons * pot.dim
    nbytes = n * 32 + n * M * 4 + n * 13 * 8
    b_ms, by = f64_bound(3 * (ops_fwd + ann), nbytes)
    db_ms, dby = f64_bound(ops_fwd, nbytes)
    print(f"[P1] {card}: NEP4 + ZBL (Cu, Ni; cutoff 8 4, n_max 4 4, "
          f"basis_size 8 8, l_max 4 2 0, 30 neurons, dim {pot.dim}) on {n} "
          f"rattled atoms, 30 % Ni, float64: capacity {M}, {n_r} radial and "
          f"{n_a} angular pairs; per-atom energy {float(e.mean()):.6f} eV, "
          f"max |F| {float(f.abs().max()):.4f} eV/A")
    out = {"force": print_call("[P1]", "NEP.calculate", ms, profile_call(run),
                               b_ms, by, peak_of(run), card),
           "descriptor": print_call("[P1]", "NEP.get_descriptors", d_ms,
                                    profile_call(desc), db_ms, dby,
                                    peak_of(desc), card)}
    del pot, system
    torch.cuda.empty_cache()

    # the card against the CPU on 2,048 atoms
    pos, box, elems = fcc_system(8, rattle=0.1, seed=8, ni_share=0.3)
    res = []
    for device in ("cuda", "cpu"):
        s = StandInSystem(pos, box, elems)
        s.calc = NEP(path, device=device)
        res.append((s.get_energies(), s.get_force(), s.get_virials(),
                    s.get_stress(), s.calc.get_descriptors(s)))
    errs = [float(np.abs(a - b).max()) for a, b in zip(*res)]
    print(f"  card against the CPU, {len(pos)} rattled Cu-Ni atoms: max |diff| "
          f"energies {errs[0]:.3e}, forces {errs[1]:.3e}, virials "
          f"{errs[2]:.3e}, stress {errs[3]:.3e}, descriptors {errs[4]:.3e}")
    if max(errs) > TOL_NEP:
        fail(f"[P1] the card and the CPU differ by {max(errs)}")
    out["card_cpu_err"] = max(errs)
    return out


def potential_phases(card: str) -> dict:
    """[N1], [E1], [F1] and [P1], their files under chiprun_out/smoke."""
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "tests"))  # _torch_system, _nep_file
    outdir = root / "chiprun_out" / "smoke"
    outdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out = {"N1": neighbor_phase(card)}
    torch.cuda.empty_cache()
    out["E1"] = eam_phase(card, outdir)
    out["F1"] = fire_phase(card, outdir)
    torch.cuda.empty_cache()
    out["P1"] = nep_phase(card, outdir)
    torch.cuda.empty_cache()
    print(f"[N1-P1] {time.perf_counter() - t0:.1f} s")
    return out


# ---- the structure analyses (ROADMAP A10), float64 ----------------------

DIAMOND_CELLS = 50    # 1,000,000 atoms of diamond
CUT_CELLS = 10        # the card against the CPU: 4,000 FCC atoms (diamond 8)
TOL_CARD_CPU = 1e-12
# float64 operations of the analyses' own arithmetic, by the unit each
# repeats (the neighbor build inside a call is not counted, so each bound
# is below the least time of the whole call): one minimum-imaged
# displacement (the difference 3, to fractional and back 30, the round and
# shift 6, rounded up); one bond-pair test (a displacement and its squared
# norm against the cutoff); one bond angle (a dot product, arccos, the
# scale and the bin); one Gaussian of the entropy (difference, square,
# scale, exp)
OPS_DISP = 45
OPS_PAIR = 50
OPS_ANGLE = 30
OPS_GAUSS = 25


def diamond_positions(n_cells: int, a: float) -> np.ndarray:
    """Cubic diamond, 8 * n_cells**3 atoms in a cube of n_cells * a."""
    fcc = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    basis = np.vstack([fcc, fcc + 0.25])
    cells = np.mgrid[0:n_cells, 0:n_cells, 0:n_cells].reshape(3, -1).T
    return (basis[None] + cells[:, None]).reshape(-1, 3) * a


def same_bits(a, b) -> bool:
    return all(x.dtype == y.dtype and x.tobytes() == y.tobytes()
               for x, y in zip(a, b))


def analysis_call(tag: str, what: str, run, outputs, card: str, ops: float,
                  nbytes: float, warm=None, reps: int = 3,
                  profile: bool = True) -> dict:
    """``run()`` computes the analysis and returns it; ``outputs(obj)`` its
    result arrays.  A warm-up call (or ``warm``, the result of one made
    before), ``reps`` timed calls (the median; each must repeat the
    warm-up's results bit for bit), then, with ``profile``, one call under
    ``torch.profiler`` that also reads the peak (else the peak of the timed
    calls, and no launches)."""
    first = outputs(run() if warm is None else warm)
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(reps):
        obj, t = sync_time(run)
        times.append(t * 1e3)
        if not same_bits(outputs(obj), first):
            fail(f"{tag} {what}: a second call differs from the first")
    del obj
    if profile:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof = profile_call(run)
    else:
        prof = {"launches": None, "copies": None, "device_ms": None,
                "top": [], "why": "not profiled"}
    peak = torch.cuda.max_memory_allocated()
    b_ms, by = f64_bound(ops, nbytes)
    out = print_call(tag, what, float(np.median(times)), prof, b_ms, by, peak,
                     card)
    print(f"    {what}: every repeat equal bit for bit to the first call")
    return out


def card_against_cpu(tag: str, what: str, make, outputs, rtol=None,
                     scale=None) -> float:
    """``make(device)`` on a cut of about 4,000 atoms, on the card and on
    the CPU: integer results equal, floats within TOL_CARD_CPU (nan and inf
    in the same places), or, given ``rtol``, within ``rtol`` of the largest
    |value| (or of ``scale``)."""
    got, want = outputs(make("cuda")), outputs(make("cpu"))
    err = 0.0
    for x, y in zip(got, want):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape:
            fail(f"{tag} {what}: card {x.shape} against CPU {y.shape}")
        if x.dtype.kind != "f":
            if not np.array_equal(x, y):
                fail(f"{tag} {what}: the card's labels or counts differ from "
                     f"the CPU's in {int((x != y).sum())} places")
            continue
        if not np.array_equal(np.isfinite(x), np.isfinite(y)):
            fail(f"{tag} {what}: the card and the CPU differ in finiteness")
        fin = np.isfinite(x)
        if fin.any():
            diff = float(np.abs(x[fin] - y[fin]).max())
            if rtol is not None:
                diff /= scale if scale is not None else max(
                    1e-300, float(np.abs(y[fin]).max()))
            err = max(err, diff)
    if rtol is None:
        if err > TOL_CARD_CPU:
            fail(f"{tag} {what}: the card and the CPU differ by {err}")
        print(f"    card against the CPU ({what}, about 4,000 atoms): labels "
              f"and counts equal, floats within {err:.3e}")
        return err
    if err > rtol:
        fail(f"{tag} {what}: the card and the CPU differ by {err:.3e} "
             f"relative (limit {rtol:g})")
    print(f"    card against the CPU ({what}): labels and counts equal, floats "
          f"within {err:.3e} relative (limit {rtol:g})")
    return err


def classifier_phase(card: str) -> dict:
    """[S1] The classifiers on N1's block, perfect and rattled."""
    import mdapy_tpu_torch as mt
    from mdapy_tpu_torch.neighbor.neighbor import neighbor_tensors

    pos, box, _ = fcc_system(NEIGHBOR_CELLS)
    rat, _, _ = fcc_system(NEIGHBOR_CELLS, rattle=0.05, seed=21)
    n = len(pos)
    cut, cbox, _ = fcc_system(CUT_CELLS, rattle=0.05, seed=22)
    out = {}
    print(f"[S1] {card}: the classifiers on {n} atoms of FCC Cu (a 3.615 A, "
          f"{NEIGHBOR_CELLS}^3 cells), rattled by 0.05 A (seed 21) when timed, "
          "float64")

    def fcc_everywhere(labels, what):
        if not (labels == 1).all():
            fail(f"[S1] {what}: {int((labels != 1).sum())} atoms of the "
                 "perfect block are not FCC")

    # CSP: 12 displacements and 66 pair sums (8 operations) an atom
    csp = mt.CentroSymmetryParameter(pos, box, 12).compute().csp
    if not csp.max() < 1e-20:
        fail(f"[S1] CSP of the perfect block reaches {csp.max()}")
    out["csp"] = analysis_call(
        "[S1]", "CentroSymmetryParameter(N=12)",
        lambda: mt.CentroSymmetryParameter(rat, box, 12).compute(),
        lambda o: (o.csp,), card, n * (12 * OPS_DISP + 66 * 8),
        n * (24 + 12 * 4 * 2 + 8))
    print(f"    perfect block: CSP max {csp.max():.3e} (< 1e-20); rattled "
          f"mean {float(np.mean(csp)):.3e}")
    card_against_cpu("[S1]", "CSP", lambda d: mt.CentroSymmetryParameter(
        cut, cbox, 12, device=d).compute(), lambda o: (o.csp,))

    # adaptive CNA: 14 displacements, 12^2 + 14^2 bond-pair tests an atom
    fcc_everywhere(mt.CommonNeighborAnalysis(pos, box).compute().cna,
                   "adaptive CNA")
    out["cna"] = analysis_call(
        "[S1]", "CommonNeighborAnalysis (adaptive)",
        lambda: mt.CommonNeighborAnalysis(rat, box).compute(),
        lambda o: (o.cna,), card, n * (14 * OPS_DISP + 340 * OPS_PAIR),
        n * (24 + 14 * 4 * 2 + 4))
    card_against_cpu("[S1]", "adaptive CNA", lambda d: mt.CommonNeighborAnalysis(
        cut, cbox, device=d).compute(), lambda o: (o.cna,))

    # fixed CNA at rc 3: 14^2 bond-pair tests an atom (12 neighbors, 14
    # columns)
    fcc_everywhere(mt.CommonNeighborAnalysis(pos, box, rc=3.0).compute().cna,
                   "fixed CNA")
    out["cna_fixed"] = analysis_call(
        "[S1]", "CommonNeighborAnalysis(rc=3.0)",
        lambda: mt.CommonNeighborAnalysis(rat, box, rc=3.0).compute(),
        lambda o: (o.cna,), card, n * 196 * OPS_PAIR,
        n * (24 + 14 * 4 * 2 + 4))
    card_against_cpu("[S1]", "fixed CNA", lambda d: mt.CommonNeighborAnalysis(
        cut, cbox, rc=3.0, device=d).compute(), lambda o: (o.cna,))

    # Ackland-Jones: 14 displacements, 196 cosines (5) binned on 7 edges
    fcc_everywhere(mt.AcklandJonesAnalysis(pos, box).compute().aja,
                   "Ackland-Jones")
    out["aja"] = analysis_call(
        "[S1]", "AcklandJonesAnalysis",
        lambda: mt.AcklandJonesAnalysis(rat, box).compute(),
        lambda o: (o.aja,), card, n * (14 * OPS_DISP + 196 * 12),
        n * (24 + 14 * 12 * 2 + 4))
    card_against_cpu("[S1]", "Ackland-Jones", lambda d: mt.AcklandJonesAnalysis(
        cut, cbox, device=d).compute(), lambda o: (o.aja,))

    # CNP at rc 3 on a list built beforehand: M^2 (j, s) slots, two
    # displacements each
    lists = neighbor_tensors(rat, box, 3.0)
    M = lists[0].shape[1]
    cnp_p = mt.CommonNeighborParameter(
        pos, box, 3.0, *neighbor_tensors(pos, box, 3.0)).compute().cnp
    if not cnp_p.max() < 1e-20:
        fail(f"[S1] CNP of the perfect block reaches {cnp_p.max()}")
    out["cnp"] = analysis_call(
        "[S1]", f"CommonNeighborParameter(rc=3.0), {M} columns",
        lambda: mt.CommonNeighborParameter(rat, box, 3.0, *lists).compute(),
        lambda o: (o.cnp,), card, n * M * M * (2 * OPS_DISP + 9),
        n * (24 + M * 12 + 8))
    del lists
    card_against_cpu("[S1]", "CNP", lambda d: mt.CommonNeighborParameter(
        cut, cbox, 3.0, *neighbor_tensors(cut, cbox, 3.0, device=d),
        device=d).compute(), lambda o: (o.cnp,))

    # Steinhardt q4, q6 (+ w-hat, averaged, solid-liquid): per bond and l a
    # displacement, the Legendre recurrences (3 (l+1)^2) and the 2l+1 terms
    # (10 each)
    kw = dict(llist=(4, 6), nnn=12, wlhat=True, average=True,
              identify_liquid=True)
    st = mt.SteinhardtBondOrientation(pos, box, **kw).compute()
    spread = float(np.ptp(st.qnarray, axis=0).max())
    if spread > 1e-10 or not (st.solidliquid == 1).all():
        fail(f"[S1] Steinhardt on the perfect block: spread {spread}, "
             f"{int((st.solidliquid != 1).sum())} atoms not solid")
    print(f"    perfect block: q4 {st.qnarray[0, 0]:.6f}, q6 "
          f"{st.qnarray[0, 1]:.6f} at every atom (spread {spread:.1e}), every "
          "atom solid")
    per_bond = sum(OPS_DISP + 3 * (l + 1) ** 2 + 10 * (2 * l + 1)
                   for l in (4, 6))
    out["steinhardt"] = analysis_call(
        "[S1]", "SteinhardtBondOrientation(l 4 6, nnn 12, wlhat, average, "
        "identify_liquid)",
        lambda: mt.SteinhardtBondOrientation(rat, box, **kw).compute(),
        lambda o: (o.qnarray, o.solidliquid, o.nbond), card,
        n * 12 * per_bond, n * (24 + 12 * 4 * 2 + 4 * 8 + 8))
    card_against_cpu("[S1]", "Steinhardt", lambda d: mt.SteinhardtBondOrientation(
        cut, cbox, device=d, **kw).compute(),
        lambda o: (o.qnarray, o.solidliquid, o.nbond))
    return out


def diamond_phase(card: str) -> dict:
    """[S2] Diamond and ice on 1,000,000 atoms of perfect cubic diamond."""
    import mdapy_tpu_torch as mt
    from mdapy_tpu_torch.core.box import Box

    out = {}
    rng = np.random.default_rng(23)
    for name, a in (("diamond", 5.431), ("ice", 6.35)):
        pos = diamond_positions(DIAMOND_CELLS, a)
        box = Box(np.eye(3) * DIAMOND_CELLS * a)
        cut = diamond_positions(8, a)
        cut = cut + rng.normal(0.0, 0.05, cut.shape)
        cbox = Box(np.eye(3) * 8 * a)
        n = len(pos)
        if name == "diamond":
            print(f"[S2] {card}: {n} atoms of perfect cubic diamond "
                  f"({DIAMOND_CELLS}^3 cells), float64")
            # 12 displacements and 12^2 bond-pair tests an atom
            run = lambda: mt.IdentifyDiamondStructure(pos, box).compute()  # noqa: E731
            out[name] = analysis_call(
                "[S2]", "IdentifyDiamondStructure (a 5.431 A)", run,
                lambda o: (o.ids,), card, n * (12 * OPS_DISP + 144 * OPS_PAIR),
                n * (24 + 4 * 8 + 4))
            labels, want = run().ids, 1
            make = lambda d: mt.IdentifyDiamondStructure(  # noqa: E731
                cut, cbox, device=d).compute()
            outputs = lambda o: (o.ids,)  # noqa: E731
        else:
            # 4 bonds an atom: a displacement, Y_3m (3 * 16 + 7 * 10)
            run = lambda: mt.ChillPlus(pos, box, 3.5).compute()  # noqa: E731
            out[name] = analysis_call(
                "[S2]", "ChillPlus (a 6.35 A, the O sublattice of cubic ice, "
                "rc 3.5)", run, lambda o: (o.chill_plus,), card,
                n * 4 * (OPS_DISP + 48 + 70 + 30), n * (24 + 16 * 12 + 4))
            labels, want = run().chill_plus, 2
            make = lambda d: mt.ChillPlus(cut, cbox, 3.5, device=d).compute()  # noqa: E731
            outputs = lambda o: (o.chill_plus,)  # noqa: E731
        if not (labels == want).all():
            fail(f"[S2] {name}: {int((labels != want).sum())} atoms are not "
                 f"label {want}")
        print(f"    every atom label {want} ("
              f"{'cubic diamond' if want == 1 else 'cubic ice'})")
        card_against_cpu("[S2]", name, make, outputs)
        del pos
    return out


def distribution_phase(card: str) -> dict:
    """[S3] RDF, ADF, bonds and entropy on N1's block rattled."""
    import mdapy_tpu_torch as mt
    from mdapy_tpu_torch.neighbor.neighbor import neighbor_tensors

    rat, box, _ = fcc_system(NEIGHBOR_CELLS, rattle=0.05, seed=21)
    n = len(rat)
    cut, cbox, _ = fcc_system(CUT_CELLS, rattle=0.05, seed=22)
    out = {}
    print(f"[S3] {card}: distributions on {n} atoms of FCC Cu rattled by "
          "0.05 A, float64")

    def counts_of(o):
        return (o.g_total,) + tuple(o.g_partial[k] for k in sorted(o.g_partial))

    run = lambda: mt.RadialDistributionFunction(rat, box, 5.0, 200).compute()  # noqa: E731
    g = run()
    print(f"    RDF (Verlet route): first peak at r {g.r[np.argmax(g.g_total)]:.4f} "
          f"A, g {g.g_total.max():.4f}")
    # the list's ~42 pairs an atom, each binned (a division and a compare)
    out["rdf"] = analysis_call("[S3]", "RadialDistributionFunction(rc 5, nbin 200)",
                               run, counts_of, card, n * 42 * 4,
                               n * (24 + 42 * 12))
    card_against_cpu("[S3]", "RDF", lambda d: mt.RadialDistributionFunction(
        cut, cbox, 5.0, 200, device=d).compute(), counts_of)

    rc_adf = {"1-1-1": [0.0, 3.0, 0.0, 3.0]}
    ones = np.ones(n, int)
    run = lambda: mt.AngularDistributionFunction(  # noqa: E731
        rat, box, rc_adf, nbin=180, types=ones).compute()
    out["adf"] = analysis_call(
        "[S3]", "AngularDistributionFunction(Cu-Cu-Cu, 0-3 A, nbin 180)", run,
        lambda o: (o.bond_angle_distribution,), card,
        n * (12 * OPS_DISP + 66 * OPS_ANGLE), n * (24 + 12 * 12))
    card_against_cpu("[S3]", "ADF", lambda d: mt.AngularDistributionFunction(
        cut, cbox, rc_adf, nbin=180, types=np.ones(len(cut), int),
        device=d).compute(), lambda o: (o.bond_angle_distribution,))

    lists = neighbor_tensors(rat, box, 3.0)
    M = lists[0].shape[1]
    run = lambda: mt.BondAnalysis(rat, box, 3.0, 180, *lists).compute()  # noqa: E731
    out["bonds"] = analysis_call(
        "[S3]", f"BondAnalysis(rc 3, nbin 180), {M} columns", run,
        lambda o: (o.bond_length_distribution, o.bond_angle_distribution),
        card, n * (M * OPS_DISP + M * (M - 1) / 2 * OPS_ANGLE),
        n * (24 + M * 12))
    del lists
    card_against_cpu("[S3]", "bonds", lambda d: mt.BondAnalysis(
        cut, cbox, 3.0, 180, *neighbor_tensors(cut, cbox, 3.0, device=d),
        device=d).compute(),
        lambda o: (o.bond_length_distribution, o.bond_angle_distribution))

    lists = neighbor_tensors(rat, box, 5.0)
    M = lists[0].shape[1]
    nbins = int(np.floor(5.0 / 0.2)) + 1
    for local in (False, True):
        run = lambda: mt.StructureEntropy(  # noqa: E731
            rat, box, 5.0, 0.2, local, *lists).compute()
        out[f"entropy_local_{local}"] = analysis_call(
            "[S3]", f"StructureEntropy(rc 5, sigma 0.2, "
            f"use_local_density={local}), {M} columns", run,
            lambda o: (o.entropy,), card,
            n * (M * nbins * OPS_GAUSS + nbins * 12), n * (M * 12 + 8))
        card_against_cpu("[S3]", f"entropy (local density {local})",
                         lambda d: mt.StructureEntropy(
                             cut, cbox, 5.0, 0.2, local,
                             *neighbor_tensors(cut, cbox, 5.0, device=d),
                             device=d).compute(), lambda o: (o.entropy,))
    del lists

    # the streaming route: a 12^3-cell block, 43.4 A thick, at rc 15
    small, sbox, _ = fcc_system(12, rattle=0.05, seed=24)
    rdf = mt.RadialDistributionFunction(small, sbox, 15.0, 200)
    if not rdf._auto_streaming():
        fail("[S3] the auto rule did not pick the streaming route")
    ns = len(small)
    out["rdf_streaming"] = analysis_call(
        "[S3]", f"RadialDistributionFunction streaming ({ns} atoms, rc 15)",
        lambda: mt.RadialDistributionFunction(small, sbox, 15.0, 200).compute(),
        counts_of, card, ns * ns * (OPS_DISP + 10), ns * 24)
    card_against_cpu("[S3]", "RDF streaming (rc 12.5)",
                     lambda d: mt.RadialDistributionFunction(
                         cut, cbox, 12.5, 200, streaming=True,
                         device=d).compute(), counts_of)
    return out


def graph_phase(card: str) -> dict:
    """[S4] Clusters, atomic strain and Wigner-Seitz on N1's block."""
    import mdapy_tpu_torch as mt
    from _torch_system import StandInSystem

    pos, box, _ = fcc_system(NEIGHBOR_CELLS)
    n = len(pos)
    cut, cbox, _ = fcc_system(CUT_CELLS)
    out = {}
    rng = np.random.default_rng(25)
    print(f"[S4] {card}: graphs and displacements on N1's block ({n} atoms), "
          "float64")

    def thinned(p, seed):
        keep = np.random.default_rng(seed).random(len(p)) >= 0.3
        q = p[keep]
        return q + np.random.default_rng(seed + 1).normal(0.0, 0.05, q.shape)

    kept = thinned(pos, 26)
    run = lambda: mt.ClusterAnalysis(kept, box, 3.0).compute()  # noqa: E731
    c = run()
    print(f"    ClusterAnalysis: {len(kept)} atoms kept of {n} (seed 26), "
          f"{c.cluster_number} clusters, the largest "
          f"{int(np.bincount(c.particleClusters).max())} atoms")
    out["cluster"] = analysis_call(
        "[S4]", "ClusterAnalysis(rc 3.0), 30 % of the atoms removed", run,
        lambda o: (o.particleClusters,), card, 0,
        len(kept) * (24 + 12 * 12 + 4))
    card_against_cpu("[S4]", "clusters", lambda d: mt.ClusterAnalysis(
        thinned(cut, 27), cbox, 3.0, device=d).compute(),
        lambda o: (o.particleClusters,))

    shear = np.eye(3)
    shear[0, 1] = 0.01
    cur = pos @ shear + rng.normal(0.0, 0.05, pos.shape)
    ref = StandInSystem(pos, box, "Cu", device="cuda")
    strain = mt.AtomicStrain(5.0, ref)
    M = ref.verlet_list.shape[1]
    current = StandInSystem(cur, box.matrix @ shear, "Cu")
    run = lambda: strain.compute(current)  # noqa: E731
    s = run()
    print(f"    AtomicStrain: mean shear strain {float(np.mean(s.shear_strain)):.6f}"
          f", mean volumetric {float(np.mean(s.volumetric_strain)):.3e}")
    # two displacements a slot; V and W (18 each); a 3x3 inverse, F, eps and
    # the outputs (~150) an atom
    out["strain"] = analysis_call(
        "[S4]", f"AtomicStrain(rc 5).compute, 1 % shear + 0.05 A rattle, "
        f"{M} columns", run, lambda o: (o.shear_strain, o.volumetric_strain),
        card, n * (M * (2 * OPS_DISP + 36) + 150), n * (48 + M * 4 + 16))

    def strain_cut(d):
        cur_c = cut @ shear + np.random.default_rng(28).normal(0.0, 0.05,
                                                                cut.shape)
        return mt.AtomicStrain(5.0, StandInSystem(cut, cbox, "Cu", device=d),
                               device=d).compute(
            StandInSystem(cur_c, cbox.matrix @ shear, "Cu"))

    card_against_cpu("[S4]", "atomic strain", strain_cut,
                     lambda o: (o.shear_strain, o.volumetric_strain))
    del strain, ref, current

    def defective(p, seed):
        r = np.random.default_rng(seed)
        q = p + r.normal(0.0, 0.05, p.shape)
        moved = r.choice(len(p), len(p) // 100, replace=False)
        q[moved] += np.array([3.615 / 2, 0.0, 0.0])   # onto octahedral sites
        return q

    cur = defective(pos, 29)
    ws = mt.WignerSeitzAnalysis((pos, box))
    run = lambda: ws.compute((cur, box))  # noqa: E731
    w = run()
    print(f"    WignerSeitzAnalysis: {n // 100} atoms moved onto interstitial "
          f"sites: {w.vacancy_number} vacancies, {w.interstitial_number} "
          "interstitials")
    if not 0 < w.vacancy_number <= n // 100:
        fail(f"[S4] Wigner-Seitz: {w.vacancy_number} vacancies for "
             f"{n // 100} atoms moved")
    out["wigner_seitz"] = analysis_call(
        "[S4]", "WignerSeitzAnalysis.compute, 1 % of the atoms interstitial",
        run, lambda o: (o.occupancy,), card, 0, n * (24 + 24 + 8 + 4))
    card_against_cpu("[S4]", "Wigner-Seitz", lambda d: mt.WignerSeitzAnalysis(
        (cut, cbox), device=d).compute((defective(cut, 30), cbox)),
        lambda o: (o.occupancy,))
    return out


def analysis_phases(card: str) -> dict:
    """[S1]-[S4], after [P1]."""
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "tests"))  # _torch_system
    t0 = time.perf_counter()
    out = {}
    for name, phase in (("S1", classifier_phase), ("S2", diamond_phase),
                        ("S3", distribution_phase), ("S4", graph_phase)):
        t1 = time.perf_counter()
        out[name] = phase(card)
        torch.cuda.empty_cache()
        print(f"[{name}] {time.perf_counter() - t1:.1f} s")
    print(f"[S1-S4] {time.perf_counter() - t0:.1f} s")
    return out


# ---- the System, its files and qNEP (ROADMAP A12a, A9q), float64 --------

QNEP_CELLS = 12       # rock-salt NaCl, 12^3 conventional cells: 13,824 atoms
QNEP_A = 5.64
TOL_QNEP = 1e-10      # the card against the CPU on 64 atoms
QNEP_PEAK_MAX = 40e9
SPLINE_POINTS = 10**7
TOL_SPLINE = 1e-15
# float64 operations of one (atom, k-vector) term of the reciprocal sum:
# the phase (5), its cosine and sine (20 each), the structure-factor and
# potential sums (8), forward; the backward pass counted as twice that
OPS_RECIP_TERM = 3 * (5 + 40 + 8)
# one real-space pair within the cutoff: the distance (6), erfc (25), the
# division, the shifted terms and the charge product (8), the potential's
# row sum (3); the backward pass counted as twice the forward
OPS_REAL_PAIR = 3 * (6 + 25 + 8 + 3)


def same_column(a, b) -> bool:
    """Equal columns: floats bit for bit, integers and strings by value."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        return a.dtype == b.dtype and a.tobytes() == b.tobytes()
    if a.dtype.kind in "OUS" or b.dtype.kind in "OUS":
        return a.astype(str).tolist() == b.astype(str).tolist()
    return np.array_equal(a, b)


def io_phase(card: str, workdir: Path) -> dict:
    """[IO1] N1's block (rattled as in [S1]) written as a dump, an extended
    XYZ, a LAMMPS data file and a gzipped dump, each read back through
    ``System(filename)``."""
    from mdapy_tpu_torch import System, native
    from mdapy_tpu_torch.io import _fast_table

    pos, box, elems = fcc_system(NEIGHBOR_CELLS, rattle=0.05, seed=21)
    s = System(pos=pos, box=box, element_list=elems)
    n = s.N
    t0 = time.perf_counter()
    lib = native.load_library("table_parser")
    print(f"[IO1] {card}: {n} atoms of FCC Cu rattled by 0.05 A (seed 21), "
          f"columns {s.data.columns}; the native table parser "
          f"{lib.path.name}: g++ {lib.build_seconds:.2f} s, loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    out = {"gxx_s": lib.build_seconds, "files": {}}
    systems = {}
    for tag, name, write in (
            ("dump", "block.dump", lambda p: s.write_dump(p)),
            ("xyz", "block.xyz", lambda p: s.write_xyz(p)),
            ("data", "block.data", lambda p: s.write_data(p)),
            ("dump.gz", "block.dump.gz", lambda p: s.write_dump(p))):
        path = str(workdir / name)
        t0 = time.perf_counter()
        write(path)
        w_s = time.perf_counter() - t0
        size = Path(path).stat().st_size
        _fast_table.reset_routes()
        t0 = time.perf_counter()
        r = System(path)
        r_s = time.perf_counter() - t0
        if _fast_table.routes != {"native": 1, "numpy": 0}:
            fail(f"[IO1] {name}: parsed by {_fast_table.routes}, not once by "
                 "the native parser")
        bad = [c for c in s.data.columns
               if c not in r.data or not same_column(r.data[c], s.data[c])]
        if bad:
            fail(f"[IO1] {name}: columns {bad} differ from what was written")
        if not (np.array_equal(r.box.matrix, s.box.matrix)
                and np.array_equal(r.box.origin, s.box.origin)
                and np.array_equal(r.box.boundary, s.box.boundary)):
            fail(f"[IO1] {name}: the box differs from what was written")
        print(f"  {tag}: {size} B; write {w_s * 1e3:.1f} ms "
              f"({size / w_s / 1e6:.1f} MB/s), read {r_s * 1e3:.1f} ms "
              f"({size / r_s / 1e6:.1f} MB/s), native route; every column "
              f"and the box equal bit for bit; {card}")
        out["files"][tag] = {"bytes": size, "write_ms": w_s * 1e3,
                             "read_ms": r_s * 1e3}
        systems[tag] = r
    return out, systems["dump"], pos, box


def warm_median(fn):
    """Median host ms of 3 calls of ``fn`` whose kernels an earlier phase
    has warmed (no warm-up call), and the first call's result."""
    first, t = sync_time(fn)
    times = [t * 1e3] + [sync_time(fn)[1] * 1e3 for _ in range(2)]
    return float(np.median(times)), first


def system_phase(card: str, s, pos, box, workdir: Path) -> dict:
    """[SY1] The user's path: ``System.cal_*`` and ``build_neighbor`` on the
    System [IO1] read, against the direct calls of [S1]; then a 3-frame
    dump ``Trajectory`` of the block with CNA on each frame."""
    import mdapy_tpu_torch as mt
    from mdapy_tpu_torch.neighbor.neighbor import neighbor_search

    kw = dict(llist=(4, 6), nnn=12, wlhat=True, average=True,
              identify_liquid=True)
    out = {}
    print(f"[SY1] {card}: System.cal_* on the {s.N}-atom System read from "
          "the dump, against the classes called directly on the same "
          "positions (medians of 3, warmed by [S1])")
    for name, via_system, direct, outputs in (
            ("csp", lambda: s.cal_centro_symmetry_parameter(),
             lambda: mt.CentroSymmetryParameter(pos, box, 12).compute().csp,
             lambda o: (o,)),
            ("cna", lambda: s.cal_common_neighbor_analysis(),
             lambda: mt.CommonNeighborAnalysis(pos, box).compute().cna,
             lambda o: (o,)),
            ("aja", lambda: s.cal_ackland_jones_analysis(),
             lambda: mt.AcklandJonesAnalysis(pos, box).compute().aja,
             lambda o: (o,)),
            ("steinhardt", lambda: s.cal_steinhardt_bond_orientation(**kw),
             lambda: mt.SteinhardtBondOrientation(pos, box, **kw).compute().qnarray,
             lambda o: (o,)),
            ("build_neighbor", lambda: s.build_neighbor(rc=5.0),
             lambda: neighbor_search(pos, box, 5.0), lambda o: tuple(o))):
        sys_ms, got = warm_median(via_system)
        dir_ms, want = warm_median(direct)
        if not same_bits(outputs(got), outputs(want)):
            fail(f"[SY1] {name}: the System's result differs from the direct call")
        if name == "cna":
            cna = want
        print(f"  {name}: System {sys_ms:.3f} ms, direct {dir_ms:.3f} ms, "
              f"System overhead {sys_ms - dir_ms:+.3f} ms; equal bit for bit; "
              f"{card}")
        out[name] = {"system_ms": sys_ms, "direct_ms": dir_ms}
    for col in ("csp", "cna", "aja", "ql4", "ql6", "solidliquid"):
        if col not in s.data:
            fail(f"[SY1] the System has no column {col!r} after its cal_* calls")

    path = str(workdir / "traj.dump")
    block = s.data.select(["id", "type", "x", "y", "z", "element"])
    frames = [mt.System(data=block, box=s.box, global_info={"timestep": k})
              for k in range(3)]
    t0 = time.perf_counter()
    mt.Trajectory(systems=frames).save(path)
    w_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    traj = mt.Trajectory(path, verbose=False)
    r_s = time.perf_counter() - t0
    if len(traj) != 3 or [f.global_info["timestep"] for f in traj] != [0, 1, 2]:
        fail(f"[SY1] the trajectory read back holds {len(traj)} frames")
    t0 = time.perf_counter()
    for k, f in enumerate(traj):
        if not np.array_equal(f.cal_common_neighbor_analysis(), cna):
            fail(f"[SY1] CNA of trajectory frame {k} differs from the direct call")
    c_s = time.perf_counter() - t0
    size = Path(path).stat().st_size
    print(f"  Trajectory: 3 frames of {s.N} atoms, {size} B; save "
          f"{w_s * 1e3:.1f} ms, read {r_s * 1e3:.1f} ms "
          f"({size / r_s / 1e6:.1f} MB/s); CNA on each frame {c_s * 1e3:.1f} "
          f"ms in all, every frame's labels equal the direct call's; {card}")
    out["trajectory"] = {"bytes": size, "save_ms": w_s * 1e3,
                         "read_ms": r_s * 1e3, "cna_ms": c_s * 1e3}
    return out


def qnep_phase(card: str, outdir: Path) -> dict:
    """[Q1] qNEP on 13,824 atoms of NaCl in charge modes 1-3, and
    ``Spline.evaluate_torch`` on 10^7 points."""
    from _nep_file import rock_salt, write_nep
    import mdapy_tpu_torch as mt
    from mdapy_tpu_torch.core.device import resolve_device
    from mdapy_tpu_torch.potentials import nep as tnep

    dev = resolve_device("cuda", "[Q1]")
    pos, cell, elems = rock_salt(QNEP_CELLS, QNEP_A, seed=31)
    n = len(pos)
    keys = ("energies", "forces", "stress", "virials", "charges", "bec")
    out = {}
    for mode in (1, 2, 3):
        path = write_nep(outdir / f"NaCl_charge{mode}.txt", version=4,
                         elements=("Na", "Cl"), charge_mode=mode, seed=40 + mode)
        pot = mt.NEP(path)
        s = mt.System(pos=pos, box=cell, element_list=elems)
        run = lambda: pot.calculate(s)  # noqa: E731
        run()
        first = {k: pot.results[k].clone() for k in keys}
        times = []
        for _ in range(3):
            _, t = sync_time(run)
            times.append(t * 1e3)
            if not all(torch.equal(first[k], pot.results[k]) for k in keys):
                fail(f"[Q1] charge mode {mode}: a repeat differs from the first call")
        ms = float(np.median(times))
        res = {k: v.cpu().numpy() for k, v in first.items()}
        if not all(np.isfinite(v).all() for v in res.values()):
            fail(f"[Q1] charge mode {mode}: a result is not finite")
        if res["bec"].shape != (n, 9) or abs(float(res["charges"].sum())) > 1e-9:
            fail(f"[Q1] charge mode {mode}: BEC shape {res['bec'].shape}, "
                 f"total charge {float(res['charges'].sum())}")
        # the sums apart, inside one call (CUDA events)
        parts = {k: Recorder(getattr(tnep, k))
                 for k in ("recip_sum", "real_sum", "born_charges")}
        with swapped(tnep, **parts):
            run()
        part_ms = {k: r.total_ms() for k, r in parts.items()}
        prof = profile_call(run)
        peak = peak_of(run)
        if peak > QNEP_PEAK_MAX:
            fail(f"[Q1] charge mode {mode}: peak {peak} B over {QNEP_PEAK_MAX:.0f}")
        nvec = tnep.ewald_nvecs(cell, pot.alpha_q)
        K, chunk = len(nvec), tnep.recip_chunk(n)
        _, _, _, verlet, _ = pot._prepare_device(s)
        pos_d = torch.as_tensor(pos, device=dev)
        j = verlet.clamp(min=0).long()
        d = (pos_d[j] - pos_d[:, None]).remainder(cell[0, 0])
        d = torch.minimum(d, cell[0, 0] - d).norm(dim=-1)
        pairs = int(((verlet >= 0) & (d < pot.rc_radial)).sum())
        pairs_a = int(((verlet >= 0) & (d < pot.rc_angular)).sum())
        M = verlet.shape[1]
        del verlet, j, d, pos_d
        line = (f"[Q1] {card}: nep4_charge{mode} (Na, Cl; cutoff 8 4, n_max 4 4, "
                f"basis_size 8 8, l_max 4 2 0, 30 neurons) on {n} atoms of NaCl "
                f"(a {QNEP_A} A, {QNEP_CELLS}^3 cells, rattled 0.05 A), float64: "
                f"capacity {M}; energy {float(res['energies'].sum()):.6f} eV, "
                f"max |F| {float(np.abs(res['forces']).max()):.4f} eV/A, max "
                f"|q| {float(np.abs(res['charges']).max()):.4f} e")
        if mode in (1, 2):
            line += f"; K = {K} k-vectors in chunks of {chunk}"
        print(line)
        rec = {"ms": ms, "K": K if mode in (1, 2) else 0, "chunk": chunk,
               **{f"{k}_ms": v for k, v in part_ms.items()}}
        # the whole call: the descriptor and its two backward passes as
        # [P1] counts them, and the sums below
        ops = 3 * (pairs * OPS_NEP_RADIAL_PAIR + pairs_a * OPS_NEP_ANGULAR_PAIR
                   + n * 2 * pot.num_neurons * pot.dim)
        ops += (n * K * OPS_RECIP_TERM if mode in (1, 2) else 0)
        ops += (pairs * OPS_REAL_PAIR if mode in (1, 3) else 0)
        c_ms, c_by = f64_bound(ops, n * 32 + n * M * 4 + n * 22 * 8)
        rec["call"] = print_call("[Q1]", f"NEP.calculate (charge mode {mode})",
                                 ms, prof, c_ms, c_by, peak, card)
        bounds = []
        if mode in (1, 2):
            b, by = f64_bound(n * K * OPS_RECIP_TERM, n * (24 + 8 + 16 + 24)
                              + K * 12)
            bounds.append(("reciprocal sum", "recip_sum", b, by))
        if mode in (1, 3):
            b, by = f64_bound(pairs * OPS_REAL_PAIR, n * M * (4 + 24 + 24) + n * 24)
            bounds.append((f"real-space sum ({pairs} pairs within "
                           f"{pot.rc_radial} A)", "real_sum", b, by))
        for what, key, b, by in bounds:
            t = part_ms[key]
            print(f"    {what}: {t:.3f} ms (CUDA events); bound {b:.4f} ms by "
                  f"{by}, share {b / t * 100:.2f} %; {card}")
            rec[f"{key}_bound_ms"], rec[f"{key}_bound_by"] = b, by
        print(f"    BEC (reverse-pair row sums): {part_ms['born_charges']:.3f} "
              f"ms; every repeat equal bit for bit; peak {peak} B (< 40 GB); "
              f"{card}")
        out[f"mode{mode}"] = rec
        del pot, s
        torch.cuda.empty_cache()

        # the card against the CPU on 64 atoms (a small box: replicated)
        spos, scell, sel = rock_salt(2, QNEP_A, rattle=0.1, seed=32)
        got = []
        for device in ("cuda", "cpu"):
            p = mt.NEP(path, device=device)
            p.calculate(mt.System(pos=spos, box=scell, element_list=sel,
                                  device=device))
            got.append([p._fetch(k) for k in keys])
        err = max(float(np.abs(a - b).max()) for a, b in zip(*got))
        print(f"    card against the CPU, 64 atoms: max |diff| {err:.3e} "
              f"(energies, forces, stress, virials, charges, BEC)")
        if err > TOL_QNEP:
            fail(f"[Q1] charge mode {mode}: the card and the CPU differ by {err}")
        rec["card_cpu_err"] = err

    # Spline.evaluate_torch on 10^7 points, the card against the CPU
    x = np.linspace(0.0, 10.0, 200)
    sp = mt.Spline(x, np.sin(x) * np.exp(-0.2 * x))
    xq = torch.rand(SPLINE_POINTS, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5)) * 10.0
    errs = []
    for order in (0, 1, 2):
        xc = xq.to(dev)
        s_ms, yc = median_ms(lambda: sp.evaluate_torch(xc, order), 3)
        yh = sp.evaluate_torch(xq, order)
        rel = float((yc.cpu() - yh).abs().max() / yh.abs().max())
        if rel > TOL_SPLINE:
            fail(f"[Q1] Spline.evaluate_torch order {order}: card against CPU "
                 f"{rel}")
        errs.append(rel)
        print(f"  Spline.evaluate_torch order {order} on {SPLINE_POINTS} "
              f"points: {s_ms:.3f} ms on the card, card against the CPU "
              f"{rel:.1e} relative; {card}")
    out["spline"] = {"max_rel_err": max(errs)}
    return out


def system_phases(card: str) -> dict:
    """[IO1], [SY1] and [Q1], after [S4]; the files in a git-ignored
    directory of the checkout, removed at the end."""
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "tests"))  # _nep_file
    outdir = root / "chiprun_out" / "smoke"
    outdir.mkdir(parents=True, exist_ok=True)
    workdir = root / "mdapy_tpu_torch" / "_build" / "smoke_io"
    workdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        io, s, pos, box = io_phase(card, workdir)
        print(f"[IO1] {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        out = {"IO1": io, "SY1": system_phase(card, s, pos, box, workdir)}
        print(f"[SY1] {time.perf_counter() - t1:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del s
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["Q1"] = qnep_phase(card, outdir)
    print(f"[Q1] {time.perf_counter() - t1:.1f} s")
    print(f"[IO1-Q1] {time.perf_counter() - t0:.1f} s")
    return out


# ---- the builders and the host analyses (ROADMAP A12b, A12c) ------------

POLY_BOX, POLY_GRAINS = 230.0, 15   # bench.py:279-281
POLY_ATOMS = 1_030_194      # BENCH_r05.json, config3_atoms
HEA_CELLS = 136             # bench.py:368-371: 10,061,824 atoms
HEA_ELEMENTS = ("Co", "Ni", "Cr", "Fe", "Mn")
SK_CELLS = 20               # S(k): 32,000 atoms of CoNiCrFeMn, a 3.59 A
SK_HEA_CELLS = 63           # 1,000,188 atoms of the same HEA
VOID_CELLS = 50             # 500,000 atoms of Al, three spheres cut out
WATER_SIDE = 69             # 69^3 molecules, 985,527 atoms
MSD_FRAMES, MSD_ATOMS = 1000, 32_000
LIND_FRAMES, LIND_ATOMS = 200, 5_000
TOL_SK_DEBYE = 1e-12        # relative to the largest |S(k)|, card against CPU
TOL_SK_DIRECT = 1e-10       # trigonometry of phases up to ~10^3 rad
TOL_MSD = 1e-9              # of max |pos|^2: cuFFT against the CPU's FFT
TOL_MSD_STAT = 0.03         # direct (from frame 0) against window, relative
TOL_LIND = 1e-12            # relative
WCP_MAX = 0.02              # |alpha| of a random HEA at 1,000,188 atoms
# float64 operations of one exponential of the direct S(k) that have a
# fixed count: the phase (a 3-term dot, 5) and the two adds of its cosine
# and sine into their sums.  The cosine and sine themselves are not counted
# (their cost is a range reduction and a polynomial whose length the
# argument decides), so the bound is below the least time of the work.
OPS_EXP = 7
OPS_FFT = 2.5               # a real-input FFT's 2.5 n log2 n


def builder_phase(card: str) -> dict:
    """[BL1] ``bench.py``'s scenes built by the port: config 3's polycrystal
    (also with the overlap filter on the card), rendered once with
    ``bench_config3``'s settings, config 5's HEA, and ``orthogonal_cell``."""
    import mdapy_tpu_torch as mt
    from mdapy_tpu_torch import TachyonRender, preset_camera
    from mdapy_tpu_torch.render import megakernel

    out = {}
    print(f"[BL1] {card}: the builders at bench.py's sizes (host numpy; the "
          "overlap filter on the card)")
    unit = mt.build_crystal("Cu", "fcc", 3.615)
    t0 = time.perf_counter()
    poly = mt.CreatePolycrystal(unit, POLY_BOX, POLY_GRAINS,
                                randomseed=1).compute()
    t_poly = time.perf_counter() - t0
    if poly.N != POLY_ATOMS:
        fail(f"[BL1] the polycrystal has {poly.N} atoms, not {POLY_ATOMS}")
    print(f"  CreatePolycrystal(build_crystal('Cu', 'fcc', 3.615), 230.0, 15, "
          f"randomseed=1): {poly.N} atoms (bench.py's config 3), "
          f"{t_poly:.2f} s on the host")
    t0 = time.perf_counter()
    pc = mt.CreatePolycrystal(unit, POLY_BOX, POLY_GRAINS, randomseed=1,
                              metal_overlap_dis=2.0)
    filtered = pc.compute(verbose=False)
    t_filt = time.perf_counter() - t0
    grain = np.asarray(poly.data["grain_id"])
    types = np.asarray(poly.data["type"])
    keep_ms, keep = median_ms(
        lambda: pc._filter_overlaps(poly.pos, types, grain), 3)
    removed = poly.N - filtered.N
    v = mt.Neighbor(filtered.pos, filtered.box, 2.0).compute().verlet_list
    if removed <= 0 or int((v >= 0).sum()) != 0:
        fail(f"[BL1] the overlap filter removed {removed} atoms and left "
             f"{int((v >= 0).sum())} pairs within 2.0 A")
    print(f"  with metal_overlap_dis=2.0: {filtered.N} atoms, {removed} removed "
          f"({removed / poly.N * 100:.3f} %), no pair left within 2.0 A; "
          f"{t_filt:.2f} s in all, the filter on the card {keep_ms:.3f} ms "
          f"(median of 3, neighbor build included; {int((~keep).sum())} removed "
          f"from the wrapped build); {card}")
    out["polycrystal"] = {"atoms": poly.N, "build_s": t_poly,
                          "filtered_atoms": filtered.N, "removed": removed,
                          "filtered_build_s": t_filt, "filter_ms": keep_ms}

    pos = np.ascontiguousarray(poly.pos)
    colors = np.tile(np.array([[0.78, 0.5, 0.2, 1.0]], np.float32), (poly.N, 1))
    radii = np.full(poly.N, 1.28, np.float32)
    cam = preset_camera("perspective", pos, max_radius=1.28)
    width, height, AA, K = 1920, 1080, 2, 12
    S = AA + 1
    ren = TachyonRender(backend="cuda", ao=True, ao_samples=K, aa_samples=AA,
                        background=(1.0, 1.0, 1.0))

    def frame():
        return ren.render(pos, colors, radii, camera=cam, width=width,
                          height=height, device_output=True)

    megakernel.reset_launches()
    img, t_first = sync_time(frame)
    img, t_warm = sync_time(lambda: [frame() for _ in range(WARM_FRAMES)][-1])
    t_warm /= WARM_FRAMES
    launches = megakernel.launches
    rays = width * height * (2 * S + K)
    if launches < 1 + WARM_FRAMES or not float(img.float().std()) > 1:
        fail(f"[BL1] the config 3 frame launched the kernel {launches} times "
             "or is flat")
    print(f"  bench.py's config 3 scene (this build, not phase 4's "
          f"voronoi_polycrystal), {width}x{height} S={S} shadows + AO {K}: "
          f"first frame {t_first * 1e3:.1f} ms, warm {t_warm * 1e3:.3f} "
          f"ms/frame over {WARM_FRAMES} frames, {rays / t_warm / 1e9:.4f} "
          f"Grays/s by the rays traced W*H*(2S+K), {launches} kernel "
          f"launches; {card}")
    out["config3_frame"] = {"first_ms": t_first * 1e3, "warm_ms": t_warm * 1e3,
                            "grays_per_s": rays / t_warm / 1e9,
                            "launches": launches}
    del ren, img, poly, filtered, pc
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    hea = mt.build_hea(HEA_ELEMENTS, (0.2,) * 5, "fcc", 3.59, nx=HEA_CELLS,
                       ny=HEA_CELLS, nz=HEA_CELLS, random_seed=1)
    t_hea = time.perf_counter() - t0
    n = hea.N
    want = np.floor(n * np.full(5, 0.2)).astype(int)
    want[-1] = n - want[:-1].sum()
    elems = np.asarray(hea.data["element"]).astype(str)
    got = np.array([int((elems == e).sum()) for e in HEA_ELEMENTS])
    if n != 4 * HEA_CELLS ** 3 or not np.array_equal(got, want) or not \
            np.array_equal(np.asarray(hea.data["type"]), _type_of(elems)):
        fail(f"[BL1] the HEA has {n} atoms and counts {got.tolist()}")
    print(f"  build_hea({HEA_ELEMENTS}, 0.2 each, 'fcc', 3.59, "
          f"{HEA_CELLS}^3 cells, random_seed=1): {n} atoms (bench.py's config "
          f"5), counts {dict(zip(HEA_ELEMENTS, got.tolist()))} as the floor "
          f"rule gives them, {t_hea:.2f} s on the host")
    out["hea"] = {"atoms": n, "build_s": t_hea, "counts": got.tolist()}
    del hea, elems

    t0 = time.perf_counter()
    hcp = mt.build_crystal("Co", "hcp", 2.507, miller1=(1, 0, -1, 0),
                           miller2=(1, 1, -2, 0), miller3=(0, 0, 0, 1),
                           c=4.07, nx=4, ny=4, nz=4)
    ortho = mt.orthogonal_cell(hcp)
    t_ortho = time.perf_counter() - t0
    m = ortho.box.matrix
    dens = (hcp.N / abs(np.linalg.det(hcp.box.matrix)),
            ortho.N / abs(np.linalg.det(m)))
    if np.abs(m - np.diag(np.diag(m))).max() > 1e-9 or \
            abs(dens[0] - dens[1]) > 1e-9 * dens[0]:
        fail(f"[BL1] orthogonal_cell gave the box {m.tolist()}")
    print(f"  orthogonal_cell of a Miller-oriented HCP Co build "
          f"({hcp.N} atoms, triclinic {hcp.box.triclinic}): {ortho.N} atoms, "
          f"box diagonal {np.diag(m).round(6).tolist()}, the density kept; "
          f"{t_ortho:.3f} s on the host")
    out["orthogonal_cell"] = {"atoms_in": hcp.N, "atoms_out": ortho.N,
                              "s": t_ortho}
    return out


def _type_of(elems):
    """1-based index of each element in HEA_ELEMENTS."""
    lut = {e: i + 1 for i, e in enumerate(HEA_ELEMENTS)}
    uniq, inv = np.unique(elems, return_inverse=True)
    return np.array([lut[e] for e in uniq], np.int32)[inv]


def _maxwell(n: int, mass: float, temp: float, seed: int) -> np.ndarray:
    """Maxwell velocities in A/fs at ``temp`` K, the net momentum removed."""
    kb, amu = 1.380649e-23, 1.0 / 6.022140857e23 / 1000.0
    sigma = np.sqrt(kb * temp / (mass * amu)) * 1e-5
    vel = np.random.default_rng(seed).normal(0.0, sigma, (n, 3))
    return vel - vel.mean(axis=0)


def _rattled(pos, seed: int, sigma: float = 0.05):
    return pos + np.random.default_rng(seed).normal(0.0, sigma, pos.shape)


def structure_factor_phase(card: str) -> dict:
    """[S5] S(k): Debye at its defaults and direct with partials on 32,000
    atoms of CoNiCrFeMn; Debye at rc 6 on 1,000,188 atoms."""
    import mdapy_tpu_torch as mt

    out = {}
    hea = mt.build_hea(HEA_ELEMENTS, (0.2,) * 5, "fcc", 3.59, nx=SK_CELLS,
                       ny=SK_CELLS, nz=SK_CELLS, random_seed=1)
    pos, box = hea.pos, hea.box
    el = np.asarray(hea.data["element"]).astype(str)
    n = hea.N
    cut = mt.build_hea(HEA_ELEMENTS, (0.2,) * 5, "fcc", 3.59, nx=10, ny=10,
                       nz=10, random_seed=2, device="cpu")
    cpos, cel = _rattled(cut.pos, 22), np.asarray(cut.data["element"]).astype(str)

    def sk_out(o):
        return (o.Sk,) + tuple(o.Sk_partial[k] for k in sorted(o.Sk_partial))

    print(f"[S5] {card}: S(k) on {n} atoms of CoNiCrFeMn (a 3.59 A, seed 1), "
          "float64")
    run = lambda: mt.StructureFactor(pos, box, cal_partial=True,  # noqa: E731
                                     elements=el).compute()
    s = run()
    L = float(box.matrix[0, 0])
    totals = [getattr(s, f"get_{k}_structure_factor")() for k in
              ("xray", "neutron", "electron")]
    if len(s.Sk_partial) != 15 or not all(np.isfinite(x).all() for x in
                                          [s.Sk] + totals):
        fail(f"[S5] Debye S(k): {len(s.Sk_partial)} partials, or not finite")
    print(f"    Debye, rc = L/2 = {L / 2:.3f} A (the RDF's streaming route), "
          f"{len(s.Sk_partial)} partials; S(k) at k = 3.0: "
          f"{float(np.interp(3.0, s.k, s.Sk)):.6f}; X-ray, neutron and "
          f"electron totals finite")
    pairs = n * (n - 1) // 2
    out["debye"] = analysis_call(
        "[S5]", "StructureFactor(debye, cal_partial=True), rc = L/2", run,
        sk_out, card, pairs * OPS_PAIR, n * 24, warm=s, reps=1, profile=False)
    card_against_cpu("[S5]", "Debye S(k) and its partials, 4,000 atoms",
                         lambda d: mt.StructureFactor(cpos, cut.box,
                                                      cal_partial=True,
                                                      elements=cel,
                                                      device=d).compute(),
                         sk_out, TOL_SK_DEBYE)
    # the perfect lattice at rc = L/2 puts pair distances exactly at rc and
    # on bin edges: the card and the CPU sum each squared norm in one
    # written order, so each pair falls on the same side on both (the JAX
    # package's fused sum may put it on the other, C15)
    card_against_cpu("[S5]", "Debye S(k) and its partials at rc = L/2 on the "
                     "perfect 4,000-atom lattice (C15)",
                     lambda d: mt.StructureFactor(cut.pos, cut.box,
                                                  cal_partial=True,
                                                  elements=cel,
                                                  device=d).compute(),
                     sk_out, TOL_SK_DEBYE)

    run = lambda: mt.StructureFactor(pos, box, cal_partial=True,  # noqa: E731
                                     elements=el, mode="direct").compute()
    s = run()
    nk = s.k_point_number
    exps = nk * n
    b_ms, by = f64_bound(exps * OPS_EXP, nk * 24 + n * 24)
    if len(s.Sk_partial) != 15 or not np.isfinite(s.Sk).any():
        fail("[S5] direct S(k) is wrong")
    print(f"    direct, k in ({s.k_min}, {s.k_max}]: {nk} k-points in chunks "
          f"of {s.chunk_rows}, {exps:.4e} complex exponentials (cos and sin); "
          f"the float64 bound of their phases and sums (cos and sin not "
          f"counted) {b_ms:.3f} ms by {by}")
    out["direct"] = analysis_call(
        "[S5]", f"StructureFactor(direct, cal_partial=True), {nk} k-points",
        run, sk_out, card, exps * OPS_EXP, nk * 24 + n * 24, warm=s)
    out["direct"].update(k_points=nk, chunk_rows=s.chunk_rows,
                         exponentials=exps)
    card_against_cpu("[S5]", "direct S(k) and its partials, 4,000 atoms, "
                         "k_max 6", lambda d: mt.StructureFactor(
                             cpos, cut.box, cal_partial=True, elements=cel,
                             mode="direct", k_max=6.0, device=d).compute(),
                         sk_out, TOL_SK_DIRECT)
    del s
    torch.cuda.empty_cache()

    big = mt.build_hea(HEA_ELEMENTS, (0.2,) * 5, "fcc", 3.59, nx=SK_HEA_CELLS,
                       ny=SK_HEA_CELLS, nz=SK_HEA_CELLS, random_seed=1)
    bpos, bel, nb = (big.pos, np.asarray(big.data["element"]).astype(str),
                     big.N)
    run = lambda: mt.StructureFactor(bpos, big.box, rc=6.0,  # noqa: E731
                                     elements=bel).compute()
    s = run()
    if not np.isfinite(s.Sk).all():
        fail("[S5] Debye S(k) at rc 6 is not finite")
    out["debye_1m"] = analysis_call(
        "[S5]", f"StructureFactor(debye, rc 6) on {nb} atoms (neighbor route)",
        run, lambda o: (o.Sk,), card, nb * 78 // 2 * OPS_PAIR,
        nb * (24 + 78 * 12),
        warm=s)
    return out, big


def hea_phase(card: str, big) -> dict:
    """[S5] Warren-Cowley on the 1,000,188-atom HEA at rc 3.0."""
    import mdapy_tpu_torch as mt
    from mdapy_tpu_torch.neighbor.neighbor import neighbor_search

    out = {}
    el = np.asarray(big.data["element"]).astype(str)
    types = np.asarray(big.data["type"])
    v, d, nn = neighbor_search(big.pos, big.box, 3.0)
    run = lambda: mt.WarrenCowleyParameter(types, v, nn,  # noqa: E731
                                           elements=el).compute()
    w = run()
    cpu = mt.WarrenCowleyParameter(types, v, nn, elements=el,
                                   device="cpu").compute()
    if w.WCP.tobytes() != cpu.WCP.tobytes():
        fail("[S5] Warren-Cowley: the card's matrix differs from the CPU's")
    if not np.abs(w.WCP).max() < WCP_MAX:
        fail(f"[S5] Warren-Cowley of a random HEA: max |alpha| "
             f"{np.abs(w.WCP).max()}")
    print(f"    WarrenCowleyParameter on {big.N} atoms at rc 3.0 "
          f"({int((v >= 0).sum())} pairs): max |alpha| "
          f"{np.abs(w.WCP).max():.5f}; equal bit for bit to the CPU's count "
          "of the same list")
    out["warren_cowley"] = analysis_call(
        "[S5]", "WarrenCowleyParameter (integer pair counts), rc 3.0", run,
        lambda o: (o.WCP,), card, 0, v.size * 4 + big.N * 8, warm=w)
    return out


def temperature_phase(card: str) -> dict:
    """[S5] Atomic temperature and spatial binning on N1's block."""
    import mdapy_tpu_torch as mt
    from mdapy_tpu_torch.core.elements import atomic_masses, atomic_numbers
    from mdapy_tpu_torch.neighbor.neighbor import neighbor_tensors

    out = {}
    pos, box, _ = fcc_system(NEIGHBOR_CELLS)
    n = len(pos)
    mass = float(atomic_masses[atomic_numbers["Cu"]])
    vel = _maxwell(n, mass, 300.0, 31)
    s = mt.System(pos=pos, box=box, element_list=np.full(n, "Cu", object))
    s.update_data(s.data.with_columns(vx=vel[:, 0], vy=vel[:, 1], vz=vel[:, 2]))
    temp = s.cal_atomic_temperature(5.0)
    mean_t = float(temp.mean())
    if not abs(mean_t - 300.0) / 300.0 < 0.05 or not (temp > 0).all():
        fail(f"[S5] atomic temperature: mean {mean_t} K for 300 K")
    verlet, dist, cnt = neighbor_tensors(pos, box, 5.0)
    amass = np.full(n, mass)
    run = lambda: mt.AtomicTemperature(amass, vel * 1e3, verlet,  # noqa: E731
                                       cnt).compute()
    if not same_bits((run().T,), (temp,)):
        fail("[S5] atomic temperature: the System's column differs from the "
             "direct call")
    M = verlet.shape[1]
    print(f"    AtomicTemperature on {n} atoms (Maxwell 300 K, seed 31, no net "
          f"momentum), rc 5, {M} columns: mean {mean_t:.3f} K; "
          "System.cal_atomic_temperature equal bit for bit")
    out["atomic_temperature"] = analysis_call(
        "[S5]", "AtomicTemperature, rc 5", run, lambda o: (o.T,), card,
        n * M * 40, n * (M * 4 + 32))
    cut, cbox, _ = fcc_system(CUT_CELLS, rattle=0.05, seed=32)
    cvel = _maxwell(len(cut), mass, 300.0, 33)

    def cut_temp(d):
        v, _, c = neighbor_tensors(cut, cbox, 5.0, device=d)
        return mt.AtomicTemperature(np.full(len(cut), mass), cvel * 1e3, v, c,
                                    device=d).compute()

    card_against_cpu("[S5]", "atomic temperature", cut_temp, lambda o: (o.T,))
    del verlet, dist, cnt

    data = s.data
    ops = ["mean", "sum", "count", "min", "max", "sum/binvol"]
    run = lambda: mt.SpatialBinning(data, box, "xyz", 5.0).compute(  # noqa: E731
        ["atomic_temp"] * 6, ops)
    b = run()
    res = b.result
    if int(res["atomic_temp_count"].sum()) != n or not np.allclose(
            res["atomic_temp_sum"].sum(), temp.sum(), rtol=1e-12):
        fail("[S5] spatial binning lost atoms or temperature")
    print(f"    SpatialBinning 'xyz' at 5 A: {res['atomic_temp_count'].size} "
          f"bins, every operation ({', '.join(ops)})")
    out["spatial_binning"] = analysis_call(
        "[S5]", "SpatialBinning('xyz', 5 A), 6 operations", run,
        lambda o: tuple(o.result[f"atomic_temp_{k}"] for k in ops), card, 0,
        n * (24 + 8) + res["atomic_temp_count"].size * 8 * 6, warm=b)
    card_against_cpu("[S5]", "spatial binning", lambda d: mt.SpatialBinning(
        {"x": cut[:, 0], "y": cut[:, 1], "z": cut[:, 2],
         "t": np.linspace(0.0, 1.0, len(cut))}, cbox, "xyz", 5.0,
        device=d).compute(["t"] * 6, ops),
        lambda o: tuple(o.result[f"t_{k}"] for k in ops))
    return out


def _holes(pkg_build, cells: int, spheres, device="cuda"):
    """An Al block with spherical holes: ((x, y, z), r^2) each."""
    fcc = pkg_build("Al", "fcc", 4.05, nx=cells, ny=cells, nz=cells,
                    device=device)
    p = fcc.pos
    keep = np.ones(len(p), bool)
    for c, r2 in spheres:
        keep &= ((p - np.array(c)) ** 2).sum(axis=1) > r2
    fcc.update_data(fcc.data.filter(keep))
    return fcc


def void_species_phase(card: str) -> dict:
    """[S5] Voids in a 500,000-atom Al block; chemical species of a water
    box of 69^3 molecules."""
    import mdapy_tpu_torch as mt
    from _water_box import water_box

    out = {}
    spheres = (((50, 50, 50), 100), ((100, 100, 100), 100),
               ((150, 150, 150), 400))      # tests/test_misc_fixtures.py:177-191
    block = _holes(mt.build_crystal, VOID_CELLS, spheres)
    run = lambda: mt.VoidAnalysis(block, 4.1).compute()  # noqa: E731
    v = run()
    if v.void_number != 3:
        fail(f"[S5] voids: {v.void_number} found, not 3")
    print(f"    VoidAnalysis on {block.N} atoms of Al, three spheres cut out, "
          f"rc 4.1: {v.void_number} voids, volume {v.void_volume:.1f} A^3, "
          f"{len(v.void_labels)} empty cells")
    out["void"] = analysis_call(
        "[S5]", "VoidAnalysis(rc 4.1)", run,
        lambda o: (o.void_labels, np.array([o.void_volume])), card, 0,
        block.N * 24, warm=v)
    card_against_cpu("[S5]", "void labels", lambda d: mt.VoidAnalysis(
        _holes(mt.build_crystal, 10, (((10, 10, 10), 36), ((30, 30, 30), 30)),
               device=d), 4.1, device=d).compute(),
        lambda o: (o.void_labels,))

    wpos, wel, wl = water_box(WATER_SIDE, 3.1, 34)
    water = mt.System(pos=wpos, box=np.eye(3) * wl, element_list=wel)
    t0 = time.perf_counter()
    res = water.cal_chemical_species(["H2O"], scale=0.4, add_mol_id=True)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    mol_id = np.asarray(water.data["mol_id"])
    if res != {"H2O": WATER_SIDE ** 3} or not (mol_id == 0).all():
        fail(f"[S5] chemical species of the water box: {res}")
    print(f"    cal_chemical_species(['H2O'], scale=0.4, add_mol_id=True) on "
          f"{water.N} atoms of water: {res}, every mol_id 0; first call "
          f"{t_cold * 1e3:.1f} ms (its neighbor build included)")

    def species():
        r = water.cal_chemical_species(["H2O"], scale=0.4, add_mol_id=True)
        if r != res:
            fail(f"[S5] a repeat of the species count gave {r}")
        return water

    M = water.verlet_list.shape[1]
    out["chemical_species"] = analysis_call(
        "[S5]", "System.cal_chemical_species (the list cached), "
        f"{WATER_SIDE ** 3:,} molecules", species, lambda o: (np.asarray(o.data["mol_id"]),), card,
        0, water.N * (M * 12 + 16))
    out["chemical_species"]["first_call_ms"] = t_cold * 1e3

    def small_water(d):
        p, e, side = water_box(11, 3.1, 35)
        keep = np.setdiff1d(np.arange(len(p)), [5, 8, 30])
        s = mt.System(pos=p[keep], box=np.eye(3) * side, element_list=e[keep],
                      device=d)
        s.result = s.cal_chemical_species(scale=0.4)
        s.result_mid = s.cal_chemical_species(["H2O", "HO"], scale=0.4,
                                              add_mol_id=True)
        return s

    a, b = small_water("cuda"), small_water("cpu")
    if list(a.result.items()) != list(b.result.items()) or \
            a.result_mid != b.result_mid or \
            not np.array_equal(a.data["mol_id"], b.data["mol_id"]):
        fail("[S5] chemical species: the card differs from the CPU")
    print(f"    card against the CPU (3,990 atoms of water with fragments): "
          f"{a.result} and mol_id equal")
    return out


def trajectory_phase(card: str) -> dict:
    """[S5] MSD (1,000 frames x 32,000 atoms) and Lindemann (200 x 5,000)."""
    import mdapy_tpu_torch as mt

    out = {}
    rng = np.random.default_rng(36)
    walk = rng.random((1, MSD_ATOMS, 3)) * 50.0 + np.cumsum(
        rng.normal(0.0, 0.1, (MSD_FRAMES, MSD_ATOMS, 3)), axis=0)
    scale = float(np.abs(walk).max()) ** 2
    nfft = 1 << (2 * MSD_FRAMES - 1).bit_length()
    run = lambda: mt.MeanSquaredDisplacement(walk, "window").compute()  # noqa: E731
    w = run()
    err = 0.0
    wt = torch.as_tensor(walk, device=w.device)
    lags = (1, 10, MSD_FRAMES // 10, MSD_FRAMES - 1)
    for lag in lags:
        ref = ((wt[lag:] - wt[:-lag]) ** 2).sum(dim=2).mean(dim=0).cpu().numpy()
        err = max(err, float(np.abs(w.particle_msd[lag] - ref).max()) / scale)
    del wt
    if err > TOL_MSD:
        fail(f"[S5] MSD window mode against the mean over origins: {err:.3e}")
    d = mt.MeanSquaredDisplacement(walk, "direct").compute()
    stat = float(np.abs(d.msd[1:] - w.msd[1:]).max() / w.msd[1:].max())
    rel = float(np.max(np.abs(d.msd[1:] - w.msd[1:]) / w.msd[1:]))
    if rel > TOL_MSD_STAT:
        fail(f"[S5] MSD direct against window: {rel:.3e} relative")
    print(f"    MeanSquaredDisplacement, {MSD_FRAMES} frames x {MSD_ATOMS} atoms "
          f"(a random walk, seed 36): window equal to the mean over all origins "
          f"at lags {lags} within {err:.3e} of max |pos|^2 "
          f"(limit {TOL_MSD:g}); direct (from frame 0) against window within "
          f"{rel:.4f} relative at every lag (statistics, limit {TOL_MSD_STAT}), "
          f"{stat:.3e} of the largest")
    series = MSD_ATOMS * 3
    out["msd_window"] = analysis_call(
        "[S5]", f"MeanSquaredDisplacement(window), FFT length {nfft}", run,
        lambda o: (o.particle_msd,), card,
        series * 2 * OPS_FFT * nfft * math.log2(nfft),
        walk.nbytes + MSD_FRAMES * MSD_ATOMS * 8, warm=w)
    out["msd_direct"] = analysis_call(
        "[S5]", "MeanSquaredDisplacement(direct)",
        lambda: mt.MeanSquaredDisplacement(walk, "direct").compute(),
        lambda o: (o.particle_msd,), card, walk.size * 3,
        walk.nbytes + MSD_FRAMES * MSD_ATOMS * 8)
    cut = walk[:100, :500]
    card_against_cpu("[S5]", "MSD window, 100 frames x 500 atoms",
                         lambda dv: mt.MeanSquaredDisplacement(
                             cut, "window", device=dv).compute(),
                         lambda o: (o.particle_msd,), TOL_MSD,
                         float(np.abs(cut).max()) ** 2)
    del walk, w, d

    lind = rng.random((1, LIND_ATOMS, 3)) * 40.0 + rng.normal(
        0.0, 0.2, (LIND_FRAMES, LIND_ATOMS, 3))
    g = mt.LindemannParameter(lind, only_global=True).compute()
    a = mt.LindemannParameter(lind).compute()
    if abs(g.lindemann_trj - a.lindemann_trj) > TOL_LIND * a.lindemann_trj:
        fail(f"[S5] Lindemann: only_global {g.lindemann_trj} against per atom "
             f"{a.lindemann_trj}")
    print(f"    LindemannParameter, {LIND_FRAMES} frames x {LIND_ATOMS} atoms: "
          f"lindemann_trj {a.lindemann_trj:.9f}, only_global and per atom "
          f"within {abs(g.lindemann_trj - a.lindemann_trj):.3e}")
    pairs = LIND_FRAMES * LIND_ATOMS * LIND_ATOMS
    for key, og in (("lindemann_global", True), ("lindemann_atom", False)):
        out[key] = analysis_call(
            "[S5]", f"LindemannParameter(only_global={og})",
            lambda og=og: mt.LindemannParameter(lind, only_global=og).compute(),
            lambda o: (o.lindemann_frame,) + (() if o.lindemann_atom is None
                                              else (o.lindemann_atom,)),
            card, pairs * 25, lind.nbytes)
    card_against_cpu("[S5]", "Lindemann, 50 frames x 400 atoms",
                         lambda dv: mt.LindemannParameter(
                             lind[:50, :400], device=dv).compute(),
                         lambda o: (o.lindemann_frame, o.lindemann_atom),
                         TOL_LIND)
    return out


def host_analysis_phases(card: str) -> dict:
    """[BL1] and [S5], after [Q1]."""
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "tests"))  # _water_box
    t0 = time.perf_counter()
    out = {"BL1": builder_phase(card)}
    torch.cuda.empty_cache()
    print(f"[BL1] {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    sk, big = structure_factor_phase(card)
    out["S5"] = sk
    out["S5"].update(hea_phase(card, big))
    del big
    torch.cuda.empty_cache()
    for phase in (temperature_phase, void_species_phase, trajectory_phase):
        out["S5"].update(phase(card))
        torch.cuda.empty_cache()
    print(f"[S5] {time.perf_counter() - t1:.1f} s")
    print(f"[BL1-S5] {time.perf_counter() - t0:.1f} s")
    return out


# ---- the native engines and the tool functions (ROADMAP A12d, A12e) -----

NATIVE_RATTLE = 0.05        # A, [N1]'s block as [S6], [V1] and [U1] take it
PTM_CUT_CELLS = 20          # 32,000 atoms: PTM on the card against the CPU
PTM_FCC_SHARE = 0.99        # of the rattled block, at least
STACK_SIDE, STACK_LAYERS = 100, 100   # 10,000 atoms a layer, 1,000,000
SQS_CELLS, SQS_STEPS, SQS_REPLICAS = 6, 10**6, 8
VELOCITY_ATOMS = 10**6
TOL_VORONOI_SUM = 1e-9      # relative, the cells' volumes against the box's
TOL_COM = 1e-12             # A/fs, the centre of mass after set_pka


def event_call(fn):
    """One call of ``fn`` between two CUDA events: (its result, ms)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    out = fn()
    ev[1].record()
    ev[1].synchronize()
    return out, ev[0].elapsed_time(ev[1])


def ptm_phase(card: str) -> dict:
    """[S6] PTM: the default structures on the rattled [N1] block, "all" on
    [S2]'s diamond, the planar faults on a 1,000,000-atom fault stack, and
    the card against the CPU on a 32,000-atom cut."""
    import mdapy_tpu_torch as mt
    from mdapy_tpu_torch.analysis import ptm as tptm
    from mdapy_tpu_torch.core.box import Box
    from mdapy_tpu_torch.neighbor.knn import knn_tensors
    from mdapy_tpu_torch.neighbor.neighbor import replicate_for_small_box
    from _fault_stack import fault_stack

    out = {}
    threads = tptm.engine_threads()
    t0 = time.perf_counter()
    tptm._get_engine()
    print(f"[S6] {card}: PTM (the kNN on the card, the matching in the host "
          f"engine on {threads} OpenMP threads); engine build and template "
          f"bootstrap {time.perf_counter() - t0:.2f} s")
    pos, box, _ = fcc_system(NEIGHBOR_CELLS, rattle=NATIVE_RATTLE, seed=61)
    n = len(pos)
    ptm = mt.PolyhedralTemplateMatching("fcc-hcp-bcc", pos, box)
    pos_r, box_r, n_img = replicate_for_small_box(pos, box, tptm.REPLICATE_RC)
    knn = lambda: knn_tensors(pos_r, box_r, tptm.K_NEIGHBORS)  # noqa: E731
    knn()                                       # warm-up
    (idx_d, _), knn_ms = event_call(knn)
    idx, copy_ms = event_call(lambda: idx_d.cpu().numpy().astype(np.int64))
    del idx_d
    (first, atoms), match_s = sync_time(lambda: ptm.match(pos_r, box_r, idx))
    types = first[:, 0].astype(int)
    share = float((types == 1).mean())
    counts = np.bincount(types, minlength=4)[:4].tolist()
    if n_img != 1 or share < PTM_FCC_SHARE:
        fail(f"[S6] PTM: {share * 100:.3f} % of the rattled block FCC "
             f"(counts Other/FCC/HCP/BCC {counts})")
    print(f"  default structures on {n} atoms of FCC Cu rattled "
          f"{NATIVE_RATTLE} A (seed 61): {share * 100:.4f} % FCC, counts "
          f"Other/FCC/HCP/BCC {counts}; kNN (k 18) on the card {knn_ms:.3f} ms "
          f"(CUDA events, after a warm-up call), indices to the host {copy_ms:.3f} ms, displacements "
          f"+ host engine {match_s:.3f} s on {threads} threads; {card}")
    out["default"] = {"atoms": n, "fcc_share": share, "knn_ms": knn_ms,
                      "copy_ms": copy_ms, "match_s": match_s,
                      "threads": threads}
    del first, atoms, idx, ptm

    dia = diamond_positions(DIAMOND_CELLS, 5.431)
    dbox = Box(np.eye(3) * DIAMOND_CELLS * 5.431)
    res, dia_s = sync_time(lambda: mt.PolyhedralTemplateMatching(
        "all", dia, dbox).compute())
    if not (res.output[:, 0] == 6).all():
        fail(f"[S6] PTM 'all': {int((res.output[:, 0] != 6).sum())} diamond "
             "atoms are not cubic diamond")
    print(f"  structure='all' on {len(dia)} atoms of cubic diamond ([S2]'s, a 5.431 A): "
          f"every atom DCUB (6); {dia_s:.3f} s; {card}")
    out["all_diamond"] = {"atoms": len(dia), "s": dia_s}
    del res, dia

    spos, sm, sb, layer, expect = fault_stack(STACK_SIDE, STACK_LAYERS)
    stack = mt.System(pos=spos, box=sm, boundary=sb)
    _, stack_s = sync_time(lambda: stack.cal_polyhedral_template_matching(
        identify_fcc_planar_faults=True))
    pft = np.asarray(stack.data["pft"])
    for k, code in enumerate(expect):
        if code >= 0 and set(pft[layer == k].tolist()) != {code}:
            fail(f"[S6] planar faults: layer {k} holds codes "
                 f"{sorted(set(pft[layer == k].tolist()))}, not {code}")
    faults = {int(k): int(c) for k, c in enumerate(expect) if c > 0}
    print(f"  identify_fcc_planar_faults on a {len(spos)}-atom close-packed "
          f"stack ({STACK_SIDE ** 2} atoms a layer, {STACK_LAYERS} layers, "
          f"tests/_fault_stack.py): every inner layer its known code "
          f"(layer: code {faults}; ISF 2, twin 3, ESF 5); {stack_s:.3f} s; {card}")
    out["faults"] = {"atoms": len(spos), "s": stack_s, "layers": faults}
    del stack, spos, pft

    cut, cbox, _ = fcc_system(PTM_CUT_CELLS, rattle=NATIVE_RATTLE, seed=62)
    got = mt.PolyhedralTemplateMatching("all", cut, cbox).compute()
    want = mt.PolyhedralTemplateMatching("all", cut, cbox,
                                         device="cpu").compute()
    err = float(np.abs(got.output[:, 2:] - want.output[:, 2:]).max())
    if not (np.array_equal(got.output[:, :2], want.output[:, :2])
            and np.array_equal(got.ptm_indices, want.ptm_indices)) \
            or err > TOL_CARD_CPU:
        fail(f"[S6] PTM: the card and the CPU differ on {len(cut)} atoms "
             f"(floats by {err})")
    print(f"    card against the CPU ({len(cut)} atoms rattled, 'all'): types "
          f"and indices equal, floats within {err:.3e}")
    out["card_cpu_err"] = err
    return out


def voronoi_phase(card: str) -> dict:
    """[V1] Voronoi volumes, neighbors and Steinhardt's use_voronoi on the
    rattled [N1] block."""
    import mdapy_tpu_torch as mt

    out = {}
    pos, box, _ = fcc_system(NEIGHBOR_CELLS, rattle=NATIVE_RATTLE, seed=61)
    n = len(pos)
    s = mt.System(pos=pos, box=box, element_list=np.full(n, "Cu", object))

    def volumes():
        s.cal_voronoi_volume()
        return tuple(np.asarray(s.data[c]).copy()
                     for c in ("volume", "neighbor_number", "cavity_radius"))

    first, vol_s = sync_time(volumes)
    rel = abs(float(first[0].sum()) / box.volume - 1.0)
    if rel > TOL_VORONOI_SUM:
        fail(f"[V1] Voronoi volumes: sum off the box by {rel:.3e} relative")
    print(f"[V1] {card}: Voronoi on {n} atoms of FCC Cu rattled "
          f"{NATIVE_RATTLE} A (the native engine on the host)")
    print(f"  cal_voronoi_volume: {vol_s:.3f} s; volumes sum to the box within "
          f"{rel:.3e} relative; faces {int(first[1].min())}-{int(first[1].max())}")
    out["volume"] = {"s": vol_s, "sum_rel": rel}

    def lists():
        s.build_voronoi_neighbor()
        return (s.voro_verlet_list.copy(), s.voro_distance_list.copy(),
                s.voro_face_area.copy(), s.voro_neighbor_number.copy())

    first, nb_s = sync_time(lists)
    if not np.array_equal(first[3], np.asarray(s.data["neighbor_number"])):
        fail("[V1] build_voronoi_neighbor: its counts are not the cells' faces")
    print(f"  build_voronoi_neighbor (rows compacted on the card): {nb_s:.3f} s; "
          f"{first[0].shape[1]} columns; {card}")
    out["neighbors"] = {"s": nb_s, "cols": first[0].shape[1]}
    del first

    def stein():
        return mt.SteinhardtBondOrientation(pos, box, llist=(4, 6),
                                            use_voronoi=True,
                                            use_weight=True).compute().qnarray

    q, q_s = sync_time(stein)
    if not np.isfinite(q).all():
        fail("[V1] Steinhardt use_voronoi: a value is not finite")
    print(f"  SteinhardtBondOrientation(use_voronoi=True, use_weight=True), l 4 "
          f"and 6: {q_s:.3f} s; mean q6 {float(q[:, 1].mean()):.6f}; {card}")
    out["steinhardt"] = {"s": q_s}
    cut, cbox, _ = fcc_system(CUT_CELLS, rattle=NATIVE_RATTLE, seed=63)
    card_against_cpu("[V1]", "Voronoi-weighted Steinhardt", lambda d:
                     mt.SteinhardtBondOrientation(cut, cbox, use_voronoi=True,
                                                  use_weight=True,
                                                  device=d).compute(),
                     lambda o: (o.qnarray,))
    return out


def sqs_phase(card: str) -> dict:
    """[Q2] SQS on 864 atoms of equimolar CoNiCrFeMn, 10^6 Monte Carlo
    steps in 8 replicas, twice."""
    import mdapy_tpu_torch as mt

    hea = mt.build_hea(HEA_ELEMENTS, (0.2,) * 5, "fcc", 3.55, nx=SQS_CELLS,
                       ny=SQS_CELLS, nz=SQS_CELLS, random_seed=1)
    kw = dict(cutoffs={2: 4.0}, n_replicas=SQS_REPLICAS, max_steps=SQS_STEPS,
              seed=1)
    base = mt.SQS(hea, **dict(kw, max_steps=0)).compute()
    first, sqs_s = sync_time(lambda: mt.SQS(hea, **kw).compute())
    again, again_s = sync_time(lambda: mt.SQS(hea, **kw).compute())
    same = (np.array_equal(first._best_types, again._best_types)
            and first.objective == again.objective
            and first.correlations.tobytes() == again.correlations.tobytes())
    if not same or not first.objective < base.objective:
        fail(f"[Q2] SQS: a rerun with the same seed differs, or the objective "
             f"{first.objective} did not fall below {base.objective}")
    counts = np.bincount(first._best_types, minlength=5).tolist()
    print(f"[Q2] {card}: SQS of {hea.N} atoms of CoNiCrFeMn (FCC 3.55 A, "
          f"{SQS_CELLS}^3 cells), cutoffs {{2: 4.0}} ({len(first.channel_info)} "
          f"channels), {SQS_REPLICAS} replicas x {SQS_STEPS} steps: "
          f"{sqs_s:.3f} s on the host (again {again_s:.3f} s, equal); "
          f"objective {base.objective:.6f} -> {first.objective:.6f}; "
          f"counts {counts}")
    return {"atoms": hea.N, "s": sqs_s, "again_s": again_s,
            "objective": first.objective, "objective_start": base.objective}


def tool_phase(card: str) -> dict:
    """[U1] set_pka and average_by_neighbor on the rattled [N1] block,
    generate_velocity on 10^6 atoms."""
    import mdapy_tpu_torch as mt
    from mdapy_tpu_torch.core.elements import atomic_masses, atomic_numbers
    from mdapy_tpu_torch.utils.tool_function import average_by_neighbor

    out = {}
    pos, box, _ = fcc_system(NEIGHBOR_CELLS, rattle=NATIVE_RATTLE, seed=61)
    n = len(pos)
    mass = float(atomic_masses[atomic_numbers["Cu"]])
    vel = _maxwell(n, mass, 300.0, 64)
    s = mt.System(pos=pos, box=box, element_list=np.full(n, "Cu", object))
    s.update_data(s.data.with_columns(vx=vel[:, 0], vy=vel[:, 1], vz=vel[:, 2]))
    _, pka_s = sync_time(lambda: s.set_pka(1000.0, np.array([1.0, 1.0, 1.0])))
    v = np.column_stack([np.asarray(s.data[c]) for c in ("vx", "vy", "vz")])
    com = float(np.abs(v.mean(axis=0)).max())
    moved = int((np.abs(v - vel).max(axis=1) > 1e-3).sum())
    if com > TOL_COM or moved != 1:
        fail(f"[U1] set_pka: centre of mass {com:.3e} A/fs, {moved} atoms "
             "sped up")
    print(f"[U1] {card}: set_pka(1000 eV) on {n} atoms: {pka_s * 1e3:.3f} ms on "
          f"the host, one atom sped up, centre of mass {com:.3e} A/fs")
    out["set_pka_s"] = pka_s

    prop = np.random.default_rng(65).normal(size=n)
    run = lambda: average_by_neighbor(pos, box, prop, 5.0)  # noqa: E731
    ms, avg = median_ms(run, 3)
    again = run()
    if avg.tobytes() != again.tobytes():
        fail("[U1] average_by_neighbor: a repeat differs")
    print(f"  average_by_neighbor at rc 5 A: {ms:.3f} ms (median of 3, the "
          f"neighbor build included), repeats bit for bit; {card}")
    out["average_ms"] = ms
    cut, cbox, _ = fcc_system(CUT_CELLS, rattle=NATIVE_RATTLE, seed=66)
    cprop = np.random.default_rng(67).normal(size=len(cut))
    out["average_card_cpu"] = card_against_cpu(
        "[U1]", "average_by_neighbor", lambda d: average_by_neighbor(
            cut, cbox, cprop, 5.0, device=d), lambda o: (o,))

    gen = lambda: mt.generate_velocity(VELOCITY_ATOMS, mass, 300.0,  # noqa: E731
                                       seed=68)
    v1, gen_s = sync_time(gen)
    temp = float((mass * (v1 ** 2).sum()) / (3 * VELOCITY_ATOMS)
                 * 1e10 / 6.022140857e26 / 1.380649e-23)
    if v1.tobytes() != gen().tobytes() or abs(temp - 300.0) > 3.0:
        fail(f"[U1] generate_velocity: a rerun differs or T = {temp} K")
    print(f"  generate_velocity({VELOCITY_ATOMS}, Cu, 300 K, seed=68): "
          f"{gen_s * 1e3:.3f} ms on the host, T {temp:.3f} K, a rerun equal")
    out["generate_velocity_s"] = gen_s
    return out


def native_phases(card: str) -> dict:
    """[S6], [V1], [Q2] and [U1], after [S5]."""
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "tests"))  # _fault_stack
    t0 = time.perf_counter()
    out = {}
    for tag, phase in (("S6", ptm_phase), ("V1", voronoi_phase),
                       ("Q2", sqs_phase), ("U1", tool_phase)):
        t1 = time.perf_counter()
        out[tag] = phase(card)
        torch.cuda.empty_cache()
        print(f"[{tag}] {time.perf_counter() - t1:.1f} s")
    print(f"[S6-U1] {time.perf_counter() - t0:.1f} s")
    return out


# ---- the elastic stacks (A9e) and scale-out (A11) ----------------------------

ELASTIC_CELLS = 6           # [EL1]: 6^3 conventional cells, 864 atoms
# relative, the supercell's tensor against the cell's: at the default fmax
# 1e-4 each relaxation stops at a residual stress that depends on N (the
# cell rows' forces are extensive), 2.3e-5 and 2.7e-5 apart at 2^3 and 3^3
# cells on the CPU (5e-7 at fmax 1e-6)
TOL_EL_SUPERCELL = 1e-4
TOL_EL_CUBIC = 1e-6         # relative, C11 = C22 = C33, C12 = C13 = C23, C44 = C55 = C66
TOL_EL_CPU = 1e-9           # relative, the card's tensor against the CPU's
TOL_BS_CPU = 1e-9           # the card's k values against the CPU's
BS_CELLS = 2                # [BS1]: 2^3 cells of FCC Al-Cu, 32 atoms
D2_REMAT = 5                # 270 rows: remat_chunks must divide them (4 does not)
TOL_D2_LOSS = 1e-5          # relative, a sharded step's loss against the unsharded
D2_COS_MIN = 0.9999         # least cosine of a sharded float64 gradient against the unsharded


def _rel(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / np.abs(b).max())


def elastic_phase(card: str, outdir: Path) -> dict:
    """[EL1] ``get_elastic_constant`` at its defaults on the Cu unit cell
    and on its 6x6x6 supercell with the port's EAM, and the card against
    the CPU."""
    import mdapy_tpu_torch as mt
    from mdapy_tpu_torch.potentials import elastic as tel
    from mdapy_tpu_torch.potentials import minimizer as tmin

    cu = str(outdir / "Cu.eam.alloy")
    mt.EAMGenerator(["Cu"], output_filename=cu)
    counts = {"steps": 0}

    class CountingFIRE(tmin.FIRE):
        def run(self, *args, **kwargs):
            rows = self._dof.gradient_rows

            def counted():
                counts["steps"] += 1
                return rows()

            self._dof.gradient_rows = counted
            return super().run(*args, **kwargs)

    def tensor(n_cells, device):
        s = mt.build_crystal("Cu", "fcc", 3.615, nx=n_cells, ny=n_cells,
                             nz=n_cells, device=device)
        counts["steps"] = 0
        with swapped(tel, FIRE=CountingFIRE):
            et, secs = sync_time(lambda: tel.get_elastic_constant(
                s, mt.EAM(cu, device=device)))
        return et.voigt, secs, counts["steps"], s.N

    out = {}
    C, secs, steps, n = tensor(1, "cuda")
    C_big, big_s, big_steps, n_big = tensor(ELASTIC_CELLS, "cuda")
    C_cpu, cpu_s, cpu_steps, _ = tensor(1, "cpu")
    sup, cpu = _rel(C_big, C), _rel(C, C_cpu)
    d, off = np.diag(C)[:3], C[[0, 0, 1], [1, 2, 2]]
    shear = np.diag(C)[3:]
    cubic = max(np.ptp(d) / d.max(), np.ptp(off) / abs(off).max(),
                np.ptp(shear) / shear.max())
    c11, c12, c44 = d.mean(), off.mean(), shear.mean()
    born = c11 - c12 > 0 and c11 + 2 * c12 > 0 and c44 > 0
    print(f"[EL1] {card}: get_elastic_constant at its defaults (FIRE with the "
          f"cell to fmax 1e-4, 24 deformed copies on the card), the port's "
          f"EAMGenerator(['Cu']), float64: unit cell ({n} atoms) {steps} FIRE "
          f"steps (force evaluations, the uphill backtracks with them) in "
          f"{secs:.3f} s host; {ELASTIC_CELLS}^3 supercell ({n_big} "
          f"atoms) {big_steps} steps in {big_s:.3f} s; the CPU's unit cell "
          f"{cpu_steps} steps in {cpu_s:.3f} s")
    print(f"  C11 {c11:.4f}, C12 {c12:.4f}, C44 {c44:.4f} GPa; cubic within "
          f"{cubic:.3e}; Born stable {born}; supercell against the cell "
          f"{sup:.3e}, card against the CPU {cpu:.3e} (relative to max |C|)")
    if not born or cubic > TOL_EL_CUBIC or sup > TOL_EL_SUPERCELL or \
            cpu > TOL_EL_CPU or not np.allclose(C, C.T):
        fail("[EL1] the elastic tensor is not cubic and Born stable, or the "
             "supercell or the CPU disagrees")
    out.update(cell_s=secs, cell_steps=steps, supercell_s=big_s,
               supercell_steps=big_steps, supercell_atoms=n_big,
               cpu_s=cpu_s, c11=c11, c12=c12, c44=c44, supercell_rel=sup,
               cpu_rel=cpu, cubic_rel=cubic)
    return out


def bond_stiffness_phase(card: str, outdir: Path) -> dict:
    """[BS1] ``BondStiffness.compute`` at its defaults on a 2x2x2 Al-Cu FCC
    alloy with the port's EAM: 579 force calls on the card, then the same
    on the CPU."""
    import mdapy_tpu_torch as mt
    from mdapy_tpu_torch.potentials import eam as team

    alcu = str(outdir / "AlCu.eam.alloy")
    mt.EAMGenerator(["Al", "Cu"], output_filename=alcu)
    calls = {"n": 0}

    class CountingEAM(team.EAM):
        def calculate(self, system):
            calls["n"] += 1
            return super().calculate(system)

    def run(device):
        s = mt.build_hea(("Al", "Cu"), (0.5, 0.5), "fcc", 3.85, nx=BS_CELLS,
                         ny=BS_CELLS, nz=BS_CELLS, random_seed=1, device=device)
        calls["n"] = 0
        bs, secs = sync_time(lambda: mt.BondStiffness(
            s, CountingEAM(alcu, device=device)).compute())
        return bs, secs, calls["n"], s.N

    bs, secs, n_calls, n = run("cuda")
    ref, cpu_s, cpu_calls, _ = run("cpu")
    probes = n * 3 * 2
    err = max(float(np.abs(bs.k_long[k] - ref.k_long[k]).max()) for k in ref.k_long)
    err = max(err, max(float(np.abs(bs.k_trans[k] - ref.k_trans[k]).max())
                       for k in ref.k_trans))
    kl = {f"{a}-{b}-{s}": [round(float(x), 5) for x in v]
          for (a, b, s), v in bs.k_long.items()}
    kt = {f"{a}-{b}-{s}": [round(float(x), 5) for x in v]
          for (a, b, s), v in bs.k_trans.items()}
    print(f"[BS1] {card}: BondStiffness at its defaults (rc_bond {bs.rc_bond:.4f} "
          f"A, 3 strains, linear k(r)) on {n} atoms of FCC Al-Cu (a 3.85 A, "
          f"seed 1), the port's EAMGenerator(['Al', 'Cu']), float64: {n_calls} "
          f"force calls ({probes} probes a strain) in {secs:.3f} s host, "
          f"{secs / n_calls * 1e3:.3f} ms a probe; the CPU {cpu_calls} calls "
          f"in {cpu_s:.3f} s")
    print(f"  shells {[round(x, 5) for x in bs.shells]}; k_long {kl}; "
          f"k_trans {kt}; card against the CPU {err:.3e}")
    if n_calls != 3 * (probes + 1) or cpu_calls != n_calls or err > TOL_BS_CPU \
            or len(bs.k_long) != 3:
        fail("[BS1] wrong force calls, pairs, or the card and the CPU differ")
    return dict(s=secs, calls=n_calls, ms_per_probe=secs / n_calls * 1e3,
                cpu_s=cpu_s, card_cpu_err=err, shells=list(bs.shells),
                k_long=kl, k_trans=kt)


def sharded_frame_phase(card: str, mesh, hier) -> dict:
    """[D1] The headline frame through ``render_image_mega_sharded`` on a
    1-D mesh and ``render_image_mega_hier`` on a (1, 1) mesh of an NCCL
    world of one, against the one-shot ``render_image_mega``."""
    from mdapy_tpu_torch import TachyonRender, preset_camera
    from mdapy_tpu_torch.render import distributed as rd
    from mdapy_tpu_torch.render import megakernel
    from mdapy_tpu_torch.render import multihost as rh
    from mdapy_tpu_torch.render import render as trender

    width, height = 1920, 1080
    pos, colors, radii = fcc_block(63)
    cam = preset_camera("perspective", pos, max_radius=float(radii.max()))
    ren = TachyonRender(backend="cuda", ao=False)
    ren.render(pos, colors, radii, camera=cam, width=width, height=height,
               device_output=True)
    frame, bins, cd, lights, params = ren._accel
    S = ren._cfg.aa_samples + 1
    kw = dict(S=S, width=width, height=height, tiles_x=bins.tiles_x,
              tiles_y=bins.tiles_y, grid_n=trender.LIGHT_GRID, eps=ren._cfg.eps,
              perspective=bool(frame["perspective"]), shadows=lights is not None)
    args = (cd, bins.sph_zmin, lights, params, 0)
    routes = {
        "sharded": lambda: rd.render_image_mega_sharded(*args, mesh=mesh, **kw),
        "hier": lambda: rh.render_image_mega_hier(*args, mesh=hier, **kw),
    }
    out = {}
    megakernel.reset_launches()
    firsts = {k: sync_time(f) for k, f in routes.items()}
    warm = {k: median_ms(f, WARM_FRAMES)[0] for k, f in routes.items()}
    launches = megakernel.launches
    one, one_first = sync_time(lambda: megakernel.render_image_mega(*args, **kw))
    one_ms = median_ms(lambda: megakernel.render_image_mega(*args, **kw),
                       WARM_FRAMES)[0]
    print(f"[D1] {card}: the headline frame ({len(pos)} atoms, {width}x{height}, "
          f"S={S}, shadows) on an NCCL world of {torch.distributed.get_world_size()} "
          f"(backend {torch.distributed.get_backend()}); one-shot "
          f"render_image_mega {one_ms:.3f} ms warm (median of {WARM_FRAMES})")
    for k, (img, t) in firsts.items():
        same = torch.equal(img, one)
        print(f"  {k}: first frame {t * 1e3:.1f} ms, warm {warm[k]:.3f} ms "
              f"({warm[k] - one_ms:+.3f} ms against the one-shot: the band slice, "
              f"the all_gather and the crop); equal to the one-shot frame bit for bit: {same}")
        if not same or tuple(img.shape) != (height, width, 3):
            fail(f"[D1] the {k} frame differs from the one-shot frame")
        out[k] = dict(first_ms=t * 1e3, warm_ms=warm[k])
    n_frames = len(routes) * (1 + 1 + WARM_FRAMES)
    print(f"  B1 launches over the sharded and hierarchical frames: {launches} "
          f"({n_frames} frames)")
    if launches != n_frames:
        fail(f"[D1] the kernel ran {launches} times for {n_frames} frames")
    out.update(one_shot_ms=one_ms, launches=launches)
    del ren, args, cd, lights, bins, one, firsts
    torch.cuda.empty_cache()
    return out


def sharded_grad_phase(card: str, mesh, hier) -> dict:
    """[D2] ``render_train_step`` and ``render_train_step_hier`` on [A6g]'s
    config-4 scene at 480x270 against the unsharded exact-tracer step:
    timed in float32, held in float64."""
    import dataclasses

    from mdapy_tpu_torch import preset_camera
    from mdapy_tpu_torch.render import distributed as rd
    from mdapy_tpu_torch.render import multihost as rh
    from mdapy_tpu_torch.render import render as trender
    from mdapy_tpu_torch.render import tracer
    from mdapy_tpu_torch.render.camera import camera_frame
    from mdapy_tpu_torch.render.config import RenderConfig
    from mdapy_tpu_torch.render.scene import scene_from_arrays

    fe = bcc_system(6)
    rad2 = np.full(fe.N, 0.5, np.float32)
    cam2 = preset_camera("perspective", fe.get_positions(), max_radius=0.5)
    w, h = A6G_SIZE
    fr = camera_frame(cam2, w, h)
    cfg = RenderConfig(aa_samples=0, aa_enabled=False, ao_enabled=False,
                       shadows_enabled=True)
    arrays = (fe.get_positions(), trender._default_colors(fe), rad2)
    target = np.random.default_rng(0).uniform(0.0, 1.0, (h, w, 3))

    def steps(dtype):
        scene = scene_from_arrays(*(torch.tensor(
            np.asarray(a, np.float64), dtype=dtype, device="cuda") for a in arrays))

        def unsharded():
            leaves = [t.detach().clone().requires_grad_(True) for t in (
                scene.sph_center, scene.sph_radius, scene.sph_color)]
            s2 = dataclasses.replace(scene, sph_center=leaves[0],
                                     sph_radius=leaves[1], sph_color=leaves[2])
            img = tracer.render_image(s2, *[fr[k] for k in rd.CAMERA_KEYS],
                                      cfg, w, h, True, 0)
            loss = torch.mean((img - torch.as_tensor(
                target, dtype=img.dtype, device=img.device)) ** 2)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        return {
            "unsharded": unsharded,
            "train_step": lambda: rd.render_train_step(scene, fr, target, cfg,
                                                       w, h, mesh),
            "hier_remat1": lambda: rh.render_train_step_hier(
                scene, fr, target, cfg, w, h, hier, remat_chunks=1),
            f"hier_remat{D2_REMAT}": lambda: rh.render_train_step_hier(
                scene, fr, target, cfg, w, h, hier, remat_chunks=D2_REMAT),
        }

    def against(res):
        ref_loss, ref_grads = res["unsharded"]
        out = {}
        for k, (loss, grads) in res.items():
            rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
            cos = [float(torch.nn.functional.cosine_similarity(
                g.double().flatten(), r.double().flatten(), dim=0))
                for g, r in zip(grads, ref_grads)]
            out[k] = (rel, cos)
        return out

    try:
        rh.render_train_step_hier(None, fr, target, cfg, w, h, hier,
                                  remat_chunks=4)
        fail("[D2] remat_chunks=4 of 270 rows did not raise")
    except ValueError as err:
        print(f"[D2] {card}: remat_chunks=4 raises as in the JAX package: {err}")
    out, res = {}, {}
    for k, fn in steps(torch.float32).items():
        sync_time(fn)                                   # warm-up
        torch.cuda.reset_peak_memory_stats()
        res[k], secs = sync_time(fn)
        out[k] = dict(ms=secs * 1e3, peak=torch.cuda.max_memory_allocated())
    f32 = against(res)
    res64 = {k: fn() for k, fn in steps(torch.float64).items()}
    f64 = against(res64)
    print(f"  config 4 ({fe.N} atoms, {w}x{h}, AA off, shadows) on the card, "
          f"forward + backward, float32 timed after a warm-up; unsharded loss "
          f"{float(res['unsharded'][0]):.8g}; the cosines of float32 "
          f"gradients lose ~1e-3 where a sphere's per-pixel terms cancel, so "
          f"the gate holds each step in float64")
    for k in res:
        (rel, cos), (rel64, cos64) = f32[k], f64[k]
        print(f"  {k}: {out[k]['ms']:.1f} ms, peak allocated {out[k]['peak']} "
              f"bytes; float32 loss {rel:.3e} relative, gradient cosines "
              f"(centres, radii, colours) {[round(c, 8) for c in cos]}; "
              f"float64 loss {rel64:.3e}, cosines {[round(c, 12) for c in cos64]}")
        if rel > TOL_D2_LOSS or rel64 > TOL_D2_LOSS or min(cos64) < D2_COS_MIN:
            fail(f"[D2] {k}: the loss or a gradient differs from the unsharded step")
        out[k].update(loss_rel=rel, cos=cos, loss_rel64=rel64, cos64=cos64)
    return out


def scaleout_phases(card: str) -> dict:
    """[EL1], [BS1], [D1] and [D2], after [U1]: the elastic stacks, then the
    sharded renders on an NCCL world of one, which they start and end."""
    from mdapy_tpu_torch.render import distributed as rd
    from mdapy_tpu_torch.render import multihost as rh
    from mdapy_tpu_torch.render._build import load_all

    load_all()
    outdir = Path(__file__).resolve().parent / "chiprun_out" / "smoke"
    outdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out = {}
    for tag, phase in (("EL1", elastic_phase), ("BS1", bond_stiffness_phase)):
        t1 = time.perf_counter()
        out[tag] = phase(card, outdir)
        torch.cuda.empty_cache()
        print(f"[{tag}] {time.perf_counter() - t1:.1f} s")
    if torch.distributed.is_initialized():
        fail("a process group exists before [D1]")
    try:
        mesh, hier = rd.make_mesh(1), rh.make_hier_mesh(1, 1)
        if torch.distributed.get_backend() != "nccl":
            fail(f"[D1] the world runs {torch.distributed.get_backend()}, not NCCL")
        for tag, phase in (("D1", sharded_frame_phase), ("D2", sharded_grad_phase)):
            t1 = time.perf_counter()
            out[tag] = phase(card, mesh, hier)
            torch.cuda.empty_cache()
            print(f"[{tag}] {time.perf_counter() - t1:.1f} s")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print(f"[EL1-D2] {time.perf_counter() - t0:.1f} s")
    return out


def image_out_phase(card: str) -> dict:
    """Phase 9: the image out (``render/image_out.py``, ``csrc/image_out.cu``)
    at the benchmark's main path's shape: a 32,000-atom FCC block (20^3
    cells, random colours) at 3000x3000, AA 20, shadows, through
    ``TachyonRender(backend="cuda", ao=False).render`` to a host image,
    opaque and then transparent.  Each call's launches counted from a reset
    just before it; each call's float frame kept, and the host image equal
    byte for byte to ``image_out_plain`` of that frame on the CPU.  Then on
    the last frame: the kernel's time by CUDA events (median of 20) and in
    ``torch.profiler`` (10 launches), its bound by bytes, ``image_out_plain``
    on the card, and the copy to the host through ``host_image`` against
    ``rgba.cpu().numpy()`` and against fresh arrays of 27-36 MB."""
    from mdapy_tpu_torch import TachyonRender, preset_camera
    from mdapy_tpu_torch.render import image_out
    from mdapy_tpu_torch.render import render as trender

    width = height = 3000
    pos, colors, radii = fcc_block(20, seed=9)
    cam = preset_camera("perspective", pos, max_radius=1.28)
    ren = TachyonRender(backend="cuda", ao=False, aa_samples=20,
                        background=(0.2, 0.4, 0.6, 0.5))
    frames = []

    def spy(img_f, *args):
        frames.append((img_f.clone(), args))
        return real(img_f, *args)

    real = trender.image_out_rgba
    ren.render(pos, colors, radii, camera=cam, width=width, height=height)
    frames.clear()
    launches, imgs = [], []
    with swapped(trender, image_out_rgba=spy):
        for transparent in (False, True):
            image_out.reset_launches()
            img = ren.render(pos, colors, radii, camera=cam, width=width,
                             height=height, transparent=transparent)
            torch.cuda.synchronize()
            launches.append(image_out.launches["image_out_rgba"])
            imgs.append(img)
    if launches != [1, 1] or len(frames) != 2:
        fail(f"[9] the host images launched the RGBA kernel {launches} times "
             f"over {len(frames)} image outs")
    for img, (frame, args), what in zip(imgs, frames, ("opaque", "transparent")):
        if frame.dtype != torch.float32 or not frame.is_cuda:
            fail(f"[9] {what}: the frame is {frame.dtype} on {frame.device}")
        want = image_out.image_out_plain(frame.cpu(), *args).numpy()
        if img.shape != (height, width, 4) or not np.array_equal(img, want):
            bad = int((img != want).any(axis=2).sum()) if img.shape == want.shape else -1
            fail(f"[9] {what}: the host image differs from image_out_plain's "
                 f"in {bad} pixels")
        print(f"  [9] {what}: host image {img.shape} equal to image_out_plain's "
              f"byte for byte; alpha values {np.unique(img[:, :, 3]).tolist()}, "
              f"RGB std {float(img[:, :, :3].std()):.2f}")
    if not float(imgs[0][:, :, :3].std()) > 1 or set(np.unique(imgs[1][:, :, 3])) != {0, 255}:
        fail("[9] the frame is flat or the transparent image has no background")
    frame, args = frames[0]
    n_px = width * height
    bound_ms = n_px * (12 + 4) / PEAK_BYTES * 1e3

    def kernel():
        return image_out.image_out_rgba_cuda(frame, *args)

    ms = event_ms(kernel, 20)
    prof = profile_call(lambda: [kernel() for _ in range(10)])
    device_ms = None if prof["device_ms"] is None else prof["device_ms"] / 10
    plain_ms = event_ms(lambda: image_out.image_out_plain(frame, *args), 5)
    rgba = kernel()
    fetch_ms, _ = median_ms(lambda: image_out.host_image(rgba), 5)
    cpu_copy_ms, _ = median_ms(lambda: rgba.cpu().numpy(), 5)
    fresh = {}
    for mb in (27, 31, 33, 36):
        src = torch.empty(mb * 10**6, dtype=torch.uint8, device="cuda")
        fresh[mb], _ = median_ms(lambda: src.cpu().numpy(), 5)
    print(f"[9] {card}: RGBA kernel on the 3000x3000 float32 frame "
          f"{ms:.4f} ms (CUDA events, median of 20), "
          + ("device time not measured" if device_ms is None else
             f"{device_ms:.4f} ms a launch in torch.profiler "
             f"({prof['launches']} launches)")
          + f"; bound {bound_ms:.4f} ms by bytes ({n_px * 16 / 1e6:.0f} MB at "
          f"3.35 TB/s), share {bound_ms / ms:.1%} (events); image_out_plain "
          f"on the card {plain_ms:.3f} ms; launches a host image {launches}")
    print(f"  [9] copy to the host: host_image {fetch_ms:.2f} ms, "
          f"rgba.cpu().numpy() {cpu_copy_ms:.2f} ms (medians of 5); a fresh "
          + ", ".join(f"{mb} MB {t:.2f}" for mb, t in fresh.items()) + " ms")
    del ren, frames, frame, rgba
    torch.cuda.empty_cache()
    return {"name": "image_out_rgba", "route": "cuda",
            "source": "mdapy_tpu_torch/csrc/image_out.cu",
            "replaces": None, "launches": sum(launches),
            "launches_per_host_image": 1, "max_abs_err": 0, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "fetch_ms": fetch_ms, "cpu_copy_ms": cpu_copy_ms,
            "fresh_copy_ms": fresh}


def chunk_gather_phase(card: str, ptxas: dict) -> dict:
    """Phase 9g: the per-tile sphere records (``render/gather.py``,
    ``csrc/chunk_gather.cu``) on the render demo's main path: the benchmark's
    ``hea32k_noao`` system (32,000 atoms, 3000x3000, AA 20, shadows) renders
    a first frame and then FRAMES frames of new snapshots through
    ``perfbench``'s client, each a view change that must launch the gather
    and the megakernel once; the last frame's records, as the main path kept
    them, against ``gather_chunk_data_plain`` on the card, bit for bit.  On
    that frame's ids: the kernel's time by CUDA events (median of 20) and in
    ``torch.profiler`` (10 launches) against its bound by bytes (records
    written, ids read, the table read once), and the plain version's time
    (median of 20).  ``ptxas``: the kernel's registers and spills from
    phase 1's pass over the build log."""
    from mdapy_tpu_torch.render import gather, megakernel
    from perfbench.drivers import render as bench

    frames = 3
    root = Path(__file__).resolve().parent / "perfbench"
    config = json.loads((root / "configs" / "hea32k_noao.json").read_text())
    mix = json.loads((root / "traffic" / "displaced_ring.json").read_text())
    traffic = bench.inputs(config, mix, 2**31 + 22)
    system = bench.make(config, "cuda", 2**31 + 22)
    client = bench.Client(system, traffic, config)
    client.step(0)
    gather.reset_launches()
    megakernel.reset_launches()
    for i in range(1, 1 + frames):
        problem = client.problem(client.step(i))
        if problem is not None:
            fail(f"[9g] step {i}: {problem}")
    launches = gather.launches["chunk_gather"]
    if launches != frames or megakernel.launches != frames:
        fail(f"[9g] {frames} frames of new snapshots launched the records' "
             f"gather {launches} times and the megakernel "
             f"{megakernel.launches} times (once a frame each expected)")
    _, bins, got, _, _ = system._accel
    scene = system._scene[0]
    ids = bins.sph_chunks
    table = gather.pack_sphere_table(scene.sph_center, scene.sph_radius,
                                     scene.sph_color)
    want = gather.gather_chunk_data_plain(ids, table)
    torch.cuda.synchronize()
    same = got.shape == want.shape and torch.equal(got.view(torch.int32),
                                                   want.view(torch.int32))
    max_abs = float((got - want).abs().max()) if got.shape == want.shape else None
    if not same or max_abs != 0.0:
        fail(f"[9g] the main path's records differ from the plain version's "
             f"(max |diff| {max_abs})")
    nbytes = got.nbytes + ids.nbytes + table.nbytes
    bound_ms = nbytes / PEAK_BYTES * 1e3
    ms = event_ms(lambda: gather.gather_chunk_data_cuda(ids, table), 20,
                  median=True)
    prof = profile_call(lambda: [gather.gather_chunk_data_cuda(ids, table)
                                 for _ in range(10)])
    device_ms = None if prof["device_ms"] is None else prof["device_ms"] / 10
    plain_ms = event_ms(lambda: gather.gather_chunk_data_plain(ids, table), 20,
                        median=True)
    nb, nchunks, ch = ids.shape
    print(f"[9g] {card}: chunk records of the demo's 3000x3000 frame "
          f"({nb} tiles x {nchunks} chunks x {ch}: {ids.numel()} slots, "
          f"{got.nbytes} B out, {ids.nbytes} B of ids): {launches} launches "
          f"over {frames} frames of the main path; max |diff| {max_abs} "
          f"against gather_chunk_data_plain, bit for bit; kernel {ms:.4f} ms "
          f"(CUDA events, median of 20), "
          + ("device time not measured" if device_ms is None else
             f"{device_ms:.4f} ms a launch in torch.profiler "
             f"(top {prof['top'][:2]})")
          + f"; bound {bound_ms:.4f} ms by bytes ({nbytes / 1e6:.1f} MB at "
          f"3.35 TB/s), share {bound_ms / ms:.1%} (events); plain version "
          f"{plain_ms:.3f} ms (median of 20)")
    for name, line in ptxas.items():
        print(f"  [9g] ptxas {name}: {line}")
    del system, client, scene, bins, ids, table, got, want
    torch.cuda.empty_cache()
    return {"name": "gather_chunk_data", "route": "cuda",
            "source": "mdapy_tpu_torch/csrc/chunk_gather.cu",
            "replaces": None, "launches": launches,
            "launches_per_frame": launches / frames,
            "max_abs_err": max_abs, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "ptxas": ptxas}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script needs a CUDA card")

    from mdapy_tpu_torch import TachyonRender, preset_camera
    from mdapy_tpu_torch.render import megakernel, tile_kernels, tracer_tiled
    from mdapy_tpu_torch.render import render as trender
    from mdapy_tpu_torch.render._build import load_all
    from mdapy_tpu_torch.render.accel import (
        build_light_bins, build_light_records, build_screen_bins,
        gather_other_records, occluder_records, other_table,
    )
    from mdapy_tpu_torch.render.camera import camera_frame
    from mdapy_tpu_torch.render.config import RenderConfig
    from mdapy_tpu_torch.render.gather import gather_chunk_data
    from mdapy_tpu_torch.render.geometry import bond_edges, box_edges
    from mdapy_tpu_torch.render.scene import build_scene

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    print(f"card: {card}")

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    libs = load_all()
    print(f"[1] built {len(libs)} libraries together in "
          f"{time.perf_counter() - t0:.2f} s")
    ptxas = {}   # kernel entry -> its ptxas lines (registers, spills)
    for lib in libs.values():
        print(f"  {lib.path.name}: nvcc {lib.build_seconds:.2f} s")
        entry = None
        for line in lib.log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line or "spill" in line:
                print("    " + line.strip())
                if entry:
                    ptxas.setdefault(entry, []).append(
                        line.split(":", 1)[-1].strip())
    variants = {}
    for name, flags in MAIN_VARIANTS.items():
        variants[name] = megakernel.kernel_attrs(**flags)
        print(f"  megakernel variant {name} {flags}: {variants[name]}")
    tile_attrs = tile_kernels.kernel_attrs()
    for name, attrs in tile_attrs.items():
        print(f"  tile kernel {name} (tiles of 3,328 rays): {attrs}")

    # ---- 9. the image out at the main path's shape --------------------------
    image_out_entry = image_out_phase(card)
    # ---- 9g. the per-tile sphere records on the demo's chunks ---------------
    chunk_gather_entry = chunk_gather_phase(
        card, {k: " ".join(v) for k, v in ptxas.items()
               if "chunk_gather_kernel" in k})

    # ---- 2. kernel vs plain, small scene ----------------------------------
    pos, colors, radii = fcc_block(8, seed=3)
    errs = []
    for preset, aa, shadows, ao in (
            ("perspective", 2, True, 0), ("top", 0, True, 0),
            ("perspective", 0, False, 0), ("perspective", 2, True, 12),
            ("top", 0, False, 4)):
        cam = preset_camera(preset, pos, max_radius=1.28)
        cfg = RenderConfig(aa_samples=aa, aa_enabled=aa > 0, ao_enabled=ao > 0,
                           ao_samples=ao, shadows_enabled=shadows)
        frame, bins, cd, lights, params = prepare_sphere_frame(
            dev, pos, colors, radii, cam, 320, 240, cfg)
        nl = 1 if lights is None else lights.lparams.shape[0]
        if nl != (1 + 2 * (ao // 2) if ao else 1):
            fail(f"{preset} ao_samples={ao}: {nl} lights stacked")
        kw = dict(S=aa + 1, tiles_x=bins.tiles_x, grid_n=32, eps=cfg.eps,
                  perspective=bool(frame["perspective"]),
                  shadows=lights is not None)
        args = (cd, bins.sph_zmin, lights, params, 0)
        out_k = megakernel.mega_render_cuda(*args, **kw)
        out_p = megakernel.mega_render_plain(*args, **kw)
        torch.cuda.synchronize()
        if float(out_p.std()) < 0.02:
            fail(f"{preset}: the plain image is flat")
        errs.append(compare(out_k, out_p, f"[2] {len(pos)} atoms 320x240 "
                            f"{preset} S={aa + 1} shadows={shadows} "
                            f"ao_samples={ao} lights={nl}"))

    # (f)-(h): bonds and box edges, on the inputs the front end builds
    small = bcc_system(3)
    colors_b = trender._default_colors(small)
    radii_b = np.full(small.N, 0.5, np.float32)
    bonds_b, _ = bond_edges(small.get_positions(), small.box, small.bond,
                            colors_b, radii_b, 0.2)
    lo_b, hi_b = small.get_positions().min(0), small.get_positions().max(0)
    mid_b, ext_b = 0.5 * (lo_b + hi_b), hi_b - lo_b
    big_cell = Cell(3 * ext_b, origin=mid_b - 1.5 * ext_b)
    ao_exact = trender.AO_EXACT_MAX_SPHERES
    trender.AO_EXACT_MAX_SPHERES = 0      # the kernel's fast AO on 54 atoms
    for case, preset, aa, ao, cell in (("f", "perspective", 2, 0, small.box),
                                       ("g", "top", 0, 4, small.box),
                                       ("h", "perspective", 0, 0, big_cell)):
        edges_c = box_edges(cell)
        view_pts = np.r_[small.get_positions(), edges_c[:, 0]]
        cam = preset_camera(preset, view_pts, max_radius=0.5)
        ren_b = TachyonRender(backend="cuda", ao=ao > 0, ao_samples=max(ao, 2),
                              aa_samples=aa, antialiasing=aa > 0)
        ren_b.render(small.get_positions(), colors_b, radii_b, camera=cam,
                     bond_edges=bonds_b, bond_radius=0.2, box_edges=edges_c,
                     box_edge_radius=0.1, width=320, height=240)
        (frame, bins, cd, lights, params), other = ren_b._accel, ren_b._other
        nl = lights.lparams.shape[0]
        if other is None or other.occ is None or other.occ.shape[0] != nl:
            fail(f"[2{case}] the cylinders reached the kernel without "
                 f"{nl} occluder tables")
        if nl != (1 + 2 * (ao // 2) if ao else 1):
            fail(f"[2{case}] {nl} lights stacked")
        only = int(((bins.sph_zmin[:, 0] >= 1e17) & (bins.oth_count > 0)).sum())
        if case == "h" and only == 0:
            fail("[2h] no tile holds only cylinders")
        kw = dict(S=aa + 1, tiles_x=bins.tiles_x, grid_n=32, eps=ren_b._cfg.eps,
                  perspective=bool(frame["perspective"]), shadows=True,
                  other=other)
        args = (cd, bins.sph_zmin, lights, params, 0)
        out_k = megakernel.mega_render_cuda(*args, **kw)
        out_p = megakernel.mega_render_plain(*args, **kw)
        torch.cuda.synchronize()
        if float(out_p.std()) < 0.02:
            fail(f"[2{case}] the plain image is flat")
        if case == "h":
            cyl_only = (bins.sph_zmin[:, 0] >= 1e17) & (bins.oth_count > 0)
            bg = torch.as_tensor(params[28:31], device=dev).repeat_interleave(256)
            drawn = int(((out_k[cyl_only] - bg).abs().amax(1) > 0.05).sum())
            print(f"  [2h] {only} tiles hold only cyl/rings, {drawn} of them "
                  f"drawn")
            if drawn == 0:
                fail("[2h] the cylinder-only tiles are background")
        errs.append(compare(out_k, out_p, f"[2{case}] {small.N} atoms + "
                            f"{other.occ.shape[1]} cyl/rings 320x240 {preset} "
                            f"S={aa + 1} ao_samples={ao} lights={nl}"))
        del ren_b
    trender.AO_EXACT_MAX_SPHERES = ao_exact

    # (i), (j): the tiled tracer's two kernels, on the arguments the path
    # gives them, and the frame against the plain route on the same tensors
    tile_errs = {"closest_hit_spheres_tiles": [], "shadow_filter_tiles": []}
    plain_route = dict(
        closest_hit_spheres_tiles=tile_kernels.closest_hit_spheres_tiles_plain,
        shadow_filter_tiles=tile_kernels.shadow_filter_tiles_plain)
    pos, colors, radii = fcc_block(8, seed=3)
    for case, preset, aa, relit in (("i", "perspective", 2, True),
                                    ("j", "top", 0, False)):
        cam = preset_camera(preset, pos, max_radius=1.28)
        cfg = RenderConfig(aa_samples=aa, aa_enabled=aa > 0, ao_enabled=False,
                           shadows_enabled=True)
        scene = build_scene(pos, colors, radii, device=dev)
        frame = camera_frame(cam, 320, 240)
        if relit:
            # the presets' light shines along the view and lights almost no
            # visible point; from beside the camera it lights them
            right = np.asarray(frame["iplaneright"], np.float64)
            L = -np.asarray(frame["view"]) + 0.8 * right / np.linalg.norm(right)
            frame = dict(frame, light_dir=L / np.linalg.norm(L))
        bins = build_screen_bins(scene, frame, 320, 240)
        lb = build_light_bins(scene, frame["light_dir"], grid=32)
        cd = gather_chunk_data(bins.sph_chunks, scene.sph_center,
                               scene.sph_radius, scene.sph_color)
        lrec = build_light_records(lb, scene)

        def small_frame():
            return tracer_tiled.render_image_pallas_banded(
                scene, bins, cd, lb, frame, cfg, 320, 240, 0, light_records=lrec)

        rec_hit = Recorder(tile_kernels.closest_hit_spheres_tiles)
        rec_sh = Recorder(tile_kernels.shadow_filter_tiles)
        tile_kernels.reset_launches()
        with swapped(tile_kernels, closest_hit_spheres_tiles=rec_hit,
                     shadow_filter_tiles=rec_sh):
            img_k = small_frame()
        if list(tile_kernels.launches.values()) != [1, 1]:
            fail(f"[2{case}] kernel launches {tile_kernels.launches}")
        with swapped(tile_kernels, **plain_route):
            img_p = small_frame()
        what = f"[2{case}] {len(pos)} atoms 320x240 {preset} S={aa + 1}"
        (hargs, hkw), (sargs, skw) = rec_hit.calls[0], rec_sh.calls[0]
        n_out = int((hargs[2] == -1e18).sum())
        n_empty = int((bins.sph_zmin[:, 0] >= 1e17).sum())
        print(f"  {what}: {n_out} rays leave the scene box (tcap -1e18), "
              f"{n_empty} tiles without a candidate")
        if n_out == 0 or (case == "i" and n_empty == 0):
            fail(f"{what}: no ray leaves the box, or no tile is empty")
        tile_errs["closest_hit_spheres_tiles"].append(
            compare_hit(tile_kernels, hargs, hkw, what + " closest hit"))
        tile_errs["shadow_filter_tiles"].append(
            compare_filt(tile_kernels, sargs, skw, what + " shadow filter"))
        compare_images(img_k, img_p, what + " render_image_pallas, kernels "
                       "against the plain route")
    del scene, bins, lb, cd, lrec, rec_hit, rec_sh, img_k, img_p

    # (k), (l): the bond scene past the megakernel's limit, and its bonds and
    # cell alone, through TachyonRender on the card and on the CPU
    shadow_max = trender.OTHER_SHADOW_MAX
    trender.OTHER_SHADOW_MAX = 100
    cam = preset_camera("perspective", np.r_[small.get_positions(),
                                             box_edges(small.box)[:, 0]],
                        max_radius=0.5)
    none = (np.zeros((0, 3)), np.zeros((0, 4), np.float32), np.zeros(0, np.float32))
    for case, atoms, route in (("k", (small.get_positions(), colors_b, radii_b), "pallas"),
                               ("l", none, "tiled")):
        kw = dict(camera=cam, bond_edges=bonds_b, bond_radius=0.2,
                  box_edges=box_edges(small.box), box_edge_radius=0.1,
                  width=320, height=240)
        ren_b = TachyonRender(backend="cuda", ao=False, aa_samples=2)
        tile_kernels.reset_launches()
        img_k = ren_b.render(*atoms, device_output=True, **kw)
        n_launch = tile_kernels.launches["closest_hit_spheres_tiles"]
        if ren_b._route_name != route or n_launch != (1 if case == "k" else 0):
            fail(f"[2{case}] route {ren_b._route_name}, {n_launch} launches")
        what = f"[2{case}] {len(atoms[0])} atoms + bonds and cell 320x240 S=3, {route}"
        if case == "k":
            with swapped(tile_kernels, **plain_route):
                img_p = ren_b.render(*atoms, device_output=True, **kw)
            if not torch.equal(img_k, img_p):
                compare_levels(img_k, img_p, what + ": kernel against the plain "
                               "route", 0.0)
            print(f"  {what}: kernel route equals the plain route")
        img_c = TachyonRender(backend="cpu", ao=False, aa_samples=2).render(
            *atoms, device_output=True, **kw)
        compare_levels(img_k, img_c, what + ': card against backend="cpu"',
                       TOL_LEVELS)
        del ren_b
    trender.OTHER_SHADOW_MAX = shadow_max

    # (m)-(s): transparency peeling
    peel_errs = peel_cases(dev, card)
    # (w): long and short cell walks
    peel_errs += walk_cases(dev, card)
    # (t): the tile kernels' edge cases
    for name, errs_t in tile_cases(tile_kernels, dev, card).items():
        tile_errs[name] += errs_t

    # ---- 3. main path, full size ------------------------------------------
    width, height, S = 1920, 1080, 13
    pos, colors, radii = fcc_block(63)
    cam = preset_camera("perspective", pos, max_radius=float(radii.max()))
    # "gpu", the reference renderer's name for the card (ROADMAP C8)
    ren = TachyonRender(backend="gpu", ao=False)
    if ren.backend != "cuda":
        fail(f'TachyonRender(backend="gpu") took backend {ren.backend!r}')

    def frame_once():
        return ren.render(pos, colors, radii, camera=cam, width=width,
                          height=height, device_output=True)

    torch.cuda.reset_peak_memory_stats()
    megakernel.reset_launches()
    img, t_first = sync_time(frame_once)
    img, t_warm = sync_time(lambda: [frame_once() for _ in range(WARM_FRAMES)][-1])
    launches = megakernel.launches
    peak = torch.cuda.max_memory_allocated()
    t_warm /= WARM_FRAMES
    headline_warm_ms = t_warm * 1e3
    print(f"[3] {card}: {len(pos)} atoms {width}x{height} S={S} shadows, 1 "
          f"light: first frame "
          f"{t_first * 1e3:.1f} ms, warm {t_warm * 1e3:.3f} ms/frame over "
          f"{WARM_FRAMES} frames, {width * height * S * 2 / t_warm / 1e9:.4f} "
          f"Grays/s, peak allocated {peak} bytes, kernel launches {launches}")
    if launches < 1 + WARM_FRAMES:
        fail(f"the main path launched the kernel {launches} times")
    if img.dtype != torch.uint8 or tuple(img.shape) != (height, width, 3):
        fail(f"image is {img.dtype} {tuple(img.shape)}")
    std = float(img.float().std())
    print(f"  image uint8 {tuple(img.shape)}, std {std:.2f}")
    if not std > 1:
        fail("the image is flat")

    # layers of the main path, each bracketed by synchronize
    cfg = ren._cfg
    scene, t_scene = sync_time(lambda: build_scene(pos, colors, radii, device=dev))
    frame = camera_frame(cam, width, height)
    bins, t_bins = sync_time(lambda: build_screen_bins(scene, frame, width, height))
    lb, t_lbins = sync_time(lambda: build_light_bins(scene, frame["light_dir"], grid=32))
    cd, t_gather = sync_time(lambda: gather_chunk_data(
        bins.sph_chunks, scene.sph_center, scene.sph_radius, scene.sph_color))
    lrec, t_lrec = sync_time(lambda: build_light_records(lb, scene))
    _, frame_bins, chunk_data, lights_main, params = ren._accel
    nb, nchunks = frame_bins.sph_zmin.shape
    if lights_main.lparams.shape[0] != 1:
        fail(f"the headline frame stacked {lights_main.lparams.shape[0]} lights")
    kw = dict(S=S, tiles_x=frame_bins.tiles_x, grid_n=32, eps=cfg.eps,
              perspective=True, shadows=True)
    args = (chunk_data, frame_bins.sph_zmin, lights_main, params, 0)
    kernel_ms = event_ms(lambda: megakernel.mega_render_cuda(*args, **kw), 5)
    print(f"  layers: scene {t_scene * 1e3:.1f} ms, screen bins "
          f"{t_bins * 1e3:.1f} ms, light bins {t_lbins * 1e3:.1f} ms, gather "
          f"{t_gather * 1e3:.1f} ms, light records {t_lrec * 1e3:.1f} ms, "
          f"kernel (full frame) {kernel_ms:.3f} ms")
    print(f"  tiles {nb} ({frame_bins.tiles_x}x{frame_bins.tiles_y}), chunks "
          f"per tile {nchunks}, live tiles "
          f"{int((frame_bins.sph_zmin[:, 0] < 1e17).sum())}, light records "
          f"{lights_main.lrec.shape[0]}, records {chunk_data.numel() * 4} bytes")
    hit_ms = event_ms(lambda: megakernel.mega_render_cuda(
        chunk_data, frame_bins.sph_zmin, None, params, 0,
        **dict(kw, shadows=False)), 5)
    print(f"  kernel split: closest hit + shading {hit_ms:.3f} ms, shadow "
          f"walks +{kernel_ms - hit_ms:.3f} ms")

    # kernel vs plain on the whole frame, then timed over a band of the
    # frame's middle tile rows
    out_k = megakernel.mega_render_cuda(*args, **kw)
    out_p, t_plain = sync_time(lambda: megakernel.mega_render_plain(*args, **kw))
    errs.append(compare(out_k, out_p, f"[3] full frame (plain {t_plain:.2f} s)"))
    work3 = megakernel.plain_work(*args, **kw)
    frame_bound("headline", work3, kernel_ms, nb, lights=lights_main)
    del out_k, out_p
    b_head = band_check(megakernel, args, kw, frame_bins,
                        f"[3] headline on {card}", lights=lights_main)
    errs.append(b_head["err"])
    # ---- 8. the tiled tracer's kernels on the headline scene ------------------
    lrec3 = (lights_main.lrec, lights_main.loffs[0].contiguous(),
             lights_main.lcnt[0].contiguous())

    def tiled_frame(config=cfg, quantized=True):
        img = tracer_tiled.render_image_pallas_banded(
            scene, frame_bins, chunk_data, lb, frame, config, width, height, 0,
            light_records=lrec3)
        if quantized:
            img = torch.clamp(torch.round(img * 255.0), 0.0, 255.0).to(torch.uint8)
        return img

    torch.cuda.reset_peak_memory_stats()
    tile_kernels.reset_launches()
    img8, t_first8 = sync_time(tiled_frame)
    img8, t_warm8 = sync_time(lambda: [tiled_frame() for _ in range(WARM_FRAMES)][-1])
    t_warm8 /= WARM_FRAMES
    launches8 = dict(tile_kernels.launches)
    peak8 = torch.cuda.max_memory_allocated()
    nbands = -(-frame_bins.tiles_y // max(1, tracer_tiled.BAND_TILES // frame_bins.tiles_x))
    print(f"[8] {card}: the headline scene through render_image_pallas in "
          f"{nbands} bands, {width}x{height} S={S} shadows: first frame "
          f"{t_first8 * 1e3:.1f} ms, warm {t_warm8 * 1e3:.3f} ms/frame over "
          f"{WARM_FRAMES} frames ({width * height * S * 2 / t_warm8 / 1e9:.4f} "
          f"Grays/s) against the megakernel's {headline_warm_ms:.3f} ms/frame "
          f"in phase 3; peak allocated {peak8} bytes; kernel launches {launches8}")
    if any(n != nbands * (1 + WARM_FRAMES) for n in launches8.values()):
        fail(f"the tiled tracer launched its kernels {launches8} times over "
             f"{1 + WARM_FRAMES} frames of {nbands} bands")
    if tuple(img8.shape) != (height, width, 3) or not float(img8.float().std()) > 1:
        fail("the tiled tracer's headline frame is wrong or flat")
    # each kernel's time and launches in one frame, and one band's arguments
    rec_hit = Recorder(tile_kernels.closest_hit_spheres_tiles)
    rec_sh = Recorder(tile_kernels.shadow_filter_tiles)
    tile_kernels.reset_launches()
    with swapped(tile_kernels, closest_hit_spheres_tiles=rec_hit,
                 shadow_filter_tiles=rec_sh):
        tiled_frame()
    per_frame8 = dict(tile_kernels.launches)
    b2_frame_ms, b3_frame_ms = rec_hit.total_ms(), rec_sh.total_ms()
    (hargs, hkw), (sargs, skw) = rec_hit.calls[1], rec_sh.calls[1]
    del rec_hit, rec_sh
    print(f"  one frame: launches counted {per_frame8}; closest hit "
          f"{b2_frame_ms:.3f} ms, shadow filter {b3_frame_ms:.3f} ms; the "
          f"torch passes around them {t_warm8 * 1e3 - b2_frame_ms - b3_frame_ms:.1f} ms")
    if any(n != nbands for n in per_frame8.values()):
        fail(f"one frame of {nbands} bands launched {per_frame8}")
    what = f"[8] band of {hargs[0].shape[0]} tiles x {hargs[0].shape[1]} rays"
    tile_errs["closest_hit_spheres_tiles"].append(
        compare_hit(tile_kernels, hargs, hkw, what + " closest hit"))
    tile_errs["shadow_filter_tiles"].append(
        compare_filt(tile_kernels, sargs, skw, what + " shadow filter"))
    b2_ms = event_ms(lambda: tile_kernels.closest_hit_spheres_tiles_cuda(*hargs, **hkw), 5)
    b3_ms = event_ms(lambda: tile_kernels.shadow_filter_tiles_cuda(*sargs, **skw), 5)
    _, t_b2_plain = sync_time(
        lambda: tile_kernels.closest_hit_spheres_tiles_plain(*hargs, **hkw))
    _, t_b3_plain = sync_time(
        lambda: tile_kernels.shadow_filter_tiles_plain(*sargs, **skw))
    hit_work = megakernel.count_work(
        tile_kernels.closest_hit_spheres_tiles_plain, *hargs, **hkw)
    b2_bound_ms, b2_by, b2_hits, b2_winners = hit_bound(
        hit_work.get("sphere", 0), hargs,
        *tile_kernels.closest_hit_spheres_tiles_cuda(*hargs, **hkw))
    b3_bound_ms, b3_by, filt_work = filt_bound(megakernel, sargs, skw)
    print(f"  closest hit on the band on {card}: kernel {b2_ms:.3f} ms, plain "
          f"{t_b2_plain * 1e3:.1f} ms; work {hit_work}, {b2_hits} rays hit "
          f"{b2_winners} distinct records, bound {b2_bound_ms:.4f} ms by "
          f"{b2_by} (roofline share {b2_bound_ms / b2_ms:.2%})")
    print(f"  shadow filter on the band on {card}: kernel {b3_ms:.3f} ms, plain "
          f"{t_b3_plain * 1e3:.1f} ms; work {filt_work}, bound "
          f"{b3_bound_ms:.4f} ms by {b3_by} (roofline share "
          f"{b3_bound_ms / b3_ms:.2%})")
    # the preset's light shines along the view and lights few visible points,
    # so few walks run; the same band lit from beside the camera
    right = np.asarray(frame["iplaneright"], np.float64)
    L = -np.asarray(frame["view"]) + 0.8 * right / np.linalg.norm(right)
    frame_r = dict(frame, light_dir=L / np.linalg.norm(L))
    lb_r = build_light_bins(scene, frame_r["light_dir"], grid=32)
    lrec_r = build_light_records(lb_r, scene)
    rows8 = max(1, tracer_tiled.BAND_TILES // frame_bins.tiles_x)
    ty0, ty1 = rows8, min(frame_bins.tiles_y, 2 * rows8)
    b0, b1 = ty0 * frame_bins.tiles_x, ty1 * frame_bins.tiles_x
    rec_sh = Recorder(tile_kernels.shadow_filter_tiles)
    with swapped(tile_kernels, shadow_filter_tiles=rec_sh):
        tracer_tiled.render_image_pallas(
            scene, tracer_tiled.band_bins(frame_bins, ty0, ty1),
            chunk_data[b0:b1], lb_r, *(frame_r[k] for k in (
                "origin", "lowleft", "iplaneright", "iplaneup", "view",
                "light_dir")), cfg, width, (ty1 - ty0) * frame_bins.tile_px,
            True, 0, frame_bins.tile_px, frame_bins.tiles_x, ty1 - ty0,
            ty_offset=ty0, do_flip=False, light_records=lrec_r)
    (rargs, rkw), = rec_sh.calls
    del rec_sh, lb_r
    tile_errs["shadow_filter_tiles"].append(
        compare_filt(tile_kernels, rargs, rkw, what + " shadow filter, relit"))
    b3r_ms = event_ms(lambda: tile_kernels.shadow_filter_tiles_cuda(*rargs, **rkw), 5)
    _, t_b3r_plain = sync_time(
        lambda: tile_kernels.shadow_filter_tiles_plain(*rargs, **rkw))
    b3r_bound_ms, b3r_by, relit_work = filt_bound(megakernel, rargs, rkw)
    print(f"  shadow filter on the band, relit, on {card}: kernel {b3r_ms:.3f} "
          f"ms, plain {t_b3r_plain * 1e3:.1f} ms; work {relit_work}, bound "
          f"{b3r_bound_ms:.4f} ms by {b3r_by} (roofline share "
          f"{b3r_bound_ms / b3r_ms:.2%})")
    if relit_work["lit"] < 10 * filt_work["lit"]:
        fail(f"the relit band lights {relit_work['lit']} rays, the preset's "
             f"{filt_work['lit']}")
    del hargs, sargs, rargs, lrec_r
    # AA off: the megakernel and the tiled tracer draw the same picture
    ren1 = TachyonRender(backend="cuda", ao=False, antialiasing=False)
    img_m = ren1.render(pos, colors, radii, camera=cam, width=width,
                        height=height, device_output=True)
    compare_levels(tiled_frame(config=ren1._cfg), img_m, "[8] AA off, the "
                   "tiled tracer against the megakernel", 4 / 7680)
    del ren1, img_m, img8, lrec3
    del ren, args, chunk_data, lights_main, frame_bins, scene, bins, lb, cd, lrec
    torch.cuda.empty_cache()

    # ---- B1f. the headline frame in bands ----------------------------------
    b1f = banded_phase(pos, colors, radii, cam, card, headline_warm_ms, peak)

    # ---- T1. the headline scene translucent: a precipitate in its matrix ----
    centre = 0.5 * (pos.min(0) + pos.max(0))
    edge = float((pos.max(0) - pos.min(0)).max())
    colors_t1 = colors.copy()
    outer = np.linalg.norm(pos - centre, axis=1) > 0.3 * edge
    colors_t1[outer, 3] = 0.3
    ren = TachyonRender(backend="cuda", ao=False)

    def t1_frame():
        return ren.render(pos, colors_t1, radii, camera=cam, width=width,
                          height=height, device_output=True)

    img, t_first, t_warm, t1_launches, t1_per_frame, t1_peak = drive(
        megakernel, t1_frame, "T1", ren)
    print(f"[T1] {card}: {len(pos)} atoms, {int(outer.sum())} of them (farther "
          f"than 0.3 x the {edge:.1f} A edge from the centre) at alpha 0.3, "
          f"{width}x{height} S={S} shadows, max_trans 4: first frame "
          f"{t_first * 1e3:.1f} ms, warm {t_warm * 1e3:.3f} ms/frame over "
          f"{WARM_FRAMES} frames against phase 3's opaque "
          f"{headline_warm_ms:.3f} ms, peak allocated {t1_peak} bytes, kernel "
          f"launches {t1_launches}")
    if not ren._scene[6]:
        fail("T1 rendered without transparency")
    if tuple(img.shape) != (height, width, 3) or not float(img.float().std()) > 1:
        fail("the T1 frame is wrong or flat")
    _, frame_bins, chunk_data, lights, params = ren._accel
    kw = dict(S=S, tiles_x=frame_bins.tiles_x, grid_n=32, eps=ren._cfg.eps,
              perspective=True, shadows=True, n_peel=4)
    args = (chunk_data, frame_bins.sph_zmin, lights, params, 0)
    t1_kernel_ms = event_ms(lambda: megakernel.mega_render_cuda(*args, **kw), 5)
    t1_hit_ms = event_ms(lambda: megakernel.mega_render_cuda(
        chunk_data, frame_bins.sph_zmin, None, params, 0,
        **dict(kw, shadows=False)), 5)
    print(f"  kernel (full frame) {t1_kernel_ms:.3f} ms against phase 3's opaque "
          f"{kernel_ms:.3f} ms ({t1_kernel_ms / kernel_ms:.2f}x); split: closest "
          f"hit + shading over the peels {t1_hit_ms:.3f} ms, shadow walks "
          f"+{t1_kernel_ms - t1_hit_ms:.3f} ms")
    plain_out = []
    work_t1, t_plain = sync_time(lambda: megakernel.count_work(
        lambda: plain_out.append(megakernel.mega_render_plain(*args, **kw))))
    out_k = megakernel.mega_render_cuda(*args, **kw)
    peel_errs.append(compare(out_k, plain_out[0], f"[T1] full frame (plain "
                                                  f"{t_plain:.2f} s)"))
    nb = frame_bins.sph_zmin.shape[0]
    ran = [work_t1.get(f"peel{p}", 0) for p in range(4)] + [0]
    print("  live tiles by the peels they ran: " + ", ".join(
        f"{k}: {ran[k - 1] - ran[k]}" for k in range(1, 5))
        + f" (of {nb} tiles, {nb - ran[0]} without a candidate); "
        f"records walked {work_t1.get('record', 0)} over {work_t1.get('lit', 0)} lit "
        f"rays ({work_t1.get('record', 0) / max(1, work_t1.get('lit', 0)):.1f} a lit "
        f"ray); chunks read {work_t1.get('chunk', 0)}")
    frame_bound("T1", work_t1, t1_kernel_ms, nb, lights=lights)
    del out_k, plain_out
    t1 = band_check(megakernel, args, kw, frame_bins, f"[T1] on {card}",
                    lights=lights)
    peel_errs.append(t1["err"])
    del ren, args, chunk_data, lights, frame_bins, img
    torch.cuda.empty_cache()

    # ---- 5. BASELINE config 2: BCC Fe + bonds, AA 12 + shadows ---------------
    width, height, S = 1920, 1080, 13
    fe = bcc_system(6)
    pos2 = fe.get_positions()
    rad2 = np.full(fe.N, 0.5, np.float32)
    cam2 = preset_camera("perspective", pos2, max_radius=0.5)
    ren = TachyonRender(backend="cuda", ao=False)
    torch.cuda.reset_peak_memory_stats()
    megakernel.reset_launches()
    rgba, t_sys = sync_time(lambda: ren.render_system(
        fe, radii=rad2, camera=cam2, draw_bond=True, bond_radius=0.2,
        width=width, height=height))
    if rgba.shape != (height, width, 4) or not float(rgba[..., :3].std()) > 1:
        fail(f"config 2 render_system frame {rgba.shape} is wrong or flat")
    if megakernel.launches != 1 or ren._other is None:
        fail(f"config 2's render_system frame took {megakernel.launches} kernel "
             f"launches, cylinders {'absent' if ren._other is None else 'present'}")
    colors2 = trender._default_colors(fe)
    (geo, t_geo) = sync_time(lambda: (box_edges(fe.box), bond_edges(
        pos2, fe.box, fe.bond, colors2, rad2, 0.2)[0]))
    cell2, bonds2 = geo
    ren = TachyonRender(backend="cuda", ao=False)

    def config2_frame():
        return ren.render(pos2, colors2, rad2, camera=cam2, bond_edges=bonds2,
                          bond_radius=0.2, box_edges=cell2, width=width,
                          height=height, device_output=True)

    img, t_first = sync_time(config2_frame)
    img, t_warm = sync_time(lambda: [config2_frame() for _ in range(WARM_FRAMES)][-1])
    c2_launches = megakernel.launches
    c2_peak = torch.cuda.max_memory_allocated()
    t_warm /= WARM_FRAMES
    config2_warm_ms = t_warm * 1e3
    (frame, frame_bins, chunk_data, lights, params), other = ren._accel, ren._other
    n_cyl = int((ren._scene[0].cyl_radius > 0).sum())
    n_ring = int((ren._scene[0].ring_rout > 0).sum())
    widest = int(other.ocnt.max())
    print(f"[5] config 2: {fe.N} atoms, {len(fe.bond)} bonds -> {len(bonds2)} "
          f"segments + {len(cell2)} cell edges = {n_cyl} cylinders and "
          f"{n_ring} rings, {n_cyl + n_ring} primitives (at most "
          f"{trender.OTHER_SHADOW_MAX}); widest tile {widest} cyl/rings, the "
          f"JAX renderer's per-tile measure {frame_bins.k_other} (at most "
          f"{trender.OTHER_TILE_MAX}); route: hand kernel, cyl/ring template")
    if (fe.N, len(fe.bond), n_cyl + n_ring) != (432, 1728, 5976):
        fail("config 2 does not have 432 atoms, 1,728 bonds and 5,976 primitives")
    if other is None or other.occ is None or tuple(other.occ.shape) != (1, 5976, 16):
        fail("config 2 did not reach the kernel with its occluder table")
    if c2_launches < 2 + WARM_FRAMES:
        fail(f"config 2 launched the kernel {c2_launches} times")
    if img.dtype != torch.uint8 or tuple(img.shape) != (height, width, 3):
        fail(f"config 2 image is {img.dtype} {tuple(img.shape)}")
    if not float(img.float().std()) > 1:
        fail("the config 2 image is flat")
    print(f"[5] {card}: config 2 {width}x{height} S={S} shadows: "
          f"render_system frame {t_sys * 1e3:.1f} ms, first frame "
          f"{t_first * 1e3:.1f} ms, warm {t_warm * 1e3:.3f} ms/frame over "
          f"{WARM_FRAMES} frames, {width * height * S * 2 / t_warm / 1e9:.4f} "
          f"Grays/s, peak allocated {c2_peak} bytes, kernel launches "
          f"{c2_launches}")

    # layers, each bracketed by synchronize
    scene, t_scene = sync_time(lambda: build_scene(
        pos2, colors2, rad2, bond_edges=bonds2, bond_radius=0.2,
        box_edges=cell2, device=dev))
    bins, t_bins = sync_time(lambda: build_screen_bins(scene, frame, width, height))
    table, t_table = sync_time(lambda: other_table(scene))
    _, t_ogather = sync_time(lambda: gather_other_records(bins, table))
    lb, t_lbins = sync_time(lambda: build_light_bins(scene, frame["light_dir"], grid=32))
    _, t_occ = sync_time(lambda: occluder_records(table, lb))
    _, t_lrec = sync_time(lambda: build_light_records(lb, scene))
    _, t_gather = sync_time(lambda: gather_chunk_data(
        bins.sph_chunks, scene.sph_center, scene.sph_radius, scene.sph_color))
    kw = dict(S=S, tiles_x=frame_bins.tiles_x, grid_n=32, eps=ren._cfg.eps,
              perspective=True, shadows=True, other=other)
    args = (chunk_data, frame_bins.sph_zmin, lights, params, 0)
    c2_kernel_ms = event_ms(lambda: megakernel.mega_render_cuda(*args, **kw), 5)
    # the split: closest hit with the cyl/ring pass, + the cell walks, + the
    # occluder tables
    hit_ms = event_ms(lambda: megakernel.mega_render_cuda(
        chunk_data, frame_bins.sph_zmin, None, params, 0,
        **dict(kw, shadows=False)), 5)
    walk_ms = event_ms(lambda: megakernel.mega_render_cuda(
        *args, **dict(kw, other=other._replace(occ=None))), 5)
    print(f"  layers: host geometry {t_geo * 1e3:.1f} ms, scene "
          f"{t_scene * 1e3:.1f} ms, screen bins (all kinds) {t_bins * 1e3:.1f} "
          f"ms, cyl/ring table {t_table * 1e3:.1f} ms, cyl/ring gather "
          f"{t_ogather * 1e3:.1f} ms, light bins {t_lbins * 1e3:.1f} ms, "
          f"occluder table {t_occ * 1e3:.1f} ms, light records "
          f"{t_lrec * 1e3:.1f} ms, sphere gather {t_gather * 1e3:.1f} ms, "
          f"kernel (full frame) {c2_kernel_ms:.3f} ms")
    print(f"  kernel split: closest hit + cyl/ring pass + shading "
          f"{hit_ms:.3f} ms, cell walks +{walk_ms - hit_ms:.3f} ms, occluder "
          f"tables +{c2_kernel_ms - walk_ms:.3f} ms")
    print(f"  tiles {frame_bins.sph_zmin.shape[0]}, live "
          f"{int(((frame_bins.sph_zmin[:, 0] < 1e17) | (other.ocnt > 0)).sum())}, "
          f"cyl/ring records {other.orec.shape[0]} (mean "
          f"{float(other.ocnt[other.ocnt > 0].float().mean()):.1f} a live tile), "
          f"light records {lights.lrec.shape[0]}")
    del scene, bins, table, lb

    # kernel vs plain on the whole frame, then both over a band of 2 tile rows
    out_k = megakernel.mega_render_cuda(*args, **kw)
    out_p, t_plain = sync_time(lambda: megakernel.mega_render_plain(*args, **kw))
    errs.append(compare(out_k, out_p, f"[5] config 2 full frame (plain {t_plain:.2f} s)"))
    frame_bound("config 2", megakernel.plain_work(*args, **kw), c2_kernel_ms,
                frame_bins.sph_zmin.shape[0], other=other, lights=lights)
    del out_k, out_p
    b_c2 = band_check(megakernel, args, kw, frame_bins,
                      f"[5] config 2 on {card}", other=other, lights=lights)
    errs.append(b_c2["err"])
    del ren, args, chunk_data, lights, frame_bins, other, img, _
    torch.cuda.empty_cache()

    # ---- A6, A6g. the exact tracer on config 2, and config 4 ----------------
    a6 = exact_phase(fe, rad2, cam2, card)
    a6g = grad_phase(fe, rad2, cam2, card)

    # ---- T3. config 2 translucent: the atoms at alpha 0.4, bonds opaque ------
    colors_t3 = colors2.copy()
    colors_t3[:, 3] = 0.4
    ren = TachyonRender(backend="cuda", ao=False)
    megakernel.reset_launches()
    rgba, t_sys = sync_time(lambda: ren.render_system(
        fe, colors=colors_t3, radii=rad2, camera=cam2, draw_bond=True,
        bond_radius=0.2, width=width, height=height))
    if (megakernel.launches != 1 or not ren._scene[6] or ren._other is None
            or rgba.shape != (height, width, 4) or not float(rgba[..., :3].std()) > 1):
        fail(f"the T3 render_system frame took {megakernel.launches} launches, "
             f"transparency {ren._scene[6]}, or is wrong or flat")

    def t3_frame():
        return ren.render(pos2, colors_t3, rad2, camera=cam2, bond_edges=bonds2,
                          bond_radius=0.2, box_edges=cell2, width=width,
                          height=height, device_output=True)

    img, t_first, t_warm, t3_launches, t3_per_frame, t3_peak = drive(
        megakernel, t3_frame, "T3", ren)
    print(f"[T3] {card}: config 2 with its {fe.N} atoms at alpha 0.4 (bonds and "
          f"cell opaque) {width}x{height} S={S} shadows, max_trans 4: "
          f"render_system frame {t_sys * 1e3:.1f} ms, first frame "
          f"{t_first * 1e3:.1f} ms, warm {t_warm * 1e3:.3f} ms/frame over "
          f"{WARM_FRAMES} frames against phase 5's opaque {config2_warm_ms:.3f} "
          f"ms, peak allocated {t3_peak} bytes, kernel launches {t3_launches}")
    if not float(img.float().std()) > 1:
        fail("the T3 frame is flat")
    (_, frame_bins, chunk_data, lights, params), other = ren._accel, ren._other
    kw = dict(S=S, tiles_x=frame_bins.tiles_x, grid_n=32, eps=ren._cfg.eps,
              perspective=True, shadows=True, other=other, n_peel=4)
    args = (chunk_data, frame_bins.sph_zmin, lights, params, 0)
    t3_kernel_ms = event_ms(lambda: megakernel.mega_render_cuda(*args, **kw), 5)
    hit_ms = event_ms(lambda: megakernel.mega_render_cuda(
        chunk_data, frame_bins.sph_zmin, None, params, 0,
        **dict(kw, shadows=False)), 5)
    walk_ms = event_ms(lambda: megakernel.mega_render_cuda(
        *args, **dict(kw, other=other._replace(occ=None))), 5)
    print(f"  kernel (full frame) {t3_kernel_ms:.3f} ms against phase 5's opaque "
          f"{c2_kernel_ms:.3f} ms; split: closest hit + cyl/ring pass + "
          f"shading over the peels {hit_ms:.3f} ms, cell walks "
          f"+{walk_ms - hit_ms:.3f} ms, occluder tables "
          f"+{t3_kernel_ms - walk_ms:.3f} ms")
    t3 = band_check(megakernel, args, kw, frame_bins, f"[T3] on {card}",
                    other=other, lights=lights)
    peel_errs.append(t3["err"])
    del ren, args, chunk_data, lights, frame_bins, other, img
    torch.cuda.empty_cache()

    # ---- 7. the heavy-bond frame: 7x7x7 BCC Fe, past the megakernel's limit ----
    fe7 = bcc_system(7)
    pos7 = fe7.get_positions()
    rad7 = np.full(fe7.N, 0.5, np.float32)
    cam7 = preset_camera("perspective", pos7, max_radius=0.5)
    ren = TachyonRender(backend="cuda", ao=False)
    torch.cuda.reset_peak_memory_stats()
    megakernel.reset_launches()
    tile_kernels.reset_launches()
    rgba, t_sys = sync_time(lambda: ren.render_system(
        fe7, radii=rad7, camera=cam7, draw_bond=True, bond_radius=0.2,
        width=width, height=height))
    if rgba.shape != (height, width, 4) or not float(rgba[..., :3].std()) > 1:
        fail(f"the heavy-bond render_system frame {rgba.shape} is wrong or flat")
    colors7 = trender._default_colors(fe7)
    cell7 = box_edges(fe7.box)
    bonds7 = bond_edges(pos7, fe7.box, fe7.bond, colors7, rad7, 0.2)[0]
    ren = TachyonRender(backend="cuda", ao=False)

    def heavy_frame():
        return ren.render(pos7, colors7, rad7, camera=cam7, bond_edges=bonds7,
                          bond_radius=0.2, box_edges=cell7, width=width,
                          height=height, device_output=True)

    img, t_first = sync_time(heavy_frame)
    img, t_warm = sync_time(lambda: [heavy_frame() for _ in range(WARM_FRAMES)][-1])
    t_warm /= WARM_FRAMES
    launches7 = dict(tile_kernels.launches)
    peak7 = torch.cuda.max_memory_allocated()
    (frame, frame_bins, chunk_data, lb7), other = ren._accel, ren._other
    n_cyl = int((ren._scene[0].cyl_radius > 0).sum())
    n_ring = int((ren._scene[0].ring_rout > 0).sum())
    nbands = -(-frame_bins.tiles_y // max(1, tracer_tiled.BAND_TILES // frame_bins.tiles_x))
    print(f"[7] heavy bonds: {fe7.N} atoms, {len(fe7.bond)} bonds -> "
          f"{len(bonds7)} segments + {len(cell7)} cell edges = {n_cyl} cylinders "
          f"and {n_ring} rings, {n_cyl + n_ring} primitives (the megakernel "
          f"takes at most {trender.OTHER_SHADOW_MAX} with shadows); widest tile "
          f"{int(other.ocnt.max())} cyl/rings, {other.orec.shape[0]} records "
          f"over {int((other.ocnt > 0).sum())} tiles; route: "
          f"{ren._route_name}, {nbands} bands")
    if ren._route_name != "pallas" or n_cyl + n_ring <= trender.OTHER_SHADOW_MAX:
        fail(f"the 7x7x7 frame took the route {ren._route_name}")
    if lb7.cyl is None or lb7.ring is None:
        fail("the heavy-bond frame lacks the light cells of three kinds")
    if (launches7 != {"closest_hit_spheres_tiles": nbands * (2 + WARM_FRAMES),
                      "shadow_filter_tiles": 0} or megakernel.launches != 0):
        fail(f"the {2 + WARM_FRAMES} heavy-bond frames of {nbands} bands "
             f"launched {launches7}, the megakernel {megakernel.launches} times")
    if img.dtype != torch.uint8 or tuple(img.shape) != (height, width, 3):
        fail(f"heavy-bond image is {img.dtype} {tuple(img.shape)}")
    if not float(img.float().std()) > 1:
        fail("the heavy-bond image is flat")
    print(f"[7] {card}: 7x7x7 BCC Fe + bonds {width}x{height} S={S} shadows: "
          f"render_system frame {t_sys * 1e3:.1f} ms, first frame "
          f"{t_first * 1e3:.1f} ms, warm {t_warm * 1e3:.3f} ms/frame over "
          f"{WARM_FRAMES} frames, {width * height * S * 2 / t_warm / 1e9:.4f} "
          f"Grays/s, peak allocated {peak7} bytes; phase 5's 6x6x6 frame "
          f"(megakernel) warm {config2_warm_ms:.3f} ms/frame in this run "
          f"({t_warm * 1e3 / config2_warm_ms:.0f}x)")
    # the layers of one warm frame, each bracketed by synchronize
    watch = {name: Stopwatch(getattr(tracer_tiled, name))
             for name in ("_raygen", "_closest", "_other_hit", "_shade",
                          "_shadow_filter_lb")}
    rec_hit = Recorder(tile_kernels.closest_hit_spheres_tiles)
    tile_kernels.reset_launches()
    with swapped(tracer_tiled, **watch), swapped(
            tile_kernels, closest_hit_spheres_tiles=rec_hit):
        _, t_layers = sync_time(heavy_frame)
    per_frame7 = tile_kernels.launches["closest_hit_spheres_tiles"]
    if per_frame7 != nbands:
        fail(f"one heavy-bond frame of {nbands} bands launched the closest "
             f"hit {per_frame7} times")
    b2_heavy_ms = rec_hit.total_ms()
    ms = {k: w.seconds * 1e3 for k, w in watch.items()}
    print(f"  layers of a frame of {t_layers * 1e3:.1f} ms: jitter (kept) + raygen "
          f"{ms['_raygen']:.1f} ms, chunked closest hit {b2_heavy_ms:.3f} ms "
          f"({per_frame7} launches counted), cylinder/ring merge {ms['_other_hit']:.1f} ms, "
          f"box cap + normals + winners "
          f"{ms['_closest'] - ms['_other_hit'] - b2_heavy_ms:.1f} ms, shadow pass "
          f"{ms['_shadow_filter_lb']:.1f} ms, shading and mean "
          f"{ms['_shade'] - ms['_shadow_filter_lb']:.1f} ms, host and assembly "
          f"{t_layers * 1e3 - ms['_raygen'] - ms['_closest'] - ms['_shade']:.1f} ms")
    hargs, hkw = rec_hit.calls[1]
    tile_errs["closest_hit_spheres_tiles"].append(compare_hit(
        tile_kernels, hargs, hkw, f"[7] band of {hargs[0].shape[0]} tiles x "
        f"{hargs[0].shape[1]} rays closest hit"))
    del ren, rec_hit, hargs, chunk_data, frame_bins, other, img, lb7, watch
    torch.cuda.empty_cache()

    # ---- 4. BASELINE config 3: ~1M-atom polycrystal with fast AO ------------
    t0 = time.perf_counter()
    pos, grain = voronoi_polycrystal()
    t_build = time.perf_counter() - t0
    n_atoms = len(pos)
    colors = np.tile(np.array([[0.78, 0.5, 0.2, 1.0]], np.float32), (n_atoms, 1))
    radii = np.full(n_atoms, 1.28, np.float32)
    print(f"[4] Voronoi polycrystal (230 A periodic cube, 15 grains, seed 1): "
          f"{n_atoms} atoms, built in {t_build:.1f} s on the host")
    if not 900_000 < n_atoms < 1_100_000:
        fail(f"the polycrystal has {n_atoms} atoms")
    AA, K = 2, 12
    S = AA + 1
    cam = preset_camera("perspective", pos, max_radius=1.28)
    ren = TachyonRender(backend="cuda", ao=True, ao_samples=K, aa_samples=AA,
                        background=(1.0, 1.0, 1.0))

    def ao_frame(camera=cam, **kw):
        return ren.render(pos, colors, radii, camera=camera, width=width,
                          height=height, **kw)

    torch.cuda.reset_peak_memory_stats()
    megakernel.reset_launches()
    img, t_first = sync_time(lambda: ao_frame(device_output=True))
    rgba, t_transp = sync_time(lambda: ao_frame(transparent=True))
    img, t_warm = sync_time(
        lambda: [ao_frame(device_output=True) for _ in range(WARM_FRAMES)][-1])
    ao_launches = megakernel.launches
    ao_peak = torch.cuda.max_memory_allocated()
    t_warm /= WARM_FRAMES
    lights = ren._accel[3]
    nl = lights.lparams.shape[0]
    grid_note = light_grid(lights)
    rays = width * height * (2 * S + K)
    print(f"[4] {card}: config 3, {n_atoms} atoms {width}x{height} S={S} "
          f"shadows + AO {K} sky lights ({nl} lights): first frame "
          f"{t_first * 1e3:.1f} ms, warm {t_warm * 1e3:.3f} ms/frame over "
          f"{WARM_FRAMES} frames, {rays / t_warm / 1e9:.4f} Grays/s by the rays "
          f"traced W*H*(2S+K), peak allocated {ao_peak} bytes, kernel launches "
          f"{ao_launches}")
    print(f"  bench.py:311 counts W*H*S*(2+K) = {width * height * S * (2 + K)} "
          f"rays, {S * (2 + K)}/{2 * S + K} of the {rays} traced "
          f"(S primary + S primary-shadow + K sample-0 sky rays per pixel)")
    if nl != 1 + K:
        fail(f"config 3 stacked {nl} lights, not {1 + K}")
    if ao_launches < 2 + WARM_FRAMES:
        fail(f"the AO path launched the kernel {ao_launches} times")
    if img.dtype != torch.uint8 or tuple(img.shape) != (height, width, 3):
        fail(f"AO image is {img.dtype} {tuple(img.shape)}")
    std = float(img.float().std())
    alpha = rgba[..., 3]
    print(f"  image uint8 {tuple(img.shape)}, std {std:.2f}; transparent frame "
          f"{t_transp * 1e3:.1f} ms, alpha 0 on {int((alpha == 0).sum())} and "
          f"255 on {int((alpha == 255).sum())} pixels")
    if not std > 1 or not float(rgba[..., :3].std()) > 1:
        fail("the AO image is flat")
    if not ((alpha == 0).any() and (alpha == 255).any()):
        fail("the transparent frame's alpha lacks 0 or 255")
    if rgba.dtype != np.uint8 or rgba.shape != (height, width, 4):
        fail(f"transparent frame is {rgba.dtype} {rgba.shape}")

    # layers of the AO main path, each bracketed by synchronize
    cfg = ren._cfg
    scene, t_scene = sync_time(lambda: build_scene(pos, colors, radii, device=dev))
    frame = camera_frame(cam, width, height)
    bins, t_bins = sync_time(lambda: build_screen_bins(scene, frame, width, height))
    lb, t_lbins = sync_time(lambda: build_light_bins(scene, frame["light_dir"], grid=32))
    _, t_lrec = sync_time(lambda: build_light_records(lb, scene))
    _, t_ao = sync_time(lambda: trender.build_ao_lights(
        scene, K, cfg.ao_brightness, 1.28, grid=32))
    _, t_gather = sync_time(lambda: gather_chunk_data(
        bins.sph_chunks, scene.sph_center, scene.sph_radius, scene.sph_color))
    del scene, bins, lb
    _, frame_bins, chunk_data, lights, params = ren._accel
    kw = dict(S=S, tiles_x=frame_bins.tiles_x, grid_n=32, eps=cfg.eps,
              perspective=True, shadows=True)
    args = (chunk_data, frame_bins.sph_zmin, lights, params, 0)
    ao_kernel_ms = event_ms(lambda: megakernel.mega_render_cuda(*args, **kw), 5)
    # the kernel's split: closest hit + shading, then the primary light's
    # sweep, then the sky lights' sweeps
    primary_only = megakernel.LightStack(
        lights.lparams[:1].contiguous(), lights.lrec,
        *(t[:1].contiguous() for t in lights[2:]))
    hit_ms = event_ms(lambda: megakernel.mega_render_cuda(
        chunk_data, frame_bins.sph_zmin, None, params, 0,
        **dict(kw, shadows=False)), 5)
    prim_ms = event_ms(lambda: megakernel.mega_render_cuda(
        chunk_data, frame_bins.sph_zmin, primary_only, params, 0, **kw), 5)
    print(f"  layers: scene {t_scene * 1e3:.1f} ms, screen bins "
          f"{t_bins * 1e3:.1f} ms, primary light bins {t_lbins * 1e3:.1f} ms, "
          f"primary light records {t_lrec * 1e3:.1f} ms, {K} AO light builds "
          f"{t_ao * 1e3:.1f} ms, gather {t_gather * 1e3:.1f} ms, kernel (full "
          f"frame) {ao_kernel_ms:.3f} ms")
    print(f"  kernel split: closest hit + shading {hit_ms:.3f} ms, primary "
          f"sweep +{prim_ms - hit_ms:.3f} ms, {K} AO sweeps "
          f"+{ao_kernel_ms - prim_ms:.3f} ms")
    print(f"  tiles {frame_bins.sph_zmin.shape[0]}, chunks per tile "
          f"{frame_bins.sph_zmin.shape[1]}, live tiles "
          f"{int((frame_bins.sph_zmin[:, 0] < 1e17).sum())}, light records "
          f"{lights.lrec.shape[0]} over {nl} lights "
          f"({lights.lrec.numel() * 4} bytes), records "
          f"{chunk_data.numel() * 4} bytes")

    # a camera move: the view-keyed structures are rebuilt, the AO lights
    # (keyed by the scene) are reused
    ao_before = ren._ao
    cam2 = preset_camera("perspective", pos + np.array([8.0, -5.0, 3.0]),
                         max_radius=1.28)
    img2, t_move = sync_time(lambda: ao_frame(camera=cam2, device_output=True))
    print(f"  camera move: {t_move * 1e3:.1f} ms, AO lights reused: "
          f"{ren._ao is ao_before}")
    if ren._ao is not ao_before:
        fail("the camera move rebuilt the AO lights")
    if float(img2.float().std()) <= 1 or torch.equal(img2, img):
        fail("the moved camera's frame is flat or unchanged")

    # kernel vs plain on the whole frame, then both over a band of 2 tile rows
    out_k = megakernel.mega_render_cuda(*args, **kw)
    out_p, t_plain = sync_time(lambda: megakernel.mega_render_plain(*args, **kw))
    errs.append(compare(out_k, out_p, f"[4] AO full frame (plain {t_plain:.2f} s)"))
    del out_k, out_p
    b_ao = band_check(megakernel, args, kw, frame_bins, f"[4] AO on {card}",
                      lights=lights)
    errs.append(b_ao["err"])
    frame_bound("config 3", megakernel.plain_work(*args, **kw), ao_kernel_ms,
                frame_bins.sph_zmin.shape[0], lights=lights)
    print(f"[3+4] {card}: headline (1 light) warm {headline_warm_ms:.3f} ms/frame, "
          f"config 3 (AO) warm {t_warm * 1e3:.3f} ms/frame")
    config3_warm_ms = t_warm * 1e3
    del ren, args, chunk_data, lights, frame_bins, primary_only, ao_before, img2
    torch.cuda.empty_cache()

    # ---- 6. config 3 as render_system draws it: the polycrystal's cell -------
    poly = StandIn(pos, Cell(230.0))
    ren = TachyonRender(backend="cuda", ao=True, ao_samples=K, aa_samples=AA,
                        background=(1.0, 1.0, 1.0))
    megakernel.reset_launches()
    rgba, t_first = sync_time(lambda: ren.render_system(
        poly, colors=colors, radii=radii, camera=cam, width=width,
        height=height))
    cell_edges = box_edges(poly.box)

    def boxed_frame():
        return ren.render(pos, colors, radii, camera=cam, box_edges=cell_edges,
                          width=width, height=height, device_output=True)

    img, t_warm = sync_time(
        lambda: [boxed_frame() for _ in range(WARM_FRAMES + 1)][-1])
    img, t_warm = sync_time(lambda: [boxed_frame() for _ in range(WARM_FRAMES)][-1])
    box_launches = megakernel.launches
    t_warm /= WARM_FRAMES
    (_, frame_bins, chunk_data, lights, params), other = ren._accel, ren._other
    nl = lights.lparams.shape[0]
    if other is None or tuple(other.occ.shape) != (nl, 36, 16) or nl != 1 + K:
        fail(f"config 3 + cell: occluder tables "
             f"{None if other is None else tuple(other.occ.shape)}")
    if box_launches < 2 + 2 * WARM_FRAMES:
        fail(f"config 3 + cell launched the kernel {box_launches} times")
    if float(img.float().std()) <= 1 or float(rgba[..., :3].std()) <= 1:
        fail("config 3 + cell: the image is flat")
    print(f"[6] {card}: config 3 + its cell through render_system: first "
          f"frame {t_first * 1e3:.1f} ms; warm {t_warm * 1e3:.3f} ms/frame "
          f"against phase 4's {config3_warm_ms:.3f} ms/frame in this run "
          f"({t_warm * 1e3 / config3_warm_ms - 1:+.1%}); {nl} lights with "
          f"{other.occ.shape[1]} occluders each, {int(other.ocnt.max())} "
          f"cyl/rings in the widest tile, kernel launches {box_launches}")
    kw = dict(S=S, tiles_x=frame_bins.tiles_x, grid_n=32, eps=ren._cfg.eps,
              perspective=True, shadows=True, other=other)
    args = (chunk_data, frame_bins.sph_zmin, lights, params, 0)
    box_kernel_ms = event_ms(lambda: megakernel.mega_render_cuda(*args, **kw), 5)
    # the split: closest hit with the cyl/ring pass, + the cell walks, + the
    # occluder tables; the light grids beside phase 4's
    hit_ms = event_ms(lambda: megakernel.mega_render_cuda(
        chunk_data, frame_bins.sph_zmin, None, params, 0,
        **dict(kw, shadows=False)), 5)
    walk_ms = event_ms(lambda: megakernel.mega_render_cuda(
        *args, **dict(kw, other=other._replace(occ=None))), 5)
    print(f"  kernel split: closest hit + cyl/ring pass + shading {hit_ms:.3f} "
          f"ms, cell walks +{walk_ms - hit_ms:.3f} ms, occluder tables "
          f"+{box_kernel_ms - walk_ms:.3f} ms")
    print(f"  light grids: {light_grid(lights)}; phase 4: {grid_note}")
    print(f"  kernel (full frame) {box_kernel_ms:.3f} ms")
    b_box = band_check(megakernel, args, kw, frame_bins,
                       f"[6] config 3 + cell on {card}", other=other,
                       lights=lights)
    errs.append(b_box["err"])
    del ren, args, chunk_data, lights, frame_bins, other
    torch.cuda.empty_cache()

    # ---- T2. config 3 translucent: grain 0 opaque, the other 14 at 0.2 -------
    colors_t2 = colors.copy()
    colors_t2[grain != 0, 3] = 0.2
    ren = TachyonRender(backend="cuda", ao=True, ao_samples=K, aa_samples=AA,
                        background=(1.0, 1.0, 1.0))

    def t2_frame():
        return ren.render(pos, colors_t2, radii, camera=cam, width=width,
                          height=height, device_output=True)

    img, t_first, t_warm, t2_launches, t2_per_frame, t2_peak = drive(
        megakernel, t2_frame, "T2", ren)
    print(f"[T2] {card}: config 3 with {int((grain == 0).sum())} atoms of grain "
          f"0 opaque and {int((grain != 0).sum())} at alpha 0.2, {width}x{height} "
          f"S={S} shadows + AO {K}, max_trans 4: first frame "
          f"{t_first * 1e3:.1f} ms, warm {t_warm * 1e3:.3f} ms/frame over "
          f"{WARM_FRAMES} frames against phase 4's opaque {config3_warm_ms:.3f} "
          f"ms, peak allocated {t2_peak} bytes, kernel launches {t2_launches}")
    if not ren._scene[6]:
        fail("T2 rendered without transparency")
    if tuple(img.shape) != (height, width, 3) or not float(img.float().std()) > 1:
        fail("the T2 frame is wrong or flat")
    _, frame_bins, chunk_data, lights, params = ren._accel
    kw = dict(S=S, tiles_x=frame_bins.tiles_x, grid_n=32, eps=ren._cfg.eps,
              perspective=True, shadows=True, n_peel=4)
    args = (chunk_data, frame_bins.sph_zmin, lights, params, 0)
    t2_kernel_ms = event_ms(lambda: megakernel.mega_render_cuda(*args, **kw), 5)
    primary_only = megakernel.LightStack(
        lights.lparams[:1].contiguous(), lights.lrec,
        *(t[:1].contiguous() for t in lights[2:]))
    hit_ms = event_ms(lambda: megakernel.mega_render_cuda(
        chunk_data, frame_bins.sph_zmin, None, params, 0,
        **dict(kw, shadows=False)), 5)
    prim_ms = event_ms(lambda: megakernel.mega_render_cuda(
        chunk_data, frame_bins.sph_zmin, primary_only, params, 0, **kw), 5)
    print(f"  kernel (full frame) {t2_kernel_ms:.3f} ms against phase 4's opaque "
          f"{ao_kernel_ms:.3f} ms; split: closest hit + shading over the peels "
          f"{hit_ms:.3f} ms, primary walks +{prim_ms - hit_ms:.3f} ms, {K} AO "
          f"walks +{t2_kernel_ms - prim_ms:.3f} ms")
    t2 = band_check(megakernel, args, kw, frame_bins, f"[T2] on {card}",
                    lights=lights)
    peel_errs.append(t2["err"])
    del ren, args, chunk_data, lights, frame_bins, img, primary_only
    torch.cuda.empty_cache()

    potentials = potential_phases(card)
    print(json.dumps({"potentials": potentials}))
    analyses = analysis_phases(card)
    print(json.dumps({"analyses": analyses}))
    system = system_phases(card)
    print(json.dumps({"system": system}))
    host = host_analysis_phases(card)
    print(json.dumps({"host": host}))
    native = native_phases(card)
    print(json.dumps({"native": native}))
    scaleout = scaleout_phases(card)
    print(json.dumps({"scaleout": scaleout}))

    print(json.dumps({"kernels": [{
        "name": "mega_render",
        "route": "cuda",
        "source": "mdapy_tpu_torch/csrc/mega_render.cu",
        "replaces": "mdapy_tpu/render/megakernel.py:156",
        "launches": (launches + ao_launches + box_launches + c2_launches
                     + t1_launches + t2_launches + t3_launches
                     + b1f["launches"] + host["BL1"]["config3_frame"]["launches"]
                     + scaleout["D1"]["launches"]),
        "bl1_launches": host["BL1"]["config3_frame"]["launches"],
        "sharded_routes": ["distributed.render_image_mega_sharded",
                           "multihost.render_image_mega_hier"],
        "sharded_launches": scaleout["D1"]["launches"],
        "sharded_warm_ms": scaleout["D1"]["sharded"]["warm_ms"],
        "hier_warm_ms": scaleout["D1"]["hier"]["warm_ms"],
        "sharded_one_shot_ms": scaleout["D1"]["one_shot_ms"],
        "max_abs_err": max(errs + peel_errs),
        "ms": b_head["ms"],
        "plain_ms": b_head["plain_ms"],
        "bound_ms": b_head["bound_ms"],
        "bound_by": b_head["bound_by"],
        "library_ms": None,
        "ao_ms": b_ao["ms"],
        "ao_plain_ms": b_ao["plain_ms"],
        "ao_bound_ms": b_ao["bound_ms"],
        "ao_bound_by": b_ao["bound_by"],
        "config3_cell_ms": b_box["ms"],
        "config3_cell_plain_ms": b_box["plain_ms"],
        "config3_cell_bound_ms": b_box["bound_ms"],
        "config3_cell_bound_by": b_box["bound_by"],
        "config2_ms": b_c2["ms"],
        "config2_plain_ms": b_c2["plain_ms"],
        "config2_bound_ms": b_c2["bound_ms"],
        "config2_bound_by": b_c2["bound_by"],
        "banded_route": "megakernel.render_image_mega_banded",
        "banded_launches": b1f["launches"],
        "banded_launches_per_frame": b1f["per_frame"],
        "banded_warm_ms": b1f["warm_ms"],
        "banded_peak_bytes": b1f["peak"],
        "banded_s1_max_abs_diff": b1f["s1_max_abs"],
        "banded_s1_pixels_over_tol": b1f["s1_over"],
        "banded_s1_witness_tiles": b1f["witness_tiles"],
        "banded_s1_witness_kernel_flips": b1f["witness_kernel_flips"],
        "banded_s1_witness_plain_flips": b1f["witness_plain_flips"],
        "banded_s1_witness_both": b1f["witness_both"],
        "peel_launches": t1_launches + t2_launches + t3_launches,
        "peel_launches_per_frame": max(t1_per_frame, t2_per_frame, t3_per_frame),
        "peel_max_abs_err": max(peel_errs),
        "peel_ms": t1["ms"],
        "peel_plain_ms": t1["plain_ms"],
        "peel_bound_ms": t1["bound_ms"],
        "peel_bound_by": t1["bound_by"],
        "peel_config3_ms": t2["ms"],
        "peel_config3_plain_ms": t2["plain_ms"],
        "peel_config3_bound_ms": t2["bound_ms"],
        "peel_config3_bound_by": t2["bound_by"],
        "peel_config2_ms": t3["ms"],
        "peel_config2_plain_ms": t3["plain_ms"],
        "peel_config2_bound_ms": t3["bound_ms"],
        "peel_config2_bound_by": t3["bound_by"],
        "registers": {k: v["registers"] for k, v in variants.items()},
        "local_bytes": {k: v["local_bytes"] for k, v in variants.items()},
        "blocks_per_sm": {k: v["blocks_per_sm"] for k, v in variants.items()},
        "records_per_lit_ray": {
            "headline": work3.get("record", 0) / max(1, work3.get("lit", 0)),
            "T1": work_t1.get("record", 0) / max(1, work_t1.get("lit", 0))},
    }, {
        "name": "closest_hit_spheres_tiles",
        "route": "cuda",
        "source": "mdapy_tpu_torch/csrc/tile_kernels.cu",
        "replaces": "mdapy_tpu/render/pallas_kernels.py:97",
        "launches": launches8["closest_hit_spheres_tiles"]
        + launches7["closest_hit_spheres_tiles"],
        "launches_per_frame": per_frame8["closest_hit_spheres_tiles"],
        "heavy_bond_launches_per_frame": per_frame7,
        "max_abs_err": max(tile_errs["closest_hit_spheres_tiles"]),
        "ms": b2_ms,
        "plain_ms": t_b2_plain * 1e3,
        "bound_ms": b2_bound_ms,
        "bound_by": b2_by,
        "library_ms": None,
        "frame_ms": b2_frame_ms,
        "heavy_bond_frame_ms": b2_heavy_ms,
        **tile_attrs["closest_hit"],
    }, {
        "name": "shadow_filter_tiles",
        "route": "cuda",
        "source": "mdapy_tpu_torch/csrc/tile_kernels.cu",
        "replaces": "mdapy_tpu/render/pallas_kernels.py:220",
        "launches": launches8["shadow_filter_tiles"],
        "launches_per_frame": per_frame8["shadow_filter_tiles"],
        "max_abs_err": max(tile_errs["shadow_filter_tiles"]),
        "ms": b3_ms,
        "plain_ms": t_b3_plain * 1e3,
        "bound_ms": b3_bound_ms,
        "bound_by": b3_by,
        "library_ms": None,
        "frame_ms": b3_frame_ms,
        "relit_ms": b3r_ms,
        "relit_plain_ms": t_b3r_plain * 1e3,
        "relit_bound_ms": b3r_bound_ms,
        "relit_bound_by": b3r_by,
        "filter_kernel": tile_attrs["shadow_filter"],
        "walk_kernel": tile_attrs["shadow_walk"],
    }, image_out_entry, chunk_gather_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
