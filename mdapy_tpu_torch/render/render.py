"""TachyonRender — user-facing renderer front end on PyTorch.

Port of ``mdapy_tpu/render/render.py`` (``TachyonRender`` :75, ``render``
:164, ``render_system`` :774, ``_default_colors`` :54): spheres, bond and
box-edge cylinders with their ring caps, opaque or translucent, one
directional light with shadows, AA, and ambient occlusion: exact below
``AO_EXACT_MAX_SPHERES`` padded spheres, fast above.  ``backend="cuda"``
runs the acceleration builds as torch ops on the card and the frame through
the hand CUDA kernels; ``backend="cpu"`` runs the same builds on the CPU and
the kernels' plain torch versions, in float32.

A frame takes one of four routes, as the JAX renderer picks them
(render.py:330-750): the one-shot megakernel (``megakernel.render_image_mega``,
or ``render_image_mega_banded`` past ``RECORD_BUDGET_BYTES`` of candidate
records); past its limits for cylinders and rings — more than
``OTHER_TILE_MAX`` candidates in a tile, or more than ``OTHER_SHADOW_MAX``
live ones with shadows — the tiled tracer
``tracer_tiled.render_image_pallas`` in bands of tile rows (chunked sphere
closest-hit kernel, dense cylinder/ring merge, light-grid shadow pass over
all three kinds); for a scene with cylinders or rings but no live sphere, or
with ``use_pallas`` off, ``tracer_tiled.render_image_tiled``; and the exact
tracer ``tracer.render_image`` (every ray against every primitive, in
torch ops): AO on at most ``AO_EXACT_MAX_SPHERES`` padded spheres, AO or
transparency off the megakernel, and every frame with ``use_tiling`` off.
It runs in float32 on the card and in float64 with ``backend="cpu"``, as
the JAX renderer runs it (render.py:236).

Transparency (``render.py:237-240, 642-645``): any alpha < 1 on an atom,
a bond colour or the box colour turns it on for the frame, and the
megakernel peels up to ``max_trans`` (4) layers, or composites one
(``peel1``) when ``max_trans`` is 1.

Fast AO (``render.py:551-637``): 2*K2 directional sky lights, K2 =
ao_samples // 2 Fibonacci hemisphere directions and their opposites, each
with its own light-grid CSR records and cylinder/ring occluder table, join
the primary light in the same launch, so one closest-hit traversal serves
them all.  Their structures are world-space and keyed by the scene alone,
so a camera move reuses them.  Where the JAX renderer builds them light by
light, ``build_ao_lights`` builds them together, in batched passes of torch
ops that read from the device once for a scene of spheres, to the same bits.

The JAX renderer's tuning knob ``MDAPY_TPU_AO_MODE`` (exact or fast AO
whatever the scene's size) is not ported: the sphere count alone picks.
"""

from __future__ import annotations

import hashlib
import time
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..core.elements import ele_radius, ele_rgb, type_rgb
from .accel import (
    PAIR_BYTES, bin_light_group, build_light_bins, build_light_records,
    build_screen_bins, frame_light_batch, gather_other_records,
    light_group_bins, light_group_records, light_rows, occluder_records,
    other_table, split_light_batch,
)
from .camera import CameraParams, auto_camera, camera_frame, preset_camera
from .config import RenderConfig
from .gather import gather_chunk_data_banded
from .geometry import bond_edges as _bond_edges
from .geometry import box_edges as _box_edges
from .image_out import host_image, image_out_rgba
from .megakernel import (
    TILE_PX, OtherRecords, build_mega_params, render_image_mega,
    render_image_mega_banded, stack_lights,
)
from .scene import build_scene
from .tracer import render_image as render_image_exact
from .tracer_tiled import render_image_pallas_banded, render_image_tiled

__all__ = ["TachyonRender", "CameraParams", "preset_camera", "build_ao_lights",
           "save_image", "load_image"]

LIGHT_GRID = 32        # shadow grid cells per side, as the JAX renderer uses
# bytes of (nb, nchunks, 8, 128) f32 candidate records one frame may gather
# at once; past it the megakernel renders in bands of tile rows, each band
# gathering at most this much (render_image_mega_banded), and
# render_image_pallas gathers each of its bands' records
RECORD_BUDGET_BYTES = 16 << 30
# bytes of transient (light, cell, sphere) pair data one pass of
# build_ao_lights may hold (accel.PAIR_BYTES a pair); past it the sky lights
# are binned in groups of consecutive lights, each within it
AO_BATCH_BUDGET_BYTES = 1 << 30
# padded sphere counts up to this take the exact AO tracer; fast AO applies
# above it (render.py:330-334)
AO_EXACT_MAX_SPHERES = 20000
# the JAX renderer's megakernel limits for cylinders and rings
# (render.py:424-431): cyl/ring candidates in one tile, and live cylinders +
# rings when shadows or AO test them as occluders
OTHER_TILE_MAX = 512
OTHER_SHADOW_MAX = 8192


def _fib_hemisphere(k: int) -> np.ndarray:
    """k stratified unit directions on the upper hemisphere (Fibonacci)."""
    i = np.arange(k, dtype=np.float64) + 0.5
    phi = i * (np.pi * (3.0 - np.sqrt(5.0)))
    z = i / k
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def build_ao_lights(scene, ao_samples: int, ao_brightness: float,
                    rmax: float, grid: int = LIGHT_GRID, table=None) -> list:
    """The fast-AO sky lights as ``stack_lights`` extra entries
    ``(lrow, lrec, loffs, lcnt, lkmax, occ)``: the K2 = ao_samples // 2
    hemisphere directions, then their opposites, each of weight 4 / (2 K2) *
    ao_brightness (``render.py:569-626``).  ``occ`` is the light's cylinder
    and ring occluder table when ``table`` (``accel.other_table``) is given,
    else None.

    The lights are built together, equal to what ``build_light_bins``,
    ``build_light_records`` and ``light_rows`` give each alone: one pass
    frames every light and reads their frames and pair counts to the host
    (``accel.frame_light_batch``), then the lights are binned and their
    records gathered in groups of at most ``AO_BATCH_BUDGET_BYTES`` of
    transient pair data (one group at the render demo's size), each group in
    one pass of torch ops with no read from the device.  Each entry's
    tensors are views into its group's, its ``loffs`` counted from its own
    first record.

    The frames and each group's bins are built in spans
    "ao_accel_build/bins", each group's records, occluder tables and rows
    in "ao_accel_build/records"; the counters "ao.lights_built",
    "ao.light_batches" (the groups) and "ao.record_bytes" (the bytes of the
    tensors the lights keep: records, CSR offsets and counts, cell key
    maxima, occluder tables) size the build (``tracing``)."""
    k2 = max(1, int(ao_samples) // 2)
    hemi = _fib_hemisphere(k2)
    dirs = np.concatenate([hemi, -hemi], axis=0)
    with tracing.span("ao_accel_build/bins"):
        batch = frame_light_batch(scene, dirs, grid)
    lightcol = (4.0 / (2 * k2)) * float(ao_brightness)
    rows = light_rows(dirs, batch.frames, lightcol, rmax)
    lights = []
    for members in split_light_batch(batch.pairs[:, 0],
                                     AO_BATCH_BUDGET_BYTES // PAIR_BYTES):
        with tracing.span("ao_accel_build/bins"):
            group = bin_light_group(batch, members)
        with tracing.span("ao_accel_build/records"):
            for j, rec in zip(members, light_group_records(batch, group, scene)):
                occ = (occluder_records(table, light_group_bins(batch, group, j))
                       if table is not None else None)
                lights.append((rows[j], *rec, occ))
        tracing.count("ao.light_batches", 1)
    tracing.count("ao.lights_built", len(lights))
    tracing.count("ao.record_bytes", sum(t.nbytes for light in lights
                                         for t in light[1:] if t is not None))
    return lights


def save_image(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def load_image(path: str) -> np.ndarray:
    """An image file as an (H, W, 4) uint8 RGBA array (the JAX renderer's
    ``load_image``, ``mdapy_tpu/render/render.py:48-51``)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGBA"))


def _default_colors(system) -> np.ndarray:
    """Jmol palette by element, type palette fallback (render.py:54-69)."""
    n = system.N
    if "element" in system.data.columns:
        elems = np.asarray(system.data["element"]).astype(str)
        rgb = np.array(
            [ele_rgb.get(e, [int(255 * 0.7)] * 3) for e in elems], dtype=np.float32
        ) / 255.0
    elif "type" in system.data.columns:
        t = np.asarray(system.data["type"]) % 9
        rgb = np.array(
            [type_rgb.get(int(v), [int(255 * 0.7)] * 3) for v in t], dtype=np.float32
        ) / 255.0
    else:
        rgb = np.full((n, 3), 0.7, dtype=np.float32)
    return np.c_[rgb, np.ones(n)].astype(np.float32)


def _fingerprint(h, a: np.ndarray) -> None:
    """Feed a sample of ``a`` to the hash: head, tail and a ~256 KB stride
    sample (the JAX renderer's cache key; an in-place edit that misses every
    sampled byte is the documented hazard)."""
    b = a.reshape(-1).view(np.uint8)
    h.update(b[:4096])
    h.update(b[-4096:])
    h.update(np.ascontiguousarray(b[::max(1, b.size // 262144)]))
    h.update(str(a.shape).encode())


def _scene_aabb(scene):
    """World-space AABB over the spheres (padding included, as the JAX
    front end takes it) and the live cylinders and rings (render.py:504-527)."""
    lo = (scene.sph_center - scene.sph_radius[:, None]).min(dim=0).values
    hi = (scene.sph_center + scene.sph_radius[:, None]).max(dim=0).values
    cmid = scene.cyl_base + 0.5 * scene.cyl_axis
    cext = (0.5 * torch.linalg.norm(scene.cyl_axis, dim=-1)
            + torch.clamp(scene.cyl_radius, min=0.0))
    lv = (scene.cyl_radius > 0)[:, None]
    lo = torch.minimum(lo, torch.where(lv, cmid - cext[:, None], 1e30).min(0).values)
    hi = torch.maximum(hi, torch.where(lv, cmid + cext[:, None], -1e30).max(0).values)
    rv = (scene.ring_rout > 0)[:, None]
    rr = scene.ring_rout[:, None]
    lo = torch.minimum(lo, torch.where(rv, scene.ring_center - rr, 1e30).min(0).values)
    hi = torch.maximum(hi, torch.where(rv, scene.ring_center + rr, -1e30).max(0).values)
    return lo.cpu().numpy(), hi.cpu().numpy()


class _Phase:
    """A phase of one ``render`` call, open from one reading of the clock to
    the next: the same two readings give its ``last_timings`` entry and the
    ends of its span (``tracing``), and its end is the next phase's
    start."""

    __slots__ = ("_renderer", "_timings", "_name", "_start", "_span")

    def __init__(self, renderer, timings: dict, name: str, start_ns=None):
        self._renderer, self._timings, self._name = renderer, timings, name
        self._start = time.perf_counter_ns() if start_ns is None else start_ns
        self._span = tracing.span(name, self._start)

    def end(self) -> int:
        """Waits for the card where phases are printed, then ends the
        phase; returns the clock's reading."""
        self._renderer._sync()
        now = time.perf_counter_ns()
        self._timings[self._name] = (now - self._start) * 1e-9
        self._span.close(now)
        return now

    def next(self, name: str) -> "_Phase":
        return _Phase(self._renderer, self._timings, name, self.end())


class TachyonRender:
    """Ray tracer with the reference renderer's look, on PyTorch.

    Parameters mirror ``mdapy_tpu.TachyonRender``.  ``backend`` is "cuda"
    (the hand kernels; raises when no card is visible), "cpu" (their plain
    torch versions, f32), "gpu" (the reference renderer's name for "cuda")
    or "auto" ("cuda" when a card is visible, else "cpu"); the resolved
    name is ``self.backend``.  ``verbosity`` "timing" or "debug" prints the
    resolved backend and, after each ``render``, its phases; every
    ``render`` fills ``last_timings`` with host seconds per phase
    ("prepare", "scene_build", "accel_build", "ao_accel_build", "trace",
    "image_out", the JAX renderer's names), the card synchronised at each
    phase's end at those verbosities only.  Under ``tracing.recording()``
    each call is a span "render" holding a span per phase ("ao_accel_build"
    inside "accel_build", whose ``last_timings`` entry leaves it out, and
    inside it "ao_accel_build/bins" and "ao_accel_build/records", with the
    counters "ao.lights_built", "ao.light_batches" and "ao.record_bytes":
    ``build_ao_lights``)
    and the spans "scene_build/fingerprint", "image_out/pack" (the RGBA image
    built on the render device: the launch of ``csrc/image_out.cu`` on the
    card, its plain version on the CPU) and "image_out/fetch" (the RGBA
    image's copy to the host), and the counter "image_out.fetch_bytes"
    (the bytes copied from the card to the host image; none under
    ``device_output`` or on the CPU, where nothing is copied).

    The JAX renderer's attributes ``use_tiling`` (True; False sends every
    frame to the exact tracer) and ``use_pallas`` (False sends the frames
    that would take the megakernel or ``render_image_pallas`` to
    ``render_image_tiled``, or with AO or transparency to the exact tracer)
    are there.  ``use_pallas`` is True on both backends: the JAX renderer
    turns it off on its CPU backend, where its kernels would run in the
    Pallas interpreter, while the port's CPU backend runs their plain
    versions."""

    def __init__(
        self,
        backend: str = "cuda",
        antialiasing: bool = True,
        aa_samples: int = 12,
        ao: bool = True,
        ao_samples: int = 12,
        ao_brightness: float = 0.8,
        ao_max_dist: float = 3.402823e38,
        shadows: bool = True,
        direct_light_intensity: float = 0.9,
        background: tuple = (0.0, 0.0, 0.0),
        seed: int = 0,
        verbosity: str = "min",
    ):
        asked = backend.lower().strip()
        if asked not in ("cuda", "cpu", "gpu", "auto"):
            raise ValueError(
                f"backend must be 'cuda', 'cpu', 'gpu' or 'auto', got {backend!r}")
        if verbosity not in ("min", "timing", "debug"):
            raise ValueError("verbosity must be 'min', 'timing' or 'debug'")
        backend = {"gpu": "cuda", "auto": "cuda" if torch.cuda.is_available()
                   else "cpu"}.get(asked, asked)
        if backend == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"TachyonRender(backend={asked!r}) needs a CUDA device, and "
                "torch.cuda.is_available() is False"
            )
        self._backend = backend
        self.verbosity = verbosity
        self.last_timings: dict = {}
        if verbosity != "min":
            print(f"[TachyonRender] backend {asked!r} -> {backend!r}")
        self._device = torch.device("cuda" if backend == "cuda" else "cpu")
        bg = tuple(float(v) for v in background)
        self._bg_a = bg[3] if len(bg) > 3 else 1.0
        self._cfg = RenderConfig(
            aa_samples=int(aa_samples),
            aa_enabled=bool(antialiasing),
            ao_samples=int(ao_samples),
            ao_enabled=bool(ao),
            shadows_enabled=bool(shadows),
            direct_light_enabled=True,
            ao_brightness=float(ao_brightness),
            ao_max_dist=float(ao_max_dist),
            direct_light_intensity=float(direct_light_intensity),
            background=bg[:3],
        )
        self._seed = int(seed)
        self.use_tiling = True
        self.use_pallas = True
        self._input_refs = None
        self._scene_key = None
        self._scene = None
        self._accel_key = None
        self._accel = None
        self._other = None
        self._route_name = None
        self._ao_key = None
        self._ao = None
        self._exact = None

    @property
    def backend(self) -> str:
        return self._backend

    def __repr__(self) -> str:
        return (f"TachyonRender(backend={self._backend!r}, "
                f"ao={self._cfg.ao_enabled}, aa={self._cfg.aa_enabled})")

    # ------------------------------------------------------------------
    def _scene_for(self, arrays, geom):
        """Scene tensors, rebuilt only when the inputs change.

        ``arrays`` = (positions, colors, radii, bond_edges, bond_colors,
        box_edges) as the caller passed them (None where absent), ``geom``
        the other scene parameters.  The same array objects and parameters
        as the last call reuse the scene with no hashing at all (the JAX
        renderer's identity fast path; the cache holds references, so the
        ids stay valid, and an in-place edit of a cached array is the
        documented hazard).  Other arrays are keyed by a sampled
        fingerprint."""
        if self._input_refs is not None and geom == self._input_refs[1] and all(
                a is b for a, b in zip(arrays, self._input_refs[0])):
            return self._scene_key, self._scene
        h = hashlib.sha1()
        with tracing.span("scene_build/fingerprint"):
            for a in arrays:
                if a is not None:
                    _fingerprint(h, np.ascontiguousarray(a))
                else:
                    h.update(b"none")
            h.update(repr(geom).encode())
            key = h.hexdigest()
        if key != self._scene_key:
            positions, colors, radii, bonds, bond_colors, box = arrays
            bond_radius, bond_color, box_edge_radius, box_color = geom
            if bonds is not None and bond_colors is None:
                bc = tuple(float(v) for v in bond_color)
                bond_colors = np.tile(np.array(
                    [bc[0], bc[1], bc[2], bc[3] if len(bc) > 3 else 1.0],
                    dtype=np.float32), (bonds.shape[0], 1))
            # any alpha < 1 turns transparency peeling on (render.py:237-240)
            alpha = (bool(np.any(colors[:, 3] < 1.0))
                     or (bond_colors is not None
                         and bool(np.any(np.asarray(bond_colors)[:, 3] < 1.0)))
                     or (len(box_color) > 3 and box_color[3] < 1.0))
            self._build_args = dict(
                positions=positions, colors=colors, radii=radii,
                bond_edges=bonds, bond_colors=bond_colors,
                bond_radius=bond_radius, box_edges=box,
                box_edge_radius=box_edge_radius, box_color=box_color)
            scene = build_scene(**self._build_args, device=self._device)
            lo, hi = _scene_aabb(scene)
            n_other = int((scene.cyl_radius > 0).sum()
                          + (scene.ring_rout > 0).sum())
            n_sph = int((scene.sph_radius > 0).sum())
            table = other_table(scene) if n_other else None
            self._scene = (scene, lo, hi, table, n_other, n_sph, alpha)
            self._scene_key = key
            self._accel_key = self._accel = self._exact = None
        self._input_refs = (arrays, geom)
        return self._scene_key, self._scene

    def _ao_for(self, scene_key, scene, radii, table):
        """The AO sky lights with their occluder tables, rebuilt only when
        the scene changes (the tables are world-space, as the JAX renderer's
        scene-keyed AO cache holds them, render.py:563-626)."""
        if scene_key != self._ao_key:
            phase = _Phase(self, self.last_timings, "ao_accel_build")
            cfg = self._cfg
            rmax = float(radii.max()) if len(radii) else 0.0
            self._ao = build_ao_lights(scene, cfg.ao_samples, cfg.ao_brightness,
                                       rmax, grid=LIGHT_GRID, table=table)
            self._ao_key = scene_key
            phase.end()
        return self._ao

    def _sync(self) -> None:
        """Wait for the card at a phase's end when phases are printed, so
        that ``last_timings`` holds the card's time and not the enqueue's."""
        if self.verbosity != "min" and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def _route(self, bins, n_other: int, n_sph: int, alpha: bool) -> str:
        """The renderer a frame takes, as the JAX renderer picks it
        (render.py:391-445, 690-750): "mega" (the megakernel), "pallas"
        (``render_image_pallas``, past the megakernel's limits for cylinders
        and rings), "tiled" (``render_image_tiled``: a scene of cylinders
        and rings without a live sphere, or ``use_pallas`` off) or "exact"
        (the exact tracer: AO or a translucent scene, ``alpha``, off the
        megakernel)."""
        cfg = self._cfg
        mega = self.use_pallas and (n_sph or not n_other) and not (
            n_other and (bins.k_other > OTHER_TILE_MAX or (
                (cfg.shadows_enabled or cfg.ao_enabled)
                and n_other > OTHER_SHADOW_MAX)))
        if mega:
            return "mega"
        if cfg.ao_enabled or alpha:
            return "exact"
        return "pallas" if self.use_pallas and n_sph else "tiled"

    def _exact_scene(self):
        """The scene the exact tracer takes: the render scene on the card,
        and on the CPU the same scene in float64 (render.py:236), built
        once per scene."""
        if self._device.type == "cuda":
            return self._scene[0]
        if self._exact is None:
            self._exact = build_scene(**self._build_args,
                                      dtype=torch.float64, device="cpu")
        return self._exact

    def _accel_for(self, scene_key, scene_entry, camera, width, height, radii):
        """Per-view structures, rebuilt only when the scene or view changes:
        (route, accel, other).  For the megakernel ``accel`` is (frame, bins,
        chunk_data, lights, params) and ``other`` its cylinders and rings
        with their occluder tables; for the tiled tracer ``accel`` is
        (frame, bins, chunk_data, lb), ``lb`` with the light cells of every
        kind, and ``other`` the tiles' cylinder and ring records."""
        key = (scene_key, repr((camera.__dict__, width, height)),
               self.use_pallas)
        if key == self._accel_key:
            return self._route_name, self._accel, self._other
        scene, lo, hi, table, n_other, n_sph, alpha = scene_entry
        cfg = self._cfg
        frame = camera_frame(camera, width, height)
        bins = build_screen_bins(scene, frame, width, height, TILE_PX)
        route = self._route(bins, n_other, n_sph, alpha)
        if route == "exact":
            self._accel, self._other = (frame,), None
            self._route_name, self._accel_key = route, key
            return route, self._accel, None
        nb, nchunks, ch = bins.sph_chunks.shape
        # past the budget the megakernel and render_image_pallas gather
        # each band's records as they render it (chunk_data None); within
        # it the frame's records are gathered once: on the card by one
        # kernel launch that writes the whole result, on the CPU a band of
        # tiles at a time, so the plain gather's peak stays near the
        # records' own size
        one_shot = nb * nchunks * ch * 32 <= RECORD_BUDGET_BYTES
        lb = build_light_bins(scene, frame["light_dir"], grid=LIGHT_GRID,
                              other_kinds=route != "mega")
        chunk_data = (gather_chunk_data_banded(
            bins.sph_chunks, scene.sph_center, scene.sph_radius,
            scene.sph_color) if one_shot and (n_sph or route == "mega")
            else None)
        if route != "mega":
            # a scene on these routes has cylinders or rings, so its shadows
            # take the light cells of three kinds: the light-grid kernel
            # (``light_records``) knows spheres only, and a sphere-only scene
            # always takes the megakernel (render.py:702-707)
            other = OtherRecords(*gather_other_records(bins, table))
            self._accel = (frame, bins, chunk_data, lb)
            self._other, self._route_name, self._accel_key = other, route, key
            return route, self._accel, other
        params = build_mega_params(frame, lb, lo, hi, cfg)
        extra = (self._ao_for(scene_key, scene, radii, table)
                 if cfg.ao_enabled else None)
        lights = other = None
        if cfg.shadows_enabled or extra:
            # with AO and no shadows the primary light gets an empty CSR and
            # the sweeps stay on for the sky lights (render.py:627-637)
            primary = (build_light_records(lb, scene) if cfg.shadows_enabled
                       else (None, None, None, None))
            lights = stack_lights(params, *primary, extra_lights=extra,
                                  grid_n=LIGHT_GRID, device=self._device)
        if table is not None:
            occ = None
            if lights is not None:
                # the primary light's table is tested whenever the sweeps
                # run, so with AO and shadows off the cylinders still shadow
                # the primary light, as in the JAX renderer (render.py:
                # 502, 627-637, megakernel.py:1995)
                occ = torch.stack([occluder_records(table, lb)]
                                  + [e[5] for e in extra or ()])
            other = OtherRecords(*gather_other_records(bins, table), occ)
        self._accel = (frame, bins, chunk_data, lights, params)
        self._other, self._route_name, self._accel_key = other, route, key
        return route, self._accel, other

    def _render_tiled(self, route: str, accel, other, width: int, height: int):
        """The frame through the tiled tracer -> (height, width, 3) f32.

        "pallas": in the JAX renderer's bands of tile rows
        (``render_image_pallas_banded``); "tiled": ``render_image_tiled``."""
        frame, bins, chunk_data, lb = accel
        scene, cfg = self._scene[0], self._cfg
        cam = (frame["origin"], frame["lowleft"], frame["iplaneright"],
               frame["iplaneup"], frame["view"], frame["light_dir"])
        if route == "tiled":
            return render_image_tiled(
                scene, bins, lb, *cam, cfg, width, height,
                bool(frame["perspective"]), self._seed, bins.tile_px,
                bins.tiles_x, bins.tiles_y, chunk_data=chunk_data, other=other)
        return render_image_pallas_banded(
            scene, bins, chunk_data, lb, frame, cfg, width, height,
            self._seed, other=other)

    def render(
        self,
        positions: np.ndarray,
        colors: np.ndarray,
        radii: np.ndarray,
        camera: Optional[CameraParams] = None,
        bond_edges: Optional[np.ndarray] = None,
        bond_colors: Optional[np.ndarray] = None,
        bond_radius: float = 0.1,
        bond_color: tuple = (0.8, 0.8, 0.8, 1.0),
        box_edges: Optional[np.ndarray] = None,
        box_edge_radius: float = 0.05,
        box_color: tuple = (1.0, 1.0, 1.0, 1.0),
        width: int = 800,
        height: int = 600,
        output_figure: Optional[str] = None,
        transparent: bool = False,
        device_output: bool = False,
    ):
        """Render spheres + optional bond/box cylinders -> (H, W, 4) uint8
        RGBA numpy (truncating quantizer), a fresh array each call: the
        image is built on the render device (``image_out.image_out_rgba``)
        and copied to the host whole.

        ``device_output=True`` returns the rounded (H, W, 3) uint8 frame as
        a tensor on the render device, with no host round trip — the serving
        path when the consumer lives on the device.  It does so on every
        route; the JAX renderer offers it on the megakernel route only
        (render.py:687-689) and returns the host image on the others.
        ``last_timings`` gets the host seconds of each phase."""
        timings: dict = {}
        self.last_timings = timings
        with tracing.span("render"):
            phase = _Phase(self, timings, "prepare")
            positions = np.ascontiguousarray(positions, dtype=np.float64)
            colors = np.ascontiguousarray(colors, dtype=np.float32)
            radii = np.ascontiguousarray(radii, dtype=np.float32)
            if positions.ndim != 2 or positions.shape[1] != 3:
                raise ValueError(f"positions must be (N,3), got {positions.shape}")
            if colors.ndim != 2 or colors.shape[1] != 4:
                raise ValueError(f"colors must be (N,4), got {colors.shape}")
            if radii.ndim != 1:
                raise ValueError(f"radii must be (N,), got {radii.shape}")
            if bond_edges is not None:
                bond_edges = np.ascontiguousarray(bond_edges, dtype=np.float64)
                if bond_edges.ndim != 3 or bond_edges.shape[1:] != (2, 3):
                    raise ValueError(f"bond_edges must be (K,2,3), got {bond_edges.shape}")
                if bond_edges.shape[0] == 0:
                    bond_edges = bond_colors = None
            if box_edges is not None:
                box_edges = np.ascontiguousarray(box_edges, dtype=np.float64)
                if box_edges.shape[0] == 0:
                    box_edges = None
            if camera is None:
                camera = auto_camera(
                    positions, max_radius=float(radii.max()) if len(radii) else 0.0)

            cfg = self._cfg
            phase = phase.next("scene_build")
            scene_key, entry = self._scene_for(
                (positions, colors, radii, bond_edges, bond_colors, box_edges),
                (float(bond_radius), tuple(bond_color), float(box_edge_radius),
                 tuple(box_color)))
            scene = entry[0]
            if not self.use_tiling or (
                    cfg.ao_enabled
                    and scene.sph_center.shape[0] <= AO_EXACT_MAX_SPHERES):
                phase = phase.next("trace")
                # exact AO on small scenes, and every frame without tiling,
                # need no acceleration structure (render.py:330-341)
                route, accel = "exact", (camera_frame(camera, int(width),
                                                      int(height)),)
                self._route_name, self._accel_key = route, None
            else:
                phase = phase.next("accel_build")
                route, accel, other = self._accel_for(
                    scene_key, entry, camera, int(width), int(height), radii)
                phase = phase.next("trace")
                timings["accel_build"] -= timings.get("ao_accel_build", 0.0)
            if route == "exact":
                frame = accel[0]
                with torch.no_grad():
                    img_f = render_image_exact(
                        self._exact_scene(), frame["origin"], frame["lowleft"],
                        frame["iplaneright"], frame["iplaneup"], frame["view"],
                        frame["light_dir"], cfg._replace(transparency=entry[6]),
                        int(width), int(height), bool(frame["perspective"]),
                        self._seed)
            elif route == "mega":
                frame, bins, chunk_data, lights, params = accel
                S = (cfg.aa_samples if cfg.aa_enabled else 0) + 1
                # a translucent frame peels max_trans layers, or composites one
                # when that is 1 (render.py:642-645)
                peel1 = entry[6] and cfg.max_trans == 1
                n_peel = cfg.max_trans if entry[6] and not peel1 else 1
                kw = dict(S=S, width=int(width), height=int(height),
                          grid_n=LIGHT_GRID, eps=cfg.eps,
                          perspective=bool(frame["perspective"]),
                          shadows=lights is not None, quantized=device_output,
                          other=other, n_peel=n_peel, peel1=peel1)
                if chunk_data is None:
                    img_f = render_image_mega_banded(
                        scene, bins, lights, params, self._seed,
                        max_band_bytes=RECORD_BUDGET_BYTES, **kw)
                else:
                    img_f = render_image_mega(
                        chunk_data, bins.sph_zmin, lights, params, self._seed,
                        tiles_x=bins.tiles_x, tiles_y=bins.tiles_y, **kw)
            else:
                img_f = self._render_tiled(route, accel, other, int(width),
                                           int(height))
            if device_output and route != "mega":
                img_f = torch.clamp(torch.round(img_f * 255.0), 0.0,
                                    255.0).to(torch.uint8)
            if device_output:
                phase.end()
                self._print_timings()
                return img_f

            phase = phase.next("image_out")
            alpha = int(np.uint8(max(0.0, min(1.0, self._bg_a)) * 255.0 + 0.5))
            bg = (np.array(cfg.background, dtype=np.float32) * 255.0
                  if transparent else None)
            with tracing.span("image_out/pack"):
                rgba = image_out_rgba(img_f, alpha, bg)
            with tracing.span("image_out/fetch"):
                img = host_image(rgba)
            phase.end()
            self._print_timings()
            if output_figure is not None:
                save_image(output_figure, img)
                return None
            return img

    def _print_timings(self) -> None:
        """The JAX renderer's per-render line at "timing" and "debug"."""
        if self.verbosity in ("timing", "debug"):
            t = self.last_timings
            phases = "  ".join(f"{k}={v:.3f}s" for k, v in t.items())
            print(f"[TachyonRender] {phases}  total={sum(t.values()):.3f}s")

    # ------------------------------------------------------------------
    def render_system(
        self,
        system,
        colors: Optional[np.ndarray] = None,
        radii: Optional[np.ndarray] = None,
        camera: Optional[CameraParams] = None,
        draw_bond: bool = False,
        bond: Optional[np.ndarray] = None,
        bond_radius: float = 0.1,
        bond_color: tuple = (0.8, 0.8, 0.8, 1.0),
        bond_color_mode: str = "uniform",
        draw_box: bool = True,
        box_edge_radius: float = 0.05,
        box_color: tuple = (1.0, 1.0, 1.0, 1.0),
        default_radius: float = 1.0,
        width: int = 800,
        height: int = 600,
        output_figure: Optional[str] = None,
        transparent: bool = False,
    ) -> Optional[np.ndarray]:
        """Render a System in one call (``render.py:774-839``).

        Reads ``system.get_positions()``, ``.box`` (``.matrix``, ``.origin``,
        ``.boundary``), ``.N``, ``.data`` (its ``"element"`` or ``"type"``
        column, when ``.data.columns`` lists one) and ``.bond``, so a JAX
        package ``System`` or any object with those works."""
        pos = system.get_positions()
        if colors is None:
            colors = _default_colors(system)
        colors = np.ascontiguousarray(colors, dtype=np.float32)
        if radii is not None:
            radii = np.ascontiguousarray(radii, dtype=np.float32)
        elif "element" in system.data.columns:
            radii = np.array(
                [
                    ele_radius.get(e, default_radius * 2) / 2
                    for e in np.asarray(system.data["element"]).astype(str)
                ],
                dtype=np.float32,
            )
        else:
            radii = np.full(system.N, default_radius, dtype=np.float32)

        box_e = _box_edges(system.box) if draw_box else None
        bond_e = None
        bond_c = None
        if draw_bond:
            if bond is None:
                if getattr(system, "bond", None) is None:
                    raise ValueError(
                        "draw_bond=True requires a bond array or system.create_bonds() first."
                    )
                bond = system.bond
            bond_e, bond_c = _bond_edges(
                pos, system.box, bond, colors, radii, bond_radius, bond_color_mode
            )
        return self.render(
            pos, colors, radii,
            camera=camera,
            bond_edges=bond_e,
            bond_colors=bond_c if bond_color_mode == "atom" else None,
            bond_radius=bond_radius,
            bond_color=bond_color,
            box_edges=box_e,
            box_edge_radius=box_edge_radius,
            box_color=box_color,
            width=width,
            height=height,
            output_figure=output_figure,
            transparent=transparent,
        )
