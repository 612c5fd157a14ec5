"""A/B timing of the port's frames on one CUDA card.

Draws, with the ``mdapy_tpu_torch`` and ``chip_smoke.py`` of the checkout
given as the first argument, the nine frames that ``chip_smoke.py``
measures and one more, each at 1920x1080 through
``TachyonRender(backend="cuda")``: the headline frame (phase 3), the same
with its cell's 12 edges as ``render_system`` draws them (the megakernel's
cylinder variant; not in ``chip_smoke.py``), its translucent variant T1,
the headline scene through the tiled tracer with light records (phase 8),
BASELINE config 2 (phase 5) and its translucent variant T3, the heavy-bond
frame (phase 7), config 3 (phase 4), config 3 with its cell (phase 6) and
config 3's translucent variant T2.  For each it prints the warm ms a frame (host clock
over ``WARM_FRAMES`` ``device_output=True`` frames after one untimed frame)
and the kernel ms of one frame: the megakernel's full frame (CUDA events,
5 launches), or for the two tiled-tracer frames the sum of the tile
kernels' launches in one frame.  Three rows time the tile kernels alone
on one band of the tiled headline frame (tile rows 17-33, 2,040 tiles x
3,328 rays), by CUDA events over 10 launches after one untimed: the
chunked closest hit (``b2_band``), the shadow filter under the preset's
light (``b3_band``, under 1 % of the rays lit) and lit from beside the
camera (``b3_relit``), each on the arguments the frame gives it, as
``chip_smoke.py`` phase 8 times them.  One JSON line ``AB {...}``
labelled with the second argument, after the megakernel's ptxas register
lines.

Compare two commits by unpacking each into a directory (``git archive``)
and running them in turns on one card, e.g. parent, change, change, parent:

    python3 tools/ab_torch_frames.py path/to/parent parent
    python3 tools/ab_torch_frames.py path/to/change change

``--frames headline,T1`` draws only the frames named.  ``--bounds`` prints
instead each megakernel frame's full-frame bound from the work its plain
version counts (``chip_smoke.frame_bound``; minutes for a translucent
frame), and ``--split`` the megakernel's ms without shadows and without the
occluder tables beside the whole kernel.
"""
import argparse
import json
import os
import re
import sys
import time

import numpy as np
import torch

ap = argparse.ArgumentParser()
ap.add_argument("checkout")
ap.add_argument("label")
ap.add_argument("--frames", default="")
ap.add_argument("--bounds", action="store_true")
ap.add_argument("--split", action="store_true")
opt = ap.parse_args()
if not torch.cuda.is_available():
    sys.exit("ab_torch_frames.py needs a CUDA card")
root = os.path.abspath(opt.checkout)
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs  # noqa: E402
from mdapy_tpu_torch import TachyonRender, preset_camera  # noqa: E402
from mdapy_tpu_torch.render import megakernel, tile_kernels, tracer_tiled  # noqa: E402
from mdapy_tpu_torch.render import render as trender  # noqa: E402
from mdapy_tpu_torch.render._build import load_all  # noqa: E402
from mdapy_tpu_torch.render.accel import build_light_bins, build_light_records  # noqa: E402
from mdapy_tpu_torch.render.geometry import bond_edges, box_edges  # noqa: E402

libs = load_all()
# ptxas: each megakernel variant's template flags and registers
flags = None
for line in libs["mega_render"].log.splitlines():
    m = re.search(r"mega_render_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E", line)
    if m and "Compiling entry" in line:
        flags = "".join(m.groups())
    elif flags and "Used" in line:
        regs = re.search(r"Used (\d+) registers", line).group(1)
        print(f"ptxas {opt.label} PERSP,SHADOWS,AO,OTHER,PEEL={flags}: {regs} "
              "registers", flush=True)
        flags = None
W, H = 1920, 1080
wanted = set(opt.frames.split(",")) if opt.frames else None
res = {"checkout": opt.label, "card": torch.cuda.get_device_name(0)}


def warm(fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(cs.WARM_FRAMES):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / cs.WARM_FRAMES * 1e3


def mega(name, ren, S, fn, other=False, n_peel=1):
    """Warm ms of fn's frames and the megakernel's full-frame ms (or, with
    --split, its split; with --bounds, its bound)."""
    if wanted is not None and name not in wanted:
        return
    w = warm(fn)
    _, fb, cd, lights, params = ren._accel
    kw = dict(S=S, tiles_x=fb.tiles_x, grid_n=32, eps=ren._cfg.eps,
              perspective=True, shadows=True, n_peel=n_peel)
    if other:
        kw["other"] = ren._other
    args = (cd, fb.sph_zmin, lights, params, 0)
    if opt.bounds:
        # the work the plain version counts on the whole frame, and its bound
        work = megakernel.plain_work(*args, **kw)
        cs.frame_bound(name, work, cs.event_ms(
            lambda: megakernel.mega_render_cuda(*args, **kw), 5),
            fb.sph_zmin.shape[0], other=kw.get("other"), lights=lights)
        return
    if opt.split:
        # the kernel without shadows, and (with cylinders) without the
        # occluder tables, beside the whole kernel
        split = {"kernel": cs.event_ms(
            lambda: megakernel.mega_render_cuda(*args, **kw), 5)}
        split["no_shadows"] = cs.event_ms(lambda: megakernel.mega_render_cuda(
            cd, fb.sph_zmin, None, params, 0, **dict(kw, shadows=False)), 5)
        if other:
            split["no_tables"] = cs.event_ms(
                lambda: megakernel.mega_render_cuda(*args, **dict(
                    kw, other=kw["other"]._replace(occ=None))), 5)
        res[name] = {"warm": w, **split}
    else:
        res[name] = (w, cs.event_ms(
            lambda: megakernel.mega_render_cuda(*args, **kw), 5))
    print(f"{name} {res[name]}", flush=True)


def tiled(name, fn, kernels):
    """Warm ms of fn's frames and the tile kernels' ms in one frame."""
    if opt.bounds or opt.split or (wanted is not None and name not in wanted):
        return
    w = warm(fn)
    recs = {k: cs.Recorder(getattr(tile_kernels, k)) for k in kernels}
    with cs.swapped(tile_kernels, **recs):
        fn()
    res[name] = (w, sum(r.total_ms() for r in recs.values()))
    print(f"{name} {res[name]}", flush=True)


def bands(scene, fb, cd, frame, cfg, lrec3):
    """The tile kernels alone on band 1 of the tiled headline frame: the
    closest hit, the shadow filter, and the shadow filter lit from beside
    the camera, each on the arguments the frame gives it.  The relit band
    is built here as ``chip_smoke.py`` phase 8 builds it, with what a
    parent checkout's ``chip_smoke.py`` also has."""
    names = ("b2_band", "b3_band", "b3_relit")
    if opt.bounds or opt.split or (wanted is not None and not wanted & set(names)):
        return
    recs = {k: cs.Recorder(getattr(tile_kernels, k))
            for k in ("closest_hit_spheres_tiles", "shadow_filter_tiles")}
    lb = build_light_bins(scene, frame["light_dir"], grid=32)
    with cs.swapped(tile_kernels, **recs):
        tracer_tiled.render_image_pallas_banded(
            scene, fb, cd, lb, frame, cfg, W, H, 0, light_records=lrec3)
    (hargs, hkw), (sargs, skw) = (r.calls[1] for r in recs.values())
    right = np.asarray(frame["iplaneright"], np.float64)
    L = -np.asarray(frame["view"]) + 0.8 * right / np.linalg.norm(right)
    frame_r = dict(frame, light_dir=L / np.linalg.norm(L))
    lb_r = build_light_bins(scene, frame_r["light_dir"], grid=32)
    rows = max(1, tracer_tiled.BAND_TILES // fb.tiles_x)
    ty0, ty1 = rows, min(fb.tiles_y, 2 * rows)
    b0, b1 = ty0 * fb.tiles_x, ty1 * fb.tiles_x
    rec_r = cs.Recorder(tile_kernels.shadow_filter_tiles)
    with cs.swapped(tile_kernels, shadow_filter_tiles=rec_r):
        tracer_tiled.render_image_pallas(
            scene, tracer_tiled.band_bins(fb, ty0, ty1), cd[b0:b1], lb_r,
            *(frame_r[k] for k in ("origin", "lowleft", "iplaneright",
                                   "iplaneup", "view", "light_dir")),
            cfg, W, (ty1 - ty0) * fb.tile_px, True, 0, fb.tile_px, fb.tiles_x,
            ty1 - ty0, ty_offset=ty0, do_flip=False,
            light_records=build_light_records(lb_r, scene))
    (rargs, rkw), = rec_r.calls
    for name, fn, args, kw in (
            ("b2_band", tile_kernels.closest_hit_spheres_tiles_cuda, hargs, hkw),
            ("b3_band", tile_kernels.shadow_filter_tiles_cuda, sargs, skw),
            ("b3_relit", tile_kernels.shadow_filter_tiles_cuda, rargs, rkw)):
        if wanted is None or name in wanted:
            res[name] = cs.event_ms(lambda: fn(*args, **kw), 10)
            print(f"{name} {res[name]}", flush=True)


# the headline scene: opaque, translucent (T1), through the tiled tracer
pos, colors, radii = cs.fcc_block(63)
cam = preset_camera("perspective", pos, max_radius=1.28)
ren = TachyonRender(backend="cuda", ao=False)
mega("headline", ren, 13, lambda: ren.render(
    pos, colors, radii, camera=cam, width=W, height=H, device_output=True))
cell1 = box_edges(cs.Cell(63 * 3.615))
ren_c = TachyonRender(backend="cuda", ao=False)
mega("headline_cell", ren_c, 13, lambda: ren_c.render(
    pos, colors, radii, camera=cam, box_edges=cell1, width=W, height=H,
    device_output=True), other=True)
del ren_c
if not (opt.bounds or opt.split):
    ren.render(pos, colors, radii, camera=cam, width=W, height=H,
               device_output=True)
    frame, fb, cd, lights, _ = ren._accel
    scene = ren._scene[0]
    lb = build_light_bins(scene, frame["light_dir"], grid=32)
    lrec3 = (lights.lrec, lights.loffs[0].contiguous(), lights.lcnt[0].contiguous())
    tiled("headline_tiled", lambda: tracer_tiled.render_image_pallas_banded(
        scene, fb, cd, lb, frame, ren._cfg, W, H, 0, light_records=lrec3),
        ("closest_hit_spheres_tiles", "shadow_filter_tiles"))
    bands(scene, fb, cd, frame, ren._cfg, lrec3)
    del frame, fb, cd, lights, scene, lb, lrec3
torch.cuda.empty_cache()
centre = 0.5 * (pos.min(0) + pos.max(0))
edge = float((pos.max(0) - pos.min(0)).max())
colors_t1 = colors.copy()
colors_t1[np.linalg.norm(pos - centre, axis=1) > 0.3 * edge, 3] = 0.3
ren = TachyonRender(backend="cuda", ao=False)
mega("T1", ren, 13, lambda: ren.render(
    pos, colors_t1, radii, camera=cam, width=W, height=H, device_output=True),
    n_peel=4)
torch.cuda.empty_cache()

# BASELINE config 2, its translucent variant T3, the heavy-bond frame
fe = cs.bcc_system(6)
pos2 = fe.get_positions()
rad2 = np.full(fe.N, 0.5, np.float32)
cam2 = preset_camera("perspective", pos2, max_radius=0.5)
colors2 = trender._default_colors(fe)
cell2 = box_edges(fe.box)
bonds2 = bond_edges(pos2, fe.box, fe.bond, colors2, rad2, 0.2)[0]
for name, alpha, n_peel in (("config2", 1.0, 1), ("T3", 0.4, 4)):
    cols = colors2.copy()
    cols[:, 3] = alpha
    ren = TachyonRender(backend="cuda", ao=False)
    mega(name, ren, 13, lambda: ren.render(
        pos2, cols, rad2, camera=cam2, bond_edges=bonds2, bond_radius=0.2,
        box_edges=cell2, width=W, height=H, device_output=True),
        other=True, n_peel=n_peel)
    torch.cuda.empty_cache()
fe7 = cs.bcc_system(7)
pos7 = fe7.get_positions()
rad7 = np.full(fe7.N, 0.5, np.float32)
cam7 = preset_camera("perspective", pos7, max_radius=0.5)
colors7 = trender._default_colors(fe7)
bonds7 = bond_edges(pos7, fe7.box, fe7.bond, colors7, rad7, 0.2)[0]
cell7 = box_edges(fe7.box)
ren = TachyonRender(backend="cuda", ao=False)
tiled("heavy_bond", lambda: ren.render(
    pos7, colors7, rad7, camera=cam7, bond_edges=bonds7, bond_radius=0.2,
    box_edges=cell7, width=W, height=H, device_output=True),
    ("closest_hit_spheres_tiles",))
torch.cuda.empty_cache()

# BASELINE config 3, with its cell, and its translucent variant T2
if wanted is None or wanted & {"config3", "config3_cell", "T2"}:
    pos3, grain = cs.voronoi_polycrystal()
    col3 = np.tile(np.array([[0.78, 0.5, 0.2, 1.0]], np.float32), (len(pos3), 1))
    rad3 = np.full(len(pos3), 1.28, np.float32)
    cam3 = preset_camera("perspective", pos3, max_radius=1.28)
    opts = dict(backend="cuda", ao=True, ao_samples=12, aa_samples=2,
                background=(1.0, 1.0, 1.0))
    ren = TachyonRender(**opts)
    mega("config3", ren, 3, lambda: ren.render(
        pos3, col3, rad3, camera=cam3, width=W, height=H, device_output=True))
    edges = box_edges(cs.Cell(230.0))
    mega("config3_cell", ren, 3, lambda: ren.render(
        pos3, col3, rad3, camera=cam3, box_edges=edges, width=W, height=H,
        device_output=True), other=True)
    torch.cuda.empty_cache()
    col_t2 = col3.copy()
    col_t2[grain != 0, 3] = 0.2
    ren = TachyonRender(**opts)
    mega("T2", ren, 3, lambda: ren.render(
        pos3, col_t2, rad3, camera=cam3, width=W, height=H, device_output=True),
        n_peel=4)
    torch.cuda.empty_cache()
print("AB " + json.dumps(res), flush=True)
