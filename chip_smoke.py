#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port's render main path on one card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. Build the hand kernel ``mdapy_tpu_torch/csrc/mega_render.cu`` from the
   sources with nvcc and print ptxas' register and shared-memory lines.
2. Kernel against its plain torch version, on the same CUDA tensors, on a
   2,048-atom FCC scene at 320x240: (a) perspective, S = 3, shadows;
   (b) orthographic ("top"), S = 1, shadows; (c) perspective, S = 1, no
   shadows.  At most 4 pixels may differ by more than 1e-3 in a channel, and
   the mean difference stays below 1e-4.
3. The main path at full size: the 1,000,188-atom FCC block (a = 3.615,
   r = 1.28), the "perspective" preset camera, 1920x1080, AA 12 (13 samples)
   with primary-light shadows, through ``TachyonRender(backend="cuda",
   ao=False).render(..., device_output=True)``.  Checks the image and that
   the kernel was launched; times the first frame (scene and accel build
   included) and 5 warm frames; times each layer; compares the kernel with
   its plain version on the whole frame and times both over a band of the
   frame's tile rows.

The last three lines are the kernel table (JSON), the card's name and power
limit as nvidia-smi reports them, and a JSON status line.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL_PIXELS = 4        # pixels allowed above TOL_PIXEL_DIFF in any channel
TOL_PIXEL_DIFF = 1e-3
TOL_MEAN = 1e-4
WARM_FRAMES = 5


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


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script needs a CUDA card")

    from mdapy_tpu_torch import TachyonRender, preset_camera
    from mdapy_tpu_torch.render import megakernel
    from mdapy_tpu_torch.render._build import load_mega_render
    from mdapy_tpu_torch.render.accel import (
        build_light_bins, build_light_records, build_screen_bins,
    )
    from mdapy_tpu_torch.render.camera import camera_frame
    from mdapy_tpu_torch.render.config import RenderConfig
    from mdapy_tpu_torch.render.gather import gather_chunk_data
    from mdapy_tpu_torch.render.scene import build_scene

    dev = torch.device("cuda")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    # ---- 1. build -------------------------------------------------------
    lib = load_mega_render()
    print(f"[1] built {lib.path.name} in {lib.build_seconds:.2f} s")
    for line in lib.log.splitlines():
        if "Used" in line or "spill" in line:
            print("  " + line.strip())

    def prepare(pos, colors, radii, cam, width, height, cfg, grid=32):
        scene = build_scene(pos, colors, radii, device=dev)
        frame = camera_frame(cam, width, height)
        bins = build_screen_bins(scene, frame, width, height)
        lb = build_light_bins(scene, frame["light_dir"], grid=grid)
        chunk_data = gather_chunk_data(bins.sph_chunks, scene.sph_center,
                                       scene.sph_radius, scene.sph_color)
        lrec = build_light_records(lb, scene)
        lo = (scene.sph_center - scene.sph_radius[:, None]).min(0).values
        hi = (scene.sph_center + scene.sph_radius[:, None]).max(0).values
        params = megakernel.build_mega_params(frame, lb, lo, hi, cfg)
        return frame, bins, chunk_data, lrec, params

    # ---- 2. kernel vs plain, small scene ----------------------------------
    pos, colors, radii = fcc_block(8, seed=3)
    errs = []
    for preset, aa, shadows in (("perspective", 2, True), ("top", 0, True),
                                ("perspective", 0, False)):
        cam = preset_camera(preset, pos, max_radius=1.28)
        cfg = RenderConfig(aa_samples=aa, aa_enabled=aa > 0, ao_enabled=False,
                           shadows_enabled=shadows)
        frame, bins, cd, lrec, params = prepare(pos, colors, radii, cam, 320,
                                                240, cfg)
        kw = dict(S=aa + 1, tiles_x=bins.tiles_x, grid_n=32, eps=cfg.eps,
                  perspective=bool(frame["perspective"]), shadows=shadows)
        args = (cd, bins.sph_zmin, *lrec, params, 0)
        out_k = megakernel.mega_render_cuda(*args, **kw)
        out_p = megakernel.mega_render_plain(*args, **kw)
        torch.cuda.synchronize()
        if float(out_p.std()) < 0.02:
            fail(f"{preset}: the plain image is flat")
        errs.append(compare(out_k, out_p, f"[2] {len(pos)} atoms 320x240 "
                            f"{preset} S={aa + 1} shadows={shadows}"))

    # ---- 3. main path, full size ------------------------------------------
    width, height, S = 1920, 1080, 13
    pos, colors, radii = fcc_block(63)
    cam = preset_camera("perspective", pos, max_radius=float(radii.max()))
    ren = TachyonRender(backend="cuda", ao=False)

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
    print(f"[3] {len(pos)} atoms {width}x{height} S={S} shadows: first frame "
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
    _, frame_bins, chunk_data, lrec_main, params = ren._accel
    nb, nchunks = frame_bins.sph_zmin.shape
    kw = dict(S=S, tiles_x=frame_bins.tiles_x, grid_n=32, eps=cfg.eps,
              perspective=True, shadows=True)
    args = (chunk_data, frame_bins.sph_zmin, *lrec_main, params, 0)
    kernel_ms = event_ms(lambda: megakernel.mega_render_cuda(*args, **kw), 5)
    print(f"  layers: scene {t_scene * 1e3:.1f} ms, screen bins "
          f"{t_bins * 1e3:.1f} ms, light bins {t_lbins * 1e3:.1f} ms, gather "
          f"{t_gather * 1e3:.1f} ms, light records {t_lrec * 1e3:.1f} ms, "
          f"kernel (full frame) {kernel_ms:.3f} ms")
    print(f"  tiles {nb} ({frame_bins.tiles_x}x{frame_bins.tiles_y}), chunks "
          f"per tile {nchunks}, live tiles "
          f"{int((frame_bins.sph_zmin[:, 0] < 1e17).sum())}, light records "
          f"{lrec_main[0].shape[0]}, records {chunk_data.numel() * 4} bytes")

    # kernel vs plain on the whole frame, then timed over a band of the
    # frame's middle tile rows
    out_k = megakernel.mega_render_cuda(*args, **kw)
    out_p, t_plain = sync_time(lambda: megakernel.mega_render_plain(*args, **kw))
    errs.append(compare(out_k, out_p, f"[3] full frame (plain {t_plain:.2f} s)"))
    del out_k, out_p
    rows = 2
    ty0 = frame_bins.tiles_y // 2 - rows // 2
    band = (ty0 * frame_bins.tiles_x, (ty0 + rows) * frame_bins.tiles_x)
    band_ms = event_ms(lambda: megakernel.mega_render_cuda(*args, tiles=band, **kw), 10)
    plain_ms = event_ms(lambda: megakernel.mega_render_plain(*args, tiles=band, **kw), 2)
    print(f"  band of {band[1] - band[0]} tiles: kernel {band_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(json.dumps({"kernels": [{
        "name": "mega_render",
        "route": "cuda",
        "source": "mdapy_tpu_torch/csrc/mega_render.cu",
        "replaces": "mdapy_tpu/render/megakernel.py:156",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": band_ms,
        "plain_ms": plain_ms,
    }]}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
