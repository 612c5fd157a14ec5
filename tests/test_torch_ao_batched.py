"""The fast-AO sky lights built in batched passes (``render.build_ao_lights``)
against each light built alone (the same pass with K = 1:
``build_light_bins`` -> ``build_light_records``, ``accel.light_rows`` and
``occluder_records``), under ``tests/_ao_lights.py``'s rules: CSR offsets, counts and each cell's sphere ids exactly; records, cell
key maxima, rows and occluder tables within rtol 1e-6, the keys
non-increasing in every cell.

On the CPU: a 108-atom FCC block at ao_samples 2, 4, 12 and 20, with box
edges (occluder tables), and in several groups under a lowered
``AO_BATCH_BUDGET_BYTES``.  On the card (tests marked ``cuda``, skipped
without one): the render demo's 32,000-atom block at AO 20, then its
3000x3000 AA 20 AO 20 frame through the megakernel with each set of lights,
max |diff| 0; there this file runs alone:

    python3 -m pytest tests/test_torch_ao_batched.py --noconftest -q

It imports no jax, as the card's machine has none.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mdapy_tpu_torch import CameraParams, tracing
from mdapy_tpu_torch.render import accel, megakernel
from mdapy_tpu_torch.render import render as trender
from mdapy_tpu_torch.render.camera import camera_frame
from mdapy_tpu_torch.render.config import RenderConfig
from mdapy_tpu_torch.render.gather import gather_chunk_data
from mdapy_tpu_torch.render.scene import build_scene

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT, ROOT / "tests"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from _ao_lights import check_ao_lights, each_alone  # noqa: E402

GRID = 32


def _fcc_block(n=3):
    a = 3.615
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.mgrid[0:n, 0:n, 0:n].reshape(3, -1).T
    pos = (frac[None] + cells[:, None]).reshape(-1, 3) * a
    rng = np.random.default_rng(3)
    colors = np.c_[rng.uniform(0.2, 1.0, (len(pos), 3)), np.ones(len(pos))]
    return pos, colors.astype(np.float32), np.full(len(pos), 1.28, np.float32)


def _box_edges(pos):
    lo, hi = pos.min(axis=0) - 1.0, pos.max(axis=0) + 1.0
    corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])])
    return np.stack([np.stack([corners[a], corners[b]])
                     for a in range(8) for b in range(a + 1, 8)
                     if np.count_nonzero(corners[a] != corners[b]) == 1])


def _scene(box: bool, device="cpu"):
    pos, colors, radii = _fcc_block()
    scene = build_scene(pos, colors, radii,
                        box_edges=_box_edges(pos) if box else None,
                        device=device)
    return scene, accel.other_table(scene) if box else None


@pytest.mark.parametrize("ao,box", [(2, False), (4, False), (12, False),
                                    (20, False), (12, True)],
                         ids=["ao2", "ao4", "ao12", "ao20", "ao12_box"])
def test_batched_lights_equal_each_light_built_alone(ao, box):
    """Every sky light of one batched pass equals the light built alone;
    with the cell's 12 edges each light carries its occluder table."""
    scene, table = _scene(box)
    with tracing.recording() as rec:
        with tracing.span("render"):
            lights = trender.build_ao_lights(scene, ao, 0.8, 1.28, grid=GRID,
                                             table=table)
    assert len(lights) == 2 * (ao // 2)
    assert all((light[5] is not None) == box for light in lights)
    assert check_ao_lights(scene, lights, ao, 0.8, 1.28, GRID, table) > 100 * ao
    (counted,) = rec.counters.values()
    assert counted["ao.light_batches"] == 1
    assert counted["ao.lights_built"] == len(lights)


def test_groups_under_a_lowered_budget(monkeypatch):
    """Past ``AO_BATCH_BUDGET_BYTES`` of pair data the lights go in groups
    of consecutive lights; each group's entries equal the one-pass build's
    bit for bit, and ``ao.light_batches`` counts the groups."""
    scene, _ = _scene(False)
    whole = trender.build_ao_lights(scene, 12, 0.8, 1.28, grid=GRID)
    pairs = [light[1].shape[0] for light in whole]
    # room for about three lights' pairs a group
    monkeypatch.setattr(trender, "AO_BATCH_BUDGET_BYTES",
                        3 * max(pairs) * accel.PAIR_BYTES)
    groups = accel.split_light_batch(np.array(pairs), 3 * max(pairs))
    assert 3 <= len(groups) < len(pairs)
    with tracing.recording() as rec:
        with tracing.span("render"):
            split = trender.build_ao_lights(scene, 12, 0.8, 1.28, grid=GRID)
    (counted,) = rec.counters.values()
    assert counted["ao.light_batches"] == len(groups)
    assert counted["ao.lights_built"] == 12
    for a, b in zip(split, whole):
        assert np.array_equal(a[0], b[0])
        assert all(torch.equal(x, y) for x, y in zip(a[1:5], b[1:5]))
    check_ao_lights(scene, split, 12, 0.8, 1.28, GRID)


@pytest.mark.parametrize("pairs,max_pairs,expect", [
    ([5, 5, 5], 10, [(0, 2), (2, 3)]),
    ([5, 5, 5], 15, [(0, 3)]),
    ([20, 1, 1, 30, 0], 10, [(0, 1), (1, 3), (3, 4), (4, 5)]),
    ([0, 0], 0, [(0, 2)]),
])
def test_split_light_batch(pairs, max_pairs, expect):
    """Consecutive lights, at most ``max_pairs`` pairs a group; a light over
    it takes a group alone."""
    got = accel.split_light_batch(np.array(pairs), max_pairs)
    assert [(g.start, g.stop) for g in got] == expect


# ---------------------------------------------------------------- card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_demo_lights_and_frame_on_the_card(card):
    """The demo's block (``hea32k_still``: 32,000 atoms, AO 20) on the card:
    the batched build against each light built alone, then the demo's
    3000x3000 AA 20 frame through the megakernel with each set of sky
    lights, max |diff| 0."""
    from perfbench.drivers import render as bench

    config = json.loads((ROOT / "perfbench" / "configs" / "hea32k_still.json")
                        .read_text())
    mix = json.loads((ROOT / "perfbench" / "traffic" / "displaced_ring.json")
                     .read_text())
    traffic = bench.inputs(config, mix, 2**31 + 7)
    r = config["render"]
    pos, colors, radii = traffic.positions[0], traffic.colors, traffic.radii
    scene = build_scene(pos, colors, radii, device=card)
    rmax = float(radii.max())
    lights = trender.build_ao_lights(scene, r["ao_samples"], r["ao_brightness"],
                                     rmax, grid=GRID)
    assert len(lights) == 20
    n = check_ao_lights(scene, lights, r["ao_samples"], r["ao_brightness"],
                        rmax, GRID)
    assert n > 1_000_000

    cam = traffic.cameras[0]
    camera = CameraParams(is_perspective=cam["is_perspective"],
                          field_of_view=cam["field_of_view"],
                          position=cam["position"], direction=cam["direction"],
                          up=cam["up"])
    w, h = r["width"], r["height"]
    frame = camera_frame(camera, w, h)
    bins = accel.build_screen_bins(scene, frame, w, h, megakernel.TILE_PX)
    lb = accel.build_light_bins(scene, frame["light_dir"], grid=GRID)
    cd = gather_chunk_data(bins.sph_chunks, scene.sph_center, scene.sph_radius,
                           scene.sph_color)
    lo = (scene.sph_center - scene.sph_radius[:, None]).min(0).values
    hi = (scene.sph_center + scene.sph_radius[:, None]).max(0).values
    cfg = RenderConfig(aa_samples=r["aa_samples"], aa_enabled=True,
                       ao_samples=r["ao_samples"], ao_enabled=True,
                       shadows_enabled=True,
                       ao_brightness=r["ao_brightness"],
                       direct_light_intensity=r["direct_light_intensity"])
    params = megakernel.build_mega_params(frame, lb, lo, hi, cfg)
    primary = accel.build_light_records(lb, scene)
    oracle = [entry for _, entry in each_alone(
        scene, r["ao_samples"], r["ao_brightness"], rmax, GRID)]
    images = []
    for extra in (lights, oracle):
        stack = megakernel.stack_lights(params, *primary, extra_lights=extra,
                                        grid_n=GRID, device=card)
        images.append(megakernel.render_image_mega(
            cd, bins.sph_zmin, stack, params, 0, S=r["aa_samples"] + 1,
            width=w, height=h, tiles_x=bins.tiles_x, tiles_y=bins.tiles_y,
            grid_n=GRID, eps=cfg.eps, perspective=True, shadows=True))
    torch.cuda.synchronize()
    batched, alone = images
    assert tuple(batched.shape) == (h, w, 3)
    assert float(alone.std()) > 0.02
    assert float((batched - alone).abs().max()) == 0.0
