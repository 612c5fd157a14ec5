"""The megakernel's sphere hit with the camera hundreds of Angstrom away,
as in mdapy's render demo (a 32,000-atom block seen from ~190 A).

There b^2 - (|oc|^2 - r^2) loses about four digits in float32: the old walk
put a third of the hit points more than eps inside their spheres, where
each sky light of fast AO found the sphere itself (AO acne), and picked
other spheres at seams and silhouettes.  The walk now takes the stable
discriminant r^2 - |w|^2, w = oc - b d, and a sphere's hit point is put
back on its surface along its normal.

On the CPU: the plain version's hit points (``megakernel._closest_hit``
and ``_surfaces``) against float64 geometry, and its fast-AO frame against
the benchmark's plain reference (``perfbench/reference/tachyon.py``,
float64, every ray against every sphere).  On the card (tests marked
``cuda``, skipped without one): every launch of ``csrc/mega_render.cu`` in
a render equal to ``mega_render_plain`` on the same tensors, max |diff| 0,
for opaque, AO, orthographic, peeled and bond frames; there this file runs
alone:

    python3 -m pytest tests/test_torch_sphere_hit.py --noconftest -q

It imports no jax, as the card's machine has none.
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mdapy_tpu_torch
from mdapy_tpu_torch import CameraParams
from mdapy_tpu_torch.render import megakernel
from mdapy_tpu_torch.render import render as trender

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.drivers import render as bench  # noqa: E402
from perfbench.reference import tachyon  # noqa: E402

EPS = 4e-4
DISTANCE = 190.0      # the demo's camera, from the block's centre (A)


def _config(name="hea32k_still"):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())


def _geometry(width: int = 64):
    """(positions, colors, radii, camera dict, width, height): the demo's
    block cut to 3^3 cells and centred on the origin, the camera 190 A away
    along the demo's view (as the demo's camera is from its 20^3 cells)
    with a 5 degree field, so the block fills the frame."""
    config = _config()
    mix = json.loads((ROOT / "perfbench" / "traffic" / "displaced_ring.json").read_text())
    config["scene"]["cells"] = 3
    traffic = bench.inputs(config, mix, 7)
    camera = traffic.cameras[0]
    d = np.array(camera["direction"])
    camera = dict(camera, position=tuple(-d * DISTANCE),
                  field_of_view=math.radians(5.0))
    pos = traffic.positions[0] - np.array(camera["center"])
    return pos, traffic.colors, traffic.radii, camera, width, width


def _params(camera: dict) -> CameraParams:
    return CameraParams(is_perspective=camera["is_perspective"],
                        field_of_view=camera["field_of_view"],
                        position=camera["position"],
                        direction=camera["direction"], up=camera["up"])


def _inside(h, rec, hit):
    """How far each hit point lies inside its sphere (A, float64)."""
    dist = torch.sqrt(sum((h[i].double() - rec[..., i].double()) ** 2
                          for i in range(3)))
    return (rec[..., 3].double() - dist)[hit]


def test_hit_points_lie_on_their_spheres_at_the_demo_distance():
    """The first sample's hit points of a 64x64 frame: o + t d from the
    walk lies within eps of its sphere (the old discriminant, on the same
    rays and winners, put a third of them further inside; on the demo's
    own 20^3 cells and camera alike), and the point the frame shades and
    walks from lies within 1e-5 A of it."""
    pos, colors, radii, camera, w, h = _geometry()
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False,
                                        antialiasing=False)
    ren.render(pos, colors, radii, camera=_params(camera), width=w, height=h)
    frame, bins, cd, lights, params = ren._accel
    p = torch.as_tensor(params)
    tiles = torch.arange(cd.shape[0])
    o, d, tcap = megakernel._raygen(p, tiles, 1, 0, bins.tiles_x, True)
    bt, bidx = megakernel._closest_hit(cd, bins.sph_zmin, tiles, o, d, tcap,
                                       EPS, True)
    hit = bidx >= 0
    assert int(hit.sum()) > 1000
    rec = cd[tiles[:, None], bidx.clamp(min=0) // megakernel.CH, :,
             bidx.clamp(min=0) % megakernel.CH]
    walk = _inside([o[i] + bt * d[i] for i in range(3)], rec, hit)
    assert float(walk.max()) <= EPS, float(walk.max())
    assert float((-walk).max()) <= EPS, float((-walk).max())

    # the old form on the same rays and winners: the fault this guards
    oc = [o[i] - rec[..., i] for i in range(3)]
    b = oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2]
    ccb = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - rec[..., 3] * rec[..., 3]
    t_old = -b - torch.sqrt(torch.clamp(b * b - ccb, min=0.0))
    old = _inside([o[i] + t_old * d[i] for i in range(3)], rec, hit)
    assert float((old > EPS).double().mean()) > 0.2

    rec_s, missed, _, h_s, _ = megakernel._surfaces(
        cd, bins.sph_zmin, None, None, p, tiles, o, d, tcap, None, S=1,
        grid_n=32, eps=EPS, camo=True, shadows=False, trans=False)
    assert torch.equal(~missed, hit)
    shaded = _inside(h_s, rec_s, hit)
    assert float(shaded.abs().max()) <= 1e-5, float(shaded.abs().max())


@pytest.mark.parametrize("aa", [0, 2])
def test_fast_ao_matches_the_reference_at_the_demo_distance(monkeypatch, aa):
    """The demo's settings with AO 20 (21 lights) on the 3-cell block seen
    from 190 A, 64x64, the megakernel's fast AO forced on the small scene:
    at most one pixel in 3,072 off by more than 2 levels from the plain
    reference (the old walk put a quarter of them off)."""
    monkeypatch.setattr(trender, "AO_EXACT_MAX_SPHERES", 0)
    pos, colors, radii, camera, w, h = _geometry()
    config = _config()
    config["render"].update(width=w, height=h)
    st = dict(bench.settings(config, 99), aa_samples=aa, antialiasing=aa > 0)
    assert st["ao"] and st["ao_samples"] == 20 and st["shadows"]
    ren = mdapy_tpu_torch.TachyonRender(
        backend="cpu", antialiasing=aa > 0, aa_samples=aa, ao=True,
        ao_samples=st["ao_samples"], ao_brightness=st["ao_brightness"],
        shadows=st["shadows"], background=tuple(st["background"]),
        seed=st["seed"])
    img = ren.render(pos, colors, radii, camera=_params(camera), width=w,
                     height=h)
    assert ren._route_name == "mega"
    rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ref = tachyon.render_pixels(pos, colors, radii, camera, st, rows.ravel(),
                                cols.ravel())
    numbers = bench.compare(img.reshape(-1, 4), ref, 2)
    assert numbers["off_px_share"] <= 1 / 3072, numbers
    assert float(ref[:, :3].std()) > 20.0


def test_the_still_configuration_is_the_demo_as_published():
    """``hea32k_still`` is ``hea32k_noao`` with AO 20 on and nothing in
    ``reduced``; its two cells take one card, and ``ao_accel.ms`` is read
    where each step builds the sky lights."""
    from perfbench import spec

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "hea32k_still")
    assert entry["reduced"] == [] and entry["file"] == "perfbench/configs/hea32k_still.json"
    still, noao = _config(), _config("hea32k_noao")
    assert still["reduced"] == [] and still["name"] == "hea32k_still"
    r = still["render"]
    assert r["ao"] is True and r["ao_samples"] == 20 and r["aa_samples"] == 20
    assert (r["width"], r["height"], r["shadows"]) == (3000, 3000, True)
    assert still["scene"] == noao["scene"] and still["check"].keys() == noao["check"].keys()
    assert dict(r, ao=False) == noao["render"]
    # the check's limits are read anew on the fixed port; nothing else moves
    assert set(still) == set(noao)
    assert {k for k in still if still[k] != noao[k]} <= {
        "name", "about", "render", "reduced", "check"}
    cells = {w["name"]: w for w in bench["workloads"] if w["config"] == "hea32k_still"}
    assert {n: (w["traffic"], w["chips"]) for n, w in cells.items()} == {
        "hea32k_still.snapshots": ("displaced_ring", 1),
        "hea32k_still.views": ("viewpoints", 1)}
    for name in cells:
        cell = spec.load_cell(name, ROOT)
        assert cell.config["render"]["ao"] is True
        per_layer = {m["name"] for m in cell.per_layer}
        assert ("ao_accel.ms" in per_layer) == name.endswith(".snapshots")
        assert {"kernel.ms", "accel.ms", "kernel.grays_per_s"} <= per_layer
        assert {m["name"] for m in cell.end_to_end} == {"step_ms", "setup_s"}
    read = spec.reader(ROOT / "perfbench", "ao_accel.ms")
    assert read({"timings": [{"ao_accel_build": 0.05}, {"ao_accel_build": 0.07}]}) == pytest.approx(60.0)
    assert read({"timings": [{"ao_accel_build": 0.05}, {"trace": 0.01}]}) is None


# ---------------------------------------------------------------- card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fcc(cells: int, seed: int):
    a = 3.59
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    grid = np.mgrid[0:cells, 0:cells, 0:cells].reshape(3, -1).T
    pos = (frac[None] + grid[:, None]).reshape(-1, 3) * a
    rng = np.random.default_rng(seed)
    pos = pos + rng.normal(0.0, 0.1, pos.shape)
    colors = np.c_[rng.uniform(0.2, 1.0, (len(pos), 3)), np.ones(len(pos))]
    return pos - pos.mean(axis=0), colors.astype(np.float32), np.full(
        len(pos), 1.25, np.float32)


def _far(perspective: bool = True) -> CameraParams:
    """190 A from the origin along the preset's view: an 8 degree field, or
    orthographic with a 20 A half-height, the block filling the frame."""
    d = np.array([-1.0, -1.0, -1.0]) / math.sqrt(3.0)
    return CameraParams(is_perspective=perspective,
                        field_of_view=math.radians(8.0) if perspective else 20.0,
                        position=tuple(-d * DISTANCE), direction=tuple(d),
                        up=(0.0, 0.0, 1.0))


def _bonds(pos, rc: float = 2.7):
    i, j = np.triu_indices(len(pos), k=1)
    near = np.linalg.norm(pos[i] - pos[j], axis=1) < rc
    return np.stack([pos[i[near]], pos[j[near]]], axis=1)


def _box(pos):
    lo, hi = pos.min(axis=0) - 1.0, pos.max(axis=0) + 1.0
    corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])])
    edges = [(a, b) for a in range(8) for b in range(a + 1, 8)
             if np.count_nonzero(corners[a] != corners[b]) == 1]
    return np.stack([np.stack([corners[a], corners[b]]) for a, b in edges])


CASES = {
    # name: (renderer options, translucent atoms, bonds and cell, camera)
    "opaque": (dict(ao=False, aa_samples=2), False, False, "far"),
    "ao20": (dict(ao=True, ao_samples=20, aa_samples=2), False, False, "far"),
    "ao20_aa20": (dict(ao=True, ao_samples=20, aa_samples=20), False, False, "far"),
    "ortho_ao4": (dict(ao=True, ao_samples=4, aa_samples=2), False, False, "ortho"),
    "peel_ao4": (dict(ao=True, ao_samples=4, aa_samples=2), True, False, "far"),
    "peel1": (dict(ao=False, aa_samples=2), True, False, "peel1"),
    "bonds_ao4": (dict(ao=True, ao_samples=4, aa_samples=2), False, True, "far"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_plain_at_the_demo_distance(card, monkeypatch, case):
    """Every launch of the hand kernel in a render (256x192, the camera
    190 A from a 6^3-cell block) equals the plain version on the same CUDA
    tensors: opaque (camera rays), AO 20, orthographic (rays from the image
    plane), peeled (rays from their previous hits), ``peel1`` (camera rays
    with peeling's compositing) and bonds with the cell (cylinders and
    rings beside the spheres)."""
    opts, glass, bonds, cam = CASES[case]
    monkeypatch.setattr(trender, "AO_EXACT_MAX_SPHERES", 0)
    pos, colors, radii = _fcc(6, seed=3)
    if glass:
        rng = np.random.default_rng(11)
        pick = rng.uniform(size=len(pos)) < 0.5
        colors[pick, 3] = rng.uniform(0.3, 0.7, int(pick.sum()))
    seen = []
    cuda = megakernel.mega_render_cuda

    def both(*args, **kwargs):
        out = cuda(*args, **kwargs)
        plain = megakernel.mega_render_plain(*args, **kwargs)
        torch.cuda.synchronize()
        seen.append((float((out - plain).abs().max()), float(plain.std()),
                     kwargs.get("n_peel", 1), kwargs.get("peel1", False),
                     kwargs.get("other") is not None))
        return out

    monkeypatch.setattr(megakernel, "mega_render_cuda", both)
    ren = mdapy_tpu_torch.TachyonRender(backend="cuda", **opts)
    if cam == "peel1":
        ren._cfg = ren._cfg._replace(max_trans=1)
    camera = _far(cam != "ortho")
    kw = {}
    if bonds:
        # the bonds of a corner of the block: within the megakernel's 8,192
        # cylinders and rings
        kw = dict(bond_edges=_bonds(pos[:160]), bond_radius=0.3,
                  box_edges=_box(pos), box_edge_radius=0.2)
    ren.render(pos, colors, radii, camera=camera, width=256, height=192, **kw)
    assert ren._route_name == "mega" and len(seen) == 1, seen
    err, std, n_peel, peel1, other = seen[0]
    assert err == 0.0, seen
    assert std > 0.02
    assert (n_peel > 1) == (glass and cam != "peel1")
    assert peel1 == (cam == "peel1")
    assert other == bonds
