"""Each traffic mix repeats bit for bit for a seed, differs between seeds,
and gives every seed the same sizes; the configurations' scenes are the
ones they name."""

import json

import numpy as np
import pytest

from conftest import ROOT, tiny_config
from perfbench.drivers import render
from perfbench.scenes import camera

MIXES = sorted(p.stem for p in (ROOT / "perfbench" / "traffic").glob("*.json"))
CONFIGS = sorted(p.stem for p in (ROOT / "perfbench" / "configs").glob("*.json"))


def _config(name):
    return tiny_config(json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text()))


def _mix(name):
    return json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json").read_text())


def _steps(t, n=12):
    return [t.step(i) for i in range(-t.warmup_steps, n)]


@pytest.mark.parametrize("mix", MIXES)
def test_a_mix_repeats_for_a_seed_and_differs_between_seeds(mix):
    config = _config("hea32k_noao")
    a = render.inputs(config, _mix(mix), 2**31 + 7)
    b = render.inputs(config, _mix(mix), 2**31 + 7)
    c = render.inputs(config, _mix(mix), 2**31 + 8)
    assert _steps(a) == _steps(b)
    assert all(np.array_equal(x, y) for x, y in zip(a.positions, b.positions))
    assert np.array_equal(a.colors, b.colors) and a.cameras == b.cameras
    # another seed: other species, displacements or order; the same sizes
    assert (not np.array_equal(a.colors, c.colors)
            or not all(np.array_equal(x, y) for x, y in zip(a.positions, c.positions))
            or _steps(a) != _steps(c))
    assert [p.shape for p in a.positions] == [p.shape for p in c.positions]
    assert sorted(map(str, a.cameras)) == sorted(map(str, c.cameras))
    assert len(a.positions) == _mix(mix)["snapshots"]


def test_displacements_have_the_mix_sigma():
    config = _config("hea32k_noao")
    mix = _mix("displaced_ring")
    t = render.inputs(config, mix, 3)
    base = render.inputs(config, dict(mix, sigma=0.0, snapshots=1), 3).positions[0]
    d = np.stack([p - base for p in t.positions])
    assert abs(d.std() - mix["sigma"]) < 0.01 and abs(d.mean()) < 0.01


def test_the_turntable_keeps_the_distance_and_turns_by_the_step():
    cam = camera.preset_perspective(np.random.default_rng(0).random((50, 3)) * 9, 1.0)
    c = np.array(cam["center"])
    turned = camera.turned(cam, 60.0)
    r0 = np.array(cam["position"]) - c
    r1 = np.array(turned["position"]) - c
    assert np.isclose(np.linalg.norm(r0), np.linalg.norm(r1))
    assert np.isclose(r0[2], r1[2])
    cosang = (r0[:2] @ r1[:2]) / np.linalg.norm(r0[:2]) / np.linalg.norm(r1[:2])
    assert np.isclose(cosang, 0.5)
    assert np.allclose(turned["direction"], -r1 / np.linalg.norm(r1))


def test_the_preset_camera_is_the_programs():
    """The benchmark's copy of the preset arithmetic gives the program's
    camera (the program is only read here, to pin the copy)."""
    from mdapy_tpu_torch.render.camera import preset_camera

    pos = np.random.default_rng(1).random((300, 3)) * [20.0, 30.0, 10.0]
    ours = camera.preset_perspective(pos, 1.25)
    theirs = preset_camera("perspective", pos, max_radius=1.25)
    for k in ("position", "direction", "up", "field_of_view"):
        assert np.allclose(ours[k], getattr(theirs, k), rtol=0, atol=1e-12)


def test_the_polycrystal_is_config_3():
    """BASELINE config 3's count: 1,002,708 atoms (``chip_smoke.py``'s
    generator, whose copy this is, with its parameters)."""
    from perfbench.scenes import voronoi_polycrystal

    spec = {"box": 230.0, "grains": 15, "structure_seed": 1, "a": 3.615,
            "min_dist": 2.0}
    pos = voronoi_polycrystal.polycrystal(spec["box"], spec["grains"],
                                          spec["structure_seed"], spec["a"],
                                          spec["min_dist"])
    assert pos.shape == (1002708, 3)
    assert pos.min() >= 0.0 and pos.max() < spec["box"]


def test_the_alloy_is_equiatomic():
    from perfbench.scenes import elements, fcc_alloy

    spec = json.loads((ROOT / "perfbench" / "configs" / "hea32k_noao.json").read_text())["scene"]
    pos, colors, radii = fcc_alloy.build(spec, np.random.default_rng(5))
    assert pos.shape == (32000, 3) and np.all(radii == spec["radius"])
    name = {tuple(elements.JMOL_RGB[e]): e for e in spec["elements"]}
    keys = [tuple(int(v) for v in c) for c in np.round(colors[:, :3] * 255.0)]
    names, counts = np.unique([name[k] for k in keys], return_counts=True)
    assert dict(zip(names, counts)) == {e: 6400 for e in spec["elements"]}
