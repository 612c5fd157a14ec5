"""The plain reference against the port's ``backend="cpu"`` (the kernel's
plain torch version) on small scenes, its copies of the renderer's
definitions, and the frozen ray count.  The program is
imported here only to hold the reference against it."""

import importlib.util
import json
import math

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny_config
from perfbench.drivers import render
from perfbench.reference import tachyon


def _config(name):
    return tiny_config(json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text()))


def _program_image(traffic, st, camera, positions=None):
    from mdapy_tpu_torch import CameraParams, TachyonRender

    ren = TachyonRender(backend="cpu", antialiasing=st["antialiasing"],
                        aa_samples=st["aa_samples"], ao=st["ao"],
                        ao_samples=st["ao_samples"], shadows=st["shadows"],
                        background=tuple(st["background"]), seed=st["seed"])
    cp = CameraParams(is_perspective=True, field_of_view=camera["field_of_view"],
                      position=camera["position"], direction=camera["direction"],
                      up=camera["up"])
    pos = traffic.positions[0] if positions is None else positions
    return ren.render(pos, traffic.colors, traffic.radii, camera=cp,
                      width=st["width"], height=st["height"],
                      transparent=st["transparent"])


def _all_pixels(st):
    rows, cols = np.meshgrid(np.arange(st["height"]), np.arange(st["width"]),
                             indexing="ij")
    return rows.ravel(), cols.ravel()


# the configuration's settings, and the transparent white background and
# AA 2 of BASELINE config 3
SETTINGS = {"hea32k_noao": {},
            "transparent": {"background": [1.0, 1.0, 1.0], "transparent": True,
                            "aa_samples": 2}}


@pytest.mark.parametrize("variant,mix", [("transparent", "displaced_ring"),
                                         ("hea32k_noao", "viewpoints")])
def test_the_reference_draws_the_ports_frame(variant, mix):
    """Every pixel of each camera of the mix, at the configuration's
    settings on a small block: the check's judgement, and at most one pixel
    in 200 off by more than its levels (a sample at a silhouette or a
    shadow's edge that float32 rounds to the other side)."""
    config = _config("hea32k_noao")
    config["render"].update(SETTINGS[variant])
    mixd = json.loads((ROOT / "perfbench" / "traffic" / f"{mix}.json").read_text())
    traffic = render.inputs(config, mixd, 2**31 + 3)
    st = render.settings(config, 2**31 + 3)
    rows, cols = _all_pixels(st)
    for camera in traffic.cameras[:3]:
        img = _program_image(traffic, st, camera)
        ref = tachyon.render_pixels(traffic.positions[0], traffic.colors,
                                    traffic.radii, camera, st, rows, cols)
        numbers = render.compare(img.reshape(-1, 4), ref, config["check"]["levels"])
        assert numbers["off_px_share"] <= 0.005, numbers
        assert numbers["mean_level_diff"] <= config["check"]["limits"]["mean_level_diff"], numbers


@pytest.mark.parametrize("distance", [6.0, 10.0])
@pytest.mark.parametrize("aa", [0, 2])
def test_the_reference_draws_the_ports_ao_where_float32_holds(monkeypatch, distance, aa):
    """The fast AO's sky lights, with the camera a few Angstrom from a
    small block (the port's float32 hit points then lie within eps of the
    surface): every pixel equal.  The megakernel's route is forced on the
    small scene."""
    import mdapy_tpu_torch.render.render as port_render

    monkeypatch.setattr(port_render, "AO_EXACT_MAX_SPHERES", 0)
    config = _config("hea32k_noao")
    config["scene"]["cells"] = 3
    traffic = render.inputs(config, json.loads(
        (ROOT / "perfbench" / "traffic" / "displaced_ring.json").read_text()), 7)
    center = np.array(traffic.cameras[0]["center"])
    d = np.array(traffic.cameras[0]["direction"])
    camera = dict(traffic.cameras[0], position=tuple(-d * distance),
                  field_of_view=math.radians(80.0))
    st = dict(render.settings(config, 99), aa_samples=aa, ao=True,
              ao_samples=12, background=[0.0, 0.0, 0.0], transparent=False)
    pos = traffic.positions[0] - center
    img = _program_image(traffic, st, camera, positions=pos)
    rows, cols = _all_pixels(st)
    ref = tachyon.render_pixels(pos, traffic.colors, traffic.radii, camera, st,
                                rows, cols)
    assert render.compare(img.reshape(-1, 4), ref, 2)["off_px_share"] <= 1 / 3072


def test_the_jitter_is_the_programs():
    from mdapy_tpu_torch.render.megakernel import hash_jitter

    rng = np.random.default_rng(0)
    tile = rng.integers(0, 40000, 500)
    s = rng.integers(1, 21, 500)
    pix = rng.integers(0, 256, 500)
    for seed in (0, 12345, 2**31 + 5, 2**32 - 1):
        jx, jy = tachyon.jitter(tile, s, seed, pix)
        px, py = hash_jitter(torch.tensor(tile), torch.tensor(s), seed, torch.tensor(pix))
        assert np.array_equal(jx, px.double().numpy())
        assert np.array_equal(jy, py.double().numpy())


def test_the_camera_frame_and_sky_lights_are_the_programs():
    from mdapy_tpu_torch.render.camera import CameraParams, camera_frame
    from mdapy_tpu_torch.render.render import _fib_hemisphere

    cam = {"is_perspective": True, "field_of_view": 0.7,
           "position": (30.0, -20.0, 45.0), "direction": (-0.5, 0.4, -0.77),
           "up": (0.0, 0.0, 1.0)}
    ours = tachyon.camera_frame(cam, 320, 200)
    theirs = camera_frame(CameraParams(**cam), 320, 200)
    for a, b in (("origin", "origin"), ("lowleft", "lowleft"),
                 ("right_step", "iplaneright"), ("up_step", "iplaneup"),
                 ("light", "light_dir")):
        assert np.allclose(ours[a], theirs[b], rtol=0, atol=1e-13), a
    hemi = _fib_hemisphere(6)
    assert np.allclose(tachyon.sky_directions(12), np.concatenate([hemi, -hemi]))


def _rays_per_frame():
    path = ROOT / "perfbench" / "metrics" / "kernel.grays_per_s.py"
    spec = importlib.util.spec_from_file_location("grays", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.rays_per_frame


HEA = {"width": 3000, "height": 3000, "antialiasing": True, "aa_samples": 20,
       "ao_samples": 20, "shadows": True}
POLY = {"width": 1920, "height": 1080, "antialiasing": True, "aa_samples": 2,
        "ao_samples": 12, "shadows": True}


@pytest.mark.parametrize("render_settings,rays", [
    (dict(POLY, ao=False), 1920 * 1080 * 3 * 2),
    (dict(HEA, ao=False), 3000 * 3000 * 21 * 2),
    (dict(POLY, ao=True), 1920 * 1080 * (3 * 2 + 12)),
    (dict(HEA, ao=True), 3000 * 3000 * (21 * 2 + 20))],
    ids=["poly_noao", "hea_noao", "poly_ao", "hea_ao"])
def test_the_frozen_ray_count(render_settings, rays):
    assert _rays_per_frame()(render_settings) == rays


def test_the_configurations_count_their_rays():
    config = json.loads((ROOT / "perfbench" / "configs" / "hea32k_noao.json").read_text())
    assert _rays_per_frame()(config["render"]) == 3000 * 3000 * 21 * 2
