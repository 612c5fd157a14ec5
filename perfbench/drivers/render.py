"""The render driver: ``mdapy_tpu_torch.TachyonRender.render`` on atomic
scenes, a step being one call from the inputs to the image it returns.

The configuration gives the scene (``scene.kind`` names the module of
``scenes/`` that builds its atoms), the render settings (``render``) and
the check (``check``).  A mix (``traffic/<mix>.json``) says how many
snapshots the ring holds and how far each atom is displaced in each
(``snapshots``, ``sigma`` in Angstrom, every axis an independent
Gaussian), which cameras the steps go through (``camera``: ``{"kind":
"fixed"}``, or ``{"kind": "turntable", "count": n, "step_deg": a}``, the
preset camera turned by ``k * a`` degrees about its up axis through the
scene's centre), how many steps set-up renders first (``warmup_steps``),
and, optionally, further keyword arguments of ``render`` (``render_kwargs``,
such as ``{"device_output": true}``).  Step ``i`` renders snapshot
``(i + s0) % snapshots`` from camera ``(i + c0) % count``; the seed draws
the displacements, the scene's own random parts and the offsets ``s0`` and
``c0``, so every seed renders the same set of sizes in another order.
Warm-up renders steps ``-warmup_steps .. -1``.

The comparison: for each kept step, pixels drawn from the seed are
rendered again by the plain reference (``reference/tachyon.py``, float64)
from the inputs the step handed the program, and two numbers compare them
with the program's image:

* ``off_px_share``: the share of the sampled pixels of which some channel
  differs by more than ``check.levels`` bytes: a sample that hits another
  sphere, or a shadow test that flips, moves a pixel by more; rounding
  moves it by at most one;
* ``mean_level_diff``: the mean absolute difference in bytes over the RGB
  channels of the sampled pixels, which a shift of every pixel by a
  little shows.
"""

from __future__ import annotations

import contextlib
import importlib
from dataclasses import dataclass

import numpy as np
import torch

from ..reference import tachyon
from ..scenes import camera as cameras
from ..spec import rng

NUMBERS = ("off_px_share", "mean_level_diff")


@dataclass
class Traffic:
    positions: list        # snapshots, each (N, 3) float64
    colors: np.ndarray     # (N, 4) float32
    radii: np.ndarray      # (N,) float32
    cameras: list          # camera dicts (scenes/camera.py)
    snap0: int
    cam0: int
    warmup_steps: int
    render_kwargs: dict

    def step(self, i: int) -> tuple:
        """(snapshot index, camera index) of step ``i``."""
        return ((i + self.snap0) % len(self.positions),
                (i + self.cam0) % len(self.cameras))


def scene_builder(kind: str):
    if not kind.replace("_", "").isalnum():
        raise ValueError(f"bad scene kind {kind!r}")
    return importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.scenes.{kind}").build


def inputs(config: dict, mix: dict, seed: int) -> Traffic:
    spec = config["scene"]
    base, colors, radii = scene_builder(spec["kind"])(spec, rng(seed, 1))
    cam_spec = config["render"]["camera"]
    if cam_spec.get("preset") != "perspective":
        raise ValueError(f"unsupported camera {cam_spec}")
    preset = cameras.preset_perspective(
        base, float(radii.max()), fov_deg=float(cam_spec["fov_deg"]),
        margin=float(cam_spec["margin"]))
    cmix = mix["camera"]
    if cmix["kind"] == "fixed":
        cams = [preset]
    elif cmix["kind"] == "turntable":
        cams = [cameras.turned(preset, k * float(cmix["step_deg"]))
                for k in range(int(cmix["count"]))]
    else:
        raise ValueError(f"unknown camera kind {cmix['kind']!r}")
    n_snap, sigma = int(mix["snapshots"]), float(mix["sigma"])
    if sigma > 0.0:
        noise = rng(seed, 2).standard_normal((n_snap,) + base.shape)
        snaps = [base + sigma * noise[k] for k in range(n_snap)]
    else:
        snaps = [base] * n_snap
    order = rng(seed, 3)
    return Traffic(snaps, colors, radii, cams, int(order.integers(n_snap)),
                   int(order.integers(len(cams))), int(mix["warmup_steps"]),
                   dict(mix.get("render_kwargs", {})))


def require() -> None:
    """Fails early where the program is absent."""
    import mdapy_tpu_torch  # noqa: F401


def make(config: dict, backend: str, seed: int):
    """The system under test, set as the configuration states."""
    from mdapy_tpu_torch import TachyonRender

    r = config["render"]
    return TachyonRender(
        backend=backend, antialiasing=r["antialiasing"],
        aa_samples=r["aa_samples"], ao=r["ao"], ao_samples=r["ao_samples"],
        ao_brightness=r["ao_brightness"], shadows=r["shadows"],
        direct_light_intensity=r["direct_light_intensity"],
        background=tuple(r["background"]), seed=int(seed) % 2**32)


class Client:
    """The one client of the closed loop: renders step ``i`` and waits for
    its image (the host image, or with ``device_output`` the finished
    tensor on the card)."""

    def __init__(self, system, traffic: Traffic, config: dict):
        from mdapy_tpu_torch import CameraParams

        self.system, self.traffic = system, traffic
        self.params = [CameraParams(
            is_perspective=c["is_perspective"], field_of_view=c["field_of_view"],
            position=c["position"], direction=c["direction"], up=c["up"])
            for c in traffic.cameras]
        r = config["render"]
        self.size = (int(r["width"]), int(r["height"]))
        self.transparent = bool(r["transparent"])

    def step(self, i: int):
        snap, cam = self.traffic.step(i)
        w, h = self.size
        out = self.system.render(
            self.traffic.positions[snap], self.traffic.colors,
            self.traffic.radii, camera=self.params[cam], width=w, height=h,
            transparent=self.transparent, **self.traffic.render_kwargs)
        if isinstance(out, torch.Tensor) and out.is_cuda:
            torch.cuda.synchronize(out.device)
        return out

    def problem(self, out):
        """Why ``out`` is no image of the frame's size, or None."""
        w, h = self.size
        if isinstance(out, np.ndarray) and out.dtype == np.uint8 and out.shape == (h, w, 4):
            return None
        if (isinstance(out, torch.Tensor) and out.dtype == torch.uint8
                and tuple(out.shape) == (h, w, 3)):
            return None
        return f"returned {type(out).__name__} {getattr(out, 'shape', None)}"

    @contextlib.contextmanager
    def phases(self, log):
        """Steps inside report their phases (``phase_times``): the renderer
        at verbosity "timing", which synchronises the card at each phase's
        end, its per-render lines sent to the file ``log``."""
        self.system.verbosity = "timing"
        try:
            with open(log, "w") as f, contextlib.redirect_stdout(f):
                yield
        finally:
            self.system.verbosity = "min"

    def phase_times(self) -> dict:
        return dict(self.system.last_timings)


def settings(config: dict, seed: int, render_kwargs=None) -> dict:
    """The render settings both sides get; a frame left on the device
    (``device_output``) is rounded to bytes, a host image truncated."""
    r = config["render"]
    keys = ("width", "height", "antialiasing", "aa_samples", "ao",
            "ao_samples", "ao_brightness", "shadows",
            "direct_light_intensity", "background", "transparent")
    out = {k: r[k] for k in keys}
    out["seed"] = int(seed) % 2**32
    out["rounded"] = bool((render_kwargs or {}).get("device_output"))
    return out


def pixels(width: int, height: int, n: int, generator: np.random.Generator):
    flat = generator.choice(width * height, size=min(n, width * height), replace=False)
    return flat // width, flat % width


def compare(program: np.ndarray, reference: np.ndarray, levels: int) -> dict:
    """The numbers, over the channels the program gives (a device image has
    no alpha); the mean over RGB alone, so that both kinds read alike."""
    reference = reference[:, :program.shape[1]]
    diff = np.abs(program.astype(np.int16) - reference.astype(np.int16))
    return {"off_px_share": float((diff.max(axis=1) > levels).mean()),
            "mean_level_diff": float(diff[:, :3].mean())}


def draw(traffic: Traffic, kept: list, st: dict, n: int,
         generator: np.random.Generator) -> list:
    """For each kept step (step, image): its snapshot, camera, the sampled
    pixels' rows and columns, and the program's bytes there."""
    out = []
    for i, image in kept:
        snap, cam = traffic.step(i)
        rows, cols = pixels(st["width"], st["height"], n, generator)
        if isinstance(image, torch.Tensor):
            got = image[torch.as_tensor(rows, device=image.device),
                        torch.as_tensor(cols, device=image.device)].cpu().numpy()
        else:
            got = np.asarray(image)[rows, cols]
        out.append((snap, cam, rows, cols, got))
    return out


def reference(traffic: Traffic, st: dict, drawn: list, *, device,
              dtype=torch.float64) -> np.ndarray:
    """The reference's bytes at the drawn pixels, in ``dtype``."""
    return np.concatenate([
        tachyon.render_pixels(traffic.positions[snap], traffic.colors,
                              traffic.radii, traffic.cameras[cam], st, rows,
                              cols, dtype=dtype, device=device)
        for snap, cam, rows, cols, _ in drawn])


def numbers(traffic: Traffic, config: dict, seed: int, kept: list, *,
            device, control=None) -> dict:
    """The comparison's numbers over the kept steps.  With ``control`` (a
    dtype), the reference computed in that precision takes the program's
    place."""
    st = settings(config, seed, traffic.render_kwargs)
    drawn = draw(traffic, kept, st, int(config["check"]["pixels"]), rng(seed, 5))
    ref = reference(traffic, st, drawn, device=device)
    if control is None:
        got = np.concatenate([d[4] for d in drawn])
    else:
        got = reference(traffic, st, drawn, device=device, dtype=control)
    return compare(got, ref, int(config["check"]["levels"]))


# The timed path broken underneath, as a run can find it: each maps
# (config, backend, seed) to a system in the program's place.

class _Stale:
    """Returns the previous call's image: a step that leaves its state
    unchanged."""

    def __init__(self, system):
        self.__dict__.update(system=system, last=None)

    def __getattr__(self, name):
        return getattr(self.system, name)

    def __setattr__(self, name, value):
        setattr(self.system, name, value)

    def render(self, *args, **kwargs):
        img = self.system.render(*args, **kwargs)
        out = img if self.last is None else self.last
        self.__dict__["last"] = img
        return out


class _Altered(_Stale):
    """Raises the green channel of every image by 4: an answer altered
    where it is produced."""

    def render(self, *args, **kwargs):
        img = self.system.render(*args, **kwargs)
        if isinstance(img, torch.Tensor):
            out = img.clone()
            out[..., 1] = (out[..., 1].int() + 4).clamp(max=255).to(torch.uint8)
        else:
            out = img.copy()
            out[..., 1] = np.minimum(out[..., 1].astype(np.int16) + 4, 255)
        return out


def _half_aa(config, backend, seed):
    """The mean taken over half the AA samples: ceil(S / 2) of S."""
    r = config["render"]
    half = dict(r, aa_samples=-(-(int(r["aa_samples"]) + 1) // 2) - 1)
    return make(dict(config, render=half), backend, seed)


FAULTS = {
    "stale": lambda config, backend, seed: _Stale(make(config, backend, seed)),
    "half_aa": _half_aa,
    "altered": lambda config, backend, seed: _Altered(make(config, backend, seed)),
}
