"""The port's tracer (``mdapy_tpu_torch.tracing``) on the render path, on
the CPU: the spans of ``TachyonRender.render`` and their nesting, the
phases' agreement with ``last_timings``, the counters of the scene upload
and the gather, a call that raises, and the spans' place in a
``torch.profiler`` trace."""

import json
import time

import numpy as np
import pytest
import torch

import mdapy_tpu_torch
from mdapy_tpu_torch import tracing
from mdapy_tpu_torch.render import render as trender

PHASES = ("prepare", "scene_build", "accel_build", "trace", "image_out")


def _scene(n=2):
    a = 3.615
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.mgrid[0:n, 0:n, 0:n].reshape(3, -1).T
    pos = (frac[None] + cells[:, None]).reshape(-1, 3) * a
    rng = np.random.default_rng(5)
    colors = np.c_[rng.uniform(0.2, 1.0, (len(pos), 3)), np.ones(len(pos))]
    return pos, colors.astype(np.float32), np.full(len(pos), 1.28, np.float32)


def _render(ren, pos, colors, radii, **kw):
    return ren.render(pos, colors, radii, width=32, height=24, **kw)


def _calls(rec):
    """{call id: its spans by start}."""
    out = {}
    for s in sorted(rec.spans, key=lambda s: (s.start_ns, s.id)):
        out.setdefault(s.call, []).append(s)
    return out


def test_off_records_nothing_and_calls_no_profiler(monkeypatch):
    """Off (the default) a render opens no span, counts nothing and calls
    no ``torch.profiler`` function."""
    def refuse(*args, **kwargs):
        raise AssertionError("torch.profiler.record_function called")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing._rec is None
    assert tracing.span("render") is tracing.span("trace")
    tracing.count("scene.upload_bytes", 10)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False)
    img = _render(ren, *_scene())
    assert img.shape == (24, 32, 4)
    assert tuple(ren.last_timings) == PHASES
    assert tracing._rec is None


@pytest.mark.parametrize("ao", [False, True])
def test_spans_nest_and_feed_last_timings(monkeypatch, ao):
    """Each call is one root span "render" holding the phases in order,
    every child inside its parent; ``last_timings[p]`` is the duration of
    phase span ``p`` (``accel_build`` less the AO light build nested in
    it); the nested spans lie in their phases."""
    if ao:
        # fast AO on the megakernel's route at this size
        monkeypatch.setattr(trender, "AO_EXACT_MAX_SPHERES", 0)
    pos, colors, radii = _scene()
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=ao, ao_samples=4)
    with tracing.recording() as rec:
        _render(ren, pos, colors, radii)
        first = dict(ren.last_timings)
        _render(ren, pos + 0.25, colors, radii)
        second = dict(ren.last_timings)
    calls = list(_calls(rec).values())
    assert len(calls) == 2 and rec._open == []
    for spans, timings in zip(calls, (first, second)):
        by_id = {s.id: s for s in spans}
        root = spans[0]
        assert root.name == "render" and root.parent is None
        assert root.call == root.id
        assert [s for s in spans if s.parent is None] == [root]
        for s in spans[1:]:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        top = [s.name for s in spans if s.parent == root.id]
        assert tuple(top) == PHASES
        names = {s.name: s for s in spans}
        for p in PHASES:
            dur = (names[p].end_ns - names[p].start_ns) * 1e-9
            if p == "accel_build" and ao:
                aos = names["ao_accel_build"]
                assert aos.parent == names["accel_build"].id
                ao_dur = (aos.end_ns - aos.start_ns) * 1e-9
                assert timings["ao_accel_build"] == ao_dur
                dur -= ao_dur
            assert timings[p] == pytest.approx(dur, rel=0, abs=1e-12), p
        for child, phase in (("scene_build/fingerprint", "scene_build"),
                             ("image_out/fetch", "image_out"),
                             ("image_out/pack", "image_out")):
            assert by_id[names[child].parent].name == phase
        # the phases follow one another: one reading ends one, starts the next
        phases = [names[p] for p in PHASES]
        assert all(a.end_ns == b.start_ns for a, b in zip(phases, phases[1:]))
    # the AO lights are built once per scene: the moved scene builds them again
    assert ("ao_accel_build" in first) == ao and ("ao_accel_build" in second) == ao


def test_counters_scene_upload_and_gather():
    """``scene.upload_bytes`` is the built scene's tensor bytes and 0 on an
    identity-cached call; ``accel.gather_bytes`` is the chunk records'
    bytes, 0 where the view is cached."""
    pos, colors, radii = _scene()
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False)
    with tracing.recording() as rec:
        _render(ren, pos, colors, radii)
        _render(ren, pos, colors, radii)
    built, cached = _calls(rec)
    scene = ren._scene[0]
    scene_bytes = sum(t.nbytes for t in vars(scene).values())
    chunk_data = ren._accel[2]
    assert rec.counters == {built: {"scene.upload_bytes": scene_bytes,
                                    "accel.gather_bytes": chunk_data.nbytes}}
    assert cached not in rec.counters


@pytest.mark.parametrize("box", [False, True])
def test_ao_build_spans_and_counters(monkeypatch, box):
    """With fast AO the sky lights' bins, then their records, are built in
    "ao_accel_build/bins" and "ao_accel_build/records", one after the
    other inside "ao_accel_build" (the frames and the one group's bins
    before its records); ``ao.lights_built`` counts 2 * (ao_samples // 2)
    lights and ``ao.light_batches`` one batched pass where the scene
    changes, neither where only the camera moves; ``ao.record_bytes`` is
    the bytes of the tensors the lights keep (with the cell's edges, their
    occluder tables too)."""
    monkeypatch.setattr(trender, "AO_EXACT_MAX_SPHERES", 0)
    pos, colors, radii = _scene()
    kw = {}
    if box:
        lo, hi = pos.min(axis=0) - 1.0, pos.max(axis=0) + 1.0
        kw["box_edges"] = np.array([[[lo[0], lo[1], z], [hi[0], lo[1], z]]
                                    for z in (lo[2], hi[2])])
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=True, ao_samples=6)
    turned = mdapy_tpu_torch.preset_camera("top", pos, max_radius=1.28)
    with tracing.recording() as rec:
        _render(ren, pos, colors, radii, **kw)
        _render(ren, pos, colors, radii, camera=turned, **kw)
    built, moved = _calls(rec).values()
    assert ren._route_name == "mega"
    names = [s.name for s in built]
    assert "ao_accel_build" in names and "ao_accel_build" not in [s.name for s in moved]
    by_id = {s.id: s for s in built}
    bins, records = ([s for s in built if s.name == n] for n in (
        "ao_accel_build/bins", "ao_accel_build/records"))
    assert len(bins) == 2 and len(records) == 1
    for s in bins + records:
        assert by_id[s.parent].name == "ao_accel_build"
    assert max(s.end_ns for s in bins) <= records[0].start_ns
    lights = ren._ao
    assert len(lights) == 6
    assert all((light[5] is not None) == box for light in lights)
    nbytes = sum(t.nbytes for light in lights for t in light[1:] if t is not None)
    counted = rec.counters[built[0].call]
    assert counted["ao.lights_built"] == 6
    assert counted["ao.light_batches"] == 1
    assert counted["ao.record_bytes"] == nbytes > 0
    assert not [k for k in rec.counters.get(moved[0].call, {}) if k.startswith("ao.")]
    assert "accel.gather_bytes" in rec.counters[moved[0].call]


def test_image_out_spans_and_no_fetch_on_the_cpu():
    """A host image is built in ``image_out/pack`` and handed out in
    ``image_out/fetch``, both under ``image_out``; a ``device_output`` call
    has no ``image_out`` phase.  On the CPU the image is already the
    host's, so neither call counts ``image_out.fetch_bytes`` (the card's
    copy counts H·W·4: ``tests/test_torch_image_out.py``)."""
    pos, colors, radii = _scene()
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False)
    _render(ren, pos, colors, radii)   # the scene and the view cached
    with tracing.recording() as rec:
        frame = _render(ren, pos, colors, radii, device_output=True)
        img = _render(ren, pos, colors, radii)
    on_device, host = _calls(rec).values()
    assert isinstance(frame, torch.Tensor) and tuple(frame.shape) == (24, 32, 3)
    assert isinstance(img, np.ndarray) and img.shape == (24, 32, 4)
    assert "image_out" not in {s.name for s in on_device}
    assert rec.counters == {}
    by_id = {s.id: s for s in host}
    out = [s for s in host if s.parent is not None
           and by_id[s.parent].name == "image_out"]
    assert [s.name for s in out] == ["image_out/pack", "image_out/fetch"]


def test_a_render_that_raises_leaves_no_span_open(monkeypatch):
    """A call that raises in its trace phase closes its open spans; the
    next call is a call of its own."""
    def broken(*args, **kwargs):
        raise RuntimeError("kernel failed")

    pos, colors, radii = _scene()
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False)
    with tracing.recording() as rec:
        with monkeypatch.context() as m:
            m.setattr(trender, "render_image_mega", broken)
            with pytest.raises(RuntimeError, match="kernel failed"):
                _render(ren, pos, colors, radii)
        assert rec._open == []
        _render(ren, pos, colors, radii)
    failed, ok = _calls(rec).values()
    assert [s.name for s in failed] == ["render", "prepare", "scene_build",
                                        "scene_build/fingerprint",
                                        "accel_build", "trace"]
    assert all(s.end_ns == failed[0].end_ns for s in failed
               if s.name in ("render", "trace"))
    assert ok[0].name == "render" and ok[0].parent is None
    with pytest.raises(RuntimeError, match="already on"):
        with tracing.recording():
            with tracing.recording():
                pass
    assert tracing._rec is None


def test_spans_lie_in_the_profiler_trace(tmp_path):
    """Under ``torch.profiler`` every span is a ``user_annotation`` of its
    name, and its start, moved by the offset of a clock mark (a zero-length
    annotation around a clock reading, as the benchmark's devtrace takes
    it), agrees with the recorder's within 0.2 ms."""
    pos, colors, radii = _scene()
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False)
    _render(ren, pos, colors, radii)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):   # the first range of a profile opens slowly
            with torch.profiler.record_function("clock.mark"):
                mark_ns = time.perf_counter_ns()
        with tracing.recording() as rec:
            _render(ren, pos + 0.25, colors, radii)
            _render(ren, pos + 0.5, colors, radii)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    marks = [e for e in events if e["name"] == "clock.mark"]
    offset_us = float(marks[-1]["ts"]) - mark_ns * 1e-3
    spans = sorted(rec.spans, key=lambda s: (s.start_ns, s.id))
    assert len(spans) == 2 * 9
    for name in {s.name for s in spans}:
        ours = [s for s in spans if s.name == name]
        theirs = sorted((e for e in events if e["name"] == name),
                        key=lambda e: float(e["ts"]))
        assert len(theirs) == len(ours), name
        for s, e in zip(ours, theirs):
            assert abs(float(e["ts"]) - offset_us - s.start_ns * 1e-3) < 200.0, name
