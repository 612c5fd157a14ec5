"""The card's idle time put down to the program's spans (``spans.py``), on
a small synthetic Chrome trace and in a CPU run of a cell."""

import pytest

from perfbench import spans


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# one call of 0-100 us in a stretch of -10 to 120 us: "render" holds
# "prepare" (0-10), "scene_build" (10-30) with its fingerprint (12-18),
# "trace" (30-70) and "image_out" (70-100) with its fetch (72-90); the card
# is busy 5-15, 40-60 and 60-75 (a kernel, then a copy that abuts it)
EVENTS = [
    _x("user_annotation", "render", 0, 100),
    _x("user_annotation", "prepare", 0, 10),
    _x("user_annotation", "scene_build", 10, 20),
    _x("user_annotation", "scene_build/fingerprint", 12, 6),
    _x("user_annotation", "trace", 30, 40),
    _x("user_annotation", "image_out", 70, 30),
    _x("user_annotation", "image_out/fetch", 72, 18),
    _x("user_annotation", "perfbench.clock", -5, 0),
    _x("kernel", "k", 5, 10),
    _x("kernel", "mega_render_kernel", 40, 20),
    _x("gpu_memcpy", "Memcpy DtoH", 60, 15),
    _x("cpu_op", "aten::copy_", 72, 18),
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 3},
]


def test_idle_goes_to_the_innermost_span_and_splits_at_boundaries():
    idle = spans.idle_by_span(EVENTS, set(spans.LAYERS), -10.0, 120.0)
    us = {k: round(v * 1e6, 6) for k, v in idle.items()}
    # -10-0 and 100-120 outside every span; 0-5 in prepare; the gap 15-40
    # crosses the fingerprint (15-18), scene_build (18-30) and trace
    # (30-40); 75-100 crosses fetch (75-90) and image_out (90-100)
    assert us == {"unspanned": 30.0, "prepare": 5.0,
                  "scene_build/fingerprint": 3.0, "scene_build": 12.0,
                  "trace": 10.0, "image_out/fetch": 15.0, "image_out": 10.0}
    layers = spans.by_layer(idle)
    assert {k: round(v * 1e6, 6) for k, v in layers.items()} == {
        "frontend": 30.0, "scene": 15.0, "kernel": 10.0, "unspanned": 30.0}
    # the layers partition the stretch's idle time: 130 us less 45 busy
    assert sum(layers.values()) * 1e6 == pytest.approx(130.0 - 45.0)


def test_a_stretch_that_cuts_through_busy_time_and_spans():
    idle = spans.idle_by_span(EVENTS, set(spans.LAYERS), 10.0, 65.0)
    us = {k: round(v * 1e6, 6) for k, v in idle.items()}
    assert us == {"scene_build/fingerprint": 3.0, "scene_build": 12.0,
                  "trace": 10.0}
    assert spans.idle_by_span(EVENTS, set(), 10.0, 65.0) == pytest.approx(
        {"unspanned": 25e-6})


def test_numbers_read_nothing_where_nothing_was_recorded():
    assert all(v is None for v in spans.numbers([], {}, {}, 0).values())
    # a call with the phases but no nested span and no counter
    rows = [("render", 0, 0, 10_000_000), ("image_out", 0, 1_000_000, 3_000_000)]
    got = spans.numbers(rows, {}, {}, 0)
    assert all(v is None for v in got.values())


def test_numbers_are_means_a_step():
    rows = [("render", 0, 0, 10), ("image_out/fetch", 0, 0, 2_000_000),
            ("render", 5, 20, 30), ("image_out/fetch", 5, 0, 4_000_000),
            ("scene_build/fingerprint", 5, 0, 1_000_000)]
    counters = {0: {"scene.upload_bytes": 3_000_000}}
    layers = {"frontend": 0.004, "unspanned": 0.002}
    got = spans.numbers(rows, counters, layers, 2)
    assert got["frontend.fetch_ms"] == pytest.approx(3.0)
    assert got["scene.fingerprint_ms"] == pytest.approx(0.5)
    assert got["scene.upload_mb"] == pytest.approx(1.5)
    assert got["accel.gather_mb"] is None and got["frontend.pack_ms"] is None
    assert got["frontend.idle_ms"] == pytest.approx(2.0)
    assert got["device.idle_unspanned_ms"] == pytest.approx(1.0)
    assert got["kernel.idle_ms"] == 0.0


def test_a_cpu_run_reads_every_number(tiny_root):
    """A short run of the snapshots cell on the CPU: every number is read,
    and the five idle numbers sum to the profiled stretch's idle time a
    step (here the whole stretch: no device operation)."""
    r = spans.run("hea32k_noao.snapshots", 2**31 + 3, 1.0, root=tiny_root,
                  backend="cpu")
    assert r["failed"] == 0 and r["profiled_steps"] >= 1 and r["timed_steps"] >= 1
    assert all(r[m] is not None for m in spans.NUMBERS), r
    idle = sum(r[m] for m, (kind, _) in spans.NUMBERS.items() if kind == "idle")
    assert idle == pytest.approx(r["idle_ms_a_step"], rel=0.02)
    assert r["frontend.fetch_ms"] + r["frontend.pack_ms"] <= r["image_out_ms"]
    assert r["image_out_ms"] - r["frontend.fetch_ms"] - r["frontend.pack_ms"] < 1.0
    assert r["scene.upload_mb"] > 0 and r["accel.gather_mb"] > 0
