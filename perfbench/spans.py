#!/usr/bin/env python3
"""The card's idle time put down to the program's spans, and the numbers
that ``mdapy_tpu_torch.tracing`` gives a cell.

``idle_by_span`` reduces a ``torch.profiler`` Chrome trace: the card's
idle intervals are the complement, within the stretch, of the same busy
union that ``device.idle_share`` takes (``devtrace._union`` of the
kernels, copies and sets), and each idle microsecond goes to the innermost
program span (a ``user_annotation`` of a span's name) open at that
instant, on the trace's own clock: a gap that crosses a span's boundary is
split there, and idle time with no span open goes to ``UNSPANNED``.
``LAYERS`` puts the render path's spans in the benchmark's layers.

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs a cell as a ``--trace 1`` run of ``run.py`` does (the warm-up, then a
profiled stretch at verbosity "min", then a stretch at verbosity "timing")
with ``mdapy_tpu_torch.tracing.recording()`` on in both stretches, and
prints one JSON line: the numbers of ``NUMBERS`` (None where the cell has
nothing to read) and the sums they are checked against.  The harness's
own traced run does not turn recording on.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import devtrace  # noqa: E402

UNSPANNED = "unspanned"
# the render path's spans by layer: the front end, the scene, the
# acceleration structures, the kernel
LAYERS = {"render": "frontend", "prepare": "frontend", "image_out": "frontend",
          "image_out/fetch": "frontend", "image_out/pack": "frontend",
          "scene_build": "scene", "scene_build/fingerprint": "scene",
          "accel_build": "accel", "ao_accel_build": "accel",
          "trace": "kernel"}
# name -> (kind, what it reads): "span", mean host ms a step of the span in
# the "timing" stretch; "counter", MB (1e6 B) a step of the counter;
# "idle", the card's idle ms a step under the layer's spans in the
# profiled stretch
NUMBERS = {
    "frontend.fetch_ms": ("span", "image_out/fetch"),
    "frontend.pack_ms": ("span", "image_out/pack"),
    "scene.fingerprint_ms": ("span", "scene_build/fingerprint"),
    "scene.upload_mb": ("counter", "scene.upload_bytes"),
    "accel.gather_mb": ("counter", "accel.gather_bytes"),
    "frontend.idle_ms": ("idle", "frontend"),
    "scene.idle_ms": ("idle", "scene"),
    "accel.idle_ms": ("idle", "accel"),
    "kernel.idle_ms": ("idle", "kernel"),
    "device.idle_unspanned_ms": ("idle", UNSPANNED),
}


def idle_by_span(events, names, lo_us: float, hi_us: float) -> dict:
    """{span name or ``UNSPANNED``: idle seconds} over ``[lo_us, hi_us]`` of
    the trace's ``events``; ``names`` are the program's span names."""
    dev, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if e.get("cat") in devtrace.DEVICE_CATS:
            dev.append((a, b))
        elif e.get("cat") == "user_annotation" and e.get("name") in names:
            spans.append((a, b, e["name"]))
    # the idle intervals: [lo, hi] less the busy union
    idle, cur = [], lo_us
    for a, b in devtrace._union(dev):
        if a > cur:
            idle.append((cur, min(a, hi_us)))
        cur = max(cur, b)
        if cur >= hi_us:
            break
    if cur < hi_us:
        idle.append((cur, hi_us))
    # a sweep over every boundary (time, kind, index); at one instant a
    # span opens (0) before any closes (3), and an idle interval ends (1)
    # before the next begins (2)
    cuts = [(a, 0, k) for k, (a, _, _) in enumerate(spans)]
    cuts += [(b, 3, k) for k, (_, b, _) in enumerate(spans)]
    cuts += [(a, 2, -1) for a, b in idle if b > a]
    cuts += [(b, 1, -1) for a, b in idle if b > a]
    cuts.sort()
    out = defaultdict(float)
    open_spans, in_idle, prev = [], False, lo_us
    for t, kind, k in cuts:
        if in_idle and t > prev:
            name = spans[open_spans[-1]][2] if open_spans else UNSPANNED
            out[name] += (t - prev) * 1e-6
        prev = t
        if kind == 0:
            open_spans.append(k)
        elif kind == 3:
            open_spans.remove(k)
        else:
            in_idle = kind == 2
    return dict(out)


def by_layer(idle: dict) -> dict:
    """``idle_by_span``'s seconds summed by layer (``LAYERS``)."""
    out = defaultdict(float)
    for name, s in idle.items():
        out[LAYERS.get(name, UNSPANNED)] += s
    return dict(out)


def numbers(spans, counters, idle_layers, profiled_steps: int) -> dict:
    """``NUMBERS`` from the "timing" stretch's ``spans`` (name, call, start
    ns, end ns) and ``counters`` ({call: {name: total}}), and the profiled
    stretch's idle seconds by layer over its steps; None where there is
    nothing to read: a span or counter no call recorded, a stretch with no
    step."""
    calls = {c for name, c, _, _ in spans if name == "render"}
    out = {}
    for metric, (kind, what) in NUMBERS.items():
        value = None
        if kind == "span" and calls:
            ns = [b - a for name, _, a, b in spans if name == what]
            value = sum(ns) * 1e-6 / len(calls) if ns else None
        elif kind == "counter" and calls:
            n = [counters.get(c, {}).get(what) for c in calls]
            if any(v is not None for v in n):
                value = sum(v or 0 for v in n) / len(calls) / 1e6
        elif kind == "idle" and profiled_steps and idle_layers:
            value = idle_layers.get(what, 0.0) / profiled_steps * 1e3
        out[metric] = value
    return out


def run(cell_name: str, seed: int, seconds: float, *, root=None,
        backend: str = "cuda") -> dict:
    """One cell's warm-up and two stretches with the tracer on (see the
    module's docstring): ``NUMBERS``, and beside them the stretches' steps,
    the profiled window and its busy time, the idle time it leaves, and
    the "timing" stretch's mean "image_out" phase."""
    import torch
    from mdapy_tpu_torch import tracing

    from perfbench import harness, spec

    cell = spec.load_cell(cell_name, root or spec.ROOT)
    driver = spec.driver(cell.config)
    device = torch.device(backend)
    inputs = driver.inputs(cell.config, cell.mix, seed)
    loop = harness.Loop(driver.Client(driver.make(cell.config, backend, seed),
                                      inputs, cell.config))
    for i in range(-inputs.warmup_steps, 0):
        loop.client.step(i)
    harness._sync(device)
    prof_s = min(0.5 * seconds, harness.PROFILE_MAX_S)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def keep(i, out):
        return None

    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        with torch.profiler.profile(activities=acts) as prof, \
                tracing.recording():
            mark_s = devtrace.mark_clock(torch.profiler.record_function)
            t0 = time.perf_counter()
            profiled = loop.window(0, prof_s, keep)
            harness._sync(device)
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        events = json.loads(path.read_text())["traceEvents"]
        marks = [e for e in events if e.get("name") == devtrace.MARK]
        offset = float(marks[0]["ts"]) - mark_s * 1e6
        lo = t0 * 1e6 + offset
        idle = idle_by_span(events, set(LAYERS), lo,
                            lo + profiled["window_s"] * 1e6)
        del events
        busy = devtrace.reduce(path)["busy_s"]
        with loop.client.phases(Path(tmp) / "phases.log"), \
                tracing.recording() as timed_rec:
            timed = loop.window(profiled["next"], seconds - prof_s, keep)
    steps = len(profiled["latencies_s"])
    rows = [(s.name, s.call, s.start_ns, s.end_ns) for s in timed_rec.spans]
    out = numbers(rows, timed_rec.counters, by_layer(idle), steps)
    image_out = [b - a for name, _, a, b in rows if name == "image_out"]
    out.update(
        profiled_steps=steps, timed_steps=len(timed["latencies_s"]),
        profile_window_s=profiled["window_s"], busy_s=busy,
        idle_ms_a_step=(profiled["window_s"] - busy) / steps * 1e3 if steps else None,
        image_out_ms=(sum(image_out) * 1e-6 / len(timed["latencies_s"])
                      if image_out else None),
        failed=loop.failed)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--backend", default="cuda")
    args = ap.parse_args(argv)
    result = run(args.workload, args.seed, args.seconds, backend=args.backend)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
