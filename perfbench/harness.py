"""One run of one cell: inputs from the seed, warm-up, the measured window,
the comparison with the plain reference, and the result.

The configuration names its driver (``drivers/<driver>.py``), which gives
the system under test, the client that drives it, and the comparison.  The
window runs the client in a closed loop: a step is one call, from the
inputs to the finished output, timed on the host clock, and the window runs
until the first step that ends past ``seconds``.  With ``trace``, the
window is two stretches: the first under ``torch.profiler`` as the system
runs by default (the device's busy time and the breakdown), the second with
the driver's phase times on (for the render driver ``last_timings`` at
verbosity "timing", the card synchronised at each phase's end), which the
per-layer readers take.
"""

from __future__ import annotations

import gc
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import check, devtrace, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "mdapy_tpu")
# the profiled stretch of a traced run takes half the window, at most this
PROFILE_MAX_S = 10.0


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


class Forbidden(RuntimeError):
    """The process has loaded JAX or the JAX package."""


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run must not load, compared
    whole (``mdapy_tpu_torch`` is not ``mdapy_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Loop:
    """The closed loop of one client, with its count of failed steps."""

    def __init__(self, client):
        self.client, self.failed = client, 0

    def window(self, first: int, seconds: float, on_step) -> dict:
        """Steps from ``first`` until one ends past ``seconds``: the window's
        seconds, the per-step seconds, the next step.  A step that raises
        or returns a malformed output counts as failed and ends the
        window."""
        start = time.perf_counter()
        end, lat, i = start, [], first
        while end - start < seconds:
            t0 = time.perf_counter()
            try:
                out = self.client.step(i)
            except Exception as exc:   # a failed step is counted, not fatal
                print(f"step {i} failed: {exc!r}", file=sys.stderr)
                self.failed += 1
                end, i = time.perf_counter(), i + 1
                break
            end = time.perf_counter()
            why = self.client.problem(out)
            if why is not None:
                print(f"step {i} {why}", file=sys.stderr)
                self.failed += 1
                i += 1
                break
            lat.append(end - t0)
            on_step(i, out)
            i += 1
        return {"window_s": end - start, "latencies_s": lat, "next": i}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def _traced_window(loop, device, seconds, keep, tmp: Path) -> tuple:
    """The two stretches of a traced run: (records, next step, breakdown)."""
    prof_s = min(0.5 * seconds, PROFILE_MAX_S)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        mark_s = devtrace.mark_clock(torch.profiler.record_function)
        with devtrace.HostSampler() as sampler:
            profiled = loop.window(0, prof_s, keep)
            _sync(device)
    path = tmp / "trace.json"
    prof.export_chrome_trace(str(path))
    del prof
    reduced = devtrace.reduce(path, sampler.samples, mark_s)
    path.unlink()
    timings = []

    def keep_timed(i, out):
        timings.append(loop.client.phase_times())
        keep(i, out)

    with loop.client.phases(tmp / "phases.log"):
        timed = loop.window(profiled["next"], seconds - prof_s, keep_timed)
    records = {"timings": timings, "busy_s": reduced["busy_s"],
               "profile_window_s": profiled["window_s"]}
    breakdown = {"device_ops": reduced["device_ops"],
                 "idle_gaps": reduced["idle_gaps"]}
    return records, timed["next"], breakdown


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        root=spec.ROOT, backend: str = "cuda", system_factory=None,
        control=None, t_start=None) -> dict:
    """One run; returns the result's fields (``check`` last).

    ``system_factory`` puts another system in the program's place (the
    driver's ``FAULTS``); ``control`` (a dtype) puts the reference computed
    in that precision in the place of the program's outputs in the
    comparison."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.load_cell(cell_name, root)
    chips = int(cell.workload["chips"])
    if backend == "cuda" and not (torch.cuda.is_available()
                                  and torch.cuda.device_count() >= chips):
        raise NoDevice(
            f"cell {cell_name} needs {chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() is {torch.cuda.device_count()}")
    driver = spec.driver(cell.config)
    driver.require()

    device = torch.device(backend)
    inputs = driver.inputs(cell.config, cell.mix, seed)
    make = system_factory or driver.make
    loop = Loop(driver.Client(make(cell.config, backend, seed), inputs,
                              cell.config))
    for i in range(-inputs.warmup_steps, 0):
        loop.client.step(i)
    _sync(device)
    gc.collect()
    setup_s = time.perf_counter() - t_start
    setup_peak = _peak(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    cfg_check = cell.config["check"]
    reservoir = check.Reservoir(cfg_check["steps"], spec.rng(seed, 4))

    def keep(i, out):
        reservoir.offer((i, out))

    tmp = Path(tempfile.mkdtemp(prefix="perfbench-"))
    try:
        records = {"setup_s": setup_s, "config": cell.config, "mix": cell.mix}
        breakdown = None
        if trace:
            traced, nxt, breakdown = _traced_window(loop, device, seconds,
                                                    keep, tmp)
            records.update(traced)
        else:
            w = loop.window(0, seconds, keep)
            nxt = w["next"]
            records.update(window_s=w["window_s"], steps=len(w["latencies_s"]),
                           latencies_s=w["latencies_s"])
        _sync(device)
        window_peak = _peak(device)
        records["peak_mem_bytes"] = window_peak
        device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                       "kind": (torch.cuda.get_device_name(device)
                                if device.type == "cuda" else "cpu"),
                       "count": chips,
                       "memory_peak_bytes": max(setup_peak, window_peak)}
        if trace:
            device_info.update(busy_s=records["busy_s"],
                               window_s=records["profile_window_s"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the program's state goes before the reference runs on the card
    failed = loop.failed
    del loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limits = cfg_check["limits"]
    if reservoir.items:
        numbers = driver.numbers(inputs, cell.config, seed, reservoir.items,
                                 device=device, control=control)
    else:
        numbers = dict.fromkeys(driver.NUMBERS)
    correct = bool(reservoir.items) and failed == 0 and check.judge(numbers, limits)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(cell.bench_dir, m["name"])(records)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded modules that a run must not load: {found}")
    result = {"correct": correct, "attempted": nxt, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in driver.NUMBERS}
    return result
