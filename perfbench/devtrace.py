"""Reduce a ``torch.profiler`` Chrome trace to the device's busy time and
the breakdown: the device operations that took most time, and the idle
gaps by what the host was doing.

What the host was doing comes from ``HostSampler``, which samples the
main thread's Python stack every few milliseconds while the trace is
taken: a gap's seconds go to the program's lines (the innermost frame in
``mdapy_tpu_torch``, else the innermost frame) in proportion to the
samples that fall in it.  A gap with no sample takes the innermost host
operation of the trace that spans its midpoint."""

from __future__ import annotations

import bisect
import json
import os
import sys
import threading
import time
from collections import Counter, defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
NO_OP = "host code outside torch operations"
TOP = 10
NAME_CHARS = 160


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _label(host, starts, t):
    """The innermost host event that spans time ``t``: among those that do,
    the latest to start."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 256), -1):
        if host[j][1] >= t:
            return host[j][2]
    return NO_OP


PROGRAM = os.sep + "mdapy_tpu_torch" + os.sep
MARK = "perfbench.clock"


def _where(frame) -> str:
    inner = frame
    while frame is not None:
        path = frame.f_code.co_filename
        if PROGRAM in path:
            short = path[path.rindex(PROGRAM) + 1:]
            return f"{short}:{frame.f_lineno} {frame.f_code.co_name}"
        frame = frame.f_back
    if inner is None:
        return NO_OP
    return (f"{os.path.basename(inner.f_code.co_filename)}:{inner.f_lineno} "
            f"{inner.f_code.co_name}")


class HostSampler:
    """Samples the calling thread's Python stack every ``period`` seconds
    from a second thread: ``samples`` holds (perf_counter, where)."""

    def __init__(self, period: float = 0.002):
        self.period, self.samples = period, []
        self._tid = threading.get_ident()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.period):
            frame = sys._current_frames().get(self._tid)
            self.samples.append((time.perf_counter(), _where(frame)))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def mark_clock(record_function) -> float:
    """A zero-length annotation that ties the trace's clock to
    ``time.perf_counter``: returns the perf_counter time at its start."""
    with record_function(MARK):
        return time.perf_counter()


def reduce(path, samples=(), mark_s=None) -> dict:
    """{busy_s, device_ops, idle_gaps} of the trace at ``path`` (times in
    microseconds); ``samples`` from ``HostSampler`` and ``mark_s`` from
    ``mark_clock`` label the idle gaps."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host, offset = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        item = (a, a + float(e["dur"]), str(e.get("name", "?"))[:NAME_CHARS])
        if e.get("cat") in DEVICE_CATS:
            dev.append(item)
        elif e.get("cat") in HOST_CATS:
            host.append(item)
        if e.get("name") == MARK and mark_s is not None:
            offset = a - mark_s * 1e6
    samples = list(samples) if offset is not None else []
    times = [t * 1e6 + offset for t, _ in samples]
    ops = defaultdict(float)
    for a, b, name in dev:
        ops[name] += (b - a) * 1e-6
    busy = _union([(a, b) for a, b, _ in dev])
    host.sort()
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        lo, hi = bisect.bisect_left(times, end), bisect.bisect_right(times, nxt)
        if hi > lo:
            for where, n in Counter(w for _, w in samples[lo:hi]).items():
                gaps[where] += (nxt - end) * 1e-6 * n / (hi - lo)
        else:
            gaps[_label(host, starts, 0.5 * (end + nxt))] += (nxt - end) * 1e-6
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "device_ops": sorted(([k, v] for k, v in ops.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:TOP],
    }
