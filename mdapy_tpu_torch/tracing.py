"""Spans and counters of the render path, kept in memory on request.

    from mdapy_tpu_torch import tracing

    with tracing.recording() as rec:
        img = ren.render(positions, colors, radii, width=800, height=600)
    for s in rec.spans:      # name, id, parent, call, start_ns, end_ns
        ...
    rec.counters             # {call: {counter name: total}}

``span(name)`` marks a block of the program and ``count(name, n)`` adds
``n`` to a counter of the ``render`` call under way.  Recording is off by
default: then both cost one test of a module flag, and record and allocate
nothing.  While it is on, a span keeps its name, its own id, its parent's
id, the id of the call it belongs to (the id of the outermost span open
when it began: ``render`` for the render path) and its start and end on
``time.perf_counter_ns``; it also opens a ``torch.profiler.record_function``
range of its name, so that under an active ``torch.profiler`` it lies in
the trace, as a ``user_annotation``, on the trace's clock.  Nothing is
written out.  One recorder at a time, fed by the thread that renders.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

__all__ = ["span", "count", "recording", "Recorder", "Span"]

_rec = None   # the Recorder while recording, else None


class Recorder:
    """What one ``recording()`` kept: ``spans``, the closed spans in the
    order they ended, and ``counters``, {call id: {name: total}} (the call
    None for counts made outside every span)."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self._open: list = []
        self._ids = 0


class Span:
    """An open span; ``close`` ends it, and the ``with`` statement's exit
    does.  Opened by ``span``."""

    __slots__ = ("name", "id", "parent", "call", "start_ns", "end_ns",
                 "_rec", "_range")

    def __init__(self, rec: Recorder, name: str, start_ns=None):
        top = rec._open[-1] if rec._open else None
        self.name, self.id, self._rec = name, rec._ids, rec
        rec._ids += 1
        self.parent = None if top is None else top.id
        self.call = self.id if top is None else top.call
        self._range = torch.profiler.record_function(name)
        self._range.__enter__()
        self.start_ns = time.perf_counter_ns() if start_ns is None else start_ns
        self.end_ns = None
        rec._open.append(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self, end_ns=None) -> None:
        """Ends the span at ``end_ns`` (now, by default), and with it every
        span opened inside it and left open, as a call that raised leaves
        them; a closed span stays as it is."""
        if self.end_ns is not None:
            return
        end = time.perf_counter_ns() if end_ns is None else end_ns
        stack = self._rec._open
        while stack:
            s = stack.pop()
            s.end_ns = end
            s._range.__exit__(None, None, None)
            self._rec.spans.append(s)
            if s is self:
                break


class _Off:
    """What ``span`` returns while nothing records: a context that does
    nothing, one object for every call."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None

    def close(self, end_ns=None) -> None:
        return None


_OFF = _Off()


def span(name: str, start_ns=None):
    """Span ``name``, open from now (or from ``start_ns``, a reading of
    ``time.perf_counter_ns`` already taken) until it is closed; inside the
    spans open at the time.  Use as ``with span(name): ...``."""
    if _rec is None:
        return _OFF
    return Span(_rec, name, start_ns)


def count(name: str, n: int) -> None:
    """Adds ``n`` to counter ``name`` of the call under way."""
    if _rec is None:
        return
    call = _rec._open[0].call if _rec._open else None
    totals = _rec.counters.setdefault(call, {})
    totals[name] = totals.get(name, 0) + int(n)


@contextmanager
def recording():
    """Turns recording on for the block and yields its ``Recorder``; spans
    still open at its end are closed there."""
    global _rec
    if _rec is not None:
        raise RuntimeError("tracing.recording() is already on")
    rec = Recorder()
    _rec = rec
    try:
        yield rec
    finally:
        _rec = None
        if rec._open:
            rec._open[0].close()
