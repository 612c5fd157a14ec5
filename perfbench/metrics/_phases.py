"""Mean milliseconds a step of phases of ``TachyonRender.last_timings``,
over the traced run's stretch at verbosity "timing"."""


def mean_ms(records, *phases):
    """The mean over the steps of the phases' sum; None, nothing to read,
    unless every step reports every phase."""
    steps = records.get("timings") or []
    if not steps or not all(p in t for t in steps for p in phases):
        return None
    return sum(sum(t[p] for p in phases) for t in steps) / len(steps) * 1e3
