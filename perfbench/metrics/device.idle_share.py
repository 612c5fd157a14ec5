"""Per cent of the profiled stretch (verbosity "min") in which no operation
ran on the card: 1 - (union of the kernels', copies' and sets' intervals in
the ``torch.profiler`` trace) / (the stretch's host-clock length)."""


def read(records):
    busy, window = records.get("busy_s"), records.get("profile_window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
