"""Milliseconds a step: the whole window over the steps completed in it
(host clock; a step ends when its host image is returned)."""


def read(records):
    if not records.get("steps"):
        return None
    return records["window_s"] / records["steps"] * 1e3
