"""The 95th percentile of the per-step latency over every step of the
window, in milliseconds (host clock from the call to the returned image;
numpy's linear interpolation)."""

import numpy as np


def read(records):
    lat = records.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95.0)) * 1e3
