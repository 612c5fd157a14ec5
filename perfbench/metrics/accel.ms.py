"""The view-keyed acceleration structures (``render/accel.py``'s screen bins
and the camera light's bins and records, ``render/gather.py``'s gather,
``megakernel.stack_lights``): "accel_build", which excludes
"ao_accel_build". Mean milliseconds a step, the card synchronised at each
phase's end."""

from perfbench.metrics._phases import mean_ms


def read(records):
    return mean_ms(records, "accel_build")
