"""The AO sky lights (``render.py:build_ao_lights``: each sky light's bins,
records and occluder table, scene-keyed): "ao_accel_build", which
"accel_build" excludes. Mean milliseconds a step, the card synchronised at
each phase's end; nothing to read where a step reuses the lights (a camera
move over a cached scene) or AO is off."""

from perfbench.metrics._phases import mean_ms


def read(records):
    return mean_ms(records, "ao_accel_build")
