"""The scene layer (``render/scene.py``: ``build_scene``, the AABB, the counts,
``other_table``), with the front end's sampled fingerprint of the inputs
("scene_build"). Mean milliseconds a step, the card synchronised at each
phase's end."""

from perfbench.metrics._phases import mean_ms


def read(records):
    return mean_ms(records, "scene_build")
