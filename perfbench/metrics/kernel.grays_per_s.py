"""Rays a second of the frame's pass, in billions: the benchmark's own
count of the rays a frame traces, W * H * (S * (1 + shadows) + K), with S
= aa_samples + 1 samples a pixel, a shadow ray a sample toward the camera
light, and K sky lights tested at each pixel's first sample, over the
"trace" phase's mean time (``kernel.ms``)."""

from perfbench.metrics._phases import mean_ms


def rays_per_frame(render: dict) -> int:
    s = (int(render["aa_samples"]) if render["antialiasing"] else 0) + 1
    k = 2 * max(1, int(render["ao_samples"]) // 2) if render["ao"] else 0
    shadow = 1 if (render["shadows"] or render["ao"]) else 0
    return int(render["width"]) * int(render["height"]) * (s * (1 + shadow) + k)


def read(records):
    ms = mean_ms(records, "trace")
    if not ms:
        return None
    return rays_per_frame(records["config"]["render"]) / (ms * 1e-3) / 1e9
