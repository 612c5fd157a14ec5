"""The frame's pass (``render/megakernel.py`` over ``csrc/mega_render.cu``, and
the frame's reassembly): "trace". Mean milliseconds a step, the card
synchronised at each phase's end."""

from perfbench.metrics._phases import mean_ms


def read(records):
    return mean_ms(records, "trace")
