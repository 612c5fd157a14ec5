"""The front end of ``render/render.py``: the input checks and conversions
("prepare") and the host image out ("image_out": the copy from the card, the
truncating quantizer, the alpha). Mean milliseconds a step, the card
synchronised at each phase's end."""

from perfbench.metrics._phases import mean_ms


def read(records):
    return mean_ms(records, "prepare", "image_out")
