"""What decides ``correct``, whatever the driver: steps of the window are
kept by a reservoir drawn from the seed (every step as likely), the
driver compares their outputs with its plain reference
(``drivers/<driver>.py``: ``numbers``), and each number is held to its
limit in the configuration's ``check.limits``."""

from __future__ import annotations

import numpy as np


class Reservoir:
    """``k`` steps of the window drawn uniformly from the seed, kept with
    their outputs (references, no copies)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = int(k), rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def judge(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] is not None and numbers[k] <= limits[k] for k in limits)
