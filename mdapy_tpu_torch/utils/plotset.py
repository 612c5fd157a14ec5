"""Publication-style matplotlib defaults + figure helpers.

A host copy of ``mdapy_tpu/utils/plotset.py`` (:1-80, whole; parity:
reference plotset.py, set_figure / save_figure / pltset).  matplotlib is
imported inside each call, so the package imports without it and a call
without it raises the same ImportError as the JAX package's.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import numpy as np

__all__ = ["pltset", "set_figure", "save_figure", "cm2inch"]

_PALETTE = [
    "#4477AA", "#EE6677", "#228833", "#CCBB44", "#66CCEE", "#AA3377",
    "#BBBBBB",
]


def pltset(color_cycler: Optional[Union[List[str], Tuple[str, ...]]] = None,
           **kwargs: Any) -> None:
    """Apply the scientific-publication rcParams profile globally."""
    import matplotlib.pyplot as plt
    from cycler import cycler

    plt.rcParams.clear()
    plt.rcParams.update(plt.rcParamsDefault)
    plt.rcParams["axes.prop_cycle"] = cycler(
        "color", list(color_cycler) if color_cycler else _PALETTE
    )
    plt.rcParams.update({
        "xtick.direction": "in", "xtick.major.size": 3,
        "xtick.major.width": 0.6, "xtick.minor.size": 1.5,
        "xtick.minor.width": 0.6, "xtick.top": True,
        "ytick.direction": "in", "ytick.major.size": 3,
        "ytick.major.width": 0.6, "ytick.minor.size": 1.5,
        "ytick.minor.width": 0.6, "ytick.right": True,
        "axes.linewidth": 0.6, "lines.linewidth": 1.2,
        "lines.markersize": 3, "font.size": 10.0,
        "legend.frameon": False, "legend.fontsize": 9.0,
        "axes.titlesize": 9.0, "font.family": "serif",
        "font.serif": ["Times New Roman", "Arial", "cmr10"],
        "axes.formatter.use_mathtext": True, "mathtext.fontset": "cm",
    })
    for key, value in kwargs.items():
        import matplotlib.pyplot as plt

        if key in plt.rcParams:
            plt.rcParams[key] = value
        else:
            print(f"Warning: '{key}' is not a valid rcParam key and will be "
                  "ignored.")


def cm2inch(value: Union[float, int]) -> float:
    return value / 2.54


def set_figure(figsize: Tuple[float, float] = (8.5, 7.0), figdpi: int = 150,
               nrow: int = 1, ncol: int = 1,
               color_cycler: Optional[Union[List[str], Tuple[str, ...]]] = None,
               **kwargs: Any):
    """Create a styled figure; ``figsize`` is in centimetres. Returns
    (fig, ax) where ax mirrors plt.subplots but as (nested) lists."""
    import matplotlib.pyplot as plt

    pltset(color_cycler=color_cycler, **kwargs)
    fig, ax = plt.subplots(nrow, ncol,
                           figsize=tuple(cm2inch(s) for s in figsize),
                           dpi=figdpi, constrained_layout=True)
    if isinstance(ax, np.ndarray):
        ax = ax.tolist()
    return fig, ax


def save_figure(fig, filename: str, dpi: int = 300, format: str = "png",
                transparent: bool = True, pad_scale: float = 1.02) -> None:
    """Save with uniform whitespace margins."""
    fig.savefig(filename, dpi=dpi, format=format, transparent=transparent,
                bbox_inches="tight", pad_inches=0.02 * pad_scale)
