"""Mean squared displacement over a trajectory (window/FFT or direct mode).

The port of ``mdapy_tpu/analysis/mean_squared_displacement.py``: "window"
mode is the Wiener-Khinchin FFT autocorrelation, MSD(m) = S1(m) - 2 S2(m),
with ``torch.fft`` (cuFFT on the card) for S2 and the S1 recursion frame by
frame in the JAX order (:41-49); "direct" is the displacement from frame 0.
Float64 on ``device`` (the card unless the caller passes ``device="cpu"``).
Positions must be unwrapped.  cuFFT, torch's CPU FFT and numpy's pocketfft
round differently, so window mode agrees with the JAX package to a few ulp
of max |pos|^2, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["MeanSquaredDisplacement"]


class MeanSquaredDisplacement:
    """``device`` is "cuda" (default) or "cpu"."""

    def __init__(self, pos_list: np.ndarray, mode: str = "window", device="cuda"):
        mode = mode.lower()
        if mode not in ("window", "direct"):
            raise ValueError("mode must be 'window' or 'direct'")
        self.pos_list = np.ascontiguousarray(pos_list, dtype=np.float64)
        assert self.pos_list.ndim == 3 and self.pos_list.shape[2] == 3
        self.mode = mode
        self.device = resolve_device(device, "MeanSquaredDisplacement")
        self.particle_msd = None
        self.msd = None

    def compute(self):
        pos = torch.as_tensor(self.pos_list, device=self.device)
        Nframe = pos.shape[0]
        if self.mode == "direct":
            disp = pos - pos[0:1]
            particle_msd = torch.sum(disp * disp, dim=2)
        else:
            # Wiener-Khinchin per particle per dimension
            n = Nframe
            nfft = 1 << (2 * n - 1).bit_length()
            # S2 via FFT autocorrelation
            fft = torch.fft.rfft(pos, n=nfft, dim=0)
            acf = torch.fft.irfft(fft * torch.conj(fft), n=nfft, dim=0)[:n]
            del fft
            norm = torch.arange(n, 0, -1, dtype=torch.float64,
                                device=self.device)[:, None]
            S2 = acf.sum(dim=2) / norm
            del acf
            # S1 recursion
            sq = torch.sum(pos * pos, dim=2)        # (n, N)
            sumsq = 2.0 * sq.sum(dim=0)             # (N,)
            S1 = torch.empty_like(S2)
            run = sumsq.clone()
            for m in range(n):
                if m > 0:
                    run = run - sq[m - 1] - sq[n - m]
                S1[m] = run / (n - m)
            particle_msd = S1 - 2.0 * S2
        self.particle_msd = particle_msd.cpu().numpy()
        self.msd = self.particle_msd.mean(axis=1)
        return self

    def plot(self, fig=None, ax=None):
        import matplotlib.pyplot as plt

        if fig is None and ax is None:
            fig, ax = plt.subplots()
        ax.plot(self.msd, "o-")
        ax.set_xlabel("lag frames")
        ax.set_ylabel(r"MSD ($\AA^2$)")
        return fig, ax
