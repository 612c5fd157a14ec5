"""Cubic-spline interpolation on a strictly-increasing grid.

A host copy of ``mdapy_tpu/utils/spline.py`` (the Thomas solve :28-43, the
end slopes :46-64, the boundary conditions :67-144, ``Spline`` :147-269:
``evaluate``, ``derivative``, ``second_derivative``, ``coefficients``),
built in NumPy.  The JAX package's jittable ``evaluate_jax`` (:238-255)
becomes ``evaluate_torch``: one ``torch.searchsorted`` and a Horner pass on
a tensor on any device.

Contract (matching reference spline.py:112-125, 152-170):
- bc_type in {"not-a-knot", "natural", "clamped"}; clamped endpoint slopes
  default to three-point quadratic estimates.
- scalar out-of-range queries raise IndexError; array queries return NaN
  element-wise (no silent extrapolation).
"""

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["Spline"]

_ArrayLike = Union[float, int, List, Tuple, np.ndarray]


def _thomas(lower, diag, upper, rhs):
    """Solve a tridiagonal system in O(n). lower[0] and upper[-1] unused."""
    n = len(diag)
    c = np.empty(n)
    d = np.empty(n)
    c[0] = upper[0] / diag[0]
    d[0] = rhs[0] / diag[0]
    for i in range(1, n):
        m = diag[i] - lower[i] * c[i - 1]
        c[i] = upper[i] / m if i < n - 1 else 0.0
        d[i] = (rhs[i] - lower[i] * d[i - 1]) / m
    x = np.empty(n)
    x[-1] = d[-1]
    for i in range(n - 2, -1, -1):
        x[i] = d[i] - c[i] * x[i + 1]
    return x


def _quadratic_end_slope(x, y, at_start: bool) -> float:
    """Three-point quadratic slope estimate at an endpoint."""
    if len(x) == 2:
        return float((y[1] - y[0]) / (x[1] - x[0]))
    if at_start:
        x0, x1, x2 = x[0], x[1], x[2]
        y0, y1, y2 = y[0], y[1], y[2]
        t = x0
    else:
        x0, x1, x2 = x[-3], x[-2], x[-1]
        y0, y1, y2 = y[-3], y[-2], y[-1]
        t = x2
    # derivative of the Lagrange quadratic through the three points
    d = (
        y0 * (2 * t - x1 - x2) / ((x0 - x1) * (x0 - x2))
        + y1 * (2 * t - x0 - x2) / ((x1 - x0) * (x1 - x2))
        + y2 * (2 * t - x0 - x1) / ((x2 - x0) * (x2 - x1))
    )
    return float(d)


def _solve_second_derivatives(x, y, bc_type, dy0, dyn):
    """Return knot second derivatives sigma_i for the chosen boundary."""
    n = len(x)
    h = np.diff(x)
    if n == 2:
        if bc_type == "clamped":
            # single cubic with prescribed end slopes: 2x2 system in (sig0, sig1)
            s = (y[1] - y[0]) / h[0]
            A = np.array([[h[0] / 3.0, h[0] / 6.0], [h[0] / 6.0, h[0] / 3.0]])
            b = np.array([s - dy0, dyn - s])
            return np.linalg.solve(A, b)
        return np.zeros(2)

    slopes = np.diff(y) / h
    rhs_int = slopes[1:] - slopes[:-1]  # length n-2

    if bc_type == "not-a-knot" and n == 3:
        # both not-a-knot conditions coincide -> the single quadratic
        # through the three points (same degeneracy handling as scipy)
        c2 = rhs_int[0] / (h[0] + h[1])  # quadratic coefficient
        return np.full(3, 2.0 * c2)

    if bc_type in ("natural", "clamped") or n <= 4:
        # assemble the full (small or simple-boundary) system
        A = np.zeros((n, n))
        b = np.zeros(n)
        for i in range(1, n - 1):
            A[i, i - 1] = h[i - 1] / 6.0
            A[i, i] = (h[i - 1] + h[i]) / 3.0
            A[i, i + 1] = h[i] / 6.0
            b[i] = rhs_int[i - 1]
        if bc_type == "natural":
            A[0, 0] = 1.0
            A[-1, -1] = 1.0
        elif bc_type == "clamped":
            A[0, 0] = h[0] / 3.0
            A[0, 1] = h[0] / 6.0
            b[0] = slopes[0] - dy0
            A[-1, -2] = h[-1] / 6.0
            A[-1, -1] = h[-1] / 3.0
            b[-1] = dyn - slopes[-1]
        else:  # not-a-knot, n in (3, 4)
            A[0, 0] = h[1]
            A[0, 1] = -(h[0] + h[1])
            A[0, 2] = h[0]
            A[-1, -3] = h[-1]
            A[-1, -2] = -(h[-2] + h[-1])
            A[-1, -1] = h[-2]
        return np.linalg.solve(A, b)

    # not-a-knot, general n: eliminate sigma_0 and sigma_{n-1} into the
    # first/last interior rows, Thomas-solve for sigma_1..sigma_{n-2}
    m = n - 2
    lower = np.empty(m)
    diag = np.empty(m)
    upper = np.empty(m)
    rhs = rhs_int.copy()
    for k in range(m):
        i = k + 1  # knot index
        lower[k] = h[i - 1] / 6.0
        diag[k] = (h[i - 1] + h[i]) / 3.0
        upper[k] = h[i] / 6.0
    # left: sigma_0 = sigma_1 (1 + h0/h1) - sigma_2 (h0/h1)
    r0 = h[0] / h[1]
    diag[0] += lower[0] * (1.0 + r0)
    upper[0] -= lower[0] * r0
    lower[0] = 0.0
    # right: sigma_{n-1} = sigma_{n-2} (1 + h_{n-2}/h_{n-3}) - sigma_{n-3} (h_{n-2}/h_{n-3})
    rn = h[-1] / h[-2]
    diag[-1] += upper[-1] * (1.0 + rn)
    lower[-1] -= upper[-1] * rn
    upper[-1] = 0.0
    sig_in = _thomas(lower, diag, upper, rhs)
    sigma = np.empty(n)
    sigma[1:-1] = sig_in
    sigma[0] = sig_in[0] * (1.0 + r0) - sig_in[1] * r0
    sigma[-1] = sig_in[-1] * (1.0 + rn) - sig_in[-2] * rn
    return sigma


class Spline:
    """C^2 piecewise-cubic interpolant (reference: src/mdapy/spline.py:9)."""

    _BC_TYPES = ("not-a-knot", "natural", "clamped")

    def __init__(
        self,
        x: _ArrayLike,
        y: _ArrayLike,
        bc_type: str = "not-a-knot",
        dy0: Optional[float] = None,
        dyn: Optional[float] = None,
    ):
        self.x, self.y = self._validate(x, y)
        if bc_type not in self._BC_TYPES:
            raise ValueError(
                f"Unknown bc_type {bc_type!r}. Expected one of {list(self._BC_TYPES)}."
            )
        self.bc_type = bc_type
        if bc_type == "clamped":
            if (dy0 is None) != (dyn is None):
                raise ValueError(
                    "For clamped with explicit derivatives both dy0 and dyn must be given."
                )
            if dy0 is None:
                dy0 = _quadratic_end_slope(self.x, self.y, True)
                dyn = _quadratic_end_slope(self.x, self.y, False)
        self._sigma = _solve_second_derivatives(self.x, self.y, bc_type, dy0, dyn)
        # per-interval cubic s(t) = a + b t + c t^2 + d t^3, t = x - x_i
        h = np.diff(self.x)
        sig = self._sigma
        self._a = self.y[:-1].copy()
        self._b = np.diff(self.y) / h - h * (2.0 * sig[:-1] + sig[1:]) / 6.0
        self._c = sig[:-1] / 2.0
        self._d = (sig[1:] - sig[:-1]) / (6.0 * h)

    # -- evaluation ----------------------------------------------------
    def evaluate(self, x: _ArrayLike) -> Union[float, np.ndarray]:
        """s(x); NaN out-of-range for arrays, IndexError for scalars."""
        return self._dispatch(x, 0, "value")

    def derivative(self, x: _ArrayLike) -> Union[float, np.ndarray]:
        """Analytic s'(x) from the stored cubic coefficients."""
        return self._dispatch(x, 1, "derivative")

    def second_derivative(self, x: _ArrayLike) -> Union[float, np.ndarray]:
        """s''(x) (exactly piecewise-linear between knots)."""
        return self._dispatch(x, 2, "second derivative")

    __call__ = evaluate

    # -- internals -----------------------------------------------------
    def _eval_array(self, xq: np.ndarray, order: int) -> np.ndarray:
        idx = np.clip(np.searchsorted(self.x, xq, side="right") - 1, 0, len(self.x) - 2)
        t = xq - self.x[idx]
        a, b, c, d = self._a[idx], self._b[idx], self._c[idx], self._d[idx]
        if order == 0:
            out = a + t * (b + t * (c + t * d))
        elif order == 1:
            out = b + t * (2.0 * c + t * 3.0 * d)
        else:
            out = 2.0 * c + 6.0 * d * t
        oob = (xq < self.x[0]) | (xq > self.x[-1])
        if np.any(oob):
            out = np.where(oob, np.nan, out)
        return out

    def _dispatch(self, x, order: int, kind: str):
        if isinstance(x, (int, float, np.integer, np.floating)):
            xf = float(x)
            if xf < self.x[0] or xf > self.x[-1]:
                raise IndexError(
                    f"Cannot evaluate {kind} at x={xf}: outside interpolation "
                    f"range [{self.x[0]}, {self.x[-1]}]."
                )
            return float(self._eval_array(np.array([xf]), order)[0])
        if isinstance(x, np.ndarray):
            xq = x if x.dtype == np.float64 else x.astype(np.float64)
        elif isinstance(x, (list, tuple)):
            xq = np.asarray(x, dtype=np.float64)
        else:
            raise TypeError(
                f"Input type {type(x)} not supported. "
                "Expected float, int, list, tuple, or numpy.ndarray."
            )
        return self._eval_array(xq, order)

    def coefficients(self):
        """(a, b, c, d) per-interval coefficients in local coordinates."""
        return self._a, self._b, self._c, self._d

    def evaluate_torch(self, xq, order: int = 0):
        """s(xq), s'(xq) (order 1) or s''(xq) (order 2) of a tensor on any
        device, in float64 (same semantics as ``evaluate`` minus the NaN
        masking, as the JAX package's ``evaluate_jax``)."""
        dev = xq.device
        xq = xq.to(torch.float64)
        knots = torch.as_tensor(self.x, device=dev)
        idx = torch.clamp(torch.searchsorted(knots, xq, right=True) - 1,
                          0, len(self.x) - 2)
        t = xq - knots[idx]
        a, b, c, d = (torch.as_tensor(v, device=dev)[idx]
                      for v in (self._a, self._b, self._c, self._d))
        if order == 0:
            return a + t * (b + t * (c + t * d))
        if order == 1:
            return b + t * (2.0 * c + t * 3.0 * d)
        return 2.0 * c + 6.0 * d * t

    @staticmethod
    def _validate(x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if x.ndim != 1:
            raise ValueError(f"x must be 1-dimensional, got {x.ndim}D array")
        if y.ndim != 1:
            raise ValueError(f"y must be 1-dimensional, got {y.ndim}D array")
        if len(x) < 2:
            raise ValueError(f"x must have at least 2 points, got {len(x)}")
        if len(x) != len(y):
            raise ValueError(f"Length of x and y must match. Got x: {len(x)}, y: {len(y)}")
        if np.any(np.diff(x) <= 0):
            raise ValueError("x must be strictly increasing")
        return x, y
