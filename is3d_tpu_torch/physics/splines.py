"""Natural cubic splines: built in numpy, evaluated in torch.

The reference interpolates delta-f coefficient tables with GSL natural cubic
splines (reference: src/cpp/deltafReader.cpp:300-395).  The polynomial
coefficients come from a host-side Thomas tridiagonal solve; evaluation is a
searchsorted + Horner scheme on the query's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..tensors import TensorContainer


@dataclass(frozen=True)
class CubicSpline(TensorContainer):
    """Piecewise cubic S_i(t) = y_i + b_i t + c_i t^2 + d_i t^3, t = x - x_i."""

    x: torch.Tensor  # knots, (n,)
    y: torch.Tensor  # values, (n,)
    b: torch.Tensor  # (n-1,)
    c: torch.Tensor  # (n-1,)
    d: torch.Tensor  # (n-1,)

    def __call__(self, xq: torch.Tensor) -> torch.Tensor:
        return evaluate(self, xq)


def _thomas(lower, diag, upper, rhs):
    """Solve a tridiagonal system (all numpy, host-side)."""
    n = len(diag)
    cp = np.empty(n)
    dp = np.empty(n)
    # n == 1 (exactly 3 spline knots -> one interior c): upper is empty
    cp[0] = upper[0] / diag[0] if n > 1 else 0.0
    dp[0] = rhs[0] / diag[0]
    for i in range(1, n):
        m = diag[i] - lower[i - 1] * cp[i - 1]
        cp[i] = upper[i] / m if i < n - 1 else 0.0
        dp[i] = (rhs[i] - lower[i - 1] * dp[i - 1]) / m
    out = np.empty(n)
    out[-1] = dp[-1]
    for i in range(n - 2, -1, -1):
        out[i] = dp[i] - cp[i] * out[i + 1]
    return out


def build_natural_cubic(x, y, dtype=torch.float64,
                        device="cpu") -> CubicSpline:
    """Host-side construction of a natural cubic spline (c''=0 at both ends)."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    n = x.shape[0]
    if n < 2:
        raise ValueError("need at least 2 knots")
    h = np.diff(x)
    if n == 2:
        c_full = np.zeros(2)
    else:
        # interior equations for c_1..c_{n-2}; natural BC: c_0 = c_{n-1} = 0
        lower = h[1:-1]
        diag = 2.0 * (h[:-1] + h[1:])
        upper = h[1:-1]
        slope = np.diff(y) / h
        rhs = 3.0 * (slope[1:] - slope[:-1])
        c_int = _thomas(lower, diag, upper, rhs)
        c_full = np.concatenate([[0.0], c_int, [0.0]])
    b = np.diff(y) / h - h * (c_full[1:] + 2.0 * c_full[:-1]) / 3.0
    d = (c_full[1:] - c_full[:-1]) / (3.0 * h)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return CubicSpline(x=t(x), y=t(y), b=t(b), c=t(c_full[:-1]), d=t(d))


def evaluate(spline: CubicSpline, xq: torch.Tensor) -> torch.Tensor:
    """Evaluate the spline at xq (any shape).

    Queries outside the knot range are clamped to the end intervals (the
    reference only evaluates in-domain; clamping gives graceful extrapolation
    instead of GSL's hard error)."""
    x = spline.x
    xq = torch.as_tensor(xq, dtype=x.dtype, device=x.device)
    n = x.shape[0]
    idx = torch.clamp(torch.searchsorted(x, xq.contiguous(), right=True) - 1,
                      0, n - 2)
    t = xq - x[idx]
    return spline.y[idx] + t * (spline.b[idx] + t * (spline.c[idx]
                                                     + t * spline.d[idx]))
