"""The fixed-point numerics of the histogram kernels (``csrc/hist_fixed.cuh``).

Each f32 (grad, hess) value of lane l becomes ``q = rint(v * 2^k_l)``, an
int64, and every histogram sum is an exact int64 add, so the kernels'
results are the same whatever order their integer atomics run in.  The
scale is a pure function of the inputs, computed here in plain PyTorch on
the inputs' device (no host sync):

    k_l = 62 - ceil(log2(n_max * amax_l)),  clamped to at most ``K_MAX``

where ``n_max`` bounds the values one bin can receive and ``amax_l`` bounds
``|v|`` of the lane.  Then no bin sum passes ``2^62 + n_max/2 < 2^63``.
Each value rounds by at most ``2^-(k+1)``, so a bin of ``m`` values ends at
most ``m * 2^-(k+1) <= m * n_max * amax * 2^-62`` from its exact sum
(:func:`error_bound`) before its one rounding to f32.  A lane whose
``amax`` is NaN or Inf gets a NaN scale, and the kernels then write NaN in
every bin of that lane.  They also write NaN in a lane where a value
reaches :func:`value_limit` (a value past the ``amax`` its scale was made
from, large enough that a bin sum could pass int64), so a bound that
understates the values gives NaN or an exact sum, never a wrapped one.
"""
from __future__ import annotations

import torch

K_MAX = 126  # 2^k stays a normal f32, and v * 2^k cannot overflow f32


def lane_amax(gh: torch.Tensor) -> torch.Tensor:
    """f32 [2]: max |gh[:, lane]| (NaN if the lane holds a NaN, Inf if it
    holds an Inf and no NaN; 0 for no rows)."""
    if gh.shape[0] == 0:
        return torch.zeros(gh.shape[1], dtype=torch.float32, device=gh.device)
    return gh.abs().amax(0).to(torch.float32)


def fixed_point_scale(amax: torch.Tensor, n_max: int) -> torch.Tensor:
    """f32 [lanes] scale ``2^k`` of each lane (see the module docstring);
    NaN for a lane whose ``amax`` is not finite."""
    a = amax.to(torch.float64) * float(max(int(n_max), 1))
    k = (62.0 - torch.ceil(torch.log2(a))).clamp(max=K_MAX)
    return torch.where(torch.isfinite(k), torch.exp2(k),
                       torch.nan).to(torch.float32)


def value_limit(n_max: int) -> int:
    """``floor((2^63 - 1) / n_max)``: ``n_max`` quantised values below it
    in magnitude sum inside int64.  A value within the scale's ``amax``
    quantises to at most ``2^62 / n_max + 1``, about half of it."""
    return (2 ** 63 - 1) // max(int(n_max), 1)


def error_bound(scale: torch.Tensor, m: int) -> torch.Tensor:
    """float64 [lanes]: the most a bin of ``m`` values can differ from its
    exact sum before the f32 rounding, ``m * 2^-(k+1)``."""
    return float(m) * 0.5 / scale.to(torch.float64)
