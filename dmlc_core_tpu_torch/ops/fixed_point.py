"""The fixed-point numerics of the kernels (``csrc/hist_fixed.cuh``).

Each f32 (grad, hess) value of lane l becomes ``q = rint(v * 2^k_l)``, an
int64, and every histogram sum is an exact int64 add, so the kernels'
results are the same whatever order their integer atomics run in.  The
scale is a pure function of the inputs, computed here in plain PyTorch on
the inputs' device (no host sync) for the histogram kernels, and inside
its launch, by the same steps, by the segment sum:

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


# ---- the accumulate / dequantize pair, in plain PyTorch ---------------------
#
# A sum over several processes splits each kernel's launch in two: every
# process accumulates its own rows into an int64 accumulator at one shared
# scale, the accumulators are summed exactly (an integer all-reduce), and
# one dequantize rounds the total.  These are the kernels' two halves in
# plain PyTorch: the CPU route runs them, and they are what the kernels are
# held to bit for bit.

_TWO63 = 2.0 ** 63


def quantize_plain(v: torch.Tensor, scale: torch.Tensor, qmax: int):
    """(q, over): ``q = rint(v * scale)`` as int64 for f32 ``v`` [n, lanes]
    (the product in f32, as the kernels form it; exact, the scale being a
    power of two), and bool [lanes], True where a value reaches ``qmax``
    in magnitude or does not quantise to a finite number (the kernels'
    overflow mark).  ``q`` is 0 where it is not a usable integer."""
    p = torch.round(v.to(torch.float32) * scale.to(torch.float32)
                    ).to(torch.float64)
    bad = ~torch.isfinite(p) | (p.abs() >= _TWO63)
    q = torch.where(bad, 0.0, p).to(torch.int64)
    over = bad | (q.abs() >= int(qmax))
    return torch.where(over, 0, q), over.any(0)


def dequantize_plain(acc: torch.Tensor, scale: torch.Tensor,
                     lanes: int) -> torch.Tensor:
    """f32 [n]: ``acc[i] / scale[i % lanes]`` for int64 ``acc`` [n + lanes]
    (the sums, then each lane's overflow mark), the int64 taken to double,
    divided in double and rounded once to f32, as ``hist_fixed::dequantize``
    does; NaN in a lane whose scale is not a finite positive f32 or whose
    mark is nonzero."""
    n = acc.numel() - lanes
    s = scale.to(torch.float32)
    ok = (s > 0) & (s <= 3.0e38) & (acc[n:] == 0)
    vals = (acc[:n].to(torch.float64).reshape(-1, lanes)
            / s.to(torch.float64)).to(torch.float32)
    return torch.where(ok, vals, torch.nan).reshape(-1)


def global_scale(plan, amax: torch.Tensor, counts) -> tuple:
    """(scale, n_max) shared by every process of ``plan``: one tiny
    all-gather of each process's ``amax`` [lanes] and ``counts`` [k] (the
    values each output can receive, by group: rows, or entries by feature),
    the max of the amaxes, and ``n_max`` = the largest group's sum over the
    processes.  The scale is then :func:`fixed_point_scale` of the values
    of every process, bit for bit the one a single process over all of
    them computes."""
    c = torch.as_tensor(counts, dtype=torch.float64).reshape(-1)
    stats = torch.cat([amax.to(torch.float64).reshape(-1),
                       c.to(amax.device)])
    every = plan.all_gather(stats)                 # [processes, lanes + k]
    lanes = amax.numel()
    g_amax = every[:, :lanes].amax(0).to(torch.float32)
    n_max = int(every[:, lanes:].sum(0).max().item()) if c.numel() else 0
    return fixed_point_scale(g_amax, n_max), n_max
