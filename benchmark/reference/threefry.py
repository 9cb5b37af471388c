"""A frozen copy of ``jax.random``'s default stream (threefry2x32,
partitionable, 32-bit mode) in plain torch: just what the GBDT's sampling
draws (``PRNGKey``, ``fold_in``, ``split``, ``bits``, ``uniform``,
``bernoulli``, ``permutation``).  Keys are Python int pairs on the host;
draws land on the device asked for.  Words are int64 tensors masked to
32 bits."""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 25


def _rotl(x, r: int):
    return ((x & ((1 << (32 - r)) - 1)) << r) | (x >> (32 - r))


def threefry2x32(key: tuple, x0, x1) -> tuple:
    """20 rounds over counter words (int64 tensors or ints < 2^32)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    a = (x0 + ks[0]) & MASK32
    b = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return a, b


def prng_key(seed: int) -> tuple:
    return (0, int(seed) & MASK32)


def fold_in(key: tuple, data: int) -> tuple:
    return threefry2x32(key, 0, int(data))


def split(key: tuple) -> tuple:
    """``jax.random.split(key)``'s two keys."""
    return tuple(threefry2x32(key, 0, i) for i in range(2))


def bits(key: tuple, n: int, device) -> torch.Tensor:
    out = torch.empty(n, dtype=torch.int64, device=device)
    for k0 in range(0, n, _CHUNK):
        i = torch.arange(k0, min(n, k0 + _CHUNK), dtype=torch.int64,
                         device=device)
        a, b = threefry2x32(key, i >> 32, i & MASK32)
        out[k0:k0 + i.numel()] = a ^ b
    return out


def uniform(key: tuple, n: int, device) -> torch.Tensor:
    """float32 in [0, 1) from the top 23 bits of each word."""
    w = bits(key, n, device)
    f = ((w >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0)


def bernoulli(key: tuple, p: float, n: int, device) -> torch.Tensor:
    return uniform(key, n, device) < torch.tensor(p, dtype=torch.float32,
                                                  device=device)


def permutation(key: tuple, n: int, device) -> torch.Tensor:
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK32)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[torch.sort(bits(sub, n, device), stable=True).indices]
    return x
