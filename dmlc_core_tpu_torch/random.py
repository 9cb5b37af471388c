"""``jax.random``'s default stream (threefry2x32), bit for bit, in torch.

The JAX package draws GBDT's row and column samples from ``jax.random``
(``PRNGKey``, ``fold_in``, ``bernoulli``, ``uniform``, ``permutation``);
a port that drew other numbers would grow other forests.  This module
reproduces JAX's output exactly for its defaults (``jax_default_prng_impl
= threefry2x32``, ``jax_threefry_partitionable = True``, 32-bit mode):

* a key is an int64 tensor ``[2]`` holding two 32-bit words.  A draw runs
  on the key's device unless it is given another: a key on the CPU is read
  as two Python ints, so a chain of ``fold_in`` stays on the host and
  costs no launches, while the bits it draws land on the card;
* :func:`bits` lays the stream out over a shape the partitionable way:
  element ``i`` (row-major) is ``x0 ^ x1`` of ``threefry2x32(key, (i >> 32,
  i & 0xffffffff))``;
* ``uint32`` lacks shifts and adds on many torch kernels, so every word is
  an int64 masked to 32 bits.

The hash and the sort are plain XLA in the JAX package; they are plain
torch here.
"""
from __future__ import annotations

import math

import torch

from ._device import resolve_device

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    # the low 32 - r bits move up without leaving 32 bits (no int64 overflow)
    return ((x & ((1 << (32 - r)) - 1)) << r) | (x >> (32 - r))


def _words(key: torch.Tensor) -> tuple:
    """The key's two words: Python ints for a key on the CPU (no device
    work and usable with tensors on any device), 0-d tensors otherwise."""
    if key.device.type == "cpu":
        return int(key[0]), int(key[1])
    return key[0], key[1]


def threefry2x32(words: tuple, x0, x1) -> tuple:
    """Threefry-2x32 with 20 rounds over the counter pairs ``(x0, x1)``
    (int64 words < 2^32: tensors of any shape, or Python ints) under the
    key words ``(k0, k1)``; returns the two output words.  The schedule of
    ``jax._src.prng._threefry2x32_lowering``."""
    k0, k1 = words
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


def PRNGKey(seed: int, device="cuda") -> torch.Tensor:  # noqa: N802
    """``jax.random.PRNGKey(seed)`` in 32-bit mode: the key ``(0, seed mod
    2^32)``, on ``device``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=resolve_device(device))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for ``0 <= data < 2^32``: the hash
    of the counter pair ``(0, data)``, as a new key on the key's device."""
    data = int(data)
    if not 0 <= data <= MASK32:
        raise OverflowError(f"fold_in data {data} is not a uint32")
    a, b = threefry2x32(_words(key), 0, data)
    if isinstance(a, int):
        return torch.tensor([a, b], dtype=torch.int64, device=key.device)
    return torch.stack([a, b])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` (partitionable): key ``i`` is the
    hash of the counter pair ``(0, i)``; returns int64 ``[num, 2]`` on the
    key's device."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(_words(key), torch.zeros_like(lo), lo)
    return torch.stack([a, b], dim=1)


def _draw_device(key: torch.Tensor, device) -> tuple:
    dev = key.device if device is None else resolve_device(device)
    if key.device.type != "cpu" and key.device != dev:
        key = key.to(dev)
    return key, dev


def bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit, partitionable): int64 words
    in ``[0, 2^32)`` of ``shape``, on ``device`` (default: the key's)."""
    key, dev = _draw_device(key, device)
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=dev)
    a, b = threefry2x32(_words(key), idx >> 32, idx & MASK32)
    return (a ^ b).reshape(shape)


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: f32 in ``[0, 1)`` from the top 23
    bits of each word, as ``1.m - 1``."""
    one = 0x3F800000  # the bits of 1.0f
    f = ((bits(key, shape, device) >> 9) | one).to(torch.int32).view(
        torch.float32)
    return torch.clamp(f - 1.0, min=0.0)


def bernoulli(key: torch.Tensor, p: float, shape, device=None
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` with a Python float ``p``
    (compared as f32): bool ``uniform < p``."""
    u = uniform(key, shape, device)
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)


def permutation(key: torch.Tensor, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` (int64) shuffled by
    ``ceil(3 ln n / ln(2^32 - 1))`` rounds of a stable sort on fresh 32-bit
    keys, each round splitting the key (``jax._src.random._shuffle``)."""
    key, dev = _draw_device(key, device)
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=dev)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK32)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(bits(sub, (n,), dev), stable=True).indices
        x = x[order]
    return x
