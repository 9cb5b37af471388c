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


def _bits_at(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The stream's words at the int64 element numbers ``idx``."""
    a, b = threefry2x32(_words(key), idx >> 32, idx & MASK32)
    return a ^ b


_BITS_CHUNK = 1 << 25  # elements hashed at a time (bounds the temporaries)


def bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit, partitionable): int64 words
    in ``[0, 2^32)`` of ``shape``, on ``device`` (default: the key's)."""
    key, dev = _draw_device(key, device)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n <= _BITS_CHUNK:
        idx = torch.arange(n, dtype=torch.int64, device=dev)
        return _bits_at(key, idx).reshape(shape)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    for k0 in range(0, n, _BITS_CHUNK):
        k1 = min(n, k0 + _BITS_CHUNK)
        out[k0:k1] = _bits_at(key, torch.arange(k0, k1, dtype=torch.int64,
                                                 device=dev))
    return out.reshape(shape)


def _unit_f32(words: torch.Tensor) -> torch.Tensor:
    """f32 in ``[0, 1)`` from the top 23 bits of each word, as ``1.m - 1``
    (``jax.random.uniform``'s map)."""
    one = 0x3F800000  # the bits of 1.0f
    f = ((words >> 9) | one).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0)


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: f32 in ``[0, 1)``."""
    return _unit_f32(bits(key, shape, device))


# Giles' single-precision erfinv polynomial, as XLA expands ``erf_inv``:
# coefficients for w = -log1p(-x^2) below 5 (in w - 2.5) and past it (in
# sqrt(w) - 3), highest degree first
_ERFINV_LOW = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HIGH = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` (its polynomial and edge cases) in torch."""
    w = -torch.log1p(-x * x)
    low = w < 5.0
    w = torch.where(low, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(low, _ERFINV_LOW[0], _ERFINV_HIGH[0])
    for a, b in zip(_ERFINV_LOW[1:], _ERFINV_HIGH[1:]):
        p = torch.where(low, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (f32): ``sqrt(2) * erf_inv(u)`` of
    a uniform ``u`` over ``[nextafter(-1, 0), 1)``.  ``u`` is JAX's bit for
    bit and ``erf_inv`` XLA's polynomial; torch's ``log1p`` inside it
    parts from XLA's in the last bit now and then, so a few percent of the
    draws differ from JAX's by an ulp."""
    f = uniform(key, shape, device)
    lo = torch.tensor(-1.0).nextafter(torch.tensor(0.0)).to(f.device)
    u = torch.maximum(f * (1.0 - lo) + lo, lo)
    return _erfinv_f32(u) * torch.tensor(math.sqrt(2), dtype=torch.float32,
                                         device=f.device)


def bernoulli(key: torch.Tensor, p: float, shape, device=None
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` with a Python float ``p``
    (compared as f32): bool ``uniform < p``."""
    u = uniform(key, shape, device)
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)


def bernoulli_at(key: torch.Tensor, p: float, index: torch.Tensor
                 ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, (n,))[index]`` for any ``n`` past
    ``index.max()``, without drawing the other elements (the partitionable
    stream's element ``i`` depends on ``i`` alone); on ``index``'s
    device."""
    key, _ = _draw_device(key, index.device)
    u = _unit_f32(_bits_at(key, index.to(torch.int64)))
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
