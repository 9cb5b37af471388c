"""A sampled GBDT tree's draws: its row weights on the card, its columns on
the host.

:func:`sample_weights` is the row draw, ``w * keep`` with ``keep =
jax.random.bernoulli(key, p, (n,))`` at each row's element of the stream
(its row, or its global row number under a mesh plan).  On a CUDA tensor it
runs the hand-written kernel ``csrc/threefry.cu`` (one launch, the key and
``p`` passed as arguments: no copy, no sync) and bumps
``sample_weights.launches``; on a CPU tensor it runs
:func:`sample_weights_plain`, built on :mod:`..random`.  The two are equal
bit for bit.

:func:`column_mask` is the column draw: a permutation of the features on
the host, where the tree's key lives, copied to the card once.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from ..random import bernoulli, bernoulli_at, permutation

_lib = None
_launch_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("threefry")
        p = ctypes.c_void_p
        lib.dmlc_threefry_sample_weights.argtypes = [
            p, p, p, ctypes.c_longlong, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_float, p]
        lib.dmlc_threefry_sample_weights.restype = ctypes.c_int
        lib.dmlc_threefry_error_string.argtypes = [ctypes.c_int]
        lib.dmlc_threefry_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def sample_weights_plain(key: torch.Tensor, p: float, w: torch.Tensor,
                         index: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``w * bernoulli(key, p,
    w.shape)``, or ``w * bernoulli_at(key, p, index)``; on ``w``'s
    device."""
    keep = (bernoulli(key, p, tuple(w.shape), w.device) if index is None
            else bernoulli_at(key, p, index))
    return w * keep.to(torch.float32)


def _check_inputs(w: torch.Tensor, index) -> None:
    """Raise on anything the kernel does not take."""
    if w.dtype != torch.float32 or (index is not None
                                    and index.dtype != torch.int64):
        raise TypeError(f"sample_weights takes f32 weights and an int64 "
                        f"index, got {w.dtype} / "
                        f"{None if index is None else index.dtype}")
    if index is not None and (index.device != w.device
                              or index.shape != w.shape):
        raise ValueError(f"sample_weights: weights {tuple(w.shape)} on "
                         f"{w.device}, index {tuple(index.shape)} on "
                         f"{index.device}")
    if not w.is_contiguous() or (index is not None
                                 and not index.is_contiguous()):
        raise ValueError("sample_weights takes contiguous tensors")


def sample_weights(key: torch.Tensor, p: float, w: torch.Tensor,
                   index: torch.Tensor | None = None) -> torch.Tensor:
    """``w * keep``, ``keep`` the Bernoulli(``p``) draw of the host ``key``
    (a :mod:`..random` key on the CPU) at element ``i`` of the stream for
    row ``i``, or at ``index[i]``.  ``p`` is compared as f32,
    as ``jax.random.bernoulli`` does.  A CUDA tensor runs the kernel on the
    current stream (f32 ``w`` and int64 ``index`` of its shape, contiguous,
    on its device; raises on anything else); a CPU tensor runs
    :func:`sample_weights_plain`."""
    if w.device.type == "cpu":
        return sample_weights_plain(key, p, w, index)
    _check_inputs(w, index)
    out = torch.empty_like(w)
    if not w.numel():
        return out
    lib = _kernel_lib()
    k0, k1 = key.tolist()
    with torch.cuda.device(w.device):
        err = lib.dmlc_threefry_sample_weights(
            w.data_ptr(), None if index is None else index.data_ptr(),
            out.data_ptr(), w.numel(), k0, k1, p,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("threefry sample_weights launch failed: "
                           + lib.dmlc_threefry_error_string(err).decode())
    with _launch_lock:
        sample_weights.launches += 1
    return out


sample_weights.launches = 0


def column_mask(key: torch.Tensor, num_features: int, k: int,
                device) -> torch.Tensor:
    """``jnp.zeros(F, bool).at[jax.random.permutation(key, F)[:k]]
    .set(True)``: ``k`` of ``num_features`` features, drawn on the host
    from a key on the CPU, then copied to ``device`` once (from pinned
    memory, without a sync)."""
    device = torch.device(device)
    sel = permutation(key, num_features, "cpu")[:k]
    mask = torch.zeros(num_features, dtype=torch.bool,
                       pin_memory=device.type == "cuda")
    mask[sel] = True
    return mask.to(device, non_blocking=True)
