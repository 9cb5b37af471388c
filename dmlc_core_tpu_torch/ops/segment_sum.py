"""Segment-sum over flattened COO batches, with a selectable backend.

``out[r] = sum of contrib[k] over k with row_id[k] == r`` is the hot op of
every sparse model here (the vectorized Row::SDot).  ``contrib`` is [nnz]
or [nnz, L]; ids outside ``[0, num_segments)`` are dropped.

Backends keep the JAX package's names, so configs written there load here
unchanged (``sdot_backend=`` on the models):

* ``"pallas"``: the hand-written CUDA kernel ``csrc/segment_sum.cu`` for a
  CUDA tensor, its plain PyTorch version for a CPU tensor.  It accumulates
  in f32 and casts back to contrib's dtype, is bitwise reproducible run to
  run, and its gradient is the gather ``g[row_id]``.
* ``None`` / ``"xla"``: ``index_add``, the counterpart of the XLA
  scatter-add the JAX package leaves outside any kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

# the one authoritative list of reduction backends; every force= /
# sdot_backend= surface validates through check_force
VALID_FORCE = (None, "xla", "pallas")


def check_force(force, what: str = "backend") -> None:
    if force not in VALID_FORCE:
        raise ValueError(f"unknown {what} force={force!r} "
                         f"(want one of {VALID_FORCE})")


def clamp_index(index: torch.Tensor, n: int) -> torch.Tensor:
    """Index a gather on an axis of length ``n`` the way JAX's ``x[index]``
    does: a negative index counts from the end, then every index is
    clamped into ``[0, n)``."""
    return torch.remainder(index.clamp(-n, n - 1), n)


def _out_shape(contrib: torch.Tensor, num_segments: int) -> tuple:
    return (num_segments,) + tuple(contrib.shape[1:])


# ---- the plain version ------------------------------------------------------

_PLAIN_STEP = 4096  # entries per one-hot block (bounds its memory)
_PLAIN_GROUP = 64   # blocks summed apart before they join the total


def segment_sum_plain(contrib: torch.Tensor, row_id: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the one-hot contraction the
    TPU kernel computes, ``out += onehot(row_id) @ contrib`` over blocks of
    entries, accumulated in f32 and cast back to contrib's dtype.  The
    block products are summed in groups of ``_PLAIN_GROUP`` before they
    join the total, so at 11M entries an output takes ~100 rounded adds
    and not ~2,700.  Used on CPU tensors and as the reference the kernel
    is held to on the card."""
    nnz = contrib.shape[0]
    lanes = 1 if contrib.dim() == 1 else contrib.shape[1]
    c = contrib.reshape(nnz, lanes).to(torch.float32)
    rid = row_id.to(torch.int64)
    rows = torch.arange(num_segments, device=contrib.device)
    out = torch.zeros(num_segments, c.shape[1], dtype=torch.float32,
                      device=contrib.device)
    group = torch.zeros_like(out)
    # the f32 contract: a TF32 product would keep ~3 decimal digits
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i, k0 in enumerate(range(0, nnz, _PLAIN_STEP)):
            k1 = k0 + _PLAIN_STEP
            onehot = (rows[:, None] == rid[None, k0:k1]).to(torch.float32)
            group += onehot @ c[k0:k1]
            if (i + 1) % _PLAIN_GROUP == 0:
                out += group
                group.zero_()
        out += group
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out.reshape(_out_shape(contrib, num_segments)).to(contrib.dtype)


# ---- the kernel -------------------------------------------------------------

_MAX_CHUNKS = 64   # entry chunks a launch splits into (grid y; partials)
_MIN_CHUNK = 256   # entries per chunk before another chunk pays off

_lib = None
_launch_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("segment_sum")
        lib.dmlc_segment_sum_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        lib.dmlc_segment_sum_f32.restype = ctypes.c_int
        lib.dmlc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dmlc_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def segment_sum_kernel(contrib: torch.Tensor, row_id: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment-sum of f32 ``contrib`` [nnz] or [nnz, L] by i32 ``row_id``
    [nnz] -> f32 [num_segments(, L)].

    On a CUDA tensor it launches ``csrc/segment_sum.cu`` on the calling
    thread's current stream (and bumps ``segment_sum_kernel.launches``);
    on a CPU tensor it runs :func:`segment_sum_plain`.  Raises on anything
    else the kernel does not take."""
    if contrib.device.type == "cpu":
        return segment_sum_plain(contrib, row_id, num_segments)
    if contrib.device.type != "cuda" or row_id.device != contrib.device:
        raise ValueError(f"segment_sum_kernel: contrib on {contrib.device}, "
                         f"row_id on {row_id.device}; want one CUDA device")
    if contrib.dtype != torch.float32 or row_id.dtype != torch.int32:
        raise TypeError(f"segment_sum_kernel takes f32 contrib and i32 "
                        f"row_id, got {contrib.dtype} / {row_id.dtype}")
    if (contrib.dim() not in (1, 2) or row_id.dim() != 1
            or row_id.shape[0] != contrib.shape[0]):
        raise ValueError(f"segment_sum_kernel: contrib {tuple(contrib.shape)}"
                         f" vs row_id {tuple(row_id.shape)}")
    if not (contrib.is_contiguous() and row_id.is_contiguous()):
        raise ValueError("segment_sum_kernel takes contiguous tensors")
    nnz = contrib.shape[0]
    lanes = 1 if contrib.dim() == 1 else contrib.shape[1]
    out = torch.empty(_out_shape(contrib, num_segments), dtype=torch.float32,
                      device=contrib.device)
    if out.numel() == 0:
        return out
    n_chunks = max(1, min(_MAX_CHUNKS, -(-nnz // _MIN_CHUNK)))
    chunk = max(1, -(-nnz // n_chunks))
    n_chunks = max(1, -(-nnz // chunk))
    partials = (torch.empty(n_chunks, out.numel(), dtype=torch.float32,
                            device=contrib.device) if n_chunks > 1 else None)
    lib = _kernel_lib()
    with torch.cuda.device(contrib.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dmlc_segment_sum_f32(
            contrib.data_ptr(), row_id.data_ptr(), out.data_ptr(),
            partials.data_ptr() if partials is not None else None,
            nnz, num_segments, lanes, n_chunks, chunk, stream)
    if err != 0:
        raise RuntimeError("segment_sum kernel launch failed: "
                           + lib.dmlc_cuda_error_string(err).decode())
    with _launch_lock:
        segment_sum_kernel.launches += 1
    return out


segment_sum_kernel.launches = 0


class _SegmentSumFn(torch.autograd.Function):
    """The kernel under autograd.  The VJP is exact and trivial: d_contrib
    = g[row_id], a gather, with ids clamped as JAX's gather clamps them (so
    a dropped id takes the gradient of the nearest row, as in the JAX
    package's custom VJP)."""

    @staticmethod
    def forward(ctx, contrib, row_id, num_segments):
        ctx.save_for_backward(row_id)
        ctx.num_segments = num_segments
        ctx.dtype = contrib.dtype
        out = segment_sum_kernel(contrib.to(torch.float32).contiguous(),
                                 row_id.to(torch.int32).contiguous(),
                                 num_segments)
        return out.to(contrib.dtype)

    @staticmethod
    def backward(ctx, g):
        (row_id,) = ctx.saved_tensors
        d_contrib = g[clamp_index(row_id, ctx.num_segments)].to(ctx.dtype)
        return d_contrib, None, None


def _segment_sum_xla(contrib, row_id, num_segments):
    # out-of-range ids go to one spare row that is cut off, so nothing is
    # dropped by a boolean mask (which would wait for the device)
    keep = (row_id >= 0) & (row_id < num_segments)
    idx = torch.where(keep, row_id, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(contrib.shape[1:]),
                      dtype=contrib.dtype, device=contrib.device)
    return out.index_add(0, idx, contrib)[:num_segments]


def segment_sum(contrib: torch.Tensor, row_id: torch.Tensor,
                num_segments: int, force: str | None = None) -> torch.Tensor:
    """Segment-sum with selectable backend (see the module docstring).

    contrib: [nnz] or [nnz, L] (multi-lane statistics share one pass).
    An empty input gives zeros in contrib's dtype on either backend."""
    check_force(force, "segment-sum backend")
    if force == "pallas":
        if contrib.dim() > 2:
            raise ValueError("pallas segment_sum supports [nnz] or [nnz, L] "
                             f"contrib, got shape {tuple(contrib.shape)}")
        if contrib.shape[0] == 0:
            return torch.zeros(_out_shape(contrib, num_segments),
                               dtype=contrib.dtype, device=contrib.device)
        return _SegmentSumFn.apply(contrib, row_id, num_segments)
    return _segment_sum_xla(contrib, row_id, num_segments)
