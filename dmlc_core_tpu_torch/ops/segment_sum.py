"""Segment-sum over flattened COO batches, with a selectable backend.

``out[r] = sum of contrib[k] over k with row_id[k] == r`` is the hot op of
every sparse model here (the vectorized Row::SDot).  ``contrib`` is [nnz]
or [nnz, L]; ids outside ``[0, num_segments)`` are dropped.

Backends keep the JAX package's names, so configs written there load here
unchanged (``sdot_backend=`` on the models):

* ``"pallas"``: the hand-written CUDA kernel ``csrc/segment_sum.cu`` for a
  CUDA tensor, its plain PyTorch version for a CPU tensor.  The kernel sums
  int64 fixed point (:mod:`.fixed_point`, one scale a lane found inside the
  launch) and returns f32, cast back to contrib's dtype; it is bitwise
  reproducible run to run and for any order of the entries, and its
  gradient is the gather ``g[row_id]``.
* ``None`` / ``"xla"``: ``index_add``, the counterpart of the XLA
  scatter-add the JAX package leaves outside any kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .fixed_point import (dequantize_plain, fixed_point_scale, global_scale,
                          lane_amax, quantize_plain, value_limit)

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

_THREADS = 512          # threads a block (csrc/segment_sum.cu kThreads)
_RUN = 4                # consecutive entries a thread loads at once (kRun)
_RUNS_PER_THREAD = 1    # runs a thread takes before another block pays off
_MAX_BLOCKS = 1024      # blocks a launch asks for (fewer if fewer fit)
_MAX_LANES = 4096       # lanes one launch takes (8 B of shared memory each)
_SHARED_OUT = 96 * 1024  # int64 outputs a block adds in shared memory, bytes

_lib = None
_launch_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("segment_sum")
        lib.dmlc_segment_sum_fixed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.dmlc_segment_sum_fixed.restype = ctypes.c_int
        lib.dmlc_segment_sum_accumulate.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p]
        lib.dmlc_segment_sum_accumulate.restype = ctypes.c_int
        lib.dmlc_segment_sum_dequantize.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.dmlc_segment_sum_dequantize.restype = ctypes.c_int
        lib.dmlc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dmlc_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_geometry(nnz: int, num_segments: int, lanes: int,
                    align: int = 16) -> dict:
    """How one launch of ``csrc/segment_sum.cu`` cuts the work.  ``vec``:
    lanes a thread loads at once (4 or 2 where they divide ``lanes`` and
    contrib's address ``align``, else 1).  ``shared``: a block adds into a
    shared-memory copy of the int64 outputs while they fit in
    ``_SHARED_OUT``, else with 64-bit atomics straight into the global
    buffer.  ``blocks``: enough for ``_RUNS_PER_THREAD`` runs of ``_RUN``
    entries a thread, at most ``_MAX_BLOCKS`` (the launch takes no more
    than the card holds at once).  The constants are the fastest at every
    main-path shape on an H100 (``python3 chip_smoke.py --segment-sweep``;
    PERF.md)."""
    vec = next(v for v in (4, 2, 1) if lanes % v == 0 and align % (4 * v) == 0)
    groups = lanes // vec
    streams = _THREADS // min(groups, _THREADS)
    per_thread = -(-groups // _THREADS) if groups > _THREADS else 1
    blocks = -(-nnz * per_thread // (streams * _RUN * _RUNS_PER_THREAD))
    out_bytes = 8 * num_segments * lanes
    shared = out_bytes <= _SHARED_OUT
    return dict(vec=vec, shared=shared,
                blocks=max(1, min(_MAX_BLOCKS, blocks)),
                smem=8 * lanes + (out_bytes if shared else 0))


def _launch(contrib: torch.Tensor, row_id: torch.Tensor, num_segments: int,
            out: torch.Tensor, scale: torch.Tensor) -> None:
    """One launch over f32 [nnz, L] ``contrib`` (L <= ``_MAX_LANES``) into
    ``out`` [num_segments, L], with each lane's ``2^k`` into ``scale`` [L]."""
    nnz, lanes = contrib.shape
    geo = launch_geometry(nnz, num_segments, lanes, contrib.data_ptr() & 15
                          or 16)
    # the int64 accumulators, each lane's overflow mark and the blocks'
    # max |v| bits (u32): the only scratch; the launch zeroes what it needs
    scratch = torch.empty(num_segments * lanes + lanes
                          + -(-geo["blocks"] * lanes // 2),
                          dtype=torch.int64, device=contrib.device)
    lib = _kernel_lib()
    with torch.cuda.device(contrib.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dmlc_segment_sum_fixed(
            contrib.data_ptr(), row_id.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), scale.data_ptr(), nnz, num_segments, lanes,
            geo["vec"], int(geo["shared"]), geo["blocks"],
            value_limit(max(nnz, 1)), stream)
    if err != 0:
        raise RuntimeError("segment_sum kernel launch failed: "
                           + lib.dmlc_cuda_error_string(err).decode())
    with _launch_lock:
        segment_sum_kernel.launches += 1


def segment_sum_kernel(contrib: torch.Tensor, row_id: torch.Tensor,
                       num_segments: int, *,
                       return_scale: bool = False):
    """Segment-sum of f32 ``contrib`` [nnz] or [nnz, L] by i32 ``row_id``
    [nnz] -> f32 [num_segments(, L)].

    On a CUDA tensor it launches ``csrc/segment_sum.cu`` on the calling
    thread's current stream (and bumps ``segment_sum_kernel.launches``
    once a launch; one launch for L <= ``_MAX_LANES``, one per column chunk
    of that many past it): int64 fixed point with each lane's scale
    ``fixed_point_scale(lane_amax(contrib), nnz)`` found inside the launch.
    A lane holding a NaN or Inf comes out NaN in every output.  With
    ``return_scale`` it also returns that f32 [L] scale.  On a CPU tensor
    it runs :func:`segment_sum_plain` (and the scale by
    :mod:`.fixed_point`).  Raises on anything else the kernel does not
    take."""
    if contrib.device.type == "cpu":
        out = segment_sum_plain(contrib, row_id, num_segments)
        if not return_scale:
            return out
        c = contrib if contrib.dim() == 2 else contrib[:, None]
        return out, fixed_point_scale(lane_amax(c), c.shape[0])
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
    c = contrib if contrib.dim() == 2 else contrib[:, None]
    lanes = c.shape[1]
    out = torch.empty(num_segments, lanes, dtype=torch.float32,
                      device=contrib.device)
    scale = torch.empty(lanes, dtype=torch.float32, device=contrib.device)
    if out.numel():
        for l0 in range(0, lanes, _MAX_LANES):
            l1 = min(l0 + _MAX_LANES, lanes)
            if l1 - l0 == lanes:
                _launch(c, row_id, num_segments, out, scale)
            else:
                part = torch.empty(num_segments, l1 - l0, dtype=torch.float32,
                                   device=contrib.device)
                _launch(c[:, l0:l1].contiguous(), row_id, num_segments, part,
                        scale[l0:l1])
                out[:, l0:l1] = part
    out = out.reshape(_out_shape(contrib, num_segments))
    return (out, scale) if return_scale else out


segment_sum_kernel.launches = 0


# ---- the accumulate / dequantize pair (a sum over several processes) --------

def segment_sum_accumulate_plain(contrib: torch.Tensor, row_id: torch.Tensor,
                                 num_segments: int, scale: torch.Tensor,
                                 qmax: int) -> torch.Tensor:
    """The kernel's accumulate half in plain PyTorch: int64 [num_segments *
    L + L], each entry with an id in range quantised once at ``scale``
    (:func:`.fixed_point.quantize_plain`) and added exactly with an int64
    ``index_add``, then each lane's overflow mark."""
    lanes = contrib.shape[1]
    n_out = num_segments * lanes
    acc = torch.zeros(n_out + lanes, dtype=torch.int64,
                      device=contrib.device)
    rid = row_id.to(torch.int64)
    live = (rid >= 0) & (rid < num_segments)
    q, over = quantize_plain(contrib[live], scale, qmax)
    acc[n_out:] = over.to(torch.int64)
    base = rid[live][:, None] * lanes + torch.arange(
        lanes, device=contrib.device)
    acc.index_add_(0, base.reshape(-1), q.reshape(-1))
    return acc


def segment_sum_accumulate(contrib: torch.Tensor, row_id: torch.Tensor,
                           num_segments: int, scale: torch.Tensor,
                           qmax: int) -> torch.Tensor:
    """The accumulate half of :func:`segment_sum_kernel` for f32 ``contrib``
    [nnz, L] (L <= ``_MAX_LANES``) and i32 ``row_id``: int64
    [num_segments * L + L], the fixed-point sums at the caller's f32 [L]
    ``scale`` and value limit ``qmax``, then each lane's overflow mark, left
    undequantized so the accumulators of several processes can be summed
    exactly before one :func:`segment_sum_dequantize`.  On a CUDA tensor it
    launches ``dmlc_segment_sum_accumulate`` (and bumps
    ``segment_sum_kernel.launches``); on a CPU tensor it runs
    :func:`segment_sum_accumulate_plain`."""
    if contrib.device.type == "cpu":
        return segment_sum_accumulate_plain(contrib, row_id, num_segments,
                                            scale, qmax)
    if (contrib.dtype != torch.float32 or row_id.dtype != torch.int32
            or contrib.dim() != 2 or row_id.shape != contrib.shape[:1]
            or not (contrib.is_contiguous() and row_id.is_contiguous())
            or row_id.device != contrib.device
            or contrib.shape[1] > _MAX_LANES):
        raise ValueError(f"segment_sum_accumulate takes contiguous f32 "
                         f"contrib [nnz, L <= {_MAX_LANES}] and i32 row_id "
                         f"[nnz] on one CUDA device, got "
                         f"{tuple(contrib.shape)} {contrib.dtype} / "
                         f"{tuple(row_id.shape)} {row_id.dtype}")
    nnz, lanes = contrib.shape
    geo = launch_geometry(nnz, num_segments, lanes, contrib.data_ptr() & 15
                          or 16)
    scratch = torch.empty(num_segments * lanes + lanes
                          + -(-geo["blocks"] * lanes // 2),
                          dtype=torch.int64, device=contrib.device)
    scale = scale.to(device=contrib.device,
                     dtype=torch.float32).contiguous()
    lib = _kernel_lib()
    with torch.cuda.device(contrib.device):
        err = lib.dmlc_segment_sum_accumulate(
            contrib.data_ptr(), row_id.data_ptr(), scratch.data_ptr(),
            scale.data_ptr(), nnz, num_segments, lanes, geo["vec"],
            int(geo["shared"]), geo["blocks"], int(qmax),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("segment_sum accumulate launch failed: "
                           + lib.dmlc_cuda_error_string(err).decode())
    with _launch_lock:
        segment_sum_kernel.launches += 1
    return scratch[:num_segments * lanes + lanes]


def segment_sum_dequantize(acc: torch.Tensor, scale: torch.Tensor,
                           num_segments: int, lanes: int) -> torch.Tensor:
    """The dequantize half: f32 [num_segments, lanes] from an int64
    accumulator of :func:`segment_sum_accumulate` (or a sum of several),
    rounded once each (``dmlc_segment_sum_dequantize`` on the card,
    :func:`.fixed_point.dequantize_plain` on the CPU)."""
    if acc.device.type == "cpu":
        return dequantize_plain(acc, scale, lanes).reshape(num_segments,
                                                           lanes)
    out = torch.empty(num_segments, lanes, dtype=torch.float32,
                      device=acc.device)
    scale = scale.to(device=acc.device, dtype=torch.float32).contiguous()
    lib = _kernel_lib()
    with torch.cuda.device(acc.device):
        err = lib.dmlc_segment_sum_dequantize(
            acc.data_ptr(), scale.data_ptr(), out.data_ptr(), out.numel(),
            lanes, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("segment_sum dequantize launch failed: "
                           + lib.dmlc_cuda_error_string(err).decode())
    return out


def segment_sum_sharded(contrib: torch.Tensor, row_id: torch.Tensor,
                        num_segments: int, plan) -> torch.Tensor:
    """Segment-sum over the entries of every process of ``plan`` (a
    ``parallel.MeshPlan``), each process passing its own: the shared scale
    from one tiny all-gather (max of the lanes' amax, sum of the entries),
    the accumulate launch on this process's entries, an exact int64
    all-reduce and one dequantize.  Bit for bit the one-process kernel's
    over all the entries, whatever the process count or strategy.
    ``contrib`` [nnz] or [nnz, L] -> f32 [num_segments(, L)]."""
    c = contrib if contrib.dim() == 2 else contrib[:, None]
    c = c.to(torch.float32).contiguous()
    rid = row_id.to(torch.int32).contiguous()
    scale, n_max = global_scale(plan, lane_amax(c), [c.shape[0]])
    acc = segment_sum_accumulate(c, rid, num_segments, scale,
                                 value_limit(max(n_max, 1)))
    out = segment_sum_dequantize(plan.allreduce(acc), scale, num_segments,
                                 c.shape[1])
    return out.reshape(_out_shape(contrib, num_segments))


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
