"""Per-level GBDT gradient histogram, with a selectable backend.

``out[n, f, b, :] = sum of gh[row] over rows with rel[row] == n and
bins[row, f] == b``: ``bins`` [rows, F] bin codes, ``rel`` [rows] node ids
in ``[0, n_nodes)``, ``gh`` [rows, 2] (grad, hess) lanes; the result is
[n_nodes, F, num_bins, 2].  Rows whose node id or bin code is out of range
add nothing.

Backends keep the JAX package's names (``histogram=`` on ``GBDT``):

* ``"pallas"``: the hand-written CUDA kernel ``csrc/histogram_gh.cu`` for a
  CUDA tensor, its plain PyTorch version for a CPU tensor.  It reads uint8
  (or int32) codes as stored, sums 64-bit fixed-point integers
  (:mod:`.fixed_point`) and returns f32 (cast back to gh's dtype), and is
  bitwise reproducible from launch to launch.
* ``None`` / ``"xla"``: ``index_add`` over flattened ``(node, feature, bin)``
  keys, the counterpart of the XLA scatter-add the JAX package leaves outside
  any kernel.  It materializes [rows, F] int64 keys and a [rows, F, 2]
  source per call, and on the card its atomics add in an order that changes
  from run to run.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .fixed_point import (dequantize_plain, fixed_point_scale, global_scale,
                          lane_amax, quantize_plain, value_limit)
from .segment_sum import check_force, segment_sum

# ---- the plain version ------------------------------------------------------

_PLAIN_ELEMS = 1 << 24  # one-hot elements per row block (bounds its memory)
_PLAIN_GROUP = 64       # row blocks summed apart before they join the total


def histogram_gh_plain(bins: torch.Tensor, rel: torch.Tensor,
                       gh: torch.Tensor, n_nodes: int,
                       num_bins: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the one-hot contraction the
    TPU kernel computes, ``out[(lane, node), (f, b)] += A^T B`` with
    ``A[row, (lane, node)] = gh[row, lane] * [rel[row] == node]`` and
    ``B[row, (f, b)] = [bins[row, f] == b]``, over blocks of rows, in f32
    with TF32 off.  The block products are summed in groups of
    ``_PLAIN_GROUP`` before they join the total, so at 11M rows an output
    takes ~140 rounded adds and not ~4,700.  Returns f32 [n_nodes, F,
    num_bins, 2].  Used on CPU tensors and as the reference the kernel is
    held to on the card."""
    rows, F = bins.shape
    dev = gh.device
    nodes = torch.arange(n_nodes, device=dev)
    bin_ids = torch.arange(num_bins, device=dev)
    out = torch.zeros(2 * n_nodes, F * num_bins, dtype=torch.float32,
                      device=dev)
    group = torch.zeros_like(out)
    step = max(1, _PLAIN_ELEMS // max(1, F * num_bins))
    # the f32 contract: a TF32 product would keep ~3 decimal digits
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i, r0 in enumerate(range(0, rows, step)):
            r1 = min(r0 + step, rows)
            mask = (rel[r0:r1, None].to(torch.int64) == nodes).to(
                torch.float32)
            g = gh[r0:r1].to(torch.float32)
            a = torch.cat([mask * g[:, 0:1], mask * g[:, 1:2]], dim=1)
            onehot = (bins[r0:r1, :, None].to(torch.int64) == bin_ids).reshape(
                r1 - r0, F * num_bins).to(torch.float32)
            group += a.T @ onehot
            if (i + 1) % _PLAIN_GROUP == 0:
                out += group
                group.zero_()
        out += group
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out.reshape(2, n_nodes, F, num_bins).permute(1, 2, 3, 0
                                                        ).contiguous()


# ---- the kernel -------------------------------------------------------------

_SMEM_MAX = 227 * 1024     # what a Hopper block may take at most
_WIDE_PAIRS = 14           # (node, feature) pairs a shallow block takes
_DEEP_GROUP = 3            # features a block takes at deeper levels
_WIDE_BLOCKS = 264         # blocks a shallow launch aims at (2 per SM)
_DEEP_BLOCKS = 2112        # blocks a deeper launch aims at (16 per SM)
_MIN_CHUNK = 4096          # rows per block before another chunk pays off

_lib = None
_launch_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("histogram_gh")
        lib.dmlc_histogram_gh_accumulate.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        lib.dmlc_histogram_gh_accumulate.restype = ctypes.c_int
        lib.dmlc_histogram_gh_dequantize.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.dmlc_histogram_gh_dequantize.restype = ctypes.c_int
        lib.dmlc_histogram_error_string.argtypes = [ctypes.c_int]
        lib.dmlc_histogram_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_geometry(rows: int, num_features: int, num_bins: int,
                    n_nodes: int) -> dict:
    """How one launch cuts the work: a block's shared histogram holds
    ``node_tile`` x ``feat_group`` (node, feature) pairs of ``chunk`` rows.
    While every node of the level fits with more than ``_DEEP_GROUP``
    features in ``_WIDE_PAIRS`` pairs (depths 0-1), a block takes all nodes
    and those features; deeper, ``_DEEP_GROUP`` features and as many nodes
    as fit, in even node tiles (each tile scans all rows, so they are
    few).  The constants are the fastest geometries at every depth at
    Higgs width on an H100 (``python3 chip_smoke.py --geometry-sweep``;
    PERF.md)."""
    per_pair = 16 * num_bins  # bytes of one (node, feature)'s int64 (g, h)
    most = _SMEM_MAX // per_pair
    if most < 1:
        raise ValueError(f"histogram_gh_kernel: num_bins={num_bins} needs "
                         f"{per_pair} B of shared memory a node (max "
                         f"{_SMEM_MAX})")
    per_node = min(_WIDE_PAIRS, most) // n_nodes
    wide = per_node > _DEEP_GROUP
    feat_group = (min(num_features, per_node) if wide
                  else min(num_features, _DEEP_GROUP, most))
    groups = -(-num_features // feat_group)
    feat_group = -(-num_features // groups)
    tiles = -(-n_nodes // (most // feat_group))
    node_tile = -(-n_nodes // tiles)
    n_chunks = max(1, min(-(-rows // _MIN_CHUNK), -(-(
        _WIDE_BLOCKS if wide else _DEEP_BLOCKS) // (groups * tiles))))
    chunk = max(1, -(-rows // n_chunks))
    return dict(node_tile=node_tile, feat_group=feat_group, chunk=chunk,
                blocks=-(-rows // chunk) * groups * tiles,
                smem=node_tile * feat_group * per_pair)


def _check_inputs(bins, rel, gh, n_nodes: int, num_bins: int) -> None:
    """Raise on anything the kernel does not take."""
    if (gh.device.type != "cuda" or bins.device != gh.device
            or rel.device != gh.device):
        raise ValueError(f"histogram_gh_kernel: bins on {bins.device}, rel "
                         f"on {rel.device}, gh on {gh.device}; want one CUDA "
                         "device")
    if (bins.dtype not in (torch.uint8, torch.int32)
            or rel.dtype != torch.int32 or gh.dtype != torch.float32):
        raise TypeError(f"histogram_gh_kernel takes uint8/int32 bins, int32 "
                        f"rel and f32 gh, got {bins.dtype} / {rel.dtype} / "
                        f"{gh.dtype}")
    rows = bins.shape[0] if bins.dim() == 2 else -1
    if (bins.dim() != 2 or rel.shape != (rows,) or gh.shape != (rows, 2)
            or n_nodes < 1 or num_bins < 1):
        raise ValueError(f"histogram_gh_kernel: bins {tuple(bins.shape)}, rel "
                         f"{tuple(rel.shape)}, gh {tuple(gh.shape)}, "
                         f"n_nodes={n_nodes}, num_bins={num_bins}")
    if not (bins.is_contiguous() and rel.is_contiguous()
            and gh.is_contiguous()):
        raise ValueError("histogram_gh_kernel takes contiguous tensors")
    if gh.data_ptr() % 8:
        raise ValueError("histogram_gh_kernel reads gh as float2: its data "
                         "must be 8-byte aligned")


def histogram_gh_kernel(bins: torch.Tensor, rel: torch.Tensor,
                        gh: torch.Tensor, n_nodes: int,
                        num_bins: int) -> torch.Tensor:
    """Histogram of f32 ``gh`` [rows, 2] by uint8 or int32 ``bins`` [rows, F]
    and int32 ``rel`` [rows] -> f32 [n_nodes, F, num_bins, 2].

    On a CUDA tensor it runs the kernel's two halves on the calling
    thread's current stream, the accumulate launch and
    :func:`histogram_gh_dequantize`, in the fixed point of
    :mod:`.fixed_point` with ``n_max = rows``, and bumps
    ``histogram_gh_kernel.launches``.  On a CPU tensor it runs
    :func:`histogram_gh_plain`.  Raises on anything else the kernel does
    not take."""
    if gh.device.type == "cpu":
        return histogram_gh_plain(bins, rel, gh, n_nodes, num_bins)
    _check_inputs(bins, rel, gh, n_nodes, num_bins)
    rows, F = bins.shape
    shape = (n_nodes, F, num_bins, 2)
    if n_nodes * F * num_bins == 0:
        return torch.empty(shape, dtype=torch.float32, device=gh.device)
    scale = fixed_point_scale(lane_amax(gh), rows)
    acc = _accumulate(bins, rel, gh, n_nodes, num_bins, scale,
                      value_limit(rows))
    out = histogram_gh_dequantize(acc, scale, shape)
    _count_launch()  # the dequantize launches even with no rows
    return out


histogram_gh_kernel.launches = 0


# ---- the accumulate / dequantize pair ---------------------------------------

def histogram_gh_accumulate_plain(bins: torch.Tensor, rel: torch.Tensor,
                                  gh: torch.Tensor, n_nodes: int,
                                  num_bins: int, scale: torch.Tensor,
                                  qmax: int) -> torch.Tensor:
    """The kernel's accumulate half in plain PyTorch: int64 [n_nodes * F *
    num_bins * 2 + 2], each row's (g, h) quantised once at ``scale``
    (:func:`.fixed_point.quantize_plain`) and added exactly with an int64
    ``index_add`` into bin ``((node * F + f) * num_bins + bin) * 2 + lane``,
    then each lane's overflow mark (1 where a row of a node in range
    reached ``qmax``)."""
    rows, F = bins.shape
    n_out = n_nodes * F * num_bins * 2
    acc = torch.zeros(n_out + 2, dtype=torch.int64, device=gh.device)
    r = rel.to(torch.int64)
    live = (r >= 0) & (r < n_nodes)
    q, over = quantize_plain(gh[live].to(torch.float32), scale, qmax)
    acc[n_out:] = over.to(torch.int64)
    b = bins[live].to(torch.int64)
    feat = torch.arange(F, dtype=torch.int64, device=gh.device)
    keys = ((r[live][:, None] * F + feat) * num_bins + b) * 2
    ok = (b >= 0) & (b < num_bins)
    for lane in range(2):
        src = q[:, lane][:, None].expand(-1, F)
        acc.index_add_(0, (keys + lane)[ok], src[ok])
    return acc


def _accumulate(bins, rel, gh, n_nodes: int, num_bins: int,
                scale: torch.Tensor, qmax: int) -> torch.Tensor:
    """Launch ``dmlc_histogram_gh_accumulate`` on checked CUDA inputs (no
    launch for no rows); the caller counts."""
    rows, F = bins.shape
    acc = torch.zeros(n_nodes * F * num_bins * 2 + 2, dtype=torch.int64,
                      device=gh.device)
    if rows == 0:
        return acc
    geo = launch_geometry(rows, F, num_bins, n_nodes)
    scale = scale.to(device=gh.device, dtype=torch.float32).contiguous()
    lib = _kernel_lib()
    with torch.cuda.device(gh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dmlc_histogram_gh_accumulate(
            bins.data_ptr(), bins.element_size(), rel.data_ptr(),
            gh.data_ptr(), scale.data_ptr(), int(qmax), acc.data_ptr(),
            rows, F, num_bins, n_nodes, geo["node_tile"], geo["feat_group"],
            geo["chunk"], stream)
    if err != 0:
        raise RuntimeError("histogram_gh accumulate launch failed: "
                           + lib.dmlc_histogram_error_string(err).decode())
    return acc


def _count_launch() -> None:
    with _launch_lock:
        histogram_gh_kernel.launches += 1


def histogram_gh_accumulate(bins: torch.Tensor, rel: torch.Tensor,
                            gh: torch.Tensor, n_nodes: int, num_bins: int,
                            scale: torch.Tensor, qmax: int) -> torch.Tensor:
    """The accumulate half of :func:`histogram_gh_kernel`: int64 [n_nodes *
    F * num_bins * 2 + 2] (the bins' fixed-point sums at the caller's f32
    [2] ``scale`` and value limit ``qmax``, then each lane's overflow
    mark), left undequantized so the accumulators of several processes can
    be summed exactly before one :func:`histogram_gh_dequantize`.  On a
    CUDA tensor it launches ``dmlc_histogram_gh_accumulate`` (and bumps
    ``histogram_gh_kernel.launches``; no launch for no rows); on a CPU
    tensor it runs
    :func:`histogram_gh_accumulate_plain`.  Takes what the kernel takes."""
    if gh.device.type == "cpu":
        return histogram_gh_accumulate_plain(bins, rel, gh, n_nodes,
                                             num_bins, scale, qmax)
    _check_inputs(bins, rel, gh, n_nodes, num_bins)
    acc = _accumulate(bins, rel, gh, n_nodes, num_bins, scale, qmax)
    if bins.shape[0]:
        _count_launch()
    return acc


def histogram_gh_dequantize(acc: torch.Tensor, scale: torch.Tensor,
                            shape) -> torch.Tensor:
    """The dequantize half: f32 ``shape`` ([n_nodes, F, num_bins, 2]) from
    an int64 accumulator of :func:`histogram_gh_accumulate` (or a sum of
    several), rounded once each (``dmlc_histogram_gh_dequantize`` on the
    card, :func:`.fixed_point.dequantize_plain` on the CPU)."""
    if acc.device.type == "cpu":
        return dequantize_plain(acc, scale, 2).reshape(shape)
    out = torch.empty(shape, dtype=torch.float32, device=acc.device)
    scale = scale.to(device=acc.device, dtype=torch.float32).contiguous()
    lib = _kernel_lib()
    with torch.cuda.device(acc.device):
        err = lib.dmlc_histogram_gh_dequantize(
            acc.data_ptr(), scale.data_ptr(), out.data_ptr(), out.numel(), 2,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("histogram_gh dequantize launch failed: "
                           + lib.dmlc_histogram_error_string(err).decode())
    return out


def histogram_gh_sharded(bins: torch.Tensor, rel: torch.Tensor,
                         gh: torch.Tensor, n_nodes: int, num_bins: int,
                         plan, chunks: int = 1,
                         force: str | None = "pallas") -> torch.Tensor:
    """One level's histogram over the rows of every process of ``plan`` (a
    ``parallel.MeshPlan``), each process passing its own rows.

    ``force="pallas"``: the shared scale from one tiny all-gather (max of
    the lanes' amax, sum of the rows), the accumulate launch on this
    process's rows, an exact int64 all-reduce of the accumulator (its
    overflow marks included) and one dequantize.  The result is the
    one-process kernel's over all the rows, bit for bit, whatever the
    process count or the plan's strategy.  Otherwise (``index_add``): each
    process's f32 histogram, all-reduced through the plan.

    ``chunks > 1`` splits the features into that many chunks and issues
    chunk k's all-reduce before chunk k + 1's histogram, with at most one
    reduction in flight; the bits do not change.  f32 [n_nodes, F,
    num_bins, 2]."""
    check_force(force, "histogram backend")
    rows, F = bins.shape
    g = gh.to(torch.float32).contiguous()
    if g.data_ptr() % 8:
        g = g.clone()
    r = rel.to(torch.int32).contiguous()
    if bins.dtype not in (torch.uint8, torch.int32):
        bins = bins.to(torch.int32)
    if force == "pallas":
        scale, n_max = global_scale(plan, lane_amax(g), [rows])
        qmax = value_limit(n_max)

        def local(part):
            return histogram_gh_accumulate(part, r, g, n_nodes, num_bins,
                                           scale, qmax)

        def finish(acc, fk):
            return histogram_gh_dequantize(acc, scale,
                                           (n_nodes, fk, num_bins, 2))
    else:
        def local(part):
            return _histogram_gh_xla(part, r, g, n_nodes, num_bins)

        def finish(h, fk):
            return h

    K = max(1, min(int(chunks), F))
    outs, pending = [], None
    for k in range(K):
        f0, f1 = F * k // K, F * (k + 1) // K
        if f0 == f1:
            continue
        # chunk k's histogram runs while chunk k - 1's reduction is in
        # flight; that one ends before chunk k's is issued
        h = local(bins if K == 1 else bins[:, f0:f1].contiguous())
        if pending is not None:
            outs.append(finish(pending[0].wait(), pending[1]))
        pending = (plan.allreduce_async(h), f1 - f0)
    outs.append(finish(pending[0].wait(), pending[1]))
    return torch.cat(outs, dim=1)


# ---- the front end ----------------------------------------------------------

def _histogram_gh_xla(bins, rel, gh, n_nodes, num_bins):
    rows, F = bins.shape
    feat = torch.arange(F, dtype=torch.int64, device=bins.device)
    keys = ((rel.to(torch.int64)[:, None] * F + feat) * num_bins
            + bins.to(torch.int64)).reshape(-1)
    src = gh[:, None, :].expand(rows, F, 2).reshape(-1, 2)
    return segment_sum(src, keys, n_nodes * F * num_bins).reshape(
        n_nodes, F, num_bins, 2)


def histogram_gh(bins: torch.Tensor, rel: torch.Tensor, gh: torch.Tensor,
                 n_nodes: int, num_bins: int,
                 force: str | None = None) -> torch.Tensor:
    """Per-level GBDT gradient histogram (see the module docstring).

    bins: [rows, F] int bin codes; rel: [rows] node ids in [0, n_nodes);
    gh: [rows, 2] (grad, hess).  Returns [n_nodes, F, num_bins, 2] in gh's
    dtype on either backend."""
    check_force(force, "histogram backend")
    if force == "pallas":
        if bins.dtype not in (torch.uint8, torch.int32):
            bins = bins.to(torch.int32)
        g = gh.to(torch.float32).contiguous()
        if g.data_ptr() % 8:
            g = g.clone()
        out = histogram_gh_kernel(bins.contiguous(),
                                  rel.to(torch.int32).contiguous(), g,
                                  n_nodes, num_bins)
        return out.to(gh.dtype)
    return _histogram_gh_xla(bins, rel, gh, n_nodes, num_bins)
