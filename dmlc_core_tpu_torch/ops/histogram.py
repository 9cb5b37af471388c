"""Per-level GBDT gradient histogram, with a selectable backend.

``out[n, f, b, :] = sum of gh[row] over rows with rel[row] == n and
bins[row, f] == b``: ``bins`` [rows, F] bin codes, ``rel`` [rows] node ids
in ``[0, n_nodes)``, ``gh`` [rows, 2] (grad, hess) lanes; the result is
[n_nodes, F, num_bins, 2].  Rows whose node id or bin code is out of range
add nothing.

Backends keep the JAX package's names (``histogram=`` on ``GBDT``):

* ``"pallas"``: the hand-written CUDA kernel ``csrc/histogram_gh.cu`` for a
  CUDA tensor, its plain PyTorch version for a CPU tensor.  It reads uint8
  (or int32) codes as stored, carries its sums in f64 and returns f32 (cast
  back to gh's dtype), and is bitwise reproducible from launch to launch.
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

_MAX_WARPS = 4             # features per block (csrc kMaxWarps)
_SMEM_TILE = 64 * 1024     # shared memory a block aims at
_SMEM_MAX = 227 * 1024     # what a Hopper block may take at most
_TARGET_BLOCKS = 1024      # blocks a launch aims at (132 SMs, a few each)
_MAX_CHUNKS = 256          # row chunks a launch splits into (grid y)
_MIN_CHUNK = 2048          # rows per chunk before another chunk pays off
_MAX_PARTIAL_BYTES = 1 << 29

_lib = None
_launch_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("histogram_gh")
        lib.dmlc_histogram_gh_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        lib.dmlc_histogram_gh_f32.restype = ctypes.c_int
        lib.dmlc_histogram_error_string.argtypes = [ctypes.c_int]
        lib.dmlc_histogram_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_geometry(rows: int, num_features: int, num_bins: int,
                    n_nodes: int) -> dict:
    """How one launch cuts the work: ``warps`` features a block, ``node_tile``
    nodes a pass over the rows, and ``n_chunks`` row chunks of ``chunk``
    rows (partials folded in chunk order when there is more than one)."""
    warps = min(_MAX_WARPS, max(1, num_features))
    per_node = 16 * num_bins  # bytes of one node's f64 (g, h) bins
    if per_node > _SMEM_MAX:
        raise ValueError(f"histogram_gh_kernel: num_bins={num_bins} needs "
                         f"{per_node} B of shared memory a node (max "
                         f"{_SMEM_MAX})")
    warps = min(warps, _SMEM_MAX // per_node)
    node_tile = max(1, min(n_nodes, _SMEM_TILE // (warps * per_node)))
    groups = -(-num_features // warps)
    tiles = -(-n_nodes // node_tile)
    out_bytes = 8 * n_nodes * num_features * num_bins
    n_chunks = max(1, min(_MAX_CHUNKS,
                          -(-_TARGET_BLOCKS // (groups * tiles)),
                          -(-rows // _MIN_CHUNK),
                          _MAX_PARTIAL_BYTES // max(1, out_bytes)))
    chunk = max(1, -(-rows // n_chunks))
    n_chunks = max(1, -(-rows // chunk))
    return dict(warps=warps, node_tile=node_tile, n_chunks=n_chunks,
                chunk=chunk, smem=warps * node_tile * per_node)


def histogram_gh_kernel(bins: torch.Tensor, rel: torch.Tensor,
                        gh: torch.Tensor, n_nodes: int,
                        num_bins: int) -> torch.Tensor:
    """Histogram of f32 ``gh`` [rows, 2] by uint8 or int32 ``bins`` [rows, F]
    and int32 ``rel`` [rows] -> f32 [n_nodes, F, num_bins, 2].

    On a CUDA tensor it launches ``csrc/histogram_gh.cu`` on the calling
    thread's current stream (and bumps ``histogram_gh_kernel.launches``); on
    a CPU tensor it runs :func:`histogram_gh_plain`.  Raises on anything else
    the kernel does not take."""
    if gh.device.type == "cpu":
        return histogram_gh_plain(bins, rel, gh, n_nodes, num_bins)
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
    F = bins.shape[1]
    out = torch.empty(n_nodes, F, num_bins, 2, dtype=torch.float32,
                      device=gh.device)
    if out.numel() == 0:
        return out
    geo = launch_geometry(rows, F, num_bins, n_nodes)
    partials = (torch.empty(geo["n_chunks"], out.numel(), dtype=torch.float32,
                            device=gh.device)
                if geo["n_chunks"] > 1 else None)
    lib = _kernel_lib()
    with torch.cuda.device(gh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dmlc_histogram_gh_f32(
            bins.data_ptr(), bins.element_size(), rel.data_ptr(),
            gh.data_ptr(), out.data_ptr(),
            partials.data_ptr() if partials is not None else None,
            rows, F, num_bins, n_nodes, geo["warps"], geo["node_tile"],
            geo["n_chunks"], geo["chunk"], stream)
    if err != 0:
        raise RuntimeError("histogram_gh kernel launch failed: "
                           + lib.dmlc_histogram_error_string(err).decode())
    with _launch_lock:
        histogram_gh_kernel.launches += 1
    return out


histogram_gh_kernel.launches = 0


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
