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

import numpy as np
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

_SMS = 132                 # streaming multiprocessors of an H100 SXM
_SMEM_MAX = 227 * 1024     # what a Hopper block may take at most
_WIDE_PAIRS = 14           # (node, feature) pairs a shallow block takes
_DEEP_GROUP = 3            # features a block takes at deeper levels
_WIDE_BLOCKS = 2 * _SMS    # blocks a shallow launch aims at (2 per SM)
_DEEP_BLOCKS = 16 * _SMS   # blocks a deeper launch aims at (16 per SM)
_SUB_DEEP_BLOCKS = 8 * _SMS  # a deeper subtracted level's: its blocks add
                             # ~1/3 of the rows (swept at Higgs and
                             # Covertype width on the H100; PERF.md)
_MIN_CHUNK = 2048          # rows per block before another chunk pays off
_FEW_BINS = 8              # used bins of a few-bin feature, at most 8 (the
                           # kernel keeps its codes in a list of 8)
_REDUCE_KEYS = 2           # (node, slot) keys of a few-bin feature in a
                           # block up to which its warps pre-reduce
_PROLOGUE_BLOCKS = 16 * _SMS  # the prologue's blocks at most
_PROLOGUE_SPAN = 8192      # values a prologue block takes before another
_QUEUE_SMEM = 32 * 64 * 4  # static shared bytes a subtracted level's row
                           # queues take (csrc/histogram_gh.cu, kQueue)

_lib = None
_launch_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("histogram_gh")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dmlc_histogram_gh_run.argtypes = [
            p, i, p, p, ll, i, i, i, p, i, p, p, p, p, p, i, i, i, i, ll, ll,
            i, i, i, p, p, ll, p, p, p, p, p]
        lib.dmlc_histogram_gh_run.restype = ctypes.c_int
        lib.dmlc_histogram_gh_dequantize.argtypes = [p, p, p, ll, i, p]
        lib.dmlc_histogram_gh_dequantize.restype = ctypes.c_int
        lib.dmlc_histogram_error_string.argtypes = [ctypes.c_int]
        lib.dmlc_histogram_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def prologue_blocks(n: int, threads: int) -> int:
    """Blocks of the prologue launch (``hist_fixed::prologue``) over ``n``
    values to read or zero: one per ``_PROLOGUE_SPAN``, at most
    ``_PROLOGUE_BLOCKS`` and four a thread of the histogram's block (each
    of its threads loads at most four blocks' maxima,
    ``hist_fixed::kPartialLoads``)."""
    return max(1, min(_PROLOGUE_BLOCKS, 4 * threads,
                      -(-n // _PROLOGUE_SPAN)))


def block_threads(work: int) -> int:
    """Threads of a block that takes ``work`` rows or entry quads: the
    largest power of two not above it, from 128 to 1024."""
    return max(128, min(1024, 1 << max(int(work), 1).bit_length() - 1))


def launch_geometry(rows: int, num_features: int, num_bins: int,
                    n_nodes: int, used=None, sub: bool = False) -> dict:
    """How one launch cuts the work (``csrc/histogram_gh.cu``).  ``used``:
    each feature's used bins, its slots in shared memory (default
    ``num_bins``).  Features are grouped in order by the rule tuned at
    Higgs width (PERF.md), with the widest feature's slots: while
    every node of the level fits with more than ``_DEEP_GROUP`` features
    in ``_WIDE_PAIRS`` (node, feature) pairs (depths 0-1 at 256 bins), a
    group is that many features; deeper, ``_DEEP_GROUP`` features.  A
    group takes as many nodes as the widest group's slots leave room for,
    in even node tiles (256-bin features at depth 5: two tiles of 16
    nodes), and a group of few-bin features (at most ``_FEW_BINS`` used
    bins each) as many as its own slots do (2-bin one-hot columns: every
    node in one tile).  A subtracted level (``sub``; ``n_nodes``: its
    pairs) keeps ``_QUEUE_SMEM`` bytes of shared memory for its row queues
    and aims its deeper launches at ``_SUB_DEEP_BLOCKS``.  An item is one
    group
    and one node tile; a block takes one item and ``chunk`` rows, aiming at
    ``_WIDE_BLOCKS`` blocks (``_DEEP_BLOCKS`` at deep levels) with chunks
    of at least ``min_chunk`` rows: ``_MIN_CHUNK``, and no fewer than the
    shared slots of the largest item, which every block zeroes and flushes
    (``python3 chip_smoke.py --geometry-sweep``).  Returns ``groups``
    (lists of features), ``items`` ((group, n0, n1), groups fastest, then
    node tiles), ``node_tile`` (of the largest item) and ``feat_group``
    (features a group), ``chunk``,
    ``min_chunk``, ``n_chunks``, ``blocks``, ``threads`` and ``smem`` (bytes
    of the largest item)."""
    F = num_features
    used = [num_bins] * F if used is None else [int(u) for u in used]
    # (node, slot) pairs a block holds
    cap = (_SMEM_MAX - (_QUEUE_SMEM if sub else 0)) // 16
    most = cap // max(1, max(used, default=1))
    if most < 1:
        raise ValueError(f"histogram_gh_kernel: num_bins={num_bins} needs "
                         f"{16 * num_bins} B of shared memory a node (max "
                         f"{_SMEM_MAX})")
    per_node = min(_WIDE_PAIRS, most) // n_nodes
    wide = per_node > _DEEP_GROUP
    fg = (min(F, per_node) if wide else min(F, _DEEP_GROUP, most))
    n_groups = -(-F // fg)
    fg = -(-F // n_groups)
    groups, items, slots, node_tile = [], [], 0, 1
    few = _FEW_BINS
    widest = max(sum(used[g * fg:(g + 1) * fg]) for g in range(n_groups))
    for g in range(n_groups):
        feats = list(range(g * fg, min((g + 1) * fg, F)))
        size = sum(used[f] for f in feats)
        # a group of few-bin features takes as many nodes as its own slots
        # leave room for; the others the widest group's tiles
        own = all(used[f] <= few for f in feats)
        tiles = -(-n_nodes // max(1, cap // max(
            size if own else widest, 1)))
        tile = -(-n_nodes // tiles)
        groups.append(feats)
        items.extend((k, g, n0, min(n0 + tile, n_nodes))
                     for k, n0 in enumerate(range(0, n_nodes, tile)))
        if tile * size > slots:
            slots, node_tile = tile * size, tile
    items = [i[1:] for i in sorted(items)]  # groups fastest, then tiles
    n_items = len(items)
    min_chunk = max(_MIN_CHUNK, slots)
    deep = _SUB_DEEP_BLOCKS if sub else _DEEP_BLOCKS
    n_chunks = max(1, min(-(-rows // min_chunk), -(-(
        _WIDE_BLOCKS if wide else deep) // n_items)))
    chunk = max(1, -(-rows // n_chunks))
    n_chunks = -(-rows // chunk)
    return dict(groups=groups, items=items, node_tile=node_tile,
                feat_group=fg, chunk=chunk, min_chunk=min_chunk,
                n_chunks=n_chunks, blocks=n_chunks * n_items,
                threads=block_threads(chunk), smem=16 * slots)


class DenseHistLayout:
    """The codes each feature's rows hold, for :func:`histogram_gh_kernel`.

    ``present`` bool [F, num_bins] (host): code b of feature f occurs.  A
    feature's used bins are its present codes; the kernel numbers them
    ``0..used-1`` (``slot``, int16 [F * num_bins] on ``device``, -1 for an
    absent code) and keeps only those in shared memory, and a feature of
    few used bins (``_FEW_BINS``) keeps them in a list and, where its keys
    in a block are few (``_REDUCE_KEYS``), takes the pre-reducing path.  A code a
    launch meets that the layout does not hold is still added, straight
    into the global accumulator: a stale layout costs speed, never bits.
    Built once a fit by :func:`dense_hist_layout`; the launch tables of
    each level's geometry are kept on the device."""

    __slots__ = ("num_features", "num_bins", "present", "used", "device",
                 "slot", "_geo", "_tables", "_parts")

    def __init__(self, present: np.ndarray, device):
        self.present = np.asarray(present, bool)
        self.num_features, self.num_bins = self.present.shape
        self.used = self.present.sum(1).astype(np.int64)
        slot = np.where(self.present, np.cumsum(self.present, 1) - 1, -1)
        self.slot = torch.from_numpy(slot.astype(np.int16).reshape(-1)).to(
            device)
        self.device = self.slot.device
        self._geo, self._tables, self._parts = {}, {}, {}

    def features(self, f0: int, f1: int) -> "DenseHistLayout":
        """The layout of features ``[f0, f1)`` (a feature chunk), kept."""
        if (f0, f1) == (0, self.num_features):
            return self
        hit = self._parts.get((f0, f1))
        if hit is None:
            hit = self._parts[(f0, f1)] = DenseHistLayout(
                self.present[f0:f1], self.device)
        return hit

    def launch(self, rows: int, n_nodes: int, sub: bool = False) -> tuple:
        """(geometry, tables) of a launch over ``rows`` rows and ``n_nodes``
        nodes (a subtracted level's: its pairs, with its row queues'
        shared memory kept): :func:`launch_geometry`, and on the device
        int32 [n, 4] items, groups, members and code lists and the int32
        slot keys (f * num_bins + code of every group slot), then the
        groups of a launch whose items the kernel computes (0 if it reads
        them); each built once and kept."""
        key = (rows, n_nodes, sub, _FEW_BINS, _MIN_CHUNK, _DEEP_BLOCKS,
               _SUB_DEEP_BLOCKS)
        geo = self._geo.get(key)
        if geo is None:
            geo = self._geo[key] = launch_geometry(
                rows, self.num_features, self.num_bins, n_nodes, self.used,
                sub)
        tables = self._tables.get(key[1:4])
        if tables is None:  # the same at every row count
            tables = self._tables[key[1:4]] = self._build_tables(geo, n_nodes)
        return geo, tables

    def _build_tables(self, geo: dict, n_nodes: int) -> tuple:
        B = self.num_bins

        def plain(feats):  # consecutive, every bin used, none few-bin
            return int(all(self.used[f] == B > _FEW_BINS for f in feats)
                       and list(feats) == list(range(feats[0],
                                                     feats[0] + len(feats))))

        items = np.array([(g, n0, n1, plain(geo["groups"][g]))
                          for g, n0, n1 in geo["items"]], np.int32)
        # every group plain and tiled alike: the kernel computes its items
        n_groups = len(geo["groups"])
        plain_groups = n_groups if items[:, 3].all() and len(items) == (
            n_groups * -(-n_nodes // geo["node_tile"])) else 0
        groups, members, lists, keys = [], [], [], []
        for feats in geo["groups"]:
            groups.append((len(members), len(feats),
                           sum(int(self.used[f]) for f in feats), len(keys)))
            off = 0
            for f in feats:
                u = int(self.used[f])
                codes = np.flatnonzero(self.present[f])
                few = u <= _FEW_BINS
                members.append((f, off, (1 if few else 0)
                                | (2 if u == B else 0), u))
                code_list = np.full(8, -1, np.int16)
                if few:
                    code_list[:u] = codes
                lists.append(code_list.view(np.int32))
                keys.extend(f * B + codes)
                off += u
        dev = self.device
        as_dev = (lambda a, shape: torch.from_numpy(
            np.asarray(a, np.int32).reshape(shape)).to(dev))
        return (as_dev(items, (-1, 4)), as_dev(groups, (-1, 4)),
                as_dev(members, (-1, 4)), as_dev(lists, (-1, 4)),
                as_dev(keys or [0], (-1,)), plain_groups)


_IDENTITY: dict = {}


def _identity_layout(F: int, B: int, device) -> DenseHistLayout:
    """Every code of every feature present: the layout of a caller with no
    scan (every feature many-bin unless ``num_bins <= _FEW_BINS``)."""
    key = (F, B, str(device))
    hit = _IDENTITY.get(key)
    if hit is None:
        hit = _IDENTITY[key] = DenseHistLayout(np.ones((F, B), bool), device)
    return hit


_PRESENT_ELEMS = 1 << 24  # codes a scan step reads (bounds its memory)


def dense_hist_layout(bins: torch.Tensor, num_bins: int) -> DenseHistLayout:
    """The :class:`DenseHistLayout` of ``bins`` [rows, F]: which codes in
    ``[0, num_bins)`` each feature's rows hold, found on the codes' device
    in steps of ``_PRESENT_ELEMS`` codes (one host copy of the [F,
    num_bins] result).  ``GBDT.fit`` builds it once a fit."""
    rows, F = bins.shape
    dev = bins.device
    flat = torch.zeros(F * num_bins + 1, dtype=torch.bool, device=dev)
    offs = torch.arange(F, dtype=torch.int64, device=dev) * num_bins
    step = max(1, _PRESENT_ELEMS // max(F, 1))
    for r0 in range(0, rows, step):
        c = bins[r0:r0 + step].to(torch.int64)
        keys = torch.where((c >= 0) & (c < num_bins), c + offs,
                           F * num_bins)
        flat[keys.reshape(-1)] = True
    return DenseHistLayout(flat[:-1].reshape(F, num_bins).cpu().numpy(),
                           dev)


def _check_inputs(bins, rel, gh, n_nodes: int, num_bins: int,
                  layout: DenseHistLayout | None) -> None:
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
    if layout is not None and (
            (layout.num_features, layout.num_bins) != (bins.shape[1],
                                                       num_bins)
            or layout.slot.device != gh.device):
        raise ValueError(f"histogram_gh_kernel: a layout of "
                         f"{layout.num_features} features x "
                         f"{layout.num_bins} bins on {layout.device}, called "
                         f"with {bins.shape[1]} x {num_bins} on {gh.device}")


def _run(bins, rel, gh, n_nodes: int, num_bins: int, layout, *,
         out=None, scale_out=None, scale=None, qmax: int = 0, parent=None,
         built=None):
    """Launch ``dmlc_histogram_gh_run`` on checked CUDA inputs: a one-process
    histogram into ``out`` (its scale into ``scale_out``), or, with the
    caller's ``scale`` and ``qmax``, the accumulate half.  With ``parent``
    (checked by :func:`_check_parent`) a subtracted level, whose launch
    geometry is over the ``n_nodes // 2`` node pairs.  Returns the int64
    scratch, whose first ``n_out + 2`` words are the accumulator (a
    one-process call's then holds ``n_nodes`` words the next level counts
    its rows in, the tickets and the prologue's maxima)."""
    rows, F = bins.shape
    n_out = n_nodes * F * num_bins * 2
    layout = layout or _identity_layout(F, num_bins, gh.device)
    sub = parent is not None
    geo, (items, groups, members, lists, keys, plain_groups) = layout.launch(
        rows, n_nodes // 2 if sub else n_nodes, sub)
    n_items = len(geo["items"])
    n_partial = prologue_blocks(max(rows, n_out), geo["threads"])
    extra = n_nodes + n_items + 1 + n_partial if out is not None else 0
    scratch = torch.empty(n_out + 2 + extra, dtype=torch.int64,
                          device=gh.device)
    if scale is not None:
        scale = scale.to(device=gh.device, dtype=torch.float32).contiguous()
    ptr = (lambda t: None if t is None else t.data_ptr())
    lib = _kernel_lib()
    with torch.cuda.device(gh.device):
        err = lib.dmlc_histogram_gh_run(
            bins.data_ptr(), bins.element_size(), rel.data_ptr(),
            gh.data_ptr(), rows, F, num_bins, n_nodes, items.data_ptr(),
            n_items, groups.data_ptr(), members.data_ptr(),
            lists.data_ptr(), layout.slot.data_ptr(), keys.data_ptr(),
            _REDUCE_KEYS, plain_groups, geo["feat_group"], geo["node_tile"],
            geo["chunk"],
            geo["n_chunks"], geo["threads"], geo["smem"], n_partial,
            ptr(scale), ptr(scale_out),
            int(qmax) if scale is not None else value_limit(rows),
            scratch.data_ptr(), ptr(out), ptr(parent), ptr(built),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("histogram_gh launch failed: "
                           + lib.dmlc_histogram_error_string(err).decode())
    return scratch


def histogram_gh_kernel(bins: torch.Tensor, rel: torch.Tensor,
                        gh: torch.Tensor, n_nodes: int, num_bins: int,
                        layout: DenseHistLayout | None = None, *,
                        return_scale: bool = False, parent=None, built=None,
                        return_acc: bool = False):
    """Histogram of f32 ``gh`` [rows, 2] by uint8 or int32 ``bins`` [rows, F]
    and int32 ``rel`` [rows] -> f32 [n_nodes, F, num_bins, 2].

    On a CUDA tensor it runs the kernel on the calling thread's current
    stream (two launches: the prologue and the histogram, which finds the
    scale ``fixed_point_scale(lane_amax(gh), rows)`` of :mod:`.fixed_point`
    itself and dequantizes) and bumps ``histogram_gh_kernel.launches``.
    ``layout``: the codes' :class:`DenseHistLayout` (a fit's; else every
    feature holds every code).  With ``return_scale`` it also returns that
    f32 [2] scale.  On a CPU tensor it runs :func:`histogram_gh_plain` (and
    the scale by :mod:`.fixed_point`).  Raises on anything else the kernel
    does not take.

    Sibling subtraction (on the card only): ``parent`` is the int64
    scratch a call with ``return_acc`` returned for the previous level,
    over the same ``bins``, ``gh`` and ``layout`` at ``n_nodes // 2``
    nodes, where each row's node was ``rel // 2``.  The prologue counts
    each node's rows (into ``parent``, which the launch leaves as it found
    it), only the rows of the child of each node pair with fewer rows add
    (:func:`smaller_sides`), each sibling is its parent's int64 sums less
    its built child's, and the result is the full level's bit for bit
    (:func:`histogram_gh_subtract_plain`); bumps
    ``histogram_gh_kernel.subtracted`` too, and ``built`` (int64 [] on the
    card, or None) gains the rows the level added.  With ``return_acc``
    the int64 scratch comes last in the result: its first ``n_out + 2``
    words are the level's accumulator and marks, what the next level takes
    as ``parent``."""
    sub = parent is not None
    if gh.device.type == "cpu":
        if sub or return_acc:
            raise ValueError("histogram_gh_kernel: sibling subtraction and "
                             "the accumulator are the kernel's, on the card")
        out = histogram_gh_plain(bins, rel, gh, n_nodes, num_bins)
        if not return_scale:
            return out
        return out, fixed_point_scale(lane_amax(gh), bins.shape[0])
    _check_inputs(bins, rel, gh, n_nodes, num_bins, layout)
    rows, F = bins.shape
    if sub:
        _check_parent(parent, built, n_nodes, F * num_bins * 2, gh.device)
    out = torch.empty((n_nodes, F, num_bins, 2), dtype=torch.float32,
                      device=gh.device)
    scale = torch.empty(2, dtype=torch.float32, device=gh.device)
    acc = None
    if out.numel():
        acc = _run(bins, rel, gh, n_nodes, num_bins, layout, out=out,
                   scale_out=scale if rows else None, parent=parent,
                   built=built)
        if not rows:
            scale = fixed_point_scale(lane_amax(gh), rows)
    _count_launch(sub)
    result = (out,) + ((scale,) if return_scale else ())
    if return_acc:
        if acc is None:  # no outputs: no sums, no marks
            acc = torch.zeros(3, dtype=torch.int64, device=gh.device)
        result += (acc,)
    return result if len(result) > 1 else out


histogram_gh_kernel.launches = 0
histogram_gh_kernel.subtracted = 0


def _check_parent(parent, built, n_nodes: int, node_words: int,
                  device) -> None:
    """Raise unless ``parent`` (a one-process scratch of ``n_nodes // 2``
    nodes of ``node_words`` int64 sums) and ``built`` can make a
    subtracted level of ``n_nodes`` nodes."""
    half = n_nodes // 2
    need = half * node_words + 2 + half + 1  # sums, marks, counts, ticket
    ok = (parent is not None and n_nodes % 2 == 0
          and parent.device == device and parent.dtype == torch.int64
          and parent.is_contiguous() and parent.numel() >= need
          and (built is None or (built.device == device
                                 and built.dtype == torch.int64
                                 and built.numel() == 1)))
    if not ok:
        desc = ", ".join(
            f"{k} {None if t is None else (t.dtype, tuple(t.shape), str(t.device))}"
            for k, t in (("parent", parent), ("built", built)))
        raise ValueError(
            f"histogram_gh_kernel: a subtracted level of {n_nodes} nodes "
            f"takes an int64 parent scratch of at least {need} words and an "
            f"int64 [] built counter or None, on {device}; got {desc}")


def smaller_sides(counts: torch.Tensor) -> torch.Tensor:
    """The built child of each node pair of a subtracted level: bool [n],
    True (the right child, node 2p + 1) where it holds fewer rows than the
    left, from ``counts`` [2n], each node's rows; ties build the left.  The
    kernel's time follows the rows it adds (a null split sends every row
    left, so its empty right child is built)."""
    return counts[1::2] < counts[0::2]


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


def histogram_gh_subtract_plain(bins: torch.Tensor, rel: torch.Tensor,
                                gh: torch.Tensor, n_nodes: int,
                                num_bins: int, scale: torch.Tensor,
                                qmax: int, parent: torch.Tensor,
                                counts: torch.Tensor) -> torch.Tensor:
    """A subtracted level in plain PyTorch, the kernel's int64 route: the
    rows of each pair's built child (:func:`smaller_sides` of ``counts``,
    each node's rows, as the kernel counts them) accumulated at ``scale``
    and ``qmax`` (:func:`histogram_gh_accumulate_plain`), each sibling the
    ``parent`` accumulator's sums (the previous level's, int64 [n_nodes //
    2 * F * num_bins * 2 + 2]) less its built child's, in int64 modulo
    2^64, and each lane's mark the built rows' or the parent's.  Returns
    int64 [n_nodes * F * num_bins * 2 + 2], the full level's accumulator
    bit for bit."""
    half = n_nodes // 2
    r = rel.to(torch.int64)
    pair = torch.div(r, 2, rounding_mode="floor")
    s = smaller_sides(counts).to(torch.int64)
    live = (r >= 0) & (pair < half)
    built_row = live & ((r % 2) == s[pair.clamp(0, max(half - 1, 0))])
    acc = histogram_gh_accumulate_plain(
        bins, torch.where(built_row, pair, -1).to(torch.int32), gh, half,
        num_bins, scale, qmax)
    n_half = acc.numel() - 2
    built = acc[:n_half].reshape(half, -1)
    sib = parent[:n_half].reshape(half, -1) - built
    full = torch.empty(n_nodes, built.shape[1], dtype=torch.int64,
                       device=built.device)
    p = torch.arange(half, device=built.device)
    full[2 * p + s] = built
    full[2 * p + 1 - s] = sib
    marks = acc[n_half:] | (parent[n_half:n_half + 2] != 0).to(torch.int64)
    return torch.cat([full.reshape(-1), marks])


def _count_launch(subtracted: bool = False) -> None:
    with _launch_lock:
        histogram_gh_kernel.launches += 1
        histogram_gh_kernel.subtracted += int(subtracted)


def histogram_gh_accumulate(bins: torch.Tensor, rel: torch.Tensor,
                            gh: torch.Tensor, n_nodes: int, num_bins: int,
                            scale: torch.Tensor, qmax: int,
                            layout: DenseHistLayout | None = None
                            ) -> torch.Tensor:
    """The accumulate half of :func:`histogram_gh_kernel`: int64 [n_nodes *
    F * num_bins * 2 + 2] (the bins' fixed-point sums at the caller's f32
    [2] ``scale`` and value limit ``qmax``, then each lane's overflow
    mark), left undequantized so the accumulators of several processes can
    be summed exactly before one :func:`histogram_gh_dequantize`.  On a
    CUDA tensor it runs the kernel's body with that scale (the prologue
    zeroes the accumulator; the launch stops before rounding) and bumps
    ``histogram_gh_kernel.launches`` (not for no rows); on a CPU tensor it
    runs :func:`histogram_gh_accumulate_plain`.  Takes what the kernel
    takes."""
    if gh.device.type == "cpu":
        return histogram_gh_accumulate_plain(bins, rel, gh, n_nodes,
                                             num_bins, scale, qmax)
    _check_inputs(bins, rel, gh, n_nodes, num_bins, layout)
    n_out = n_nodes * bins.shape[1] * num_bins * 2
    if n_out == 0:
        return torch.zeros(2, dtype=torch.int64, device=gh.device)
    acc = _run(bins, rel, gh, n_nodes, num_bins, layout, scale=scale,
               qmax=qmax)
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
                         force: str | None = "pallas",
                         layout: DenseHistLayout | None = None
                         ) -> torch.Tensor:
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
    reduction in flight; the bits do not change.  ``layout``: this
    process's codes' :class:`DenseHistLayout` (a launch takes each chunk's
    features of it).  f32 [n_nodes, F, num_bins, 2]."""
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

        def local(part, f0, f1):
            return histogram_gh_accumulate(
                part, r, g, n_nodes, num_bins, scale, qmax,
                layout and layout.features(f0, f1))

        def finish(acc, fk):
            return histogram_gh_dequantize(acc, scale,
                                           (n_nodes, fk, num_bins, 2))
    else:
        def local(part, f0, f1):
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
        h = local(bins if K == 1 else bins[:, f0:f1].contiguous(), f0, f1)
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
                 n_nodes: int, num_bins: int, force: str | None = None,
                 layout: DenseHistLayout | None = None) -> torch.Tensor:
    """Per-level GBDT gradient histogram (see the module docstring).

    bins: [rows, F] int bin codes; rel: [rows] node ids in [0, n_nodes);
    gh: [rows, 2] (grad, hess); ``layout``: the codes'
    :class:`DenseHistLayout` for the kernel (``GBDT.fit`` builds it once a
    fit).  Returns [n_nodes, F, num_bins, 2] in gh's dtype on either
    backend."""
    check_force(force, "histogram backend")
    if force == "pallas":
        if bins.dtype not in (torch.uint8, torch.int32):
            bins = bins.to(torch.int32)
        g = gh.to(torch.float32).contiguous()
        if g.data_ptr() % 8:
            g = g.clone()
        out = histogram_gh_kernel(bins.contiguous(),
                                  rel.to(torch.int32).contiguous(), g,
                                  n_nodes, num_bins, layout)
        return out.to(gh.dtype)
    return _histogram_gh_xla(bins, rel, gh, n_nodes, num_bins)
