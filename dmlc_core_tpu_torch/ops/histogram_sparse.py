"""Sparse (COO) GBDT gradient histogram, with a selectable backend.

``out[n, f, b, :] = sum of gh[row_id[k]] over live entries k with
rel[row_id[k]] == n, findex[k] == f and ebin[k] == b``: the per-level
histogram of ``GBDT.fit_batch``, O(nnz) work, no densify.  ``row_id``,
``findex``, ``ebin``, ``emask`` are [nnz] entry arrays (``emask`` 0 marks
padding and masked lanes), ``rel`` [rows] node ids, ``gh`` [rows, 2]; the
result is [n_nodes, F, num_bins, 2].

Backends keep the JAX package's names (``histogram=`` on ``GBDT``):

* ``"pallas"``: the hand-written CUDA kernel ``csrc/histogram_gh_sparse.cu``
  for a CUDA tensor, its plain PyTorch version for a CPU tensor, over the
  feature-sorted :class:`SparseHistLayout` (built here unless one is passed;
  ``GBDT.fit_batch`` builds it once a fit).  Bitwise reproducible from launch
  to launch.
* ``None`` / ``"xla"``: ``index_add`` over flattened ``(rel[rid] * F + fi) *
  B + ebin`` keys, the counterpart of the XLA scatter-add the JAX package
  leaves outside any kernel.  On the card its atomics add in an order that
  changes from run to run.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import _build
from .fixed_point import (dequantize_plain, fixed_point_scale, global_scale,
                          lane_amax, quantize_plain, value_limit)
from .histogram import block_threads, prologue_blocks
from .segment_sum import check_force, clamp_index, segment_sum

# ---- the layout -------------------------------------------------------------


def _sparse_geometry(num_features: int, num_bins: int) -> int:
    """Per-feature key stride ``nb`` (the power of two >= num_bins) of the
    global key ``gkey = f * nb + bin``, which must fit int32."""
    nb = 1 << max(num_bins - 1, 1).bit_length()
    if num_features * nb >= 2 ** 31:
        raise ValueError(f"feature x bin key space overflows int32 "
                         f"({num_features} features x {nb} bin stride)")
    return nb


class SparseHistLayout:
    """Feature-sorted COO layout for :func:`histogram_gh_sparse`.

    ``findex``/``ebin`` are the same at every level of every tree, so the
    entries are sorted by feature once a fit and the sort is reused.  Masked
    entries are dropped.  Fields: ``gkey`` int32 [nnz_live] (``fi * nb +
    ebin``) and ``rid`` int32 [nnz_live] (row ids) on the entries' device, in
    stable feature order; ``starts`` int64 [num_features + 1] on the host,
    feature f's entries being ``[starts[f], starts[f + 1])``."""

    __slots__ = ("num_features", "num_bins", "nb", "nnz_live", "gkey", "rid",
                 "starts", "_tables", "_used")

    def __init__(self, **kw):
        for k in self.__slots__[:-2]:
            setattr(self, k, kw[k])
        self._tables, self._used = {}, None

    def used_bins(self) -> np.ndarray:
        """int64 [F] (host): the distinct bins of each feature's entries,
        counted on ``gkey``'s device."""
        return used_bins(self.gkey, self.num_features, self.nb)

    def used_on_device(self) -> torch.Tensor:
        """int32 [F] :meth:`used_bins` on ``gkey``'s device, what the kernel
        reads to pre-reduce a feature of few keys a block (``_REDUCE_KEYS``);
        counted on first use and kept, as a fit's levels share it."""
        if self._used is None:
            self._used = torch.from_numpy(self.used_bins().astype(
                np.int32)).to(self.gkey.device)
        return self._used

    def span_table(self, span: int) -> tuple:
        """:func:`span_table` of ``starts`` with the table on ``gkey``'s
        device, built on first use for a span and kept: a fit's levels
        share it, and a launch that finds it copies nothing from the host
        (a copy would wait for the card)."""
        hit = self._tables.get(span)
        if hit is None:
            n_spans, table = span_table(self.starts, span)
            hit = self._tables[span] = (
                n_spans, torch.from_numpy(table).to(self.gkey.device))
        return hit


def used_bins(gkey: torch.Tensor, num_features: int, nb: int) -> np.ndarray:
    """int64 [F] (host): the distinct bins among the keys ``f * nb + bin``
    of each feature, by one ``bincount`` on the keys' device."""
    if gkey.numel() == 0:
        return np.zeros(num_features, np.int64)
    hits = torch.bincount(gkey.to(torch.int64), minlength=num_features * nb)
    return (hits[:num_features * nb].reshape(num_features, nb) > 0).sum(
        1).cpu().numpy()


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _sparse_layout_shard(rid: torch.Tensor, fi: torch.Tensor,
                         eb: torch.Tensor, nb: int, num_features: int):
    """Sort one shard's live entries by feature.  The sort is stable, so
    within a feature the entries keep their input order (numpy's
    ``argsort(kind="stable")`` order) and the layout, and with it the
    kernel's order of adds, is a pure function of the entry stream."""
    order = torch.sort(fi, stable=True).indices
    fi_s = fi[order]
    gkey = (fi_s * nb + eb[order]).to(torch.int32)
    rid_s = rid[order].to(torch.int32)
    starts = torch.zeros(num_features + 1, dtype=torch.int64)
    starts[1:] = torch.cumsum(torch.bincount(fi_s, minlength=num_features),
                              0).cpu()
    return rid_s, gkey, starts


# the TPU kernel's tiles, which fix the per-shard layout's padding and spans
_JAX_KEY_TILE = 512
_JAX_NNZ_TILE = 1024


class ShardedSparseHistLayout:
    """The per-shard packed layout of ``sparse_hist_layout(num_shards > 1)``
    (the JAX package's arrays for its ``shard_map`` route): ``gkey`` /
    ``rid`` / ``w`` [num_shards * nnz_pad] (padding: gkey -1, rid 0, w 0;
    row ids local to the shard), ``tstart`` / ``tcount`` [num_shards *
    num_kt] (each 512-key tile's span of 1024-entry blocks), ``max_tiles``,
    ``nnz_pad``, ``nnz_live``, as numpy arrays.  Each process of a sharded
    fit takes its shard's :class:`SparseHistLayout` with :meth:`shard`."""

    def __init__(self, shards: list, **kw):
        self._shards = shards
        for k, v in kw.items():
            setattr(self, k, v)

    def shard(self, s: int) -> SparseHistLayout:
        """Shard ``s``'s entries (shard-local row ids) as the port's
        kernel layout."""
        return self._shards[s]


def _jax_tile_spans(starts: np.ndarray, nb: int, num_kt: int,
                    num_features: int) -> tuple:
    tstart = np.zeros(num_kt, np.int32)
    tcount = np.zeros(num_kt, np.int32)
    for kt in range(num_kt):
        # features whose key range [f*nb, (f+1)*nb) meets this key tile
        flo = min((kt * _JAX_KEY_TILE) // nb, num_features)
        fhi = min(-(-((kt + 1) * _JAX_KEY_TILE) // nb), num_features)
        s, e = int(starts[flo]), int(starts[fhi])
        if e > s:
            tstart[kt] = s // _JAX_NNZ_TILE
            tcount[kt] = -(-e // _JAX_NNZ_TILE) - tstart[kt]
    return tstart, tcount


def _sharded_layout(rid, fi, eb, em, num_features: int, num_bins: int,
                    nb: int, num_shards: int, rows) -> ShardedSparseHistLayout:
    if rows is None or rows % num_shards:
        raise ValueError("sharded layout needs rows divisible by "
                         f"num_shards (rows={rows}, "
                         f"num_shards={num_shards})")
    local = rows // num_shards
    owner = rid // local
    num_kt = -(-(num_features * nb) // _JAX_KEY_TILE)
    shards, spans = [], []
    for s in range(num_shards):
        sel = em & (owner == s)
        r, f, e = rid[sel] - s * local, fi[sel], eb[sel]
        rid_s, gkey, starts = _sparse_layout_shard(r, f, e, nb, num_features)
        shards.append(SparseHistLayout(
            num_features=num_features, num_bins=num_bins, nb=nb,
            nnz_live=int(gkey.numel()), gkey=gkey, rid=rid_s,
            starts=starts))
        spans.append(_jax_tile_spans(starts.numpy(), nb, num_kt,
                                     num_features))
    n_live = [sh.nnz_live for sh in shards]
    nnz_pad = max(-(-max(max(n_live), 1) // _JAX_NNZ_TILE) * _JAX_NNZ_TILE,
                  _JAX_NNZ_TILE)
    gkey_p = np.full(num_shards * nnz_pad, -1, np.int32)
    rid_p = np.zeros(num_shards * nnz_pad, np.int32)
    w_p = np.zeros(num_shards * nnz_pad, np.float32)
    for s, sh in enumerate(shards):
        o = s * nnz_pad
        gkey_p[o:o + sh.nnz_live] = sh.gkey.cpu().numpy()
        rid_p[o:o + sh.nnz_live] = sh.rid.cpu().numpy()
        w_p[o:o + sh.nnz_live] = 1.0
    tstart = np.concatenate([t for t, _ in spans])
    tcount = np.concatenate([c for _, c in spans])
    return ShardedSparseHistLayout(
        shards, num_features=num_features, num_bins=num_bins,
        num_shards=num_shards, nb=nb, num_kt=num_kt,
        max_tiles=max(int(tcount.max()) if tcount.size else 0, 1),
        nnz_pad=nnz_pad, nnz_live=sum(n_live), gkey=gkey_p, rid=rid_p,
        w=w_p, tstart=tstart, tcount=tcount)


def sparse_hist_layout(row_id, findex, ebin, emask, num_features: int,
                       num_bins: int, num_shards: int = 1,
                       rows: int | None = None):
    """Build the feature-sorted layout (see :class:`SparseHistLayout`) on
    the entries' device.  row_id/findex/ebin/emask: [nnz] COO entry arrays
    (tensors or numpy, any int/bool dtypes).  ``num_shards > 1`` buckets
    the entries by the row shard that owns them (``rows`` must divide
    evenly, the JAX package's rule and error), localises their row ids
    and returns the packed :class:`ShardedSparseHistLayout`."""
    fi = _tensor(findex).to(torch.int64)
    eb = _tensor(ebin).to(torch.int64).to(fi.device)
    em = _tensor(emask).to(torch.bool).to(fi.device)
    rid = _tensor(row_id).to(torch.int64).to(fi.device)
    fl, el = fi[em], eb[em]
    if fl.numel():
        if int(fl.min()) < 0 or int(fl.max()) >= num_features:
            raise ValueError("findex out of range for live entries")
        if int(el.min()) < 0 or int(el.max()) >= num_bins:
            raise ValueError("ebin out of range for live entries")
    nb = _sparse_geometry(num_features, num_bins)
    if num_shards != 1:
        return _sharded_layout(rid, fi, eb, em, num_features, num_bins, nb,
                               num_shards, rows)
    rid_s, gkey, starts = _sparse_layout_shard(rid[em], fl, el, nb,
                                               num_features)
    return SparseHistLayout(num_features=num_features, num_bins=num_bins,
                            nb=nb, nnz_live=int(gkey.numel()), gkey=gkey,
                            rid=rid_s, starts=starts)


# ---- the plain version ------------------------------------------------------

_PLAIN_ELEMS = 1 << 24  # one-hot elements per entry block (bounds its memory)
_PLAIN_GROUP = 64       # entry blocks summed apart before they join the total


def histogram_gh_sparse_plain(gkey: torch.Tensor, rel_e: torch.Tensor,
                              gh_e: torch.Tensor, starts, n_nodes: int,
                              num_features: int,
                              num_bins: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the one-hot contraction the
    TPU kernel computes.  For each feature's span of entries, in blocks,
    ``out[(lane, node), b] += A^T B`` with ``A[k, (lane, node)] = gh_e[k,
    lane] * [rel_e[k] == node]`` and ``B[k, b] = [gkey[k] - f * nb == b]``,
    in f32 with TF32 off; a feature's block products are summed in groups of
    ``_PLAIN_GROUP`` before they join its total.  Returns f32 [n_nodes, F,
    num_bins, 2].  Used on CPU tensors and as the reference the kernel is
    held to on the card."""
    dev = gh_e.device
    nb = _sparse_geometry(num_features, num_bins)
    st = [int(s) for s in _tensor(starts).tolist()]
    nodes = torch.arange(n_nodes, device=dev)
    bin_ids = torch.arange(num_bins, device=dev)
    out = torch.zeros(num_features, 2 * n_nodes, num_bins,
                      dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_ELEMS // max(1, 2 * n_nodes, num_bins))
    # the f32 contract: a TF32 product would keep ~3 decimal digits
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for f in range(num_features):
            total, group = out[f], torch.zeros_like(out[f])
            for i, k0 in enumerate(range(st[f], st[f + 1], step)):
                k1 = min(k0 + step, st[f + 1])
                mask = (rel_e[k0:k1, None].to(torch.int64) == nodes).to(
                    torch.float32)
                g = gh_e[k0:k1].to(torch.float32)
                a = torch.cat([mask * g[:, 0:1], mask * g[:, 1:2]], dim=1)
                onehot = ((gkey[k0:k1, None].to(torch.int64) - f * nb)
                          == bin_ids).to(torch.float32)
                group += a.T @ onehot
                if (i + 1) % _PLAIN_GROUP == 0:
                    total += group
                    group.zero_()
            total += group
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out.reshape(num_features, 2, n_nodes, num_bins).permute(
        2, 0, 3, 1).contiguous()


# ---- the kernel -------------------------------------------------------------

_SMS = 132                   # streaming multiprocessors of an H100 SXM
_SMEM_MAX = 227 * 1024       # what a Hopper block (and an SM) may take
_TARGET_SPANS = 1024         # spans a large launch aims at (many waves)
_MIN_SPAN = 16384            # entries per span before another span pays off
_SMALL_SPANS = 2 * _SMS      # spans a launch of fewer entries aims at
_SPAN_FLOOR = 4096           # entries a span takes at the least
_REDUCE_KEYS = 2             # (node, bin) keys of a feature in a block up
                             # to which its warps pre-reduce

_lib = None
_launch_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("histogram_gh_sparse")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dmlc_histogram_gh_sparse_run.argtypes = [
            p, p, p, ll, i, p, ll, p, i, i, i, i, i, i, i, i, ll, p, p, p,
            ll, p, p, p, p]
        lib.dmlc_histogram_gh_sparse_run.restype = ctypes.c_int
        lib.dmlc_histogram_gh_sparse_dequantize.argtypes = [p, p, p, ll, i, p]
        lib.dmlc_histogram_gh_sparse_dequantize.restype = ctypes.c_int
        lib.dmlc_histogram_sparse_error_string.argtypes = [ctypes.c_int]
        lib.dmlc_histogram_sparse_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_geometry(nnz: int, num_features: int, num_bins: int,
                    n_nodes: int) -> dict:
    """How one launch cuts the work: a block's shared histogram holds
    ``node_tile`` nodes (every node of the level while they fit, else even
    tiles, one pass over the entries each), and spans of at most ``span``
    entries of one feature: about ``_TARGET_SPANS`` of at least
    ``_MIN_SPAN`` at Bosch width (the constants it was tuned at), and below
    ``_SMALL_SPANS * _MIN_SPAN`` entries about ``_SMALL_SPANS`` spans (two
    blocks an SM) of at least ``min_span``: ``_SPAN_FLOOR``, and no fewer
    than the shared bins a block zeroes and flushes (``python3
    chip_smoke.py --geometry-sweep``).  ``threads``: a block's, one a quad
    of the span's entries, from 128 to 1024."""
    per_node = 16 * num_bins  # bytes of one node's int64 (g, h) bins
    most = _SMEM_MAX // per_node
    if most < 1:
        raise ValueError(f"histogram_gh_sparse_kernel: num_bins={num_bins} "
                         f"needs {per_node} B of shared memory a node (max "
                         f"{_SMEM_MAX})")
    tiles = -(-n_nodes // most)
    node_tile = max(1, -(-n_nodes // tiles))
    min_span = max(_SPAN_FLOOR, node_tile * num_bins)
    span = max(min_span, min(_MIN_SPAN, -(-nnz // _SMALL_SPANS)),
               -(-nnz // _TARGET_SPANS))
    return dict(node_tile=node_tile, span=span, min_span=min_span,
                smem=node_tile * per_node,
                threads=block_threads(-(-span // 4)))


def span_table(starts, span: int) -> tuple:
    """Cut each feature's entries ``[starts[f], starts[f + 1])`` into spans
    of at most ``span`` entries, one empty span for a feature with none (so
    the launch writes every feature's bins).  Returns (n_spans, int64
    table): span begins, span ends, span features and each span's
    feature's span count, as the kernel reads them."""
    st = _tensor(starts).cpu().numpy().astype(np.int64)
    per = np.maximum(-(-np.diff(st) // span), 1)
    feat_spans = np.zeros(st.size, np.int64)
    np.cumsum(per, out=feat_spans[1:])
    n_spans = int(feat_spans[-1])
    feat = np.repeat(np.arange(st.size - 1, dtype=np.int64), per)
    begin = np.minimum(st[feat] + (np.arange(n_spans) - feat_spans[feat])
                       * span, st[feat + 1])
    end = np.minimum(begin + span, st[feat + 1])
    return n_spans, np.concatenate([begin, end, feat, per[feat]])


def _check_kernel_inputs(gkey, rel_e, gh_e, st, n_nodes, num_features,
                         num_bins, gh_amax) -> None:
    """Raise on anything the kernel does not take."""
    if (gh_e.device.type != "cuda" or gkey.device != gh_e.device
            or rel_e.device != gh_e.device):
        raise ValueError(f"histogram_gh_sparse_kernel: gkey on "
                         f"{gkey.device}, rel_e on {rel_e.device}, gh_e on "
                         f"{gh_e.device}; want one CUDA device")
    if (gkey.dtype != torch.int32 or rel_e.dtype != torch.int32
            or gh_e.dtype != torch.float32):
        raise TypeError(f"histogram_gh_sparse_kernel takes int32 gkey and "
                        f"rel_e and f32 gh_e, got {gkey.dtype} / "
                        f"{rel_e.dtype} / {gh_e.dtype}")
    nnz = gkey.shape[0] if gkey.dim() == 1 else -1
    if (gkey.dim() != 1 or rel_e.shape != (nnz,) or gh_e.shape != (nnz, 2)
            or st.device.type != "cpu" or st.shape != (num_features + 1,)
            or int(st[0]) != 0 or int(st[-1]) != nnz
            or n_nodes < 1 or num_bins < 1):
        raise ValueError(f"histogram_gh_sparse_kernel: gkey "
                         f"{tuple(gkey.shape)}, rel_e {tuple(rel_e.shape)}, "
                         f"gh_e {tuple(gh_e.shape)}, host starts "
                         f"{tuple(st.shape)} on {st.device} ending at "
                         f"{int(st[-1]) if st.numel() else None}, "
                         f"F={num_features}, n_nodes={n_nodes}, "
                         f"num_bins={num_bins}")
    if not (gkey.is_contiguous() and rel_e.is_contiguous()
            and gh_e.is_contiguous()):
        raise ValueError("histogram_gh_sparse_kernel takes contiguous "
                         "tensors")
    if gh_e.data_ptr() % 8:
        raise ValueError("histogram_gh_sparse_kernel reads gh_e as float2: "
                         "its data must be 8-byte aligned")
    if gh_amax is not None and (gh_amax.shape != (2,)
                                or gh_amax.device != gh_e.device
                                or gh_amax.dtype != torch.float32):
        raise ValueError(f"histogram_gh_sparse_kernel: gh_amax "
                         f"{tuple(gh_amax.shape)} {gh_amax.dtype} on "
                         f"{gh_amax.device}, want f32 [2] on {gh_e.device}")


def histogram_gh_sparse_kernel(gkey: torch.Tensor, rel_e: torch.Tensor,
                               gh_e: torch.Tensor, starts, n_nodes: int,
                               num_features: int, num_bins: int,
                               layout: SparseHistLayout | None = None, *,
                               gh_amax: torch.Tensor | None = None,
                               return_scale: bool = False):
    """Histogram of feature-sorted entries: int32 ``gkey`` [nnz] (``f * nb
    + bin``), int32 ``rel_e`` [nnz] (each entry's node), f32 ``gh_e`` [nnz,
    2], host ``starts`` [F + 1] (feature f's entries are ``[starts[f],
    starts[f + 1])``) -> f32 [n_nodes, F, num_bins, 2].  The arrays of a
    :class:`SparseHistLayout` with ``rel_e = rel[layout.rid]`` and ``gh_e =
    gh[layout.rid]``; pass that ``layout`` too and the launch takes the span
    table and the used-bin counts it keeps on the card, else the table is
    built and copied here (and no feature pre-reduces).

    On a CUDA tensor it runs the kernel on the calling thread's current
    stream (two launches: the prologue and the histogram, which finds its
    scale and dequantizes) and bumps
    ``histogram_gh_sparse_kernel.launches``, in the fixed point of
    :mod:`.fixed_point` with ``n_max`` = the most entries of one feature and
    ``amax`` = ``gh_amax`` (f32 [2] on the card, a bound on ``|gh_e|`` of
    each lane; default ``max |gh_e|``, found inside the launch; the result
    depends on it, so callers that must agree bit for bit pass the same).
    A ``gh_amax`` below the values gives NaN in a lane where a value could
    carry a bin past int64 (:func:`.fixed_point.value_limit`), else the
    exact sums at a finer scale.  With ``return_scale`` it also returns the
    f32 [2] scale.  On a CPU tensor it runs :func:`histogram_gh_sparse_plain`
    (and the scale by :mod:`.fixed_point`).  Raises on anything else the
    kernel does not take."""
    st = _tensor(starts)
    if gh_e.device.type == "cpu":
        out = histogram_gh_sparse_plain(gkey, rel_e, gh_e, starts, n_nodes,
                                        num_features, num_bins)
        if not return_scale:
            return out
        n_max = int((st[1:] - st[:-1]).max()) if num_features else 0
        return out, fixed_point_scale(
            lane_amax(gh_e) if gh_amax is None else gh_amax, n_max)
    _check_kernel_inputs(gkey, rel_e, gh_e, st, n_nodes, num_features,
                         num_bins, gh_amax)
    if gkey.shape[0] == 0:  # no entries: no launch
        out = torch.zeros((n_nodes, num_features, num_bins, 2),
                          dtype=torch.float32, device=gh_e.device)
        return (out, fixed_point_scale(
            lane_amax(gh_e) if gh_amax is None else gh_amax, 0)
        ) if return_scale else out
    out = torch.empty((n_nodes, num_features, num_bins, 2),
                      dtype=torch.float32, device=gh_e.device)
    scale = torch.empty(2, dtype=torch.float32, device=gh_e.device)
    if out.numel():
        n_max = int((st[1:] - st[:-1]).max())
        _run(gkey, rel_e, gh_e, st, n_nodes, num_features, num_bins, layout,
             n_max=n_max, amax=gh_amax, out=out, scale_out=scale)
        with _launch_lock:
            histogram_gh_sparse_kernel.launches += 1
    return (out, scale) if return_scale else out


histogram_gh_sparse_kernel.launches = 0


_WORKSPACES: dict = {}


def _workspace(device) -> torch.Tensor:
    """int64 [4] kept zeroed between the launches on ``device``'s current
    stream (each launch that uses it zeroes it again at its end): the
    overflow marks and ticket of a one-launch call."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = _WORKSPACES[key] = torch.zeros(4, dtype=torch.int64,
                                            device=device)
    return ws


def _run(gkey, rel_e, gh_e, starts, n_nodes: int, num_features: int,
         num_bins: int, layout, *, n_max: int = 0, amax=None, out=None,
         scale_out=None, scale=None, qmax: int = 0) -> torch.Tensor:
    """Launch ``dmlc_histogram_gh_sparse_run`` on checked CUDA inputs: a
    one-process histogram into ``out`` (scale from ``amax`` or the entries,
    into ``scale_out``), or, with the caller's ``scale`` and ``qmax``, the
    accumulate half.  Returns the int64 scratch, whose first ``n_out + 2``
    words are the accumulator."""
    nnz = gkey.shape[0]
    geo = launch_geometry(nnz, num_features, num_bins, n_nodes)
    if layout is not None:
        n_spans, table = layout.span_table(geo["span"])
        # no feature pre-reduces once a tile's nodes alone pass the bound
        used = (layout.used_on_device()
                if geo["node_tile"] <= _REDUCE_KEYS else None)
    else:
        n_spans, table = span_table(starts, geo["span"])
        table, used = torch.from_numpy(table).to(gh_e.device), None
    n_out = n_nodes * num_features * num_bins * 2
    tiles = -(-n_nodes // geo["node_tile"])
    n_partial = prologue_blocks(max(nnz if amax is None else 0, n_out),
                                geo["threads"])
    # one span a feature with the caller's bound: one launch, no scratch
    alone = out is not None and amax is not None and n_spans == num_features
    workspace = _workspace(gh_e.device) if alone else None
    extra = ((num_features * tiles + 2) // 2 + n_partial
             if out is not None else 0)
    scratch = None if alone else torch.empty(
        n_out + 2 + extra, dtype=torch.int64, device=gh_e.device)
    if scale is not None:
        scale = scale.to(device=gh_e.device,
                         dtype=torch.float32).contiguous()
    vec = all(t.data_ptr() % 16 == 0 for t in (gkey, rel_e, gh_e))
    ptr = (lambda t: None if t is None else t.data_ptr())
    lib = _kernel_lib()
    with torch.cuda.device(gh_e.device):
        err = lib.dmlc_histogram_gh_sparse_run(
            gkey.data_ptr(), rel_e.data_ptr(), gh_e.data_ptr(), nnz,
            int(vec), table.data_ptr(), n_spans, ptr(used), _REDUCE_KEYS,
            num_features,
            num_bins, _sparse_geometry(num_features, num_bins), n_nodes,
            geo["node_tile"], geo["threads"], n_partial, n_max, ptr(amax),
            ptr(scale), ptr(scale_out),
            int(qmax) if scale is not None else value_limit(max(n_max, 1)),
            ptr(scratch), ptr(workspace), ptr(out),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("histogram_gh_sparse launch failed: "
                           + lib.dmlc_histogram_sparse_error_string(err)
                           .decode())
    return scratch


# ---- the accumulate / dequantize pair ---------------------------------------

def feature_counts(layout: SparseHistLayout) -> torch.Tensor:
    """int64 [F] live entries of each feature (host)."""
    st = _tensor(layout.starts).to(torch.int64)
    return st[1:] - st[:-1]


def histogram_gh_sparse_accumulate_plain(gkey, rel_e, gh_e, starts,
                                         n_nodes: int, num_features: int,
                                         num_bins: int, scale, qmax: int
                                         ) -> torch.Tensor:
    """The kernel's accumulate half in plain PyTorch: int64 [n_nodes * F *
    num_bins * 2 + 2], each entry whose node and bin are in range
    quantised once at ``scale`` (:func:`.fixed_point.quantize_plain`) and
    added exactly with an int64 ``index_add``, then each lane's overflow
    mark."""
    nb = _sparse_geometry(num_features, num_bins)
    dev = gh_e.device
    n_out = n_nodes * num_features * num_bins * 2
    acc = torch.zeros(n_out + 2, dtype=torch.int64, device=dev)
    st = _tensor(starts).to(torch.int64)
    feat = torch.repeat_interleave(torch.arange(num_features),
                                   st[1:] - st[:-1]).to(dev)
    node = rel_e.to(torch.int64)
    b = gkey.to(torch.int64) - feat * nb
    live = (node >= 0) & (node < n_nodes) & (b >= 0) & (b < num_bins)
    q, over = quantize_plain(gh_e[live].to(torch.float32), scale, qmax)
    acc[n_out:] = over.to(torch.int64)
    keys = ((node[live] * num_features + feat[live]) * num_bins + b[live]) * 2
    for lane in range(2):
        acc.index_add_(0, keys + lane, q[:, lane])
    return acc


def histogram_gh_sparse_accumulate(layout: SparseHistLayout,
                                   rel_e: torch.Tensor, gh_e: torch.Tensor,
                                   n_nodes: int, scale: torch.Tensor,
                                   qmax: int) -> torch.Tensor:
    """The accumulate half of :func:`histogram_gh_sparse_kernel` over a
    layout's entries (``rel_e``, ``gh_e`` in its order): int64 [n_nodes *
    F * num_bins * 2 + 2], the fixed-point sums at the caller's f32 [2]
    ``scale`` and value limit ``qmax``, then each lane's overflow mark,
    left undequantized so the accumulators of several processes can be
    summed exactly before one :func:`histogram_gh_sparse_dequantize`.  On a
    CUDA tensor it runs the kernel's body with that scale (the prologue
    zeroes the accumulator; the launch stops before rounding) and bumps
    ``histogram_gh_sparse_kernel.launches``; on a CPU tensor it runs
    :func:`histogram_gh_sparse_accumulate_plain`."""
    F, B = layout.num_features, layout.num_bins
    gkey = layout.gkey
    if gh_e.device.type == "cpu":
        return histogram_gh_sparse_accumulate_plain(
            gkey, rel_e, gh_e, layout.starts, n_nodes, F, B, scale, qmax)
    nnz = gkey.shape[0]
    if (rel_e.dtype != torch.int32 or gh_e.dtype != torch.float32
            or rel_e.shape != (nnz,) or gh_e.shape != (nnz, 2)
            or not (rel_e.is_contiguous() and gh_e.is_contiguous())
            or gh_e.data_ptr() % 8 or rel_e.device != gh_e.device
            or gkey.device != gh_e.device):
        raise ValueError(f"histogram_gh_sparse_accumulate: rel_e "
                         f"{tuple(rel_e.shape)} {rel_e.dtype}, gh_e "
                         f"{tuple(gh_e.shape)} {gh_e.dtype}, want contiguous "
                         f"int32 [{nnz}] and 8-byte aligned f32 [{nnz}, 2] "
                         "on the layout's CUDA device")
    if F == 0 or nnz == 0:  # no entries: no launch
        return torch.zeros(n_nodes * F * B * 2 + 2, dtype=torch.int64,
                           device=gh_e.device)
    acc = _run(gkey, rel_e, gh_e, layout.starts, n_nodes, F, B, layout,
               scale=scale, qmax=qmax)
    with _launch_lock:
        histogram_gh_sparse_kernel.launches += 1
    return acc


def histogram_gh_sparse_dequantize(acc: torch.Tensor, scale: torch.Tensor,
                                   shape) -> torch.Tensor:
    """The dequantize half: f32 ``shape`` ([n_nodes, F, num_bins, 2]) from
    an int64 accumulator of :func:`histogram_gh_sparse_accumulate` (or a
    sum of several), rounded once each."""
    if acc.device.type == "cpu":
        return dequantize_plain(acc, scale, 2).reshape(shape)
    out = torch.empty(shape, dtype=torch.float32, device=acc.device)
    scale = scale.to(device=acc.device, dtype=torch.float32).contiguous()
    lib = _kernel_lib()
    with torch.cuda.device(acc.device):
        err = lib.dmlc_histogram_gh_sparse_dequantize(
            acc.data_ptr(), scale.data_ptr(), out.data_ptr(), out.numel(), 2,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("histogram_gh_sparse dequantize launch failed: "
                           + lib.dmlc_histogram_sparse_error_string(err)
                           .decode())
    return out


def histogram_gh_sparse_sharded(layout: SparseHistLayout, rel: torch.Tensor,
                                gh: torch.Tensor, gh_e: torch.Tensor,
                                n_nodes: int, plan,
                                counts: torch.Tensor) -> torch.Tensor:
    """One level's sparse histogram over the entries of every process of
    ``plan``, each process passing its own rows' ``layout``, ``rel``,
    ``gh`` and its layout-ordered ``gh_e`` (:func:`entry_gh`): the shared
    scale from one tiny all-gather (the max of each lane's amax of ``gh``,
    and ``n_max`` = the most entries of one feature over all processes:
    the max over features of ``counts`` [F] summed over the processes,
    never a sum of the processes' maxima), the accumulate launch on this
    process's entries, an exact int64 all-reduce and one dequantize.  Bit
    for bit the one-process kernel's over all the entries.  f32 [n_nodes,
    F, num_bins, 2]."""
    F, B = layout.num_features, layout.num_bins
    scale, n_max = global_scale(plan, lane_amax(gh), counts)
    rel_e = rel.to(torch.int32)[layout.rid].contiguous()
    acc = histogram_gh_sparse_accumulate(layout, rel_e, gh_e, n_nodes, scale,
                                         value_limit(max(n_max, 1)))
    return histogram_gh_sparse_dequantize(plan.allreduce(acc), scale,
                                          (n_nodes, F, B, 2))


# ---- the front end ----------------------------------------------------------

def entry_gh(gh: torch.Tensor, row_id=None, emask=None,
             layout: SparseHistLayout | None = None) -> torch.Tensor:
    """Each entry's (grad, hess), the gather a tree's levels share (the
    values change with the margins, the entries do not).  With ``layout``:
    f32 in the layout's feature order, what the kernel reads; else in entry
    order with masked entries carrying 0, what ``index_add`` reads."""
    if layout is not None:
        return gh[layout.rid].to(torch.float32).contiguous()
    return gh[row_id] * emask.to(gh.dtype)[:, None]


def histogram_gh_sparse(row_id, findex, ebin, emask, rel: torch.Tensor,
                        gh: torch.Tensor, n_nodes: int, num_features: int,
                        num_bins: int, force: str | None = None,
                        layout: SparseHistLayout | None = None,
                        gh_e: torch.Tensor | None = None) -> torch.Tensor:
    """Sparse (COO) GBDT gradient histogram (see the module docstring).
    ``gh_e``: :func:`entry_gh` for this backend, when the caller gathered
    it already (a tree's levels share it).  Returns [n_nodes, F, num_bins,
    2] in gh's dtype on either backend."""
    check_force(force, "histogram backend")
    if force == "pallas":
        if layout is None:
            layout = sparse_hist_layout(row_id, findex, ebin, emask,
                                        num_features, num_bins)
        if (layout.num_features, layout.num_bins) != (num_features,
                                                      num_bins):
            raise ValueError(
                f"layout built for F={layout.num_features}/"
                f"B={layout.num_bins}, called with F={num_features}/"
                f"B={num_bins}")
        if gh_e is None:
            gh_e = entry_gh(gh, layout=layout)
        rel_e = rel.to(torch.int32)[layout.rid].contiguous()
        out = histogram_gh_sparse_kernel(
            layout.gkey, rel_e, gh_e, layout.starts, n_nodes, num_features,
            num_bins, layout=layout,
            gh_amax=lane_amax(gh) if gh_e.device.type == "cuda" else None)
        return out.to(gh.dtype)
    rid = clamp_index(_tensor(row_id).to(gh.device).to(torch.int64),
                      gh.shape[0])
    fi = _tensor(findex).to(gh.device).to(torch.int64)
    em = _tensor(emask).to(gh.device).to(torch.bool)
    if gh_e is None:
        gh_e = entry_gh(gh, rid, em)
    keys = ((rel.to(torch.int64)[rid] * num_features + fi) * num_bins
            + _tensor(ebin).to(gh.device).to(torch.int64))
    return segment_sum(gh_e, torch.where(em, keys, -1),
                       n_nodes * num_features * num_bins).reshape(
        n_nodes, num_features, num_bins, 2)
