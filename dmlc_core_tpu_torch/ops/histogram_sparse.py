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
from .fixed_point import fixed_point_scale, lane_amax, value_limit
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
                 "starts", "_tables")

    def __init__(self, **kw):
        for k in self.__slots__[:-1]:
            setattr(self, k, kw[k])
        self._tables = {}

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


def sparse_hist_layout(row_id, findex, ebin, emask, num_features: int,
                       num_bins: int, num_shards: int = 1,
                       rows: int | None = None) -> SparseHistLayout:
    """Build the feature-sorted layout (see :class:`SparseHistLayout`) on
    the entries' device.  row_id/findex/ebin/emask: [nnz] COO entry arrays
    (tensors or numpy, any int/bool dtypes).  Only one shard is ported."""
    if num_shards != 1:
        raise NotImplementedError(
            "a sharded sparse layout (num_shards > 1, the multi-device "
            "histogram route) is not ported yet: ROADMAP A6")
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

_SMEM_MAX = 227 * 1024       # what a Hopper block (and an SM) may take
_TARGET_SPANS = 1024         # spans a launch aims at (132 SMs, many waves)
_MIN_SPAN = 16384            # entries per span before another span pays off

_lib = None
_launch_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("histogram_gh_sparse")
        lib.dmlc_histogram_gh_sparse_fixed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.dmlc_histogram_gh_sparse_fixed.restype = ctypes.c_int
        lib.dmlc_histogram_sparse_error_string.argtypes = [ctypes.c_int]
        lib.dmlc_histogram_sparse_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_geometry(nnz: int, num_features: int, num_bins: int,
                    n_nodes: int) -> dict:
    """How one launch cuts the work: a block's shared histogram holds
    ``node_tile`` nodes (every node of the level while they fit, else even
    tiles, one pass over the entries each), and spans of at most ``span``
    entries of one feature."""
    per_node = 16 * num_bins  # bytes of one node's int64 (g, h) bins
    most = _SMEM_MAX // per_node
    if most < 1:
        raise ValueError(f"histogram_gh_sparse_kernel: num_bins={num_bins} "
                         f"needs {per_node} B of shared memory a node (max "
                         f"{_SMEM_MAX})")
    tiles = -(-n_nodes // most)
    node_tile = max(1, -(-n_nodes // tiles))
    span = max(_MIN_SPAN, -(-nnz // _TARGET_SPANS))
    return dict(node_tile=node_tile, span=span, smem=node_tile * per_node)


def span_table(starts, span: int) -> tuple:
    """Cut each feature's entries ``[starts[f], starts[f + 1])`` into spans
    of at most ``span`` entries.  Returns (n_spans, int64 table): span
    begins, span ends and span features, as the kernel reads them."""
    st = _tensor(starts).cpu().numpy().astype(np.int64)
    per = -(-np.diff(st) // span)
    feat_spans = np.zeros(st.size, np.int64)
    np.cumsum(per, out=feat_spans[1:])
    n_spans = int(feat_spans[-1])
    feat = np.repeat(np.arange(st.size - 1, dtype=np.int64), per)
    begin = st[feat] + (np.arange(n_spans) - feat_spans[feat]) * span
    end = np.minimum(begin + span, st[feat + 1])
    return n_spans, np.concatenate([begin, end, feat])


def histogram_gh_sparse_kernel(gkey: torch.Tensor, rel_e: torch.Tensor,
                               gh_e: torch.Tensor, starts, n_nodes: int,
                               num_features: int, num_bins: int,
                               layout: SparseHistLayout | None = None, *,
                               gh_amax: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Histogram of feature-sorted entries: int32 ``gkey`` [nnz] (``f * nb
    + bin``), int32 ``rel_e`` [nnz] (each entry's node), f32 ``gh_e`` [nnz,
    2], host ``starts`` [F + 1] (feature f's entries are ``[starts[f],
    starts[f + 1])``) -> f32 [n_nodes, F, num_bins, 2].  The arrays of a
    :class:`SparseHistLayout` with ``rel_e = rel[layout.rid]`` and ``gh_e =
    gh[layout.rid]``; pass that ``layout`` too and the launch takes the span
    table it keeps on the card, else the table is built and copied here.

    On a CUDA tensor it launches ``csrc/histogram_gh_sparse.cu`` on the
    calling thread's current stream (and bumps
    ``histogram_gh_sparse_kernel.launches``), in the fixed point of
    :mod:`.fixed_point` with ``n_max`` = the most entries of one feature and
    ``amax`` = ``gh_amax`` (f32 [2] on the card, a bound on ``|gh_e|`` of
    each lane; default :func:`.fixed_point.lane_amax` of ``gh_e``; the
    result depends on it, so callers that must agree bit for bit pass the
    same).  A ``gh_amax`` below the values gives NaN in a lane where a
    value could carry a bin past int64 (:func:`.fixed_point.value_limit`),
    else the exact sums at a finer scale.  On a CPU tensor it runs
    :func:`histogram_gh_sparse_plain`.  Raises on anything else the kernel
    does not take."""
    if gh_e.device.type == "cpu":
        return histogram_gh_sparse_plain(gkey, rel_e, gh_e, starts, n_nodes,
                                         num_features, num_bins)
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
    st = _tensor(starts)
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
                                or gh_amax.device != gh_e.device):
        raise ValueError(f"histogram_gh_sparse_kernel: gh_amax "
                         f"{tuple(gh_amax.shape)} on {gh_amax.device}, want "
                         f"[2] on {gh_e.device}")
    nb = _sparse_geometry(num_features, num_bins)
    out = torch.empty(n_nodes, num_features, num_bins, 2,
                      dtype=torch.float32, device=gh_e.device)
    if out.numel() == 0:
        return out
    geo = launch_geometry(nnz, num_features, num_bins, n_nodes)
    if layout is not None:
        n_spans, table = layout.span_table(geo["span"])
    else:
        n_spans, table = span_table(st, geo["span"])
        table = torch.from_numpy(table).to(gh_e.device)
    if n_spans == 0:
        return out.zero_()
    n_max = int((st[1:] - st[:-1]).max())
    scale = fixed_point_scale(
        lane_amax(gh_e) if gh_amax is None else gh_amax, n_max)
    # the bins, then each lane's overflow mark
    acc = torch.zeros(out.numel() + 2, dtype=torch.int64, device=gh_e.device)
    vec = all(t.data_ptr() % 16 == 0 for t in (gkey, rel_e, gh_e))
    lib = _kernel_lib()
    with torch.cuda.device(gh_e.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dmlc_histogram_gh_sparse_fixed(
            gkey.data_ptr(), rel_e.data_ptr(), gh_e.data_ptr(), nnz, int(vec),
            scale.data_ptr(), value_limit(n_max), table.data_ptr(), n_spans,
            num_features, num_bins, nb, n_nodes, geo["node_tile"],
            acc.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("histogram_gh_sparse kernel launch failed: "
                           + lib.dmlc_histogram_sparse_error_string(err)
                           .decode())
    with _launch_lock:
        histogram_gh_sparse_kernel.launches += 1
    return out


histogram_gh_sparse_kernel.launches = 0


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
