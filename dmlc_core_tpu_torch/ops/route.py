"""Dense GBDT routing: each row's node, walked down levels of a tree.

A tree is a fixed-depth complete binary heap; level ``d`` holds nodes
``2^d - 1`` to ``2^(d+1) - 2``, and a row in node ``n`` of its level moves to
``2 n`` or ``2 n + 1`` of the next.  At each level walked a row reads its
node's feature ``f``, threshold ``t`` and default direction ``d``, and its
code ``b = bins[row, f]``; it goes right when ``b > t``, and under
``missing_aware`` a missing code (``b == 0``) goes right iff ``d == 1``.

:func:`route_dense_kernel` walks ``levels`` levels from level ``first``:
``rel`` holds each row's node in level ``first`` (None: every row at node
0), and the split tables hold those levels' nodes in heap order from level
``first``'s node 0.  On a CUDA tensor it runs the hand-written kernel
``csrc/route_dense.cu`` (one launch for all the levels, on the current
stream: no sync, no allocation but the result) and bumps
``route_dense_kernel.launches`` and ``route_dense_kernel.levels`` (levels
walked on the kernel); on a CPU tensor it runs :func:`route_dense_plain`.
The two are equal bit for bit.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

_MAX_LEVEL = 30  # first + levels: node ids stay in int32

_lib = None
_launch_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("route_dense")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dmlc_route_dense.argtypes = [p, i, ctypes.c_longlong, i, p, p, p,
                                         p, p, i, i, i, p]
        lib.dmlc_route_dense.restype = ctypes.c_int
        lib.dmlc_route_error_string.argtypes = [ctypes.c_int]
        lib.dmlc_route_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def route_dense_plain(bins: torch.Tensor, rel, feature: torch.Tensor,
                      threshold: torch.Tensor, default_right: torch.Tensor,
                      first: int, levels: int,
                      missing_aware: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch, a level at a time: int32
    [rows], each row's node in level ``first + levels``."""
    node = (torch.zeros(bins.shape[0], dtype=torch.int32, device=bins.device)
            if rel is None else rel)
    for lv in range(levels):
        idx = node.to(torch.int64)
        base = 2 ** (first + lv) - 2 ** first  # the level's first entry
        if base:
            idx = idx + base
        row_bin = torch.gather(bins, 1, feature[idx].to(torch.int64)
                               [:, None])[:, 0].to(torch.int32)
        go_right = row_bin > threshold[idx]
        if missing_aware:
            go_right = torch.where(row_bin == 0, default_right[idx] == 1,
                                   go_right)
        node = torch.add(go_right.to(torch.int32), node, alpha=2)
    return node


def _check_inputs(bins, rel, tables, first: int, levels: int) -> None:
    """Raise on anything the kernel does not take."""
    dev = bins.device
    if any(t.device != dev for t in tables) or (rel is not None
                                                and rel.device != dev):
        raise ValueError(f"route_dense_kernel: bins on {dev}, rel on "
                         f"{None if rel is None else rel.device}, tables on "
                         f"{[str(t.device) for t in tables]}; want one "
                         "device")
    if (bins.dtype not in (torch.uint8, torch.int32)
            or (rel is not None and rel.dtype != torch.int32)
            or any(t.dtype != torch.int32 for t in tables)):
        raise TypeError(f"route_dense_kernel takes uint8/int32 bins, int32 "
                        f"rel and int32 tables, got {bins.dtype} / "
                        f"{None if rel is None else rel.dtype} / "
                        f"{[t.dtype for t in tables]}")
    if not (0 <= first and 0 <= levels and first + levels <= _MAX_LEVEL):
        raise ValueError(f"route_dense_kernel: levels {first} to "
                         f"{first + levels}, past {_MAX_LEVEL}")
    rows = bins.shape[0] if bins.dim() == 2 else -1
    entries = (2 ** levels - 1) * 2 ** first
    if (bins.dim() != 2 or (rows and bins.shape[1] < 1)
            or (rel is not None and rel.shape != (rows,))
            or any(t.shape != (entries,) for t in tables)):
        raise ValueError(f"route_dense_kernel: bins {tuple(bins.shape)}, rel "
                         f"{None if rel is None else tuple(rel.shape)}, "
                         f"tables {[tuple(t.shape) for t in tables]}; levels "
                         f"{first} to {first + levels} take {entries} "
                         "entries")
    if not (bins.is_contiguous() and all(t.is_contiguous() for t in tables)
            and (rel is None or rel.is_contiguous())):
        raise ValueError("route_dense_kernel takes contiguous tensors")


def route_dense_kernel(bins: torch.Tensor, rel, feature: torch.Tensor,
                       threshold: torch.Tensor, default_right: torch.Tensor,
                       first: int, levels: int,
                       missing_aware: bool) -> torch.Tensor:
    """Each row's node after walking ``levels`` levels from level
    ``first``: int32 [rows].

    ``bins``: uint8 or int32 codes [rows, F]; ``rel``: int32 [rows], each
    row's node in level ``first``, or None for every row at node 0;
    ``feature``, ``threshold``, ``default_right``: int32 tables of the
    levels walked in heap order from level ``first``'s node 0, ``(2^levels
    - 1) 2^first`` entries each, all contiguous and on one device (raises
    on anything else).  A CUDA tensor runs the kernel on the current stream
    into a new tensor; a CPU tensor runs :func:`route_dense_plain`.
    The kernel clamps a feature out of range into ``[0, F)`` and a node
    into its level (a negative one counts as past the end); the plain
    version raises on either."""
    _check_inputs(bins, rel, (feature, threshold, default_right), first,
                  levels)
    if bins.device.type == "cpu":
        return route_dense_plain(bins, rel, feature, threshold,
                                 default_right, first, levels, missing_aware)
    rows, F = bins.shape
    out = torch.empty(rows, dtype=torch.int32, device=bins.device)
    if not rows:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(bins.device):
        err = lib.dmlc_route_dense(
            bins.data_ptr(), bins.element_size(), rows, F,
            None if rel is None else rel.data_ptr(), out.data_ptr(),
            feature.data_ptr(), threshold.data_ptr(),
            default_right.data_ptr(), first, levels, int(missing_aware),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("route_dense launch failed: "
                           + lib.dmlc_route_error_string(err).decode())
    with _launch_lock:
        route_dense_kernel.launches += 1
        route_dense_kernel.levels += levels
    return out


route_dense_kernel.launches = 0
route_dense_kernel.levels = 0
