"""Collectives over ``torch.distributed``: the rabit-allreduce equivalent.

The reference builds a TCP tree and ring and brokers peer links through
the tracker; the JAX package reduces with ``psum`` over a mesh axis.  The
port reduces with ``torch.distributed`` over a process group: NCCL on
cards, gloo on the CPU.  A gloo group takes a CUDA tensor through host
memory (a copy to a pinned host buffer and back): gloo has no CUDA path
for every collective (``reduce_scatter``, point-to-point), so every gloo
collective here stages the same way, and a gloo number on a card measures
gloo through the host, not NVLink.

``allreduce`` is the drop-in API; ``collective_bench`` and
``allreduce_bench`` measure achieved bus bandwidth with the NCCL-tests
conventions the JAX package's benches use.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..timer import Stopwatch

_OPS = ("max", "mean", "min", "sum")


def reduce_op(op: str):
    """The ``torch.distributed.ReduceOp`` of ``op`` (``mean`` reduces as a
    sum; the caller divides).  Unknown ops raise the JAX package's
    error."""
    if op not in _OPS:
        raise ValueError(f"unknown allreduce op '{op}' (have {sorted(_OPS)})")
    return {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
            "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]


def group_size(group=None) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def is_gloo(group=None) -> bool:
    return dist.get_backend(group) == "gloo"


def to_host(x: torch.Tensor) -> torch.Tensor:
    """``x`` in host memory (pinned for a CUDA tensor), contiguous; a CPU
    tensor comes back as is when already contiguous."""
    if x.device.type == "cpu":
        return x.contiguous()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def on_group_device(x: torch.Tensor, group=None):
    """(a fresh copy of ``x`` where a collective on ``group`` takes it, the
    function that brings a result back to ``x``'s device): gloo groups
    take host memory."""
    if x.device.type == "cuda" and is_gloo(group):
        return to_host(x), lambda y: y.to(x.device)
    return x.clone(memory_format=torch.contiguous_format), lambda y: y


def allreduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """All-reduce ``x`` over ``group`` (default: the world); returns a new
    tensor on ``x``'s device, every rank's bit for bit the same.  One
    process (no process group): ``x`` itself, as ``psum`` over one device."""
    rop = reduce_op(op)
    n = group_size(group)
    if n <= 1:
        return x
    buf, back = on_group_device(x, group)
    dist.all_reduce(buf, rop, group=group)
    out = back(buf)
    return out / n if op == "mean" else out


def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor, op, group) -> None:
    with warnings.catch_warnings():  # renamed in newer torch; same call
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, inp, op, group=group)


def _all_gather_flat(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, inp, group=group)


def _ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """ppermute ``i -> i + 1`` around the group, as one
    ``batch_isend_irecv``."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    glob = dist.get_global_rank if group is not None else (lambda g, r: r)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, glob(group, (me + 1) % n), group),
           dist.P2POp(dist.irecv, out, glob(group, (me - 1) % n), group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


def _bench_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# per-op (run, algbw size base as a function of n, bus-bandwidth factor),
# after NCCL-tests so numbers compare across stacks (the JAX package's
# conventions): the algbw base is the TOTAL data size of the op (allgather:
# n * sendcount; the others the per-rank buffer); bus factors allreduce
# 2(n-1)/n, allgather and reducescatter (n-1)/n, ppermute 1
def _ops(n: int, group):
    def allreduce_fn(x):
        dist.all_reduce(x, group=group)
        return x

    def allgather_fn(x):
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        _all_gather_flat(out, x, group)
        return out

    def reducescatter_fn(x):
        out = torch.empty(x.numel() // n, dtype=x.dtype, device=x.device)
        _reduce_scatter(out, x, dist.ReduceOp.SUM, group)
        return out

    def ppermute_fn(x):
        return _ring_shift(x, group)

    return {
        "allreduce": (allreduce_fn, lambda n: 1.0,
                      lambda n: 2.0 * (n - 1) / n),
        "allgather": (allgather_fn, lambda n: float(n),
                      lambda n: (n - 1) / n),
        "reducescatter": (reducescatter_fn, lambda n: 1.0,
                          lambda n: (n - 1) / n),
        "ppermute": (ppermute_fn, lambda n: 1.0, lambda n: 1.0),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def collective_bench(group=None, op: str = "allreduce",
                     mib_per_device: float = 64.0, iters: int = 10,
                     warmup: int = 2) -> dict:
    """Bandwidth of one collective over the process ``group`` (default: the
    world): the data plane the reference's TCP tree and ring hand off to.

    op: "allreduce" | "allgather" | "reducescatter" | "ppermute" (a ring
    shift by one ``batch_isend_irecv``).  The buffer lives where the
    group's backend takes it (the card for NCCL, host memory for gloo).
    Warm-up calls run before the timed loop, which ends in a device
    synchronise.  Returns {devices, bytes, seconds_per_iter, algo_gbps,
    bus_gbps, op}."""
    n = group_size(group)
    table = _ops(n, group)
    try:
        fn, size_base, bus_factor = table[op]
    except KeyError:
        raise ValueError(
            f"unknown collective '{op}' (have {sorted(table)})") from None
    nfloats = int(mib_per_device * (1 << 20) // 4)
    # reducescatter needs the per-rank count divisible by the group size
    nfloats = max(n, nfloats - nfloats % n)
    dev = _bench_device(group)
    gen = np.random.default_rng(dist.get_rank()).standard_normal(
        nfloats, dtype=np.float32)
    x = torch.from_numpy(gen).to(dev)
    for _ in range(max(1, warmup)):
        fn(x.clone())
    _sync(dev)
    xs = [x.clone() for _ in range(iters)]
    dist.barrier(group=group)
    watch = Stopwatch()
    for xi in xs:
        fn(xi)
    _sync(dev)
    secs = watch.elapsed() / max(iters, 1)
    nbytes = int(nfloats * 4 * size_base(n))
    algo = nbytes / secs / 1e9
    return {"devices": n, "bytes": nbytes, "seconds_per_iter": secs,
            "algo_gbps": algo, "bus_gbps": algo * bus_factor(n), "op": op}


def allreduce_bench(group=None, mib_per_device: float = 64.0,
                    iters: int = 10, warmup: int = 2) -> dict:
    """All-reduce bus bandwidth over ``group`` (BASELINE config 4)."""
    return collective_bench(group, "allreduce", mib_per_device, iters,
                            warmup=warmup)


def collective_sweep(group=None, op: str = "allreduce",
                     payloads_mib: Sequence[float] = (0.25, 16.0),
                     iters: int = 10, warmup: int = 2) -> list:
    """``collective_bench`` at several payload sizes (the latency and the
    bandwidth regimes)."""
    return [collective_bench(group, op, mib, iters, warmup=warmup)
            for mib in payloads_mib]

