"""Multi-process scenarios of the PyTorch port, run as gloo ranks on the CPU.

``run_ranks(n, "scenario", tmp_path, **kwargs)`` starts ``n`` child
processes (this file as a script), each joins a gloo process group over a
``FileStore`` in ``tmp_path`` (no ports), runs ``scenario(rank, n,
**kwargs)`` from this module and pickles its result; the parent returns
the results in rank order.  Every child has a timeout, so a deadlock fails
the test instead of hanging the suite.  The scenarios import torch and the
port only (never JAX), so the children start fast; the tests hold their
results to the JAX package.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def run_ranks(n: int, scenario: str, tmp_path, timeout: float = 90.0,
              env: dict | None = None, **kwargs) -> list:
    """Run ``scenario`` on ``n`` gloo ranks; returns each rank's result.
    Raises if a rank fails or the run outlasts ``timeout`` seconds."""
    work = Path(tmp_path) / f"ranks_{scenario}_{n}_{time.monotonic_ns()}"
    work.mkdir(parents=True)
    (work / "args.pkl").write_bytes(pickle.dumps(kwargs))
    child_env = dict(os.environ, **(env or {}))
    child_env.pop("DMLC_TRACKER_URI", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, scenario, str(r), str(n), str(work)],
        env=child_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(n)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 1.0)
            out, _ = p.communicate(timeout=left)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{scenario} on {n} ranks outlasted {timeout} "
                             "s (a deadlock?)") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"{scenario} rank {r} exited "
                                 f"{p.returncode}:\n{outs[r][-4000:]}")
    return [pickle.loads((work / f"rank{r}.pkl").read_bytes())
            for r in range(n)]


def _child(scenario: str, rank: int, n: int, work: Path) -> None:
    import torch.distributed as dist
    sys.path.insert(0, str(REPO))
    kwargs = pickle.loads((work / "args.pkl").read_bytes())
    dist.init_process_group("gloo", store=dist.FileStore(
        str(work / "store"), n), rank=rank, world_size=n)
    try:
        result = globals()[scenario](rank, n, **kwargs)
        (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    finally:
        dist.destroy_process_group()


def _np(tree):
    """Tensors of a (nested) dict as numpy."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.cpu().numpy() if hasattr(tree, "cpu") else tree


def shard_bounds(rows: int, n: int, rank: int, uneven: bool = False,
                 align: int = 1):
    """Contiguous row ranges, cut at multiples of ``align``; ``uneven``
    moves about a third of a part from the last rank to the first."""
    units = rows // align
    cuts = [units * r // n for r in range(n + 1)]
    if uneven:
        shift = max(1, units // (3 * n))
        cuts[1:n] = [c + shift for c in cuts[1:n]]
    cuts = [c * align for c in cuts]
    cuts[-1] = rows
    return cuts[rank], cuts[rank + 1]


# ---- the exact cross-process sums -------------------------------------------

def ops_sharded(rank, n, bins, rel, gh, n_nodes, num_bins, layout_args,
                plans, uneven=False):
    """Each fixed-point route (dense histogram, sparse histogram, segment
    sum) over this rank's rows, one result per plan spec."""
    import torch

    from dmlc_core_tpu_torch.ops.histogram import histogram_gh_sharded
    from dmlc_core_tpu_torch.ops.histogram_sparse import (
        entry_gh, feature_counts, histogram_gh_sparse_sharded,
        sparse_hist_layout)
    from dmlc_core_tpu_torch.ops.segment_sum import segment_sum_sharded
    from dmlc_core_tpu_torch.parallel import MeshPlan
    lo, hi = shard_bounds(len(rel), n, rank, uneven)
    b, r, g = (torch.tensor(a[lo:hi]) for a in (bins, rel, gh))
    rid, fi, eb, em = layout_args
    sel = (rid >= lo) & (rid < hi)
    layout = sparse_hist_layout(rid[sel] - lo, fi[sel], eb[sel], em[sel],
                                bins.shape[1], num_bins)
    out = []
    for hosts, collective, chunks in plans:
        plan = MeshPlan.build(hosts=hosts, collective=collective)
        out.append(dict(
            dense=histogram_gh_sharded(b, r, g, n_nodes, num_bins, plan,
                                       chunks=chunks).numpy(),
            sparse=histogram_gh_sparse_sharded(
                layout, r, g, entry_gh(g, layout=layout), n_nodes, plan,
                feature_counts(layout)).numpy(),
            seg=segment_sum_sharded(g, r, n_nodes, plan).numpy()))
    return out


# ---- GBDT -------------------------------------------------------------------

def gbdt_fits(rank, n, cases):
    """Sharded fits: each case a dict of ``kind`` ("dense" with ``bins``,
    ``y``, optional ``weight``; "sparse" with a CSR ``data`` dict and
    ``cuts``), ``kw`` (the GBDT's), ``plans`` (a list of (hosts,
    collective, overlap_chunks, histogram)) and ``uneven``/``align`` (the
    row cut); returns each case's forests, one per plan."""
    import torch

    from dmlc_core_tpu_torch.data.staging import PaddedBatch
    from dmlc_core_tpu_torch.models.gbdt import GBDT, QuantileBinner
    from dmlc_core_tpu_torch.parallel import MeshPlan
    out = []
    for case in cases:
        kw, forests = case["kw"], []
        if case["kind"] == "dense":
            y = case["y"]
            lo, hi = shard_bounds(len(y), n, rank, case.get("uneven", False),
                                  case.get("align", 1))
            w = case.get("weight")
            args = (case["bins"][lo:hi], y[lo:hi])
            fit_kw = {} if w is None else {"weight": w[lo:hi]}
        else:
            data = case["data"]
            rp = data["row_ptr"]
            lo, hi = shard_bounds(len(rp) - 1, n, rank,
                                  case.get("uneven", False),
                                  case.get("align", 1))
            e0, e1 = int(rp[lo]), int(rp[hi])
            batch = PaddedBatch(
                label=torch.tensor(data["label"][lo:hi]),
                weight=torch.tensor(data["weight"][lo:hi]),
                row_ptr=torch.tensor((rp[lo:hi + 1] - e0).astype(np.int32)),
                index=torch.tensor(data["index"][e0:e1]),
                value=torch.tensor(data["value"][e0:e1]), num_rows=hi - lo)
            args = (batch, QuantileBinner.from_cuts(
                case["cuts"], kw["num_bins"], missing_aware=True,
                device="cpu"))
            fit_kw = {}
        for hosts, collective, chunks, histogram in case["plans"]:
            plan = MeshPlan.build(hosts=hosts, collective=collective,
                                  overlap_chunks=chunks)
            m = GBDT(device="cpu", histogram_mesh=plan, histogram=histogram,
                     **kw)
            fit = m.fit if case["kind"] == "dense" else m.fit_batch
            forests.append(_np(fit(*args, **fit_kw)))
        out.append(forests)
    return out


def gbdt_streamed(rank, n, data, kw, cuts, batch_rows, histogram="auto"):
    """A sharded ``fit_streamed`` over this rank's rows in batches of
    ``batch_rows``, with the ``histogram`` backend."""
    import torch

    from dmlc_core_tpu_torch.data.staging import PaddedBatch
    from dmlc_core_tpu_torch.models.gbdt import GBDT, QuantileBinner
    from dmlc_core_tpu_torch.parallel import MeshPlan
    rp = data["row_ptr"]

    def batch(lo, hi):
        e0, e1 = int(rp[lo]), int(rp[hi])
        return PaddedBatch(
            label=torch.tensor(data["label"][lo:hi]),
            weight=torch.tensor(data["weight"][lo:hi]),
            row_ptr=torch.tensor((rp[lo:hi + 1] - e0).astype(np.int32)),
            index=torch.tensor(data["index"][e0:e1]),
            value=torch.tensor(data["value"][e0:e1]), num_rows=hi - lo)

    lo, hi = shard_bounds(len(rp) - 1, n, rank)
    parts = [batch(a, min(a + batch_rows, hi))
             for a in range(lo, hi, batch_rows)]
    binner = QuantileBinner.from_cuts(cuts, kw["num_bins"],
                                      missing_aware=True, device="cpu")
    plan = MeshPlan.build()
    m = GBDT(device="cpu", histogram_mesh=plan, histogram=histogram, **kw)
    return _np(m.fit_streamed(parts, binner))


# ---- collectives and the mesh plan --------------------------------------------

def collectives(rank, n, size=513):
    """Every collective and plan route this rank sees, as numpy."""
    import os

    import torch

    from dmlc_core_tpu_torch.parallel import (
        MeshPlan, allreduce, allreduce_bench, collective_bench,
        collective_sweep, make_mesh, plan_allreduce_bench)
    rng = np.random.default_rng(100 + rank)
    x = torch.from_numpy(rng.standard_normal(size).astype(np.float32))
    xi = torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, size))
    out = {"inputs": (x.numpy(), xi.numpy())}
    out["ops"] = {op: allreduce(x, op).numpy()
                  for op in ("sum", "max", "min", "mean")}
    out["int_sum"] = allreduce(xi).numpy()
    out["x_unchanged"] = x.numpy()
    routes = {}
    for hosts in (None, 2):
        plan = MeshPlan.build(hosts=hosts)
        for op in ("sum", "max", "min", "mean"):
            routes[(hosts, op)] = tuple(
                plan.allreduce(x, op, strategy=s).numpy()
                for s in ("flat", "hier", "hier"))
        routes[(hosts, "int")] = tuple(plan.allreduce(xi, strategy=s).numpy()
                                       for s in ("flat", "hier"))
        routes[(hosts, "describe")] = plan.describe()
        routes[(hosts, "offsets")] = plan.row_offsets(10 * (rank + 1))
    out["routes"] = routes
    out["benches"] = ([collective_bench(None, op, 0.0625, 2, 1) for op in
                       ("allreduce", "allgather", "reducescatter",
                        "ppermute")]
                      + collective_sweep(None, "allreduce", (0.03125,), 2, 1)
                      + [allreduce_bench(None, 0.0625, 2, 1)]
                      + [plan_allreduce_bench(MeshPlan.build(hosts=2), s,
                                              0.0625, 2, 1)
                         for s in ("flat", "hier", "auto")])
    plan = MeshPlan.build()
    knobs = {"default": (plan.strategy_for(1 << 10),
                         plan.strategy_for(1 << 20), plan.axes,
                         plan.chip_axis, plan.host_axis)}
    two_d = ("DMLCTPU_MESH_HOSTS", "2")
    for env in (("DMLCTPU_MESH_COLLECTIVE", "flat"),
                ("DMLCTPU_MESH_COLLECTIVE", "hier"),
                ("DMLCTPU_MESH_HIER_THRESHOLD_KB", "1"),
                ("DMLCTPU_MESH_OVERLAP_CHUNKS", "4"),
                ("DMLCTPU_MESH_HOSTS", "4"),
                ("DMLCTPU_MESH_COLLECTIVE", "bogus"),
                ("DMLCTPU_MESH_HOSTS", "3"),
                two_d,
                (two_d, ("DMLCTPU_MESH_HIER_THRESHOLD_KB", "1"))):
        pairs = env if isinstance(env[0], tuple) else (env,)
        os.environ.update(dict(pairs))
        try:
            p = MeshPlan.build()
            knobs[env] = (p.strategy_for(16), p.strategy_for(2048),
                          p.strategy_for(1 << 20), p.overlap_chunks,
                          p.shape, p.axes)
        except ValueError as e:
            knobs[env] = str(e)
        for key, _ in pairs:
            del os.environ[key]
    out["knobs"] = knobs
    errors = {}
    for sizes, names in (((3, 5), ("host", "chip")),
                         (None, ("host", "chip"))):
        try:
            make_mesh(sizes, names)
        except ValueError as e:
            errors[(sizes, names)] = str(e)
    mesh = make_mesh()
    mesh2 = make_mesh((2, n // 2), ("host", "chip"))
    spec = {"none": MeshPlan.from_spec(None),
            "passthrough": MeshPlan.from_spec(plan) is plan,
            "bare": MeshPlan.from_spec(mesh).axes,
            "tuple": MeshPlan.from_spec((mesh, "data")).axes,
            "tuple2": MeshPlan.from_spec((mesh2, ("host", "chip"))).axes,
            "mesh2": MeshPlan.from_spec(mesh2).describe()}
    try:
        MeshPlan.from_spec((mesh, "model"))
    except ValueError as e:
        spec["bad_axis"] = str(e)
    out["errors"], out["spec"] = errors, spec
    return out


# ---- staging ------------------------------------------------------------------

def _rows_of(batch):
    """(labels of the real rows, the batch's global facts) of a staged
    batch."""
    w = batch.weight.numpy()
    return (batch.label.numpy()[w > 0].tolist(), batch.global_num_rows,
            batch.global_row_ptr.numpy(), batch.row_ptr.numpy(),
            int(batch.num_rows))


def sharded_staging(rank, n, files, bad_files, B, nnz_max, binned_file,
                    record_files, cuts):
    """Each rank stages its own file; the epochs' rows, batch counts and
    global facts, the missing-nnz_max error, a failing peer, and the
    binned and RecordIO iterators, sharded."""
    from dmlc_core_tpu_torch.data import binned_cache
    from dmlc_core_tpu_torch.data.staging import (DeviceStagingIter,
                                                  RecordStagingIter)
    from dmlc_core_tpu_torch.models.gbdt import QuantileBinner
    from dmlc_core_tpu_torch.parallel import MeshPlan, data_sharding
    plan = MeshPlan.build()
    out = {}
    bad = DeviceStagingIter(files[rank], batch_size=B, nnz_bucket=8,
                            sharding=plan, format="libsvm", device="cpu")
    try:
        next(iter(bad))
    except ValueError as e:
        out["no_nnz_max"] = str(e)
    bad.close()
    for name, sharding in (("plan", plan),
                           ("data_sharding", data_sharding(plan.mesh))):
        it = DeviceStagingIter(files[rank], batch_size=B, nnz_bucket=8,
                               nnz_max=nnz_max, sharding=sharding,
                               format="libsvm", device="cpu")
        out[name] = [_rows_of(b) for b in it]
        out[name + "_max_index"] = it.max_index
        it.close()
    it = DeviceStagingIter(bad_files[rank], batch_size=B, nnz_bucket=8,
                           nnz_max=nnz_max, sharding=plan, format="libsvm",
                           device="cpu")
    try:
        for _ in it:
            pass
        out["failure"] = None
    except RuntimeError as e:
        out["failure"] = str(e)
    it.close()
    binner = QuantileBinner.from_cuts(cuts, 16, missing_aware=True,
                                      device="cpu")
    bit = binned_cache.BinnedStagingIter(
        binned_file, binner, cache=f"{binned_file}.{rank}.bincache",
        batch_size=B, nnz_bucket=8, nnz_max=nnz_max, part=rank,
        num_parts=n, format="libsvm", sharding=plan, device="cpu")
    out["binned"] = [_rows_of(b) for b in bit]
    rit = RecordStagingIter(record_files[rank], records_cap=8,
                            bytes_cap=1024, sharding=plan, device="cpu")
    recs = []
    for b in rit:
        raw, offs = b.bytes.numpy(), b.offsets.numpy()
        recs.append(([raw[offs[k]:offs[k + 1]].tobytes()
                      for k in range(b.num_records)], b.global_num_records,
                     b.global_offsets.numpy(),
                     b.global_block_num_records.numpy()))
    out["records"] = recs
    rit.close()
    return out


# ---- data-parallel training ---------------------------------------------------

def dp_steps(rank, n, family, params, batches, kw, steps):
    """``steps`` data-parallel steps of ``family`` on this rank's share of
    each batch (``batches``: per rank, a list of local batch dicts);
    returns the losses and the parameters after each step."""
    import torch

    from dmlc_core_tpu_torch.data.staging import PaddedBatch
    from dmlc_core_tpu_torch.models import (FactorizationMachine,
                                            FieldAwareFactorizationMachine,
                                            SparseLinearModel)
    from dmlc_core_tpu_torch.parallel import MeshPlan
    plan = MeshPlan.build()
    cls = {"linear": SparseLinearModel, "fm": FactorizationMachine,
           "ffm": FieldAwareFactorizationMachine}[family]
    model = cls(device="cpu", **kw)
    model.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    losses, states = [], []
    for i in range(steps):
        b = batches[rank][i % len(batches[rank])]
        batch = PaddedBatch(num_rows=b["num_rows"], plan=plan,
                            **{k: torch.tensor(v) for k, v in b.items()
                               if k != "num_rows"})
        losses.append(float(model.train_step(batch)))
        states.append({k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()})
    return losses, states


def linear_mesh_helpers(rank, n, params, grads):
    """``SparseLinearModel(mesh_plan=)``'s helpers on this rank's values:
    the placed params, the all-reduced grads and the batch sharding's
    axes."""
    import torch

    from dmlc_core_tpu_torch.models import SparseLinearModel
    from dmlc_core_tpu_torch.parallel import MeshPlan
    plan = MeshPlan.build()
    m = SparseLinearModel(len(params[0]["w"]), mesh_plan=plan, device="cpu")
    mine = {k: torch.tensor(v) for k, v in params[rank].items()}
    placed = m.place_params(mine)
    assert all(torch.equal(mine[k], torch.tensor(params[rank][k]))
               for k in mine)  # the inputs are left as they were
    reduced = m.grad_allreduce({k: torch.tensor(v)
                                for k, v in grads[rank].items()})
    return {"placed": _np(placed), "reduced": _np(reduced),
            "axes": m.batch_sharding().axes}


# ---- checkpoints --------------------------------------------------------------

def checkpoint_save(rank, n, params, path):
    """A 2-process save of ``params`` with ``w`` row-sharded over the mesh
    as a ``DTensor``; every rank loads it back."""
    import torch

    from dmlc_core_tpu_torch import checkpoint
    from dmlc_core_tpu_torch.parallel import make_mesh
    try:
        from torch.distributed.tensor import Shard, distribute_tensor
    except ImportError:  # older torch
        from torch.distributed._tensor import Shard, distribute_tensor
    mesh = make_mesh()
    tree = {k: torch.tensor(v) for k, v in params.items()}
    tree["w"] = distribute_tensor(tree["w"], mesh, [Shard(0)])
    wrote = checkpoint.save(tree, path)
    arrays, meta = checkpoint.load(path)
    return wrote, [np.asarray(a) for a in arrays], meta


# ---- the data service ---------------------------------------------------------

def dataservice_sharding_refused(rank, n, uri):
    """A ``DataServiceIter`` given this job's plan (more than one process)
    without ``nnz_max`` refuses it before it contacts any service (its
    ranks could not contribute batches of one shape); returns the
    message."""
    from dmlc_core_tpu_torch.dataservice import DataServiceIter
    from dmlc_core_tpu_torch.models import QuantileBinner
    from dmlc_core_tpu_torch.parallel.meshplan import MeshPlan
    plan = MeshPlan.build()
    assert plan.num_shards == n
    try:
        DataServiceIter(uri, QuantileBinner(32, missing_aware=True,
                                            device="cpu"),
                        sharding=plan, device="cpu")
    except ValueError as e:
        return str(e)
    return "accepted"


def _service_iter(rank, uri, port, binner, nnz_max, geom, device="cpu",
                  **kw):
    """This job's plan's ``DataServiceIter`` on the aggregator at
    ``port``."""
    from dmlc_core_tpu_torch.dataservice import DataServiceIter
    from dmlc_core_tpu_torch.parallel import MeshPlan
    from dmlc_core_tpu_torch.tracker import metrics as tm
    return DataServiceIter(
        uri, binner, sharding=MeshPlan.build(), nnz_max=nnz_max, retries=8,
        device=device, shard_client=tm.ShardClient("127.0.0.1", port,
                                                   rank=rank), **geom, **kw)


def dataservice_epoch(rank, n, uri, port, nnz_max, geom, binner_kw,
                      mode="binned", cuts=None, fault=None):
    """One epoch of this rank's share of the service (``cuts``: a fitted
    binner's, for the staged mode; ``fault``: a fault spec armed on rank 0
    for the epoch); returns the client id, the share and every batch's
    leaves and global facts."""
    import contextlib

    from dmlc_core_tpu_torch import faultinject
    from dmlc_core_tpu_torch.models import QuantileBinner
    binner = (QuantileBinner(device="cpu", **binner_kw)
              if cuts is None else QuantileBinner.from_cuts(
                  cuts, binner_kw["num_bins"], missing_aware=True,
                  device="cpu"))
    it = _service_iter(rank, uri, port, binner, nnz_max, geom, mode=mode)
    it.ensure_meta()
    armed = (faultinject.armed(fault) if fault is not None and rank == 0
             else contextlib.nullcontext())
    batches = []
    with armed:
        for b in it:
            leaves = {k: getattr(b, k).numpy().copy() for k in (
                "label", "weight", "row_ptr", "index", "ebin", "emask")}
            batches.append(dict(
                leaves, num_rows=b.num_rows, cuts_digest=b.cuts_digest,
                planned=b.plan is not None,
                global_num_rows=b.global_num_rows,
                global_row_ptr=b.global_row_ptr.numpy()))
    return {"client_id": it.client_id, "share": list(it.share),
            "batches": batches}


def dataservice_forest(rank, n, uri, port, nnz_max, geom, kw,
                       device="cpu"):
    """A sharded ``fit_streamed`` (on the CPU the kernel route's plain
    version, on ``"cuda"`` the kernels) over this rank's share of the
    service; the forest, the epochs read and the launches of each
    kernel."""
    import torch

    from dmlc_core_tpu_torch.models.gbdt import GBDT, QuantileBinner
    from dmlc_core_tpu_torch.ops import histogram as hg
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    from dmlc_core_tpu_torch.ops import segment_sum as ss
    from dmlc_core_tpu_torch.parallel import MeshPlan
    if device == "cuda":
        torch.cuda.set_device(0)
    kernels = (hs.histogram_gh_sparse_kernel, ss.segment_sum_kernel,
               hg.histogram_gh_kernel)
    for k in kernels:
        k.launches = 0
    binner = QuantileBinner(num_bins=kw["num_bins"], missing_aware=True,
                            device=device)
    it = _service_iter(rank, uri, port, binner, nnz_max, geom,
                       device=device)
    m = GBDT(device=device, histogram="pallas",
             histogram_mesh=MeshPlan.build(), **kw)
    forest = m.fit_streamed(lambda: iter(it), binner)
    return {"forest": _np(forest), "epochs": it._epoch,
            "launches": [k.launches for k in kernels]}


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
           Path(sys.argv[4]))
