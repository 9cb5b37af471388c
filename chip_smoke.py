#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``dmlc_core_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the native runtime and every CUDA kernel from the checkout (side
by side) and prints each kernel's atomic instructions from the SASS, holds
each kernel against its plain PyTorch version on the card,
serves a Criteo-width factorization machine (2^20 hashed features, 16
factors, 39 nonzeros a row) over HTTP through the port's ``ScoringServer``
and checks every score against a float64 numpy oracle, then trains that FM
from a 524,288-row libsvm file (written under ``build/chip_smoke/``)
through ``DeviceStagingIter`` and ``train_step`` for two epochs, holding
every staged batch to the host parse, the first step to float64 numpy SGD
and the kernel route to the ``index_add`` route, with a shorter linear run
and the segment-sum kernel timed at the training shape, then trains a
Higgs-width histogram GBDT (11M rows x 28 features, 256 bins, 20 trees of
depth 6) through ``GBDT.fit`` and checks its histograms (every level of
the first tree timed beside the previous kernel, ``index_add`` and the
bound, and below the root built by sibling subtraction, as a fit builds
it, bit for bit the full level), the fit against one with every level in
full, forests and predictions against float64 oracles, and a sampled fit
(subsample, colsample_bytree and colsample_bylevel 0.8: draws on the card
equal to the CPU's bit for bit), then trains a Bosch-width sparse GBDT
(1,183,747 rows x 968 features, ~19% present) on a CSR batch through
``GBDT.fit_batch`` (and sampled), audits it against float64, cross-checks
it against a dense fit of the densified data, scores a libsvm file of its
first 50,000 rows through ``predict_staged``, and serves it from a
snapshot through ``ScoringServer``.  It also trains a Criteo-width
field-aware FM (2^20 features, 39 fields, 4 factors) from a
262,144-row libffm file through ``DeviceStagingIter(with_field=True)`` (the
field lane held to the host parse, one segment-sum launch a step, the first
update to float64) and served through ``ScoringServer(with_field=True)``
against a float64 pairwise oracle; the first 262,144 Bosch rows written to
libsvm, staged into the binned epoch cache by ``BinnedStagingIter`` and fit
out of core by ``GBDT.fit_streamed`` (its forest equal to ``fit_batch``'s
bit for bit, a shorter text replay's to a cache fit's, every level
audited against float64); the same file served by two staging workers on
the card through the data service (``DataServiceIter``; one cache file,
batches equal to a local cache hit's, a worker killed mid-epoch, the
staged text mode) and fit out of core over it, its forest equal to the
local one's bit for bit; an ImageNet-sized RecordIO file staged by
``RecordStagingIter`` with 1 and 4 workers, every record held to
``RecordIOReader``'s; and the
FM and the forest checkpointed and loaded back bit for bit (the FFM's
factor table, one record past the native 2^29-byte limit, raises its
error).  Then the observability phase trains one epoch of the FM through
an autotuned ``DeviceStagingIter`` (a window of 8 batches; every batch held
to the host parse while the tuner moves the native pool's knobs; its
decision log, knob paths and stall table beside an untuned epoch), stages
the RecordIO file under the tuner, holds the HBM gauges to
``torch.cuda``, stalls a staging epoch under a 1 s watchdog (a flight
record naming the stage, served at ``/flight``) and reads ``/trace``,
``/snapshot``, ``/timeseries`` and ``/autotune`` off the FM
``ScoringServer``; and the job phase runs the port's tracker over two
local ranks on the one card (rendezvous, ``init_from_env(backend="gloo")``,
an FM epoch over each rank's half of the file, an all-reduced row count,
metric pushes) and holds the tracker's job snapshot, trace and time series
to both ranks.  Last, the mesh phase (``phase_mesh``) fits the Higgs and
Bosch forests on 2 and 4 gloo ranks on the card, held to the one-process
kernels bit for bit; its 2-rank job also fits out of core over the data
service, each rank leasing its share of the parts from two staging
workers under the job's tracker (``service_rank``), and trains the FM
data-parallel.  Any failed check raises and the script exits non-zero.
The last two lines of its output are the card's name and power limit, and
one JSON object with ``"ok": true``; the line before them is the
per-kernel JSON (times, bound, launches on each main path, error against
the plain version).  It imports nothing of JAX.

    python3 chip_smoke.py --label-study

builds the kernels, then fits the Higgs-width GBDT four ways (histogram
and leaf sums each on the kernel or on ``index_add``) for two labels and
three data seeds, and audits every split of every fit against float64
(see ``label_study``).  It prints its readings and no result line.

    python3 chip_smoke.py --segment-sweep

builds the kernels, then times the segment-sum kernel at its five
main-path shapes under every launch geometry of ``segment_sweep``, beside
the one ``segment_sum.launch_geometry`` picks.  It prints its readings and
no result line.

    python3 chip_smoke.py --route

builds the kernels, then holds the dense route kernel to its plain version
bit for bit and times both beside the kernel's bound at a Higgs and a
Covertype training level and at Covertype's held-out walk of a whole tree
(``phase_route``, which the full run also runs after the Higgs GBDT).  It
prints its readings and no result line.

    python3 chip_smoke.py --service-sweep

builds the kernels, then times epochs of the Bosch out-of-core cell over
the data service with 1, 2, 4 and 8 parts in flight, beside a local cache
hit (see ``service_sweep``).  It prints its readings and no result line.

    python3 chip_smoke.py --geometry-sweep

builds the kernels, then times both histogram kernels on synthetic levels
under each few-bin threshold, least row chunk and small-launch span
setting (see ``geometry_sweep``), beside the ones the launch geometries
pick.  It prints its readings and no result line.

    python3 chip_smoke.py --ab DIR

builds the kernels of this tree and of the checkout at DIR (a parent
commit unpacked by ``git archive``), then times both histogram kernels of
each in turns on the same synthetic levels, outputs held bit for bit (see
``ab_parent``).  It prints its readings and no result line; the two flags
combine in one run.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import re
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# served configuration: Criteo Display Advertising rows (13 integer + 26
# categorical fields) hashed into 2^20 slots, FM with the repo default K
NUM_FEATURES = 1 << 20
NUM_FACTORS = 16
INT_FIELDS, CAT_FIELDS = 13, 26
NNZ_PER_ROW = INT_FIELDS + CAT_FIELDS
REQUEST_ROWS = (1, 7, 64, 256)
LATENCY_REPEATS = 30

TOL = 1e-5  # max abs error, kernel vs plain and scores vs oracle
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SLEEP_CYCLES = 50_000_000  # keeps the card busy while launches queue up


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def run_text(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


# ---- phase 1: the card and the builds ---------------------------------------

KERNELS = ("segment_sum", "histogram_gh", "histogram_gh_sparse")


def phase_builds(native, build):
    """Build the native runtime and every kernel at once: one thread for the
    runtime and one ``nvcc`` for each kernel source, all started together."""
    times = {}
    errors = []

    def run(name, fn):
        t0 = time.monotonic()
        try:
            fn()
        except Exception as exc:  # re-raised on the main thread below
            errors.append(exc)
        times[name] = time.monotonic() - t0

    jobs = [("libdmlctpu.so", native.build)] + [
        (f"{k}.cu", lambda k=k: build.build(k)) for k in KERNELS]
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    print("build: " + ", ".join(f"{name} {times[name]:.1f} s"
                                for name, _ in jobs))
    for k in KERNELS:
        for line in build.build_log(k).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")
    for k in KERNELS:
        sass_atomics(build, k)


ATOMIC_OP = re.compile(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)")


def sass_atomics(build, name: str) -> None:
    """Print the atomic instructions of each kernel of ``name`` as
    ``cuobjdump -sass`` shows them, and fail on a compare-and-swap loop or a
    float atomic: every kernel adds integers with native atomics."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = run_text([str(cuobjdump), "-sass", str(build.build(name))])
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        for op in ATOMIC_OP.findall(line):
            counts.setdefault(fn, {}).setdefault(op, 0)
            counts[fn][op] += 1
    for fn, ops in counts.items():
        print(f"  sass {name} {fn[:48]}: " + ", ".join(
            f"{op} x{c}" for op, c in sorted(ops.items())))
        bad = [op for op in ops if "CAS" in op or ".F" in op]
        check(not bad, f"{name} {fn}: {bad} (want native integer atomics)")
    check(any(op.startswith("ATOMS.ADD") for ops in counts.values()
              for op in ops), f"{name}: no shared-memory integer add")


# ---- phase 2: the kernel against its plain version ----------------------------

def device_ms(torch, fn, iters: int, warmup: int = 3) -> tuple:
    """Device time of one ``fn()`` in ms: ``iters`` calls queued behind a
    sleep kernel so they run back to back, between two CUDA events.
    Returns (ms, covered): covered is False when the host took longer to
    queue the calls than the sleep lasted (then host gaps may count)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s0.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    s1.record()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.monotonic()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.monotonic() - t0) * 1e3
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms < s0.elapsed_time(s1)


def served_inputs(torch, params, device):
    """The three segment-sum inputs of one 256-row FM micro-batch, as the
    served path builds them (bucket (256, 16384), ids sorted by row)."""
    from dmlc_core_tpu_torch.serving import ScoringIterator
    from dmlc_core_tpu_torch.ops.segment_sum import clamp_index
    rng = np.random.default_rng(7)
    it = ScoringIterator(max_batch=4096, device=device)
    batch, _ = it.pack(criteo_rows(rng, 256))
    rid = batch.row_ids()
    idx = clamp_index(batch.index, NUM_FEATURES)
    w = torch.as_tensor(params["w"], device=device)
    v = torch.as_tensor(params["v"], device=device)
    x = batch.value
    return batch.batch_size, rid, {
        1: (w[idx] * x).contiguous(),
        NUM_FACTORS: (v[idx] * x[:, None]).contiguous()}


def phase_kernel(torch, ss_mod, params, device) -> dict:
    from dmlc_core_tpu_torch.ops.fixed_point import (fixed_point_scale,
                                                     lane_amax)
    kernel, plain = ss_mod.segment_sum_kernel, ss_mod.segment_sum_plain
    rng = np.random.default_rng(3)

    def cuda(a):
        return torch.as_tensor(a, device=device)

    def case(rows, nnz, lanes, lo=0, hi=None, sort=True):
        hi = rows if hi is None else hi
        rid = rng.integers(lo, hi, nnz).astype(np.int32)
        if sort:
            rid.sort()
        shape = (nnz,) if lanes is None else (nnz, lanes)
        c = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        return rows, cuda(rid), cuda(c)

    R, rid_s, served = served_inputs(torch, params, device)
    cases = {
        "served L=1": (R, rid_s, served[1]),
        "served L=16": (R, rid_s, served[NUM_FACTORS]),
        "L=64": case(256, 16384, 64),
        "1-D contrib": case(300, 5000, None),
        "ragged": case(37, 1001, 5),
        "unsorted, out-of-range ids": case(256, 16384, 16, lo=-8, hi=264,
                                           sort=False),
        "empty": case(256, 0, 16),
        # a served bucket at max_batch: 65,536 outputs, past shared memory
        "4096 rows x 16 lanes, unsorted": case(4096, 160_000, 16, lo=-4,
                                               hi=4100, sort=False),
    }
    # a tree's root node total: (grad, hess)-like rows all on one id, held
    # like the leaf sums to 1e-5 of the largest output (and to float64)
    one = "one segment, 1.2M entries"
    gh = np.stack([rng.uniform(-0.5, 0.5, 1_200_000),
                   rng.uniform(0.2, 0.25, 1_200_000)], 1).astype(np.float32)
    cases[one] = (1, cuda(np.zeros(1_200_000, np.int32)), cuda(gh))
    for bad in ("nan", "inf"):
        rows, rid, c = case(256, 16384, 16)
        c[777, 3] = float(bad)
        cases[f"{bad} in lane 3"] = (rows, rid, c)
    max_err = 0.0
    for name, (rows, rid, c) in cases.items():
        a, scale = kernel(c, rid, rows, return_scale=True)
        b = kernel(c, rid, rows)
        torch.cuda.synchronize()
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"{name}: two launches differ")
        c2 = c if c.dim() == 2 else c[:, None]
        want_scale = fixed_point_scale(lane_amax(c2), c2.shape[0])
        check(torch.equal(scale.isnan(), want_scale.isnan()) and torch.equal(
            scale.nan_to_num(), want_scale.nan_to_num()),
            f"{name}: kernel scale {scale} != fixed_point_scale {want_scale}")
        want = plain(c, rid, rows)
        if name.endswith("in lane 3"):
            # the lane is NaN in every output; the plain one-hot product
            # makes it non-finite; the other lanes as without it
            keep = torch.arange(16, device=device) != 3
            check(bool(a[:, 3].isnan().all())
                  and not bool(want[:, 3].isfinite().any()),
                  f"{name}: lane 3 not poisoned")
            a, want = a[:, keep], want[:, keep]
        err = float((a - want).abs().max()) if a.numel() else 0.0
        tol = TOL
        if name == one:
            f64 = c.double().sum(0)
            tol = HIST_TOL * max(1.0, float(f64.abs().max()))
            err_o = float((a[0].double() - f64).abs().max())
            print(f"kernel vs float64 [{name}]: {err_o:.3e}, tol {tol:.3e}")
            check(err_o <= tol, f"{name}: {err_o} from float64 > {tol}")
        print(f"kernel vs plain [{name}] rows={rows} "
              f"contrib={tuple(c.shape)}: max abs err {err:.3e}, tol "
              f"{tol:.1e}; scale equals fixed_point_scale bit for bit")
        check(err <= tol, f"{name}: max abs err {err} > {tol}")
        if name != one:  # reported with the node totals
            max_err = max(max_err, err)
    # bf16 through the front end: f32 accumulation, cast back; k/8 values
    # sum exactly, so the two agree bit for bit
    rows, rid, _ = cases["unsorted, out-of-range ids"]
    c16 = cuda((rng.integers(-32, 33, (16384, 16)) / 8.0).astype(np.float32)
               ).to(torch.bfloat16)
    got = ss_mod.segment_sum(c16, rid, rows, force="pallas")
    want = plain(c16, rid, rows)
    check(got.dtype == torch.bfloat16, f"bf16 result is {got.dtype}")
    err = float((got.float() - want.float()).abs().max())
    print(f"kernel vs plain [bf16 front end]: max abs err {err:.3e}")
    check(err <= TOL, f"bf16: max abs err {err} > {TOL}")
    max_err = max(max_err, err)

    timings = {}
    for lanes in (1, NUM_FACTORS):
        c = served[lanes]
        nnz = c.shape[0]
        zeros = torch.zeros((R,) + tuple(c.shape[1:]), device=device)
        ms, cov = device_ms(torch, lambda: kernel(c, rid_s, R), 200)
        plain_ms, pcov = device_ms(torch, lambda: plain(c, rid_s, R), 20)
        lib_ms, lcov = device_ms(
            torch, lambda: torch.index_add(zeros, 0, rid_s, c), 200)
        nbytes = 4 * (nnz * lanes + nnz + R * lanes)
        byte_s, op_s = nbytes / HBM_BYTES_PER_S, nnz * lanes / F32_OPS_PER_S
        bound_ms = max(byte_s, op_s) * 1e3
        timings[lanes] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by="bytes" if byte_s >= op_s else "operations")
        print(f"time [served L={lanes}, R={R}, nnz={nnz}]: kernel "
              f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
              f"index_add {lib_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} "
              f"us ({nbytes} bytes); queue covered: {cov}/{pcov}/{lcov}")
    return {"max_abs_err": max_err, "timings": timings}


# ---- phase 3: serving end to end ----------------------------------------------

def criteo_rows(rng, n: int) -> list:
    """``n`` Criteo-shaped rows: 13 integer fields (log1p of a count) and 26
    categorical fields (value 1), each hashed to a slot in [0, 2^20)."""
    idx = rng.integers(0, NUM_FEATURES, (n, NNZ_PER_ROW))
    val = np.ones((n, NNZ_PER_ROW), np.float32)
    val[:, :INT_FIELDS] = np.log1p(rng.integers(0, 1000, (n, INT_FIELDS)))
    return [(idx[r].tolist(), val[r].tolist()) for r in range(n)]


def fm_params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": (0.05 * rng.standard_normal(NUM_FEATURES)
                  ).astype(np.float32),
            "v": (0.02 * rng.standard_normal((NUM_FEATURES, NUM_FACTORS))
                  ).astype(np.float32),
            "b": np.float32(-0.5)}


def fm_oracle(params: dict, rows: list) -> np.ndarray:
    """float64 FM probabilities of request rows (all NNZ_PER_ROW wide)."""
    idx = np.asarray([r[0] for r in rows], np.int64)
    x = np.asarray([r[1] for r in rows], np.float32).astype(np.float64)
    w = params["w"].astype(np.float64)[idx]
    v = params["v"].astype(np.float64)[idx]  # [n, nnz, K]
    vx = np.einsum("nkf,nk->nf", v, x)
    v2x2 = np.einsum("nkf,nk->nf", v ** 2, x ** 2)
    m = (float(params["b"]) + (w * x).sum(1)
         + 0.5 * (vx ** 2 - v2x2).sum(1))
    return 1.0 / (1.0 + np.exp(-m))


def post_score(url: str, rows: list) -> tuple:
    """POST request rows ((index, value) or (index, value, field)) to
    ``/score``: (the response, the host clock's ms)."""
    body = json.dumps({"rows": [
        dict(index=r[0], value=r[1], **({"field": r[2]} if len(r) > 2
                                        else {})) for r in rows]}).encode()
    req = urllib.request.Request(url + "/score", data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=60) as resp:
        doc = json.loads(resp.read())
    return doc, (time.monotonic() - t0) * 1e3


def phase_serving(torch, ss_mod, params_a, params_b, device) -> dict:
    from dmlc_core_tpu_torch.serving import (ScoringServer, pack_snapshot,
                                             push_snapshot, snapshot_digest)
    cfg = {"num_features": NUM_FEATURES, "num_factors": NUM_FACTORS,
           "sdot_backend": "pallas"}
    snap_a = pack_snapshot("fm", cfg, params_a, seq=1)
    snap_b = pack_snapshot("fm", cfg, params_b, seq=2)
    from dmlc_core_tpu_torch import telemetry
    split = ("serve.requests", "serve.queue_wait_us", "serve.pack_us",
             "serve.score_busy_us")
    c0 = {k: telemetry.counter_get(k) for k in split}
    rng = np.random.default_rng(11)
    lat = {n: [] for n in REQUEST_ROWS}
    with ScoringServer(device=device) as srv:
        url = f"http://127.0.0.1:{srv.http_port}"
        # the main path: counts go to 0 here and are read when it ends
        ss_mod.segment_sum_kernel.launches = 0
        batches0 = srv.queue.batches
        rep = push_snapshot("127.0.0.1", srv.port, snap_a, seq=1)
        check(rep.get("ok") and rep["digest"] == snapshot_digest(snap_a),
              f"push of snapshot A: {rep}")
        worst = 0.0
        for params, snap, label in ((params_a, snap_a, "A"),
                                    (params_b, snap_b, "B")):
            if label == "B":
                rep = push_snapshot("127.0.0.1", srv.port, snap, seq=2)
                check(rep.get("ok"), f"push of snapshot B: {rep}")
            for n in REQUEST_ROWS:
                for _ in range(LATENCY_REPEATS if label == "B" else 2):
                    rows = criteo_rows(rng, n)
                    doc, ms = post_score(url, rows)
                    check(doc["model"] == snapshot_digest(snap),
                          f"model {doc['model']} != snapshot {label}")
                    got = np.asarray(doc["scores"], np.float64)
                    check(got.shape == (n,) and np.isfinite(got).all(),
                          f"{n}-row response shape/finiteness")
                    err = float(np.abs(got - fm_oracle(params, rows)).max())
                    check(err <= TOL, f"{n} rows, snapshot {label}: "
                          f"score err {err} > {TOL}")
                    worst = max(worst, err)
                    if label == "B":
                        lat[n].append(ms)
        launches = ss_mod.segment_sum_kernel.launches
        batches = srv.queue.batches - batches0
    d = {k: telemetry.counter_get(k) - c0[k] for k in split}
    print(f"serving: {batches} micro-batches, {launches} segment_sum "
          f"launches, max |score - oracle| {worst:.3e}; host split: queue "
          f"wait {d['serve.queue_wait_us'] / d['serve.requests']:.0f} "
          f"us/request, pack {d['serve.pack_us'] / batches:.0f} us/batch, "
          f"score {d['serve.score_busy_us'] / batches:.0f} us/batch")
    check(batches > 0 and launches == 3 * batches,
          f"segment_sum launched {launches} times for {batches} "
          "micro-batches (want 3 each)")
    for n in REQUEST_ROWS:
        print(f"/score {n:>3} rows: p50 {np.percentile(lat[n], 50):.3f} ms, "
              f"p99 {np.percentile(lat[n], 99):.3f} ms "
              f"({len(lat[n])} requests, host clock)")
    return {"launches": launches, "batches": batches}


def phase_profile(torch, params) -> None:
    """Where one 256-row micro-batch spends its time on the card."""
    from torch.profiler import ProfilerActivity, profile
    from dmlc_core_tpu_torch.serving import (ScoringEngine, ScoringIterator,
                                             pack_snapshot)
    cfg = {"num_features": NUM_FEATURES, "num_factors": NUM_FACTORS,
           "sdot_backend": "pallas"}
    eng = ScoringEngine.from_snapshot_bytes(
        pack_snapshot("fm", cfg, params), device="cuda")
    it = ScoringIterator(max_batch=4096, device="cuda")
    rows = criteo_rows(np.random.default_rng(5), 256)
    for _ in range(5):
        eng.score(it.pack(rows)[0])
    n = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            eng.score(it.pack(rows)[0])
        wall_ms = (time.monotonic() - t0) * 1e3 / n
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    dev_us = sum(e.device_time_total for e in events) / n
    print(f"profile [engine.score, 256 rows, under the profiler]: wall "
          f"{wall_ms:.3f} ms, device busy {dev_us / 1e3:.3f} ms per batch "
          f"({len(events)} kernel kinds)")
    if not events:
        print("  device time: not measured (no CUDA events in the trace)")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:8]:
        print(f"  {e.device_time_total / n:9.2f} us  x{e.count // n:<3} "
              f"{e.key[:90]}")


# ---- phase 4: training from a file (DeviceStagingIter + train_step) -------

# Criteo Display Advertising rows at the served width (13 integer fields as
# log1p counts, 26 categorical fields of value 1, hashed into 2^20 slots);
# labels drawn from a planted FM.  Cut: 524,288 rows of Criteo Kaggle's
# 45,840,617, for the time limit
TRAIN_ROWS, TRAIN_BATCH, TRAIN_NNZ_BUCKET = 524_288, 8192, 65_536
TRAIN_EPOCHS, TRAIN_WORKERS = 2, 4
TRAIN_SEED = 21          # the planted FM's params and the labels' draws
XLA_STEPS = 64           # steps of the index_add route held to the kernel's
ROUTE_TOL = 1e-5         # |kernel grad - index_add grad| / max |grad|
STEP_TOL = 1e-5          # first update vs float64, relative to its largest
PROFILE_STEPS = 8
LOSS_STEPS = (0, 16, 64, 127)


def libsvm_text(label, row_ptr, index, value, field=None,
                shortest: bool = False) -> bytes:
    """libsvm lines (label, then ``index:value`` pairs), or libffm lines
    (``field:index:value`` triples) when ``field`` is given, for CSR rows,
    assembled with numpy: every row is a run of tokens from one byte table
    (labels, separators, index and value strings), gathered in one
    fancy-indexing pass.  Values are written as %.9g, or with
    ``shortest`` as the shortest decimal that reads back as the same f32;
    either way f32 values read back exactly."""
    uniq, inv = np.unique(value, return_inverse=True)
    n_idx = int(index.max()) + 1 if index.size else 0
    if field is not None and field.size:
        n_idx = max(n_idx, int(field.max()) + 1)
    fmt = ((lambda v: np.format_float_positional(
        np.float32(v), unique=True, trim="-").encode()) if shortest
        else (lambda v: b"%.9g" % float(v)))
    words = ([b"0", b"1", b" ", b":", b"\n"]
             + [str(i).encode() for i in range(n_idx)]
             + [fmt(v) for v in uniq])
    lens = np.array([len(w) for w in words], np.int64)
    offs = np.cumsum(lens) - lens
    table = np.frombuffer(b"".join(words), np.uint8)
    rows, nnz = len(label), len(index)
    per = 4 if field is None else 6  # tokens an entry
    counts = np.diff(row_ptr).astype(np.int64)
    first = 2 * np.arange(rows) + per * row_ptr[:-1].astype(np.int64)
    tok = np.empty(2 * rows + per * nnz, np.int64)
    tok[first] = (label > 0.5).astype(np.int64)
    e_row = np.repeat(np.arange(rows), counts)
    e_pos = (first[e_row] + 1
             + per * (np.arange(nnz) - row_ptr[:-1].astype(np.int64)[e_row]))
    tok[e_pos] = 2
    if field is not None:
        tok[e_pos + 1] = 5 + field.astype(np.int64)
        tok[e_pos + 2] = 3
        e_pos = e_pos + 2
    tok[e_pos + 1] = 5 + index.astype(np.int64)
    tok[e_pos + 2] = 3
    tok[e_pos + 3] = 5 + n_idx + inv.reshape(-1)
    tok[first + 1 + per * counts] = 4
    seg_len = lens[tok]
    dst = np.cumsum(seg_len) - seg_len
    src = np.repeat(offs[tok] - dst, seg_len) + np.arange(int(seg_len.sum()))
    return table[src].tobytes()


def criteo_planted_chunks(rows: int, chunk: int = 32_768):
    """Criteo-width training rows with labels drawn from the planted FM
    (``fm_params(TRAIN_SEED)``), ``chunk`` rows at a time: (labels, idx
    [n, 39], values [n, 39]).  The same seed gives the same rows for any
    ``rows``, so a shorter file holds the first rows of a longer one."""
    planted = fm_params(TRAIN_SEED)
    rng = np.random.default_rng(TRAIN_SEED)
    w64, v64 = planted["w"].astype(np.float64), planted["v"]
    for r0 in range(0, rows, chunk):
        n = min(chunk, rows - r0)
        idx = rng.integers(0, NUM_FEATURES, (n, NNZ_PER_ROW))
        val = np.ones((n, NNZ_PER_ROW), np.float32)
        val[:, :INT_FIELDS] = np.log1p(
            rng.integers(0, 1000, (n, INT_FIELDS))).astype(np.float32)
        x = val.astype(np.float64)
        v = v64[idx].astype(np.float64)           # [n, 39, K]
        vx = np.einsum("nkf,nk->nf", v, x)
        m = (float(planted["b"]) + (w64[idx] * x).sum(1)
             + 0.5 * (vx ** 2 - np.einsum("nkf,nk->nf", v ** 2,
                                          x ** 2)).sum(1))
        y = rng.random(n) < 1.0 / (1.0 + np.exp(-m))
        yield y, idx, val


def criteo_train_file(path: Path, rows: int = 0,
                      with_field: bool = False) -> None:
    """Write the training file once (a file already there is reused):
    ``rows`` planted Criteo-width rows as libsvm, or as libffm with each
    entry's field id 0..38 (its position in the row, as libffm's Criteo
    runs number the 13 integer and 26 categorical fields)."""
    if path.exists():
        return
    rows = rows or TRAIN_ROWS
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        for y, idx, val in criteo_planted_chunks(rows):
            n = len(y)
            ptr = np.arange(n + 1, dtype=np.int64) * NNZ_PER_ROW
            fld = (np.tile(np.arange(NNZ_PER_ROW), n) if with_field
                   else None)
            f.write(libsvm_text(y, ptr, idx.reshape(-1), val.reshape(-1),
                                field=fld))
    tmp.rename(path)


def host_packed(uri: str, batch: int, bucket: int,
                with_field: bool = False, part: int = 0,
                num_parts: int = 1, limit: int = 0) -> list:
    """The staged batches as the port's ``Parser`` RowBlocks packed on the
    host by numpy: ``batch`` rows each (the last zero-padded: weight 0,
    label 0, empty spans), nonzeros padded with zeros to a multiple of
    ``bucket``; with ``with_field``, the libffm field lane too; ``part`` of
    ``num_parts`` of the file; with ``limit``, its first ``limit`` batches
    (read no further than they need)."""
    from dmlc_core_tpu_torch.data import Parser
    labels, weights, offsets, index, value, field = [], [], [], [], [], []
    base = 0
    with Parser(uri, part=part, num_parts=num_parts) as parser:
        for blk in parser:
            if limit and sum(map(len, labels)) >= limit * batch:
                break
            labels.append(blk.label)
            weights.append(blk.weight if blk.weight is not None
                           else np.ones(blk.size, np.float32))
            offsets.append(blk.offset[1:].astype(np.int64) + base)
            base += blk.num_nonzero
            index.append(blk.index.astype(np.int32))
            value.append(blk.values_or_ones())
            if with_field:
                field.append(blk.field.astype(np.int32))
    label, weight = np.concatenate(labels), np.concatenate(weights)
    ptr = np.concatenate([[0]] + offsets)
    index, value = np.concatenate(index), np.concatenate(value)
    field = np.concatenate(field) if with_field else None
    out = []
    for r0 in range(0, len(label), batch):
        r1 = min(r0 + batch, len(label))
        e0, e1 = int(ptr[r0]), int(ptr[r1])
        pad = -(-(e1 - e0) // bucket) * bucket - (e1 - e0)
        rp = (ptr[r0:r1 + 1] - e0).astype(np.int32)
        out.append({
            "label": np.pad(label[r0:r1], (0, batch - (r1 - r0))),
            "weight": np.pad(weight[r0:r1], (0, batch - (r1 - r0))),
            "row_ptr": np.pad(rp, (0, batch - (r1 - r0)), mode="edge"),
            "index": np.pad(index[e0:e1], (0, pad)),
            "value": np.pad(value[e0:e1], (0, pad)),
            "num_rows": r1 - r0})
        if with_field:
            out[-1]["field"] = np.pad(field[e0:e1], (0, pad))
    return out[:limit] if limit else out


STAGED_LEAVES = ("label", "weight", "row_ptr", "index", "value")


def batch_mismatch(batch, want: dict, leaves=STAGED_LEAVES):
    """The first leaf of a staged batch (already copied to the host, as
    numpy) that differs from the host packing bit for bit, or None."""
    if batch["num_rows"] != want["num_rows"]:
        return "num_rows"
    for k in leaves:
        a, b = batch[k], want[k]
        if a.shape != b.shape or not np.array_equal(a.view(np.int32),
                                                    b.view(np.int32)):
            return k
    return None


def leaves_digest(batch: dict, leaves=STAGED_LEAVES) -> str:
    """sha256 over a host batch's leaves (4-byte words, in ``leaves``
    order) and its ``num_rows``."""
    h = hashlib.sha256(str(int(batch["num_rows"])).encode())
    for k in leaves:
        h.update(np.ascontiguousarray(batch[k]).view(np.int32).tobytes())
    return h.hexdigest()


def copy_back(torch, batch, host_pin: dict, slot: int,
              leaves=STAGED_LEAVES) -> tuple:
    """Non-blocking copies of a staged batch's leaves into pinned host
    buffers (``host_pin``, recycled by ``slot``) on the consumer's stream,
    and an event after them."""
    out = {}
    for k in leaves:
        t = getattr(batch, k)
        h = host_pin.get((k, slot))
        if h is None or h.shape != t.shape:
            h = host_pin[(k, slot)] = torch.empty(t.shape, dtype=t.dtype,
                                                  pin_memory=True)
        h.copy_(t, non_blocking=True)
        out[k] = h
    ev = torch.cuda.Event()
    ev.record()
    return out, ev


def compare_back(out, ev, num_rows, ref, leaves=STAGED_LEAVES):
    """``batch_mismatch`` of a ``copy_back`` once its copies are done."""
    ev.synchronize()
    got = {k: out[k].numpy() for k in leaves}
    got["num_rows"] = num_rows
    return batch_mismatch(got, ref, leaves)


def fm_step_oracle(p0: dict, h: dict, lr: float) -> dict:
    """float64 numpy SGD update of an FM on one host batch: margins, the
    weighted logistic mean, and ``np.add.at`` gradients for w, v and b.
    (Margins are nonzero here, away from the loss's kink.)"""
    B = h["label"].shape[0]
    nnz = h["index"].shape[0]
    rid = np.minimum(np.searchsorted(h["row_ptr"], np.arange(nnz),
                                     side="right") - 1, B - 1)
    x, idx = h["value"].astype(np.float64), h["index"].astype(np.int64)
    w = p0["w"].astype(np.float64)
    b = float(p0["b"])
    lin = np.zeros(B)
    np.add.at(lin, rid, w[idx] * x)
    m = b + lin
    out = {}
    if "v" in p0:
        v = p0["v"].astype(np.float64)
        K = v.shape[1]
        vx = np.zeros((B, K))
        np.add.at(vx, rid, v[idx] * x[:, None])
        v2x2 = np.zeros((B, K))
        np.add.at(v2x2, rid, v[idx] ** 2 * x[:, None] ** 2)
        m = m + 0.5 * (vx ** 2 - v2x2).sum(1)
    y = (h["label"] > 0.5).astype(np.float64)
    wt = h["weight"].astype(np.float64)
    dm = (1.0 / (1.0 + np.exp(-m)) - y) * wt / max(wt.sum(), 1.0)
    gw = np.zeros(w.shape[0])
    np.add.at(gw, idx, dm[rid] * x)
    out["w"], out["b"] = -lr * gw, -lr * dm.sum()
    if "v" in p0:
        gv = np.zeros(v.shape)
        np.add.at(gv, idx, dm[rid][:, None] * (x[:, None] * vx[rid]
                                               - v[idx] * x[:, None] ** 2))
        out["v"] = -lr * gv
    return out


def caught_step(model, batch) -> tuple:
    """One ``train_step`` with each parameter's gradient caught as it
    lands (a post-accumulate hook; the step clears it after) and the rows
    whose margin came out exactly 0 counted: there the loss's slope jumps
    (the port takes the JAX package's slopes at the kink, -y where the
    smooth loss has sigmoid(0) - y).  Returns (loss, grads, those rows)."""
    grads, zeros = {}, []
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
        for n, p in model.named_parameters()]
    inner = model.margins

    def margins(b):
        m = inner(b)
        zeros.append(int(((m.detach() == 0) & (b.weight > 0)).sum()))
        return m

    model.margins = margins
    try:
        loss = model.train_step(batch)
    finally:
        del model.margins
        for h in hooks:
            h.remove()
    return loss, grads, zeros[0]


def traced_step(torch, model, batch, p0: dict, want: dict) -> tuple:
    """One ``caught_step`` held to a float64 update.  Returns (max over
    params of |update - float64 update| / max |float64 update|, where
    update = -learning_rate * grad as the step computes it in f32; whether
    every p1 equals p0 - learning_rate * grad bit for bit; the same error
    measured as p1 - p0, which also holds the f32 rounding of storing p1:
    half an ulp of |p|, far above 1e-5 of an update at this batch size;
    the step's loss)."""
    loss, grads, zeros = caught_step(model, batch)
    check(zeros == 0, f"{zeros} rows with an exactly-zero margin in the "
          "step held to float64")
    err = err_p = 0.0
    exact = True
    for k, d in want.items():
        scale = max(float(np.abs(d).max()), 1e-30)
        step = model.learning_rate * grads[k]
        p1 = model.state_dict()[k]
        exact &= torch.equal(p1, torch.as_tensor(p0[k], device=p1.device)
                             - step)
        err = max(err, float(np.abs(-step.double().cpu().numpy() - d).max())
                  / scale)
        err_p = max(err_p, float(np.abs(p1.double().cpu().numpy() - p0[k]
                                        - d).max()) / scale)
    return err, exact, err_p, loss


def union_ms(intervals) -> float:
    """Total length of a union of (start, end) intervals, in ms (us in)."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def overlap_ms(xs, ys) -> float:
    """Length of the intersection of two interval unions, in ms."""
    return union_ms(xs) + union_ms(ys) - union_ms(list(xs) + list(ys))


def profile_train_steps(torch, model, it, what: str) -> None:
    """Where ``PROFILE_STEPS`` steady training steps from the iterator go on
    the card, staging included: wall, device busy share, the H2D copies
    and their overlap with kernels, and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    batches = iter(it)
    for _ in range(3):
        model.train_step(next(batches))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(PROFILE_STEPS):
            model.train_step(next(batches))
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    batches.close()
    dev_ev = [e for e in prof.events()
              if e.device_type.name == "CUDA" and e.time_range.elapsed_us()]
    copies = [(e.time_range.start, e.time_range.end) for e in dev_ev
              if "HtoD" in e.name]
    kernels = [(e.time_range.start, e.time_range.end) for e in dev_ev
               if "Memcpy" not in e.name and "Memset" not in e.name]
    busy = union_ms(copies + kernels)
    print(f"profile [{PROFILE_STEPS} {what} train steps from the file, under "
          f"the profiler]: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall_ms:.1f}%); H2D copies {union_ms(copies):.3f}"
          f" ms, kernels {union_ms(kernels):.3f} ms, copy time overlapping "
          f"kernels {overlap_ms(copies, kernels):.3f} ms")
    if not dev_ev:
        print("  device time: not measured (no CUDA events in the trace)")
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    for e in sorted(events, key=lambda e: -e.device_time_total)[:10]:
        print(f"  {e.device_time_total / PROFILE_STEPS:9.2f} us  "
              f"x{e.count / PROFILE_STEPS:<5.1f} {e.key[:90]}")


def phase_training(torch, ss_mod, dev, build_dir: Path) -> dict:
    """Train the Criteo-width FM from a libsvm file through the port's
    DeviceStagingIter and train_step on the segment-sum kernel; hold the
    staged batches, the first step and the index_add route to their
    references; a shorter linear run; the kernel at the training shape."""
    from concurrent.futures import ThreadPoolExecutor

    from dmlc_core_tpu_torch import telemetry
    from dmlc_core_tpu_torch.data import DeviceStagingIter
    from dmlc_core_tpu_torch.models import (FactorizationMachine,
                                            SparseLinearModel,
                                            params_from_numpy)
    path = build_dir / f"criteo_{TRAIN_ROWS}_seed{TRAIN_SEED}.libsvm"
    t0 = time.monotonic()
    criteo_train_file(path)
    t_write = time.monotonic() - t0
    size = path.stat().st_size
    uri = str(path)
    t0 = time.monotonic()
    want = host_packed(uri, TRAIN_BATCH, TRAIN_NNZ_BUCKET)
    t_host = time.monotonic() - t0
    steps_per_epoch = len(want)
    check(steps_per_epoch == TRAIN_ROWS // TRAIN_BATCH,
          f"{steps_per_epoch} batches in an epoch")
    check(all(int(w["num_rows"]) == TRAIN_BATCH for w in want),
          "a short batch in the training file")
    print(f"train data: {TRAIN_ROWS} Criteo-width rows x {NNZ_PER_ROW} "
          f"nonzeros, {size / 2**20:.1f} MiB of libsvm written in "
          f"{t_write:.1f} s (host, numpy); Parser + numpy packing of "
          f"{steps_per_epoch} host batches {t_host:.1f} s; "
          f"{float(np.mean([w['label'].mean() for w in want])):.3f} positive")

    kw = dict(batch_size=TRAIN_BATCH, nnz_bucket=TRAIN_NNZ_BUCKET,
              num_workers=TRAIN_WORKERS)
    it = DeviceStagingIter(uri, device=dev, **kw)
    check(it.device.type == "cuda", "DeviceStagingIter is not on the card")
    fm = FactorizationMachine(NUM_FEATURES, num_factors=NUM_FACTORS,
                              sdot_backend="pallas", device=dev).init(0)
    lr = fm.learning_rate
    names = ("h2d.wait_us", "h2d.busy_us", "h2d.emit_wait_us", "h2d.batches")
    c0 = {k: telemetry.counter_get(k) for k in names}
    pool = ThreadPoolExecutor(1)
    pending, losses, per_step, epoch_s = [], [], [], []
    after64 = first = None
    host_pin = {}

    # the main path: counts to 0 here, read when the second epoch ends
    ss_mod.segment_sum_kernel.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = 0
    for epoch in range(TRAIN_EPOCHS):
        torch.cuda.synchronize()
        t_ep = time.monotonic()
        bytes0 = it.bytes_read
        for i, batch in enumerate(it):
            before = ss_mod.segment_sum_kernel.launches
            if step == 0:
                p0 = {k: v.detach().cpu().numpy().copy()
                      for k, v in fm.state_dict().items()}
            if step == 0:
                first = traced_step(torch, fm, batch, p0,
                                    fm_step_oracle(p0, want[0], lr))
                loss = first[3]
            else:
                loss = fm.train_step(batch)
            per_step.append(ss_mod.segment_sum_kernel.launches - before)
            losses.append(loss)
            if epoch == 0:
                # while the next steps run: this batch, copied back, against
                # the host packing (a pinned buffer recycled too early, or
                # device memory reused early, shows as a difference)
                out, ev = copy_back(torch, batch, host_pin, len(pending) % 8)
                pending.append(pool.submit(compare_back, out, ev,
                                           batch.num_rows, want[i]))
                if len(pending) >= 8:
                    pending[-8].result()
            step += 1
            if step == XLA_STEPS:
                after64 = {k: v.detach().clone()
                           for k, v in fm.state_dict().items()}
        torch.cuda.synchronize()
        epoch_s.append((time.monotonic() - t_ep, it.bytes_read - bytes0,
                        dict(it.profile)))
    launches = ss_mod.segment_sum_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    bad = [(i, r) for i, f in enumerate(pending) if (r := f.result())]
    pool.shutdown()
    d = {k: telemetry.counter_get(k) - c0[k] for k in names}
    total_steps = TRAIN_EPOCHS * steps_per_epoch
    check(step == total_steps, f"{step} steps, want {total_steps}")
    print(f"train [staged batches vs host packing, epoch 1, compared while "
          f"the steps ran]: {len(pending) - len(bad)} of {len(pending)} "
          f"equal bit for bit" + (f"; first mismatch {bad[0]}" if bad else ""))
    check(not bad and len(pending) == steps_per_epoch,
          f"staged batches differ from the host packing: {bad[:3]}")
    print(f"train [segment_sum launches]: {launches} in {step} steps, "
          f"{sorted(set(per_step))} a step")
    check(launches == 3 * step and set(per_step) == {3},
          f"segment_sum launched {launches} times in {step} FM steps "
          "(want 3 a step)")
    print(f"train [first step vs float64 numpy SGD]: |update - float64| / "
          f"max |float64 update| = {first[0]:.3e}, tol {STEP_TOL:.0e}; p1 = "
          f"p0 - lr * grad bit for bit: {first[1]}; as p1 - p0 (with the f32 "
          f"rounding of storing p1) {first[2]:.3e}")
    check(first[0] <= STEP_TOL and first[1],
          f"first FM step: {first[0]} from float64, applied {first[1]}")
    loss_v = [float(x) for x in losses]
    print("train logloss (the step's batch, before the step) at steps "
          + ", ".join(f"{s}: {loss_v[s]:.6f}" for s in LOSS_STEPS)
          + f"; mean over epoch 2 {np.mean(loss_v[steps_per_epoch:]):.6f}")
    check(all(np.isfinite(loss_v)), "a non-finite training loss")
    check(np.mean(loss_v[-16:]) < loss_v[0], "the FM's loss did not fall")
    for e, (secs, nbytes, prof) in enumerate(epoch_s):
        print(f"train epoch {e + 1}: {secs:.3f} s wall, "
              f"{steps_per_epoch / secs:.1f} steps/s, "
              f"{steps_per_epoch * TRAIN_BATCH / secs:.0f} rows/s, parse "
              f"{nbytes / 2**20 / secs:.1f} MB/s ({nbytes} bytes read); "
              f"profile " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                                      else f"{k} {v}"
                                      for k, v in prof.items()))
    print(f"train: peak device memory {peak / 2**30:.2f} GiB; h2d counters "
          f"over both epochs: " + ", ".join(f"{k} {v}" for k, v in d.items())
          + f"; iterator counters {it.counters}")

    # (d) the index_add route: from the kernel route's params at every
    # step, its gradients against the kernel route's; and run apart from
    # the same init for XLA_STEPS steps, its params against the main run's
    def new_fm(route):
        return FactorizationMachine(NUM_FEATURES, num_factors=NUM_FACTORS,
                                    sdot_backend=route, device=dev)
    fm_k, fm_x = new_fm("pallas").init(0), new_fm("xla")
    fm_apart = new_fm("xla").init(0)
    worst, kinks, kink_rows = 0.0, [], 0
    for i, batch in enumerate(it):
        if i == XLA_STEPS:
            break
        fm_apart.train_step(batch)
        fm_x.load_state_dict(fm_k.state_dict())
        _, gk, zk = caught_step(fm_k, batch)
        _, gx, zx = caught_step(fm_x, batch)
        gap = max(float((gk[n] - gx[n]).abs().max())
                  / max(float(gx[n].abs().max()), 1e-30) for n in gx)
        if zk or zx:
            kinks.append((i, zk, zx, f"{gap:.3e}"))
            kink_rows += zk + zx
        else:
            worst = max(worst, gap)
    gaps = {k: float((after64[k] - v).abs().max())
            / max(float(after64[k].abs().max()), 1e-30)
            for k, v in fm_apart.state_dict().items()}
    print(f"train [kernel route vs index_add route, from the same params at "
          f"each of {XLA_STEPS} steps]: |grad difference| / max |grad| "
          f"{worst:.3e} (tol {ROUTE_TOL:.0e}) at the "
          f"{XLA_STEPS - len(kinks)} steps where no margin is exactly 0; "
          f"steps with such rows (step, kernel rows, index_add rows, gap): "
          f"{kinks}")
    print(f"train [the routes run apart from one init for {XLA_STEPS} "
          f"steps]: |param difference| / max |param|: " + ", ".join(
              f"{k} {g:.3e}" for k, g in gaps.items())
          + " (one row at an exactly-zero margin in one route and not the "
          "other moves that route's step by 0.5 / batch rows on that row)")
    check(worst <= ROUTE_TOL and len(kinks) < XLA_STEPS,
          f"kernel and index_add routes part: {worst}, kinks {kinks}")

    # (h) two runs from the same init over the same batches, bitwise?
    held = []
    for batch in it:
        held.append(batch)
        if len(held) == PROFILE_STEPS:
            break
    runs = []
    for _ in range(2):
        m = FactorizationMachine(NUM_FEATURES, num_factors=NUM_FACTORS,
                                 sdot_backend="pallas", device=dev).init(0)
        for batch in held:
            m.train_step(batch)
        runs.append(m.state_dict())
    same = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    diff = max(float((runs[0][k] - runs[1][k]).abs().max()) for k in runs[0])
    print(f"train [two runs of {PROFILE_STEPS} steps from one init]: bitwise "
          f"equal {same}, max |difference| {diff:.3e} (the forward sums are "
          "the fixed-point kernel's; the gathered tables' gradient is "
          "PyTorch's indexing backward, see the profile below)")
    del held, runs

    # (g) where 8 steady steps go: staging included
    profile_train_steps(torch, fm, it, "FM")

    # the shorter linear run: one epoch, 1 launch a step, its first step
    rng = np.random.default_rng(TRAIN_SEED + 1)
    lin_p0 = {"w": (0.01 * rng.standard_normal(NUM_FEATURES)).astype(
        np.float32), "b": np.float32(-0.1)}
    lin = SparseLinearModel(NUM_FEATURES, sdot_backend="pallas", device=dev)
    lin.load_state_dict(params_from_numpy("linear", lin_p0, dev))
    ss_mod.segment_sum_kernel.launches = 0
    lin_losses, lin_first = [], None
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i, batch in enumerate(it):
        if i == 0:
            lin_first = traced_step(torch, lin, batch, lin_p0, fm_step_oracle(
                lin_p0, want[0], lin.learning_rate))
            lin_losses.append(lin_first[3])
        else:
            lin_losses.append(lin.train_step(batch))
    torch.cuda.synchronize()
    t_lin = time.monotonic() - t0
    lin_launches = ss_mod.segment_sum_kernel.launches
    ev = lin.evaluate(it)
    print(f"train linear: {steps_per_epoch} steps in {t_lin:.3f} s "
          f"({steps_per_epoch / t_lin:.1f} steps/s), segment_sum launches "
          f"{lin_launches}; first step vs float64 {lin_first[0]:.3e} "
          f"(applied bit for bit: {lin_first[1]}; as p1 - p0 "
          f"{lin_first[2]:.3e}); logloss "
          f"{float(lin_losses[0]):.6f} -> {float(lin_losses[-1]):.6f}; "
          f"evaluate {ev}")
    check(lin_launches == steps_per_epoch,
          f"linear: {lin_launches} launches in {steps_per_epoch} steps")
    check(lin_first[0] <= STEP_TOL and lin_first[1],
          f"first linear step: {lin_first}")
    check(np.isfinite(ev["loss"]) and 0.0 <= ev["accuracy"] <= 1.0,
          f"evaluate {ev}")

    # the FM after training, over the file: its weighted logloss
    tot = wsum = 0.0
    with torch.no_grad():
        for batch in it:
            sw = float(batch.weight.sum())
            tot += float(fm.loss(batch)) * sw
            wsum += sw
    print(f"train FM after {step} steps: logloss over the file "
          f"{tot / wsum:.6f} (first batch before training {loss_v[0]:.6f})")

    # staging alone: how fast the pipeline delivers batches to the card
    torch.cuda.synchronize()
    t0 = time.monotonic()
    bytes0 = it.bytes_read
    n = sum(1 for _ in it)
    torch.cuda.synchronize()
    t_stage = time.monotonic() - t0
    print(f"staging alone (no training): {n} batches in {t_stage:.3f} s, "
          f"{n / t_stage:.1f} batches/s, "
          f"{(it.bytes_read - bytes0) / 2**20 / t_stage:.1f} MB/s parsed; "
          f"profile {it.profile}")
    it.close()

    # the segment-sum kernel at the training shape, on the trained FM's own
    # inputs of the first batch (327,680 entries with the padding lanes)
    batch = next(iter(DeviceStagingIter(uri, device=dev, **kw)))
    timings = phase_train_kernel(torch, ss_mod, fm, batch)
    return {"launches": launches, "timings": timings,
            "steps": step, "model": fm, "uri": uri, "want": want}


def phase_train_kernel(torch, ss_mod, fm, batch,
                       lanes_of=(1, NUM_FACTORS)) -> dict:
    """The segment-sum kernel at a training step's shapes (L=1: the linear
    term; L=16: an FM's two second-order sums): against its plain version
    and a float64 sum, two launches bitwise equal, and its device time
    beside the plain version, ``index_add`` and its byte bound."""
    from dmlc_core_tpu_torch.ops.segment_sum import clamp_index
    kernel, plain = ss_mod.segment_sum_kernel, ss_mod.segment_sum_plain
    R = batch.batch_size
    rid = batch.row_ids()
    idx = clamp_index(batch.index, NUM_FEATURES)
    x = batch.value
    with torch.no_grad():
        contrib = {1: (fm.w[idx] * x).contiguous()}
        if NUM_FACTORS in lanes_of:
            contrib[NUM_FACTORS] = (fm.v[idx] * x[:, None]).contiguous()
    out = {}
    for lanes, c in contrib.items():
        nnz = c.shape[0]
        a = kernel(c, rid, R)
        b = kernel(c, rid, R)
        want = plain(c, rid, R)
        f64 = torch.zeros((R,) + tuple(c.shape[1:]), dtype=torch.float64,
                          device=c.device).index_add_(0, rid.long(),
                                                      c.double())
        torch.cuda.synchronize()
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"training shape L={lanes}: two launches differ")
        err = float((a - want).abs().max())
        tol = HIST_TOL * max(1.0, float(f64.abs().max()))
        err_o = float((a.double() - f64).abs().max())
        zeros = torch.zeros((R,) + tuple(c.shape[1:]), device=c.device)
        ms, cov = device_ms(torch, lambda: kernel(c, rid, R), 100)
        plain_ms, _ = device_ms(torch, lambda: plain(c, rid, R), 3,
                                warmup=1)
        lib_ms, _ = device_ms(
            torch, lambda: torch.index_add(zeros, 0, rid, c), 100)
        nbytes = 4 * (nnz * lanes + nnz + R * lanes)
        byte_s, op_s = nbytes / HBM_BYTES_PER_S, nnz * lanes / F32_OPS_PER_S
        bound_ms = max(byte_s, op_s) * 1e3
        print(f"time [training step, L={lanes}, R={R}, nnz={nnz}]: kernel "
              f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, index_add "
              f"{lib_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us "
              f"({nbytes} bytes); |kernel - plain| {err:.3e} (tol {TOL:.0e}),"
              f" |kernel - float64| {err_o:.3e} (tol {tol:.3e}); geometry "
              f"{ss_mod.launch_geometry(nnz, R, lanes)}; queue covered: {cov}")
        check(err <= TOL and err_o <= tol,
              f"training shape L={lanes}: kernel error {err} / {err_o}")
        out[lanes] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, max_abs_err=err, nnz=nnz,
                          bound_by="bytes" if byte_s >= op_s
                          else "operations")
    return out


# ---- phase 4b: the field-aware FM from a libffm file, then served ---------

# The served FM's Criteo-width rows with each entry's field id 0..38 (the 13
# integer and 26 categorical fields), as libffm's Criteo runs give them, and
# the FFM at that paper's Criteo settings (Juan et al., RecSys 2016): k = 4,
# eta = 0.2, lambda = 2e-5.  Cut: rows, 262,144 of Criteo Kaggle's
# 45,840,617, for the time limit
FFM_ROWS, FFM_FIELDS, FFM_FACTORS = 262_144, NNZ_PER_ROW, 4
FFM_LR, FFM_L2 = 0.2, 2e-5
FFM_LEAVES = STAGED_LEAVES + ("field",)
FFM_CFG = {"num_features": NUM_FEATURES, "num_fields": FFM_FIELDS,
           "num_factors": FFM_FACTORS, "sdot_backend": "pallas"}


def ffm_step_oracle(p0: dict, h: dict, lr: float, l2: float) -> dict:
    """float64 numpy SGD update of an FFM on one host batch: margins by the
    field-grouped sums S[r, a, b] (entries of field a of row r times their
    factor rows toward field b), the weighted logistic mean, and the
    gradients of w, v (the cross term meets S[r, b, a], the self pair
    subtracts x^2 v[f, fl]) and b, plus l2 on w and v, by ``bincount``."""
    B = h["label"].shape[0]
    nnz = h["index"].shape[0]
    rid = np.minimum(np.searchsorted(h["row_ptr"], np.arange(nnz),
                                     side="right") - 1, B - 1)
    x, idx = h["value"].astype(np.float64), h["index"].astype(np.int64)
    w, v = p0["w"].astype(np.float64), p0["v"].astype(np.float64)
    F, A, K = v.shape
    fld = np.clip(h["field"].astype(np.int64), 0, A - 1)
    lane = np.arange(A * K)
    src = rid * A + fld                        # (row, source field)
    ve = v[idx].reshape(nnz, A * K) * x[:, None]
    S = np.bincount((src[:, None] * (A * K) + lane).ravel(), ve.ravel(),
                    minlength=B * A * A * K).reshape(B, A, A, K)
    del ve
    vs = v[idx, fld]                           # [nnz, K]
    m = (float(p0["b"]) + np.bincount(rid, w[idx] * x, minlength=B)
         + 0.5 * (np.einsum("rabk,rbak->r", S, S)
                  - np.bincount(rid, x ** 2 * (vs ** 2).sum(1),
                                minlength=B)))
    y = (h["label"] > 0.5).astype(np.float64)
    wt = h["weight"].astype(np.float64)
    dm = (1.0 / (1.0 + np.exp(-m)) - y) * wt / max(wt.sum(), 1.0)
    G = S.transpose(0, 2, 1, 3).reshape(B * A, A * K)  # S[r, b, a] at (r, a)
    del S
    gv = np.bincount((idx[:, None] * (A * K) + lane).ravel(),
                     (G[src] * (dm[rid] * x)[:, None]).ravel(),
                     minlength=F * A * K)
    gv -= np.bincount(((idx * A + fld)[:, None] * K + np.arange(K)).ravel(),
                      ((dm[rid] * x ** 2)[:, None] * vs).ravel(),
                      minlength=F * A * K)
    gw = np.bincount(idx, dm[rid] * x, minlength=F) + l2 * w
    return {"w": -lr * gw, "v": -lr * (gv.reshape(F, A, K) + l2 * v),
            "b": np.asarray(-lr * dm.sum())}


def ffm_rows(rng, n: int) -> list:
    """``n`` Criteo-shaped request rows with their libffm fields (entry j of
    a row is field j)."""
    fields = list(range(NNZ_PER_ROW))
    return [(i, v, fields) for i, v in criteo_rows(rng, n)]


def ffm_pairwise64(params: dict, rows: list) -> np.ndarray:
    """float64 FFM probabilities of request rows by the explicit pairwise
    sum over entry pairs i < j of <v[f_i, fl_j], v[f_j, fl_i]> x_i x_j
    (tests/test_models.py's oracle), row by row."""
    w, v = params["w"].astype(np.float64), params["v"]
    out = []
    for idx, val, fld in rows:
        x = np.asarray(val, np.float64)
        vv = v[np.asarray(idx)][:, np.asarray(fld)].astype(np.float64)
        pair = np.einsum("ijk,jik->ij", vv, vv) * np.outer(x, x)
        m = (float(params["b"]) + (w[np.asarray(idx)] * x).sum()
             + np.triu(pair, 1).sum())
        out.append(1.0 / (1.0 + np.exp(-m)))
    return np.asarray(out)


def segment_timing(torch, ss_mod, c, rid, R: int, what: str,
                   iters: int = 200) -> dict:
    """The segment-sum kernel on one input: against its plain version, two
    launches bitwise equal, and its device time beside the plain version,
    ``index_add`` and its byte bound."""
    kernel, plain = ss_mod.segment_sum_kernel, ss_mod.segment_sum_plain
    a, b = kernel(c, rid, R), kernel(c, rid, R)
    want = plain(c, rid, R)
    torch.cuda.synchronize()
    check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
          f"{what}: two launches differ")
    err = float((a - want).abs().max())
    check(err <= TOL, f"{what}: kernel vs plain {err} > {TOL}")
    lanes = 1 if c.dim() == 1 else c.shape[1]
    nnz = c.shape[0]
    zeros = torch.zeros((R,) + tuple(c.shape[1:]), device=c.device)
    ms, cov = device_ms(torch, lambda: kernel(c, rid, R), iters)
    plain_ms, _ = device_ms(torch, lambda: plain(c, rid, R), 5, warmup=1)
    lib_ms, _ = device_ms(torch, lambda: torch.index_add(zeros, 0, rid, c),
                          iters)
    nbytes = 4 * (nnz * lanes + nnz + R * lanes)
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, nnz * lanes / F32_OPS_PER_S
    bound_ms = max(byte_s, op_s) * 1e3
    print(f"time [{what}, L={lanes}, R={R}, nnz={nnz}]: kernel "
          f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, index_add "
          f"{lib_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us ({nbytes} "
          f"bytes); |kernel - plain| {err:.3e} (tol {TOL:.0e}); queue "
          f"covered: {cov}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, max_abs_err=err, nnz=nnz,
                bound_by="bytes" if byte_s >= op_s else "operations")


def ffm_file_uri(build_dir: Path) -> str:
    """The FFM phase's libffm training file, as a staging URI."""
    return (f"{build_dir / f'criteo_{FFM_ROWS}_seed{TRAIN_SEED}.libffm'}"
            "?format=libfm")


def phase_ffm(torch, ss_mod, dev, build_dir: Path) -> dict:
    """Train the Criteo-width FFM from a libffm file through
    DeviceStagingIter(with_field=True) and train_step: every staged batch
    of epoch 1, the field lane included, against the host parse; one
    segment-sum launch a step (the linear term; the field-pair sums are
    index_add); the first update against float64; steps/s, rows/s, peak
    memory, a profile of 8 steps; the kernel at the step's shape."""
    from concurrent.futures import ThreadPoolExecutor

    from dmlc_core_tpu_torch.data import DeviceStagingIter
    from dmlc_core_tpu_torch.models import FieldAwareFactorizationMachine
    path = build_dir / f"criteo_{FFM_ROWS}_seed{TRAIN_SEED}.libffm"
    t0 = time.monotonic()
    criteo_train_file(path, FFM_ROWS, with_field=True)
    t_write = time.monotonic() - t0
    uri = f"{path}?format=libfm"
    t0 = time.monotonic()
    want = host_packed(uri, TRAIN_BATCH, TRAIN_NNZ_BUCKET, with_field=True)
    t_host = time.monotonic() - t0
    steps_per_epoch = len(want)
    check(steps_per_epoch == FFM_ROWS // TRAIN_BATCH
          and all(int(w["num_rows"]) == TRAIN_BATCH for w in want),
          f"{steps_per_epoch} batches in the FFM epoch")
    check(all(np.array_equal(w["field"][:TRAIN_BATCH * NNZ_PER_ROW],
                             np.tile(np.arange(NNZ_PER_ROW), TRAIN_BATCH))
              for w in want), "the parsed field lane is not 0..38 a row")
    print(f"ffm data: {FFM_ROWS} Criteo-width rows x {NNZ_PER_ROW} "
          f"field:index:value triples, {path.stat().st_size / 2**20:.1f} MiB"
          f" of libffm written in {t_write:.1f} s (host, numpy); Parser + "
          f"numpy packing {t_host:.1f} s")
    kw = dict(batch_size=TRAIN_BATCH, nnz_bucket=TRAIN_NNZ_BUCKET,
              num_workers=TRAIN_WORKERS, with_field=True)
    it = DeviceStagingIter(uri, device=dev, **kw)
    ffm = FieldAwareFactorizationMachine(
        NUM_FEATURES, FFM_FIELDS, num_factors=FFM_FACTORS,
        learning_rate=FFM_LR, l2=FFM_L2, sdot_backend="pallas",
        device=dev).init(0)
    pool = ThreadPoolExecutor(1)
    pending, losses, per_step, epoch_s, host_pin = [], [], [], [], {}
    first = None
    # the main path: counts to 0 here, read when the second epoch ends
    ss_mod.segment_sum_kernel.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = 0
    for epoch in range(TRAIN_EPOCHS):
        torch.cuda.synchronize()
        t_ep = time.monotonic()
        bytes0 = it.bytes_read
        for i, batch in enumerate(it):
            before = ss_mod.segment_sum_kernel.launches
            if step == 0:
                p0 = {k: v.detach().cpu().numpy().copy()
                      for k, v in ffm.state_dict().items()}
                first = traced_step(torch, ffm, batch, p0, ffm_step_oracle(
                    p0, want[0], FFM_LR, FFM_L2))
                loss = first[3]
                del p0
            else:
                loss = ffm.train_step(batch)
            per_step.append(ss_mod.segment_sum_kernel.launches - before)
            losses.append(loss)
            if epoch == 0:
                out, ev = copy_back(torch, batch, host_pin, len(pending) % 8,
                                    FFM_LEAVES)
                pending.append(pool.submit(compare_back, out, ev,
                                           batch.num_rows, want[i],
                                           FFM_LEAVES))
                if len(pending) >= 8:
                    pending[-8].result()
            step += 1
        torch.cuda.synchronize()
        epoch_s.append((time.monotonic() - t_ep, it.bytes_read - bytes0))
    launches = ss_mod.segment_sum_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    bad = [(i, r) for i, f in enumerate(pending) if (r := f.result())]
    pool.shutdown()
    print(f"ffm [staged batches vs host packing, field lane included, epoch "
          f"1]: {len(pending) - len(bad)} of {len(pending)} equal bit for "
          f"bit" + (f"; first mismatch {bad[0]}" if bad else ""))
    check(not bad and len(pending) == steps_per_epoch,
          f"FFM staged batches differ from the host packing: {bad[:3]}")
    print(f"ffm [segment_sum launches]: {launches} in {step} steps, "
          f"{sorted(set(per_step))} a step")
    check(launches == step and set(per_step) == {1},
          f"segment_sum launched {launches} times in {step} FFM steps "
          "(want 1 a step)")
    print(f"ffm [first step vs float64 numpy SGD]: |update - float64| / max "
          f"|float64 update| = {first[0]:.3e}, tol {STEP_TOL:.0e}; p1 = p0 - "
          f"lr * grad bit for bit: {first[1]}; as p1 - p0 {first[2]:.3e}")
    check(first[0] <= STEP_TOL and first[1],
          f"first FFM step: {first[0]} from float64, applied {first[1]}")
    loss_v = [float(x) for x in losses]
    at = (0, steps_per_epoch // 2, steps_per_epoch, step - 1)
    print("ffm logloss (the step's batch, before the step) at steps "
          + ", ".join(f"{s}: {loss_v[s]:.6f}" for s in at))
    check(all(np.isfinite(loss_v)) and np.mean(loss_v[-8:]) < loss_v[0],
          "the FFM's loss did not fall")
    for e, (secs, nbytes) in enumerate(epoch_s):
        print(f"ffm epoch {e + 1}: {secs:.3f} s wall, "
              f"{steps_per_epoch / secs:.1f} steps/s, "
              f"{steps_per_epoch * TRAIN_BATCH / secs:.0f} rows/s, parse "
              f"{nbytes / 2**20 / secs:.1f} MB/s ({nbytes} bytes read)")
    print(f"ffm: peak device memory {peak / 2**30:.2f} GiB (params "
          f"{sum(p.numel() for p in ffm.parameters()) * 4 / 2**30:.2f} GiB)")
    profile_train_steps(torch, ffm, it, "FFM")
    it.close()
    batch = next(iter(DeviceStagingIter(uri, device=dev, **kw)))
    timings = phase_train_kernel(torch, ss_mod, ffm, batch, lanes_of=(1,))
    return {"launches": launches, "steps": step, "timings": timings,
            "model": ffm}


def phase_ffm_serving(torch, ss_mod, ffm, dev) -> dict:
    """The trained FFM from a DTSNAP01 snapshot packed by the port, served
    by ScoringServer(with_field=True): /score bodies carry "field"; every
    score against the float64 pairwise oracle; one segment-sum launch a
    micro-batch; p50/p99 per request size; the kernel at a served
    micro-batch's shape."""
    from dmlc_core_tpu_torch.ops.segment_sum import clamp_index
    from dmlc_core_tpu_torch.serving import (ScoringIterator, ScoringServer,
                                             pack_snapshot, push_snapshot,
                                             snapshot_digest)
    params = {k: v.detach().cpu().numpy() for k, v in
              ffm.state_dict().items()}
    t0 = time.monotonic()
    snap = pack_snapshot("ffm", FFM_CFG, params, seq=1)
    t_pack = time.monotonic() - t0
    digest = snapshot_digest(snap)  # a sha256 of 628 MiB: once
    rng = np.random.default_rng(13)
    lat = {n: [] for n in REQUEST_ROWS}
    worst = 0.0
    with ScoringServer(with_field=True, device=dev) as srv:
        url = f"http://127.0.0.1:{srv.http_port}"
        # the main path: counts go to 0 here and are read when it ends
        ss_mod.segment_sum_kernel.launches = 0
        batches0 = srv.queue.batches
        t0 = time.monotonic()
        rep = push_snapshot("127.0.0.1", srv.port, snap, seq=1, timeout=300)
        t_push = time.monotonic() - t0
        check(rep.get("ok") and rep["digest"] == digest,
              f"push of the ffm snapshot: {rep}")
        for n in REQUEST_ROWS:
            for _ in range(LATENCY_REPEATS):
                rows = ffm_rows(rng, n)
                doc, ms = post_score(url, rows)
                check(doc["model"] == digest,
                      "served model is not the ffm snapshot")
                got = np.asarray(doc["scores"], np.float64)
                check(got.shape == (n,) and np.isfinite(got).all(),
                      f"{n}-row ffm response shape/finiteness")
                err = float(np.abs(got - ffm_pairwise64(params, rows)).max())
                check(err <= TOL, f"{n}-row ffm score err {err} > {TOL}")
                worst = max(worst, err)
                lat[n].append(ms)
        launches = ss_mod.segment_sum_kernel.launches
        batches = srv.queue.batches - batches0
    print(f"ffm serving: snapshot {len(snap) / 2**20:.1f} MiB packed in "
          f"{t_pack:.2f} s, pushed and swapped in {t_push:.2f} s; {batches} "
          f"micro-batches, {launches} segment_sum launches; max |score - "
          f"float64 pairwise oracle| {worst:.3e}")
    check(batches > 0 and launches == batches,
          f"segment_sum launched {launches} times for {batches} ffm "
          "micro-batches (want 1 each)")
    for n in REQUEST_ROWS:
        print(f"ffm /score {n:>3} rows: p50 {np.percentile(lat[n], 50):.3f} "
              f"ms, p99 {np.percentile(lat[n], 99):.3f} ms ({len(lat[n])} "
              "requests, host clock)")
    it = ScoringIterator(max_batch=4096, with_field=True, device=dev)
    batch, _ = it.pack(ffm_rows(np.random.default_rng(7), 256))
    rid = batch.row_ids()
    with torch.no_grad():
        c = (ffm.w[clamp_index(batch.index, NUM_FEATURES)]
             * batch.value).contiguous()
    timing = segment_timing(torch, ss_mod, c, rid, batch.batch_size,
                            "served FFM micro-batch")
    return {"launches": launches, "batches": batches, "timing": timing}


# ---- phase 5: the histogram GBDT at Higgs width -------------------------------

# UCI HIGGS (Baldi et al., 2014): 11,000,000 rows x 28 dense float features,
# generated here from a numpy seed; the GBDT at the repo's and XGBoost's
# defaults (20 trees, depth 6, 256 bins, eta 0.3, lambda 1, logistic)
HIGGS_ROWS, HIGGS_FEATURES = 11_000_000, 28
GBDT_KW = dict(num_trees=20, max_depth=6, num_bins=256, learning_rate=0.3,
               lambda_=1.0, objective="logistic")
BINNER_SAMPLE = 1_000_000
PREDICT_ROWS = 100_000
CHECK_DEPTHS = (0, 3, 5)
HIST_TOL = 1e-5  # max |kernel - oracle| <= HIST_TOL * max(1, max |oracle|)
XLA_LOSS_TOL = 1e-4  # |train logloss, kernel fit - index_add fit|
LEAF_TOL = 1e-5  # |leaf - leaf from float64 sums| (eta 0.3, leaves < 1)


def higgs_like(rows: int, seed: int, label: str = "xor") -> tuple:
    """``rows`` x 28 standard-normal f32 features and a 0/1 label.  "xor"
    is bench.py's GBDT label, ``(x0*x1 > 0) ^ (x2 > 0.4)``, which gives no
    feature any marginal signal.  "steps" is a Bernoulli draw from a
    logistic model over threshold terms of seven features and their
    conjunctions, so that (like HIGGS's) seven features carry signal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, HIGGS_FEATURES), dtype=np.float32)
    if label == "xor":
        y = (x[:, 0] * x[:, 1] > 0) ^ (x[:, 2] > 0.4)
        return x, y.astype(np.float32)
    m = (1.5 * (x[:, 0] > 0.0) - 1.0 * (x[:, 1] > 0.5)
         + 1.0 * ((x[:, 2] > -0.3) & (x[:, 3] > 0.2)) + 0.8 * (x[:, 4] > 1.0)
         - 0.6 * (x[:, 5] < -0.8) + 0.5 * ((x[:, 6] > 0) & (x[:, 0] > 0))
         - 0.9)
    y = rng.random(rows, dtype=np.float32) < 1.0 / (1.0 + np.exp(-2.0 * m))
    return x, y.astype(np.float32)


def hist_oracle(bins: np.ndarray, rel: np.ndarray, gh: np.ndarray,
                n_nodes: int, num_bins: int) -> np.ndarray:
    """float64 [n, F, B, 2] histogram by ``np.bincount``, feature by
    feature."""
    rows, F = bins.shape
    out = np.zeros((n_nodes, F, num_bins, 2))
    g = gh.astype(np.float64)
    base = rel.astype(np.int64) * num_bins
    for f in range(F):
        key = base + bins[:, f]
        for lane in range(2):
            out[:, f, :, lane] = np.bincount(
                key, weights=g[:, lane], minlength=n_nodes * num_bins
            ).reshape(n_nodes, num_bins)
    return out


def tree_inputs(torch, model, forest, bins, label):
    """Yield, tree by tree, what a logistic fit with unit weights gave its
    tree builder: (grad, hess) [rows, 2] (times the tree's row mask when
    the model samples rows), each row's node at every depth as (rel,
    n_nodes), each row's leaf, routed through the fitted forest, and the
    features each level could split on (None: all).  Margins add up tree by
    tree as the fit adds them, so the inputs are the fit's own, bit for
    bit."""
    margin = forest["base"].expand(label.shape[0]).clone()
    ones = torch.ones_like(label)
    for t in range(model.num_trees):
        g, h = model._grad_hess(margin, label)
        w_t, col_mask, col_key = model._tree_keys(t, ones)
        gh = torch.stack([g * w_t, h * w_t], dim=-1).contiguous()
        masks = [model._level_feature_mask(col_mask, col_key, d, None)
                 for d in range(model.max_depth)]
        feat, thr = forest["feature"][t], forest["threshold"][t]
        node = torch.zeros(label.shape[0], dtype=torch.int64,
                           device=label.device)
        levels = []
        for d in range(model.max_depth):
            levels.append(((node - (2 ** d - 1)).to(torch.int32)
                           .contiguous(), 2 ** d))
            b = torch.gather(bins, 1, feat[node].long()[:, None])[:, 0]
            node = 2 * node + 1 + (b.to(torch.int32) > thr[node]).long()
        leaf_rel = node - (2 ** model.max_depth - 1)
        yield gh, levels, leaf_rel.to(torch.int32).contiguous(), masks
        margin = margin + forest["leaf"][t][leaf_rel]


def check_hist(torch, hg, name, bins, rel, gh, n, B, layout=None) -> float:
    """Kernel vs plain vs the float64 oracle, and two launches bitwise
    equal.  Returns max |kernel - plain|."""
    a = hg.histogram_gh_kernel(bins, rel, gh, n, B, layout)
    b = hg.histogram_gh_kernel(bins, rel, gh, n, B, layout)
    plain = hg.histogram_gh_plain(bins, rel, gh, n, B)
    torch.cuda.synchronize()
    check(torch.equal(a, b), f"histogram {name}: two launches differ")
    oracle = hist_oracle(bins.cpu().numpy(), rel.cpu().numpy(),
                         gh.cpu().numpy(), n, B)
    tol = HIST_TOL * max(1.0, float(np.abs(oracle).max()))
    err_o = float(np.abs(a.cpu().numpy() - oracle).max())
    err_po = float(np.abs(plain.cpu().numpy() - oracle).max())
    err_p = float((a - plain).abs().max())
    print(f"histogram [{name}] rows={bins.shape[0]} F={bins.shape[1]} B={B} "
          f"n={n} {str(bins.dtype)[6:]}: |kernel-plain| {err_p:.3e}, "
          f"|kernel-oracle| {err_o:.3e}, |plain-oracle| {err_po:.3e}, "
          f"tol {tol:.3e}; two launches bitwise equal")
    check(err_o <= tol and err_p <= tol and err_po <= tol,
          f"histogram {name}: error past {tol}")
    return err_p


# per-level times of the previous design, per-warp f64 histograms, on the
# same shapes (PERF.md's per-level table; H100 80GB HBM3, 700 W)
F64_WARP_DENSE_MS = (3.533, 5.532, 6.391, 12.430, 17.522, 32.784)
F64_WARP_SPARSE_MS = (2.379, 3.418, 4.335, 12.599, 16.860, 29.450)
# per-level times of the previous kernels (before the redesign for few-bin
# columns and small launches) on the same shapes, from their last chip_smoke
# run (PERF.md; H100 80GB HBM3, 700 W); the service cell is the streamed
# shape
PRIOR_MS = {
    "Higgs": (0.751, 0.784, 0.967, 1.138, 1.492, 2.557),
    "Bosch": (1.177, 1.196, 1.227, 1.271, 1.343, 1.462),
    "streamed": (0.309, 0.321, 0.339, 0.368, 0.426, 0.539),
    "Covertype": (0.564, 0.569, 0.524, 0.560, 0.662, 0.700),
    "MSLR": (0.827, 0.872, 0.754, 0.908, 0.990, 1.133),
    "gbdt_train --native-sparse": (0.298, 0.302, 0.309, 0.321, 0.339),
    "gbdt_train --rank": (0.040, 0.040, 0.040, 0.040, 0.041),
    "gbdt_train --missing": (0.098, 0.084, 0.081, 0.082, 0.083),
}
# the previous accumulate halves at the mesh phase's shares (same run), ms
PRIOR_ACCUMULATE_MS = {("histogram_gh", 2): 1.289, ("histogram_gh", 4): 0.325,
                      ("histogram_gh_sparse", 2): 0.752,
                      ("histogram_gh_sparse", 4): 0.452,
                      ("histogram_gh_sparse", "streamed"): 0.271}


def graph_ops(torch, fn):
    """Device operations (kernel and memset nodes) that one call of ``fn``
    queues, from a CUDA graph captured around it on a stream of its own
    (libcuda's ``cuGraphGetNodes``); the reason as text where this torch
    cannot capture it or hand the graph over.  A counting aid: the call
    already ran and was checked outside any capture."""
    import ctypes
    stream = torch.cuda.Stream()
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(stream):
            fn()  # the first call on this stream builds what it keeps
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            fn()
        handle = graph.raw_cuda_graph()
    except (TypeError, RuntimeError) as exc:
        torch.cuda.synchronize()
        return f"not measured ({type(exc).__name__}: {str(exc)[:80]})"
    count = ctypes.c_size_t(0)
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    err = lib.cuGraphGetNodes(handle, None, ctypes.byref(count))
    return int(count.value) if err == 0 else f"not measured (CUresult {err})"


def device_ops(torch, fn) -> list:
    """(name, device us) of each device operation (kernel, memset, copy)
    that one call of ``fn`` queues, from torch.profiler, after a warm-up
    call; a trace with none (its device records lost) is taken again, up
    to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [(re.sub(r"\(anonymous namespace\)::|[(<].*", "", e.key)[:40],
                e.device_time_total / e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               for _ in range(e.count)]
        if ops:
            return ops
    return []


def op_times(torch, fn) -> str:
    """Each device operation of one call of ``fn`` with its device time,
    as text."""
    return "; ".join(f"{name} {us:.1f} us"
                     for name, us in device_ops(torch, fn)) or "no trace"


def ops_line(torch, what: str, fn) -> int:
    """Print and return the device operations of one call of ``fn``: the
    profiler's count and names, and the nodes of a CUDA graph of the call
    (the count where the profiler's trace holds no device records)."""
    ops = device_ops(torch, fn)
    nodes = graph_ops(torch, fn)
    print(f"device ops [{what}, one call]: profiler {len(ops) or 'no trace'}"
          f" (" + ", ".join(name for name, _ in ops)
          + f"); CUDA graph nodes {nodes}")
    return len(ops)


def dense_level_time(torch, hg, bins, rel, gh, n: int, B: int,
                     layout=None) -> tuple:
    """The dense kernel at one level (with the fit's ``layout``): its
    device time beside the plain version, ``index_add`` over the prebuilt
    flattened keys and its bound, and its error against float64 sums by
    ``index_add``.  Returns (the times, the error, the bytes of the bound,
    whether the queue covered the launches)."""
    rows, F = bins.shape
    dev = bins.device
    ms, cov = device_ms(
        torch, lambda: hg.histogram_gh_kernel(bins, rel, gh, n, B, layout),
        20)
    plain_ms, _ = device_ms(
        torch, lambda: hg.histogram_gh_plain(bins, rel, gh, n, B), 1,
        warmup=1)
    keys = ((rel.long()[:, None] * F
             + torch.arange(F, device=dev)) * B + bins.long()).reshape(-1)
    src = gh[:, None, :].expand(rows, F, 2).reshape(-1, 2)
    zeros = torch.zeros(n * F * B, 2, device=dev)
    lib_ms, _ = device_ms(
        torch, lambda: torch.index_add(zeros, 0, keys, src), 3, warmup=1)
    h64 = torch.zeros(n * F * B, 2, dtype=torch.float64, device=dev)
    h64.index_add_(0, keys, src.double())
    err = level_error(hg.histogram_gh_kernel(bins, rel, gh, n, B, layout),
                      h64)
    del keys, src, h64
    nbytes = rows * F + 4 * rows + 8 * rows + 8 * n * F * B
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, 2 * rows * F / F32_OPS_PER_S
    return (dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                 bound_ms=max(byte_s, op_s) * 1e3,
                 bound_by="bytes" if byte_s >= op_s else "operations"),
            err, nbytes, cov)


def subtracted_level_time(torch, hg, bins, rel, parent_rel, gh, n: int,
                          B: int, layout=None) -> tuple:
    """The dense kernel at one level built as a fit builds it below the
    root, by sibling subtraction from its parent level (``parent_rel``,
    n / 2 nodes; the parent's launch not timed): its device time and the
    share of the rows it adds (the child of fewer rows of each pair), with
    its histogram and accumulator checked equal to the full level's bit
    for bit.  Returns (ms, share of rows added)."""
    _, parent = hg.histogram_gh_kernel(bins, parent_rel, gh, n // 2, B,
                                       layout, return_acc=True)
    ms, _ = device_ms(torch, lambda: hg.histogram_gh_kernel(
        bins, rel, gh, n, B, layout, parent=parent), 20)
    got, acc = hg.histogram_gh_kernel(bins, rel, gh, n, B, layout,
                                      parent=parent, return_acc=True)
    want, want_acc = hg.histogram_gh_kernel(bins, rel, gh, n, B, layout,
                                            return_acc=True)
    n_acc = n * bins.shape[1] * B * 2 + 2
    check(torch.equal(got.view(torch.int32), want.view(torch.int32))
          and torch.equal(acc[:n_acc], want_acc[:n_acc]),
          f"histogram at n={n}: the subtracted level is not the full one")
    counts = torch.bincount(rel, minlength=n)
    return ms, float(counts.view(-1, 2).amin(1).sum()) / rel.shape[0]


def level_times(torch, hg, bins, levels, gh, B, layout) -> list:
    """:func:`dense_level_time` at each of a tree's levels, and below the
    root :func:`subtracted_level_time` as ``sub_ms`` and ``built`` (the
    root: its full level, every row); each with its error, bytes and
    coverage."""
    out = []
    for d, (rel, n) in enumerate(levels):
        lv, err, nbytes, cov = dense_level_time(torch, hg, bins, rel, gh, n,
                                                B, layout)
        lv["sub_ms"], lv["built"] = (subtracted_level_time(
            torch, hg, bins, rel, levels[d - 1][0], gh, n, B, layout)
            if d else (lv["ms"], 1.0))
        out.append((lv, err, nbytes, cov))
    return out


def tree_ms(per_level) -> dict:
    """A tree's histogram time, the levels' sum, with every level in full
    and with the levels below the root subtracted (the kernels line)."""
    return {"tree_ms": float(sum(lv["ms"] for lv in per_level)),
            "tree_ms_subtracted": float(sum(lv["sub_ms"]
                                            for lv in per_level))}


def subtraction_text(lv) -> str:
    return (f"; subtracted {lv['sub_ms']:.4f} ms ({100 * lv['built']:.1f}% "
            f"of rows added)")


def level_error(h32, h64) -> float:
    """max |f32 histogram - float64 sums| relative to max(1, the largest
    float64 bin)."""
    h64 = h64.reshape(h32.shape)
    return float((h32.double() - h64).abs().max()) / max(
        1.0, float(h64.abs().max()))


def print_level(what, d, n, lv, before_ms, err, nbytes, cov,
                prior_ms) -> None:
    print(f"time [{what}, depth {d}, n={n}]: kernel {lv['ms']:.3f} ms "
          f"(previous kernel: {prior_ms:.3f}; per-warp f64 kernel: "
          f"{before_ms:.3f}), plain "
          f"{lv['plain_ms']:.1f} ms, index_add {lv['library_ms']:.3f} ms, bound {lv['bound_ms']:.4f} ms "
          f"({nbytes} bytes, {lv['bound_by']}); |kernel - float64| "
          f"{err:.3e} of the largest bin; queue covered: {cov}"
          + (subtraction_text(lv) if "sub_ms" in lv else ""))


def level_summary(what, per_level, before_ms=None, prior_ms=None) -> None:
    ms = [lv["ms"] for lv in per_level]
    lib = [lv["library_ms"] for lv in per_level]
    if "sub_ms" in per_level[0]:
        sub = [lv["sub_ms"] for lv in per_level]
        print(f"{what} a tree (the levels' sum): {sum(ms):.4f} ms in full, "
              f"{sum(sub):.4f} ms with the levels below the root "
              f"subtracted ({sum(sub) / sum(ms):.3f}); rows added "
              f"{100 * np.mean([lv['built'] for lv in per_level[1:]]):.1f}% "
              "a level below the root")
    old = ([f"previous kernel: {np.mean(prior_ms):.4f}"] if prior_ms else []) + (
        [f"per-warp f64 kernel: {np.mean(before_ms):.3f}"] if before_ms
        else [])
    print(f"{what} per level: mean {np.mean(ms):.4f} ms ("
          + ", ".join(old + [f"index_add {np.mean(lib):.4f}"]) + "); "
          + "".join(f"faster than {name} at depths {[d for d, (a, b) in enumerate(zip(ms, ref)) if a < b]}, "
                    for name, ref in (("the previous kernel", prior_ms),
                                      ("the per-warp f64 kernel", before_ms))
                    if ref)
          + f"than index_add at depths "
          f"{[d for d, (a, b) in enumerate(zip(ms, lib)) if a < b]}")


def check_leaf_sums(torch, ss_mod, gh, leaf_rel, n_leaves,
                    what: str = "leaf sums") -> dict:
    """The segment-sum kernel at a GBDT's leaf-sum (or node-total) shape
    (every row's (grad, hess) into its leaf or node), on a fit's own inputs:
    against its plain version and a float64 ``bincount`` oracle, two
    launches bitwise equal, and its time beside the plain version,
    ``index_add`` and its bound."""
    kernel, plain = ss_mod.segment_sum_kernel, ss_mod.segment_sum_plain
    a = kernel(gh, leaf_rel, n_leaves)
    b = kernel(gh, leaf_rel, n_leaves)
    want = plain(gh, leaf_rel, n_leaves)
    torch.cuda.synchronize()
    check(torch.equal(a, b), f"{what}: two launches differ")
    rel, g = leaf_rel.cpu().numpy(), gh.cpu().numpy().astype(np.float64)
    oracle = np.stack([np.bincount(rel, weights=g[:, lane],
                                   minlength=n_leaves) for lane in (0, 1)], 1)
    tol = HIST_TOL * max(1.0, float(np.abs(oracle).max()))
    err_o = float(np.abs(a.cpu().numpy() - oracle).max())
    err_po = float(np.abs(want.cpu().numpy() - oracle).max())
    err_p = float((a - want).abs().max())
    nnz = gh.shape[0]
    zeros = torch.zeros(n_leaves, 2, device=gh.device)
    idx = leaf_rel.long()
    ms, cov = device_ms(torch, lambda: kernel(gh, leaf_rel, n_leaves), 20)
    plain_ms, _ = device_ms(torch, lambda: plain(gh, leaf_rel, n_leaves), 2,
                            warmup=1)
    lib_ms, _ = device_ms(torch, lambda: torch.index_add(zeros, 0, idx, gh),
                          20)
    nbytes = 4 * (2 * nnz + nnz + 2 * n_leaves)
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, 2 * nnz / F32_OPS_PER_S
    bound_ms = max(byte_s, op_s) * 1e3
    print(f"{what} [segment_sum, first tree] nnz={nnz} L=2 "
          f"segments={n_leaves}: |kernel-plain| {err_p:.3e}, |kernel-oracle| "
          f"{err_o:.3e}, |plain-oracle| {err_po:.3e}, tol {tol:.3e}; two "
          f"launches bitwise equal; kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, index_add {lib_ms:.3f} ms, bound {bound_ms:.4f} ms ({nbytes} "
          f"bytes); queue covered: {cov}")
    check(err_o <= tol and err_p <= tol and err_po <= tol,
          f"{what}: error past {tol}")
    return dict(max_abs_err=err_p, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms,
                bound_by="bytes" if byte_s >= op_s else "operations")


def segment_share(events, busy_ms: float) -> None:
    """Print the segment-sum kernel's device time in a profiled tree and
    its share of the device's busy time."""
    seg = [e for e in events if "seg_fixed" in e.key]
    ms = sum(e.device_time_total for e in seg) / 1e3
    print(f"  segment_sum: {ms:.3f} ms in {sum(e.count for e in seg)} "
          f"launches, {100 * ms / max(busy_ms, 1e-9):.1f}% of busy")


def tree_losses(torch, model, forest, bins, label) -> list:
    """Train logloss after 0, 1, ..., num_trees trees."""
    from dmlc_core_tpu_torch.models import logistic_nll
    m = forest["base"].expand(label.shape[0]).clone()
    losses = [float(logistic_nll(m, label).mean())]
    for i in range(model.num_trees):
        m += model._tree_margins(forest["feature"][i],
                                 forest["threshold"][i],
                                 forest["default_right"][i],
                                 forest["leaf"][i], bins)
        losses.append(float(logistic_nll(m, label).mean()))
    return losses


def predict_oracle(forest: dict, bins: np.ndarray, depth: int) -> np.ndarray:
    """float64 probabilities: every row routed through every tree in
    numpy."""
    feat = forest["feature"].cpu().numpy()
    thr = forest["threshold"].cpu().numpy()
    leaf = forest["leaf"].cpu().numpy().astype(np.float64)
    rows = np.arange(bins.shape[0])
    m = np.full(bins.shape[0], float(forest["base"]))
    for t in range(feat.shape[0]):
        node = np.zeros(bins.shape[0], np.int64)
        for _ in range(depth):
            node = 2 * node + 1 + (bins[rows, feat[t, node]] > thr[t, node])
        m += leaf[t, node - (2 ** depth - 1)]
    return 1.0 / (1.0 + np.exp(-m))


def fit_timed(torch, hg, ss_mod, model, bins, label) -> tuple:
    """One fit of the main path, with the launch counts set to 0 just
    before it and read just after.  Returns (forest, seconds, histogram
    launches, segment-sum launches, peak device memory of the fit in
    bytes, row-draw launches, levels built by subtraction, route-kernel
    launches)."""
    from dmlc_core_tpu_torch.ops import draws
    from dmlc_core_tpu_torch.ops.route import route_dense_kernel
    route_dense_kernel.launches = 0
    hg.histogram_gh_kernel.launches = 0
    hg.histogram_gh_kernel.subtracted = 0
    ss_mod.segment_sum_kernel.launches = 0
    draws.sample_weights.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    forest = model.fit(bins, label)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    return (forest, secs, hg.histogram_gh_kernel.launches,
            ss_mod.segment_sum_kernel.launches,
            torch.cuda.max_memory_allocated(), draws.sample_weights.launches,
            hg.histogram_gh_kernel.subtracted, route_dense_kernel.launches)


# stochastic boosting: rows and columns drawn from jax.random's threefry
# stream (the port's dmlc_core_tpu_torch.random), XGBoost's usual 0.8s
SAMPLE_KW = dict(subsample=0.8, colsample_bytree=0.8, colsample_bylevel=0.8,
                 seed=7)
KEEP_TOL = 0.01  # |a tree's kept share of rows - subsample|


def check_draws(torch, model, rows: int, what: str) -> list:
    """The card's draws for every tree of ``model`` against the same draws
    on CPU tensors, bit for bit (integer arithmetic): the row mask (as the
    weights it leaves), the tree's column mask, every level's mask.
    Returns each tree's share of rows kept."""
    from dmlc_core_tpu_torch.models import GBDT
    cpu = GBDT(num_features=model.num_features, num_trees=model.num_trees,
               max_depth=model.max_depth, device="cpu", **SAMPLE_KW)
    ones_d, ones_c = torch.ones(rows, device=model.device), torch.ones(rows)
    t0 = time.monotonic()
    shares, cols = [], []
    for t in range(model.num_trees):
        wd, cd, kd = model._tree_keys(t, ones_d)
        wc, cc, kc = cpu._tree_keys(t, ones_c)
        check(torch.equal(wd.cpu(), wc) and torch.equal(cd.cpu(), cc)
              and torch.equal(kd.cpu(), kc),
              f"{what} tree {t}: card draws differ from the CPU's")
        for d in range(model.max_depth):
            check(torch.equal(model._level_feature_mask(cd, kd, d, None)
                              .cpu(), cpu._level_feature_mask(cc, kc, d,
                                                              None)),
                  f"{what} tree {t} depth {d}: level mask differs")
        shares.append(float(wd.mean()))
        cols.append(int(cd.sum()))
    print(f"{what} sampled draws: {model.num_trees} trees x {rows} rows, "
          f"row masks, column masks and {model.max_depth} level masks a tree"
          f" equal on the card and the CPU bit for bit "
          f"({time.monotonic() - t0:.1f} s); "
          f"rows kept {min(shares):.4f}-{max(shares):.4f} (mean "
          f"{np.mean(shares):.4f}), columns a tree {sorted(set(cols))}")
    check(all(abs(x - model.subsample) <= KEEP_TOL for x in shares),
          f"{what}: kept shares {shares}")
    return shares


# shifts and logic a row that only the integer ALU pipe runs: threefry.cu's
# SASS has 85 LOP3 and 82 SHF for the 4 rows a thread takes (its 20
# rotations, 21 xors and the uniform's shift and or, with some merged into
# three-input LOP3s); its adds may go to the FMA pipe as IMAD
DRAW_ALU_OPS = (85 + 82) / 4
ALU_OPS_S = 132 * 64 * 1.98e9  # H100 SXM: 64 ALU lanes an SM at 1.98 GHz


def time_draws(torch, dev) -> dict:
    """The row-draw kernel (``ops.draws.sample_weights``) at Higgs's 11M
    rows, without and with an index past 2^32: its ptxas report, its output
    against the plain version bit for bit, both device times beside the
    bound (the hash's ALU-only operations or the bytes, the larger), and
    the host column draw's time at 28 and 968 features.  Returns the
    unindexed timing."""
    from dmlc_core_tpu_torch import random as tr
    from dmlc_core_tpu_torch.ops import _build, draws
    for line in _build.build_log("threefry").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  threefry ptxas: {line.strip()}")
    key = tr.fold_in(tr.PRNGKey(3_100_000_007, device="cpu"), 0)
    n = HIGGS_ROWS
    w = torch.rand(n, device=dev)
    out = {}
    for index in (None, torch.arange(n, device=dev) + (2 ** 32 - n // 2)):
        what = "indexed" if index is not None else "rows"
        got = draws.sample_weights(key, 0.8, w, index)
        want = draws.sample_weights_plain(key, 0.8, w, index)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"sample_weights ({what}) differs from its plain version")
        k_ms, covered = device_ms(
            torch, lambda: draws.sample_weights(key, 0.8, w, index), 200)
        p_ms, _ = device_ms(
            torch, lambda: draws.sample_weights_plain(key, 0.8, w, index),
            5, warmup=1)
        byte_s = n * (8 if index is None else 16) / HBM_BYTES_PER_S
        op_s = n * DRAW_ALU_OPS / ALU_OPS_S
        bound_ms = max(byte_s, op_s) * 1e3
        print(f"row draws {what}, {n} rows: kernel {k_ms:.4f} ms (queued "
              f"back to back: {covered}), plain {p_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms (bytes {byte_s * 1e3:.4f}, hash "
              f"{op_s * 1e3:.4f}), {100 * bound_ms / k_ms:.1f}% of it")
        out.setdefault("ms", k_ms)
        out.setdefault("plain_ms", p_ms)
        out.setdefault("bound_ms", bound_ms)
        out.setdefault("bound_by", "bytes" if byte_s >= op_s
                       else "operations")
    for F in (HIGGS_FEATURES, 968):
        key = tr.fold_in(tr.PRNGKey(3_100_000_007, device="cpu"), 1)
        draws.column_mask(key, F, round(0.8 * F), dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(200):
            draws.column_mask(key, F, round(0.8 * F), dev)
        host_ms = (time.monotonic() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        print(f"column draw, {F} features: {host_ms:.4f} ms a draw on the "
              f"host")
    return {**out, "max_abs_err": 0.0, "library_ms": None}


ROUTE_SHAPES = (  # (what, rows, features, first level, levels walked)
    ("Higgs training level at depth 5", HIGGS_ROWS, HIGGS_FEATURES, 5, 1),
    ("Covertype training level at depth 5", 435_759, 54, 5, 1),
    ("Covertype eval walk, 6 levels", 145_253, 54, 0, 6))


def route_bound_ms(rows: int, F: int, code_bytes: int, first: int,
                   levels: int) -> float:
    """The route kernel's bound: each row's node read (not for a walk from
    the root) and written once, and at each level walked the 32-byte
    sector of the row's codes that holds its split feature's code, but
    no more than the whole row once, at 3.35 TB/s."""
    row_bytes = (4 if first else 0) + 4 + min(levels * 32, F * code_bytes)
    return rows * row_bytes / HBM_BYTES_PER_S * 1e3


def phase_route(torch, dev) -> dict:
    """The route kernel (``ops.route.route_dense_kernel``) at the dense
    fits' shapes: a Higgs and a Covertype training level at depth 5 and
    Covertype's held-out walk of a whole depth-6 tree.  Random uint8 codes
    and split tables (a fifth of the nodes unsplit), rows spread over the
    level's nodes; the kernel's output equals the plain version's bit for
    bit with and without ``missing_aware``, and its device time is printed
    beside its bound and the plain version's.  Returns the Higgs level's
    timing."""
    from dmlc_core_tpu_torch.ops import _build
    from dmlc_core_tpu_torch.ops.route import (route_dense_kernel,
                                               route_dense_plain)
    _build.build("route_dense")
    for line in _build.build_log("route_dense").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  route_dense ptxas: {line.strip()}")
    g = torch.Generator(device=dev).manual_seed(2_718_281_829)
    out = {}
    for what, rows, F, first, levels in ROUTE_SHAPES:
        bins = torch.randint(0, 256, (rows, F), generator=g, device=dev,
                             dtype=torch.uint8)
        n = 2 ** 6 - 1
        tables = [torch.randint(0, top, (n,), generator=g, device=dev,
                                dtype=torch.int32) for top in (F, 256, 2)]
        null = torch.rand(n, generator=g, device=dev) < 0.2
        for t, v in zip(tables, (0, 256, 0)):
            t[null] = v
        lo, hi = 2 ** first - 1, 2 ** (first + levels) - 1
        walk = [t[lo:hi].contiguous() for t in tables]
        rel = (torch.randint(0, 2 ** first, (rows,), generator=g, device=dev,
                             dtype=torch.int32) if first else None)
        for missing in (False, True):
            got = route_dense_kernel(bins, rel, *walk, first, levels,
                                     missing)
            want = route_dense_plain(bins, rel, *walk, first, levels,
                                     missing)
            check(torch.equal(got, want), f"route_dense ({what}, "
                  f"missing_aware={missing}) differs from its plain version")
        k_ms, covered = device_ms(torch, lambda: route_dense_kernel(
            bins, rel, *walk, first, levels, False), 200)
        p_ms, _ = device_ms(torch, lambda: route_dense_plain(
            bins, rel, *walk, first, levels, False), 20, warmup=2)
        bound_ms = route_bound_ms(rows, F, 1, first, levels)
        print(f"route {what}, {rows} x {F}: kernel {k_ms:.4f} ms (queued "
              f"back to back: {covered}), plain {p_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms, {k_ms / bound_ms:.2f}x the bound")
        if not out:
            out = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                   "bound_by": "bytes", "library_ms": None,
                   "max_abs_err": 0.0}
    return out


def phase_gbdt(torch, ss_mod, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from dmlc_core_tpu_torch import telemetry
    from dmlc_core_tpu_torch.models import GBDT, QuantileBinner
    from dmlc_core_tpu_torch.ops import histogram as hg
    rows, F, B = HIGGS_ROWS, HIGGS_FEATURES, GBDT_KW["num_bins"]
    depth, trees = GBDT_KW["max_depth"], GBDT_KW["num_trees"]

    t0 = time.monotonic()
    x, y = higgs_like(rows, seed=2014)
    t_gen = time.monotonic() - t0
    t0 = time.monotonic()
    binner = QuantileBinner(num_bins=B, device=dev).fit(x[:BINNER_SAMPLE])
    t_sketch = time.monotonic() - t0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    bins = binner.transform(torch.from_numpy(x).to(dev))
    label = torch.from_numpy(y).to(dev)
    torch.cuda.synchronize()
    t_bin = time.monotonic() - t0
    cuts = binner.cuts.cpu().numpy()
    want = np.stack([np.searchsorted(cuts[f], x[:PREDICT_ROWS, f],
                                     side="right") for f in range(F)], 1)
    check(np.array_equal(bins[:PREDICT_ROWS].cpu().numpy(), want),
          "binner codes differ from numpy searchsorted")
    del x
    print(f"gbdt data: {rows} x {F} Higgs-width rows, {y.mean():.3f} "
          f"positive; generate {t_gen:.1f} s (host), sketch of "
          f"{BINNER_SAMPLE} rows {t_sketch:.1f} s (host), copy + binning on "
          f"the card {t_bin:.2f} s; codes {bins.dtype} "
          f"{tuple(bins.shape)} = {bins.numel() / 1e6:.0f} MB")

    model = GBDT(num_features=F, device=dev, **GBDT_KW)  # histogram="auto"
    warm, t_warm, *_ = fit_timed(torch, hg, ss_mod, model, bins, label)

    # the kernel against its plain version and a float64 oracle, on the
    # first tree's own level inputs, plus the op surface's edges
    gh, levels, leaf_rel, _ = next(tree_inputs(torch, model, warm, bins,
                                               label))
    leaf = check_leaf_sums(torch, ss_mod, gh, leaf_rel, 2 ** depth)
    layout = hg.dense_hist_layout(bins, B)  # as the fit builds it
    max_err = 0.0
    for d in CHECK_DEPTHS:
        rel, n = levels[d]
        max_err = max(max_err, check_hist(torch, hg, f"Higgs depth {d}",
                                          bins, rel, gh, n, B, layout))
    rng = np.random.default_rng(9)
    for name, (r, f, b, n, dt) in {
            "1024 bins": (200_000, 5, 1024, 4, torch.int32),
            "512 nodes": (1_000_000, F, B, 512, torch.uint8)}.items():
        cb = torch.from_numpy(rng.integers(0, b, (r, f)).astype(np.int32))
        cr = torch.from_numpy(rng.integers(0, n, r).astype(np.int32))
        cg = torch.from_numpy(rng.standard_normal((r, 2)).astype(np.float32))
        max_err = max(max_err, check_hist(
            torch, hg, name, cb.to(dt).to(dev).contiguous(), cr.to(dev),
            cg.to(dev), n, b))

    # time per launch at each level of the first tree, beside the previous
    # kernel's, its bound, the plain version and index_add over the
    # prebuilt flattened keys; the error against float64 sums by index_add
    # at every level
    per_level = []
    for d, (lv, err, nbytes, cov) in enumerate(level_times(
            torch, hg, bins, levels, gh, B, layout)):
        n = levels[d][1]
        per_level.append(lv)
        print_level("histogram", d, n, per_level[-1], F64_WARP_DENSE_MS[d], err,
                    nbytes, cov, PRIOR_MS["Higgs"][d])
        check(err <= HIST_TOL, f"histogram depth {d}: {err} of the largest "
              "bin from float64")
    level_summary("histogram", per_level, F64_WARP_DENSE_MS, PRIOR_MS["Higgs"])
    rel, n = levels[-1]
    ops_line(torch, "histogram_gh, Higgs depth 5",
             lambda: hg.histogram_gh_kernel(bins, rel, gh, n, B, layout))
    del gh, levels, leaf_rel

    # the main path: two timed fits of the same forest
    fits = [fit_timed(torch, hg, ss_mod, model, bins, label)
            for _ in range(2)]
    forest = fits[0][0]
    for f_i, secs, h_l, s_l, peak, d_l, sub_l, r_l in fits:
        print(f"gbdt fit: {secs:.3f} s wall, {rows * trees / secs:.0f} "
              f"row_trees_s; launches: histogram_gh {h_l} ({sub_l} levels "
              f"subtracted, gbdt.hist_built_permille "
              f"{telemetry.gauge_get('gbdt.hist_built_permille')}), "
              f"segment_sum {s_l}, route_dense {r_l}; peak device memory "
              f"of the fit "
              f"{peak / 2**30:.2f} GiB (codes {bins.numel() / 2**30:.2f} GiB)")
        check(h_l == trees * depth, f"histogram_gh launched {h_l} times in "
              f"a fit (want {trees * depth})")
        check(sub_l == trees * (depth - 1), f"{sub_l} levels subtracted in "
              f"a fit (want {trees * (depth - 1)})")
        check(s_l == trees, f"segment_sum launched {s_l} times in a fit "
              f"(want {trees}: one leaf sum a tree)")
        check(r_l == trees * depth, f"route_dense launched {r_l} times in "
              f"a fit (want {trees * depth}: one a level)")
        check(d_l == 0, f"an unsampled fit launched the row draw {d_l} "
              "times")
        check(all(torch.equal(f_i[k], forest[k]) and
                  torch.equal(warm[k], forest[k]) for k in forest),
              "two fits gave different forests")
    print(f"gbdt: warm-up fit {t_warm:.3f} s; three fits bitwise identical")
    # the same fit with every level built in full
    full = GBDT(num_features=F, device=dev, **GBDT_KW)
    full._SUBTRACT = False
    f_full, t_full, h_full, *_, sub_full, _ = [
        fit_timed(torch, hg, ss_mod, full, bins, label) for _ in range(2)][1]
    check(sub_full == 0 and h_full == trees * depth
          and all(torch.equal(f_full[k], forest[k]) for k in forest),
          "the fit with every level in full differs from the subtracted fit")
    print(f"gbdt fit, every level in full: {t_full:.3f} s wall, "
          f"{rows * trees / t_full:.0f} row_trees_s (subtracted: "
          f"{fits[1][1]:.3f} s, {t_full / fits[1][1]:.3f} x faster); forest "
          "bitwise the subtracted fit's")
    del full, f_full
    losses = tree_losses(torch, model, forest, bins, label)
    print("gbdt train logloss after 0/1/5/10/20 trees: " + ", ".join(
        f"{losses[i]:.6f}" for i in (0, 1, 5, 10, trees)))
    check(all(b < a for a, b in zip(losses, losses[1:])),
          "train logloss did not fall with every tree")
    loss_k = float(model.loss(forest, bins, label))
    check(abs(loss_k - losses[-1]) <= 1e-6, "loss() disagrees with the "
          "tree-by-tree margins")

    # the same fit on the index_add backend
    xla = GBDT(num_features=F, device=dev, histogram="xla", **GBDT_KW)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    forest_x = xla.fit(bins, label)
    torch.cuda.synchronize()
    t_xla = time.monotonic() - t0
    loss_x = float(xla.loss(forest_x, bins, label))
    real = forest["threshold"] < B
    node_differs = ((forest["feature"] != forest_x["feature"])
                    | (forest["threshold"] != forest_x["threshold"]))
    differ = int(node_differs.sum())
    tree_differs = node_differs.any(dim=1).nonzero()
    first = int(tree_differs[0]) if tree_differs.numel() else None
    print(f"gbdt index_add fit: {t_xla:.3f} s wall, "
          f"{rows * trees / t_xla:.0f} row_trees_s; {differ} of "
          f"{forest['feature'].numel()} split nodes differ from the kernel "
          f"fit ({int(real.sum())} real splits there; first differing "
          f"tree: {first}); train logloss "
          f"{loss_x:.7f} vs {loss_k:.7f}")
    check(abs(loss_x - loss_k) <= XLA_LOSS_TOL,
          f"index_add fit logloss {loss_x} vs kernel fit {loss_k}")

    # every level and split of both fits against float64 on their own
    # inputs; the kernel fit's must hold, the index_add fit's are read
    for name, m, f, force in (("kernel", model, forest, "pallas"),
                              ("index_add", xla, forest_x, "xla")):
        a = split_audit(torch, hg, m, f, bins, label, force)
        print(f"gbdt audit [{name} fit, every level of {trees} trees]: "
              f"histogram vs float64 {a['hist_err']:.3e} of the largest "
              f"bin; {a['off_best']} of {a['nodes']} splits off the float64 "
              f"best, {a['beyond']} beyond rounding (worst regret/noise "
              f"{a['worst']:.2f}); replay mismatches {a['replay']}; |leaf - "
              f"float64 leaf| {a['leaf_err']:.3e}, leaf/float64 leaf - 1 "
              f"{a['leaf_scale']:+.3e}")
        if name == "kernel":
            check(a["hist_err"] <= HIST_TOL and a["beyond"] == 0
                  and a["replay"] == 0 and a["leaf_err"] <= LEAF_TOL,
                  f"kernel fit audit: {a}")

    # sampled forests: the same fit drawing rows and columns (subsample,
    # colsample_bytree, colsample_bylevel)
    sm = GBDT(num_features=F, device=dev, **GBDT_KW, **SAMPLE_KW)
    sfits = [fit_timed(torch, hg, ss_mod, sm, bins, label) for _ in range(2)]
    sforest = sfits[0][0]
    check(all(torch.equal(sfits[1][0][k], sforest[k]) for k in sforest),
          "two sampled fits gave different forests")
    check(not torch.equal(sforest["feature"], forest["feature"]),
          "the sampled forest equals the unsampled one")
    check(all(f[5] == trees for f in sfits), "the row draw launched "
          f"{[f[5] for f in sfits]} times in the sampled fits (want {trees}:"
          " one a tree)")
    check_draws(torch, sm, rows, "gbdt")
    draw = {**time_draws(torch, dev), "launches": sfits[0][5]}
    s_losses = tree_losses(torch, sm, sforest, bins, label)
    a = split_audit(torch, hg, sm, sforest, bins, label, "pallas")
    print(f"gbdt sampled fit ({SAMPLE_KW}): {sfits[0][1]:.3f} / "
          f"{sfits[1][1]:.3f} s wall (unsampled {fits[0][1]:.3f}), two fits "
          f"bitwise equal, launches histogram_gh {sfits[0][2]}, segment_sum "
          f"{sfits[0][3]}, threefry {sfits[0][5]}; train logloss after 20 "
          f"trees {s_losses[-1]:.6f} "
          f"(unsampled {losses[-1]:.6f}); audit over the sampled features: "
          f"histogram vs float64 {a['hist_err']:.3e}, {a['off_best']} of "
          f"{a['nodes']} splits off the float64 best, {a['beyond']} beyond "
          f"rounding, replay mismatches {a['replay']}, |leaf - float64 leaf| "
          f"{a['leaf_err']:.3e}")
    check(a["hist_err"] <= HIST_TOL and a["beyond"] == 0 and a["replay"] == 0
          and a["leaf_err"] <= LEAF_TOL, f"sampled fit audit: {a}")
    check(s_losses[-1] < s_losses[0], "the sampled fit's loss did not fall")
    del sfits, sforest

    # predict against a float64 numpy routing of the same forest
    pb = bins[:PREDICT_ROWS]
    got = model.predict(forest, pb)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = model.predict(forest, pb)
    torch.cuda.synchronize()
    t_pred = time.monotonic() - t0
    err = float(np.abs(got.cpu().numpy().astype(np.float64) - predict_oracle(
        forest, pb.cpu().numpy(), depth)).max())
    print(f"gbdt predict: {PREDICT_ROWS} rows in {t_pred * 1e3:.2f} ms "
          f"(host clock), max |p - float64 oracle| {err:.3e}")
    check(err <= 1e-5, f"predict error {err}")

    # where one tree's time goes on the card
    one = GBDT(num_features=F, device=dev,
               **{**GBDT_KW, "num_trees": 1})
    one.fit(bins, label)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        one.fit(bins, label)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    dev_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"profile [one tree, under the profiler]: wall {wall_ms:.2f} ms, "
          f"device busy {dev_ms:.2f} ms ({100 * dev_ms / wall_ms:.1f}%), "
          f"{len(events)} kernel kinds")
    if not events:
        print("  device time: not measured (no CUDA events in the trace)")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:10]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:<4} "
              f"{e.key[:90]}")
    segment_share(events, dev_ms)
    mean = {k: float(np.mean([lv[k] for lv in per_level]))
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"launches": fits[0][2], "max_abs_err": max_err,
            "bound_by": per_level[0]["bound_by"], **mean,
            **tree_ms(per_level),
            "leaf": {**leaf, "launches": fits[0][3]},
            "bins": bins, "label": label, "forest": forest,
            "fit_s": fits[0][1], "draws": draw,
            "route_launches": fits[0][7]}


# ---- phase 6: the sparse GBDT (fit_batch) at Bosch width ---------------------

# Kaggle Bosch Production Line Performance, train_numeric: 1,183,747 rows x
# 968 numeric features, ~81% of cells missing, values to 3 decimals (the
# sparse set of XGBoost's GPU-hist benchmarks, Mitchell et al. 2018).  Made
# here on the card from a torch.Generator seed: 52 "stations" of ~19
# features present or absent together per row; same model as the Higgs fit,
# missing-aware
BOSCH_ROWS, BOSCH_FEATURES, BOSCH_STATIONS = 1_183_747, 968, 52
BOSCH_DENSITY = 0.19  # train_numeric's share of cells present
BOSCH_SKETCH_ROWS = 50_000
BOSCH_CHUNK = 131_072  # rows generated (and densified) at a time
SPARSE_REQUEST_ROWS = (1, 7, 64)


def bosch_like(torch, dev, seed: int = 2016) -> dict:
    """A Bosch-width CSR batch on the card.  Station s is present in a row
    with probability p_s (drawn in [0.02, 0.36], then scaled so that the
    expected share of cells present is ``BOSCH_DENSITY``), and then all of
    its features are; a value is N(0, scale_f^2) rounded to 3 decimals (a
    rounded 0 becomes 0.001, since a stored 0 reads as missing).  Label: a
    Bernoulli draw from a logistic model over the presence and the values
    of one feature of each of the six most present stations, so that
    missingness, thresholds and default directions all carry signal."""
    g = torch.Generator(device=dev).manual_seed(seed)
    R, F, S = BOSCH_ROWS, BOSCH_FEATURES, BOSCH_STATIONS
    station = torch.as_tensor(np.repeat(np.arange(S), [
        len(c) for c in np.array_split(np.arange(F), S)]), device=dev)
    p = 0.02 + 0.34 * torch.rand(S, generator=g, device=dev)
    p *= BOSCH_DENSITY * F / float(p[station].sum())
    scale = 0.05 + 0.45 * torch.rand(F, generator=g, device=dev)
    lab = [int((station == s).nonzero()[0])
           for s in torch.argsort(p, descending=True)[:6]]
    counts, index, value = [], [], []
    cols = [[] for _ in lab]
    for r0 in range(0, R, BOSCH_CHUNK):
        n = min(BOSCH_CHUNK, R - r0)
        present = (torch.rand(n, S, generator=g, device=dev) < p)[:, station]
        counts.append(present.sum(1))
        r, f = present.nonzero(as_tuple=True)
        v = torch.round(torch.randn(r.numel(), generator=g, device=dev)
                        * scale[f] * 1000) / 1000
        v = torch.where(v == 0, 0.001, v)
        index.append(f.to(torch.int32))
        value.append(v)
        for col, fx in zip(cols, lab):
            c = torch.full((n,), torch.nan, device=dev)
            c[r[f == fx]] = v[f == fx]
            col.append(c)
    x = [torch.cat(c) / scale[fx] for c, fx in zip(cols, lab)]
    miss = [torch.isnan(c) for c in x]
    m = (1.2 * miss[0] + 1.5 * (x[0] > 0.5) - 1.0 * ~miss[1]
         + 0.8 * (x[2] > 0) - 0.9 * (x[3] < -0.5) + 0.7 * (miss[4] & ~miss[5])
         + 0.6 * (x[5] > 1.0) - 0.8)
    y = torch.rand(R, generator=g, device=dev) < torch.sigmoid(2 * m)
    row_ptr = torch.zeros(R + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(torch.cat(counts), 0)
    return dict(label=y.to(torch.float32), row_ptr=row_ptr,
                index=torch.cat(index), value=torch.cat(value),
                rule=m > 0)


def sparse_tree_inputs(torch, model, forest, ent, label):
    """Yield, tree by tree, what a logistic fit with unit weights gave its
    sparse tree builder: gh_row [rows, 2], (rel, n_nodes) at every depth
    and each row's leaf, routed by sparse routing through the fitted forest
    (the dense missing-aware route sends every row the same way), margins
    added tree by tree as the fit adds them; then the tree's feature draws
    (``col_mask``, ``col_key``; None without sampling)."""
    rows = label.shape[0]
    rid, fi, ebin, emask = ent[:4]
    margin = forest["base"].expand(rows).clone()
    ones = torch.ones_like(label)
    for t in range(model.num_trees):
        g, h = model._grad_hess(margin, label)
        w_t, col_mask, col_key = model._tree_keys(t, ones)
        gh = torch.stack([g * w_t, h * w_t], dim=-1).contiguous()
        feat, thr = forest["feature"][t], forest["threshold"][t]
        dflt = forest["default_right"][t]
        node = torch.zeros(rows, dtype=torch.int64, device=label.device)
        levels = []
        for d in range(model.max_depth):
            levels.append(((node - (2 ** d - 1)).to(torch.int32)
                           .contiguous(), 2 ** d))
            right = model._route_sparse(fi, ebin, emask, rid, feat[node],
                                        thr[node], dflt[node], rows)
            node = 2 * node + 1 + right.to(torch.int64)
        leaf_rel = node - (2 ** model.max_depth - 1)
        yield (gh, levels, leaf_rel.to(torch.int32).contiguous(), col_mask,
               col_key)
        margin = margin + forest["leaf"][t][leaf_rel]


def sparse_oracle64(torch, layout, rel_e, gh_e, n, F, B):
    """float64 [n, F, B, 2] histogram of the layout's entries by
    ``index_add``."""
    gk = layout.gkey.long()
    keys = (rel_e.long() * F + gk // layout.nb) * B + gk % layout.nb
    out = torch.zeros(n * F * B, 2, dtype=torch.float64, device=gh_e.device)
    out.index_add_(0, keys, gh_e.double())
    return out.reshape(n, F, B, 2)


def check_sparse_hist(torch, hs, name, gkey, rel_e, gh_e, starts, n, F, B,
                      oracle) -> tuple:
    """Kernel vs plain vs the float64 oracle, two launches bitwise equal,
    bin 0 exactly 0.  Returns (max |kernel - plain|, the plain result)."""
    a = hs.histogram_gh_sparse_kernel(gkey, rel_e, gh_e, starts, n, F, B)
    b = hs.histogram_gh_sparse_kernel(gkey, rel_e, gh_e, starts, n, F, B)
    plain = hs.histogram_gh_sparse_plain(gkey, rel_e, gh_e, starts, n, F, B)
    torch.cuda.synchronize()
    check(torch.equal(a, b), f"sparse histogram {name}: two launches differ")
    tol = HIST_TOL * max(1.0, float(oracle.abs().max()))
    err_o = float((a.double() - oracle).abs().max())
    err_po = float((plain.double() - oracle).abs().max())
    err_p = float((a - plain).abs().max())
    print(f"sparse histogram [{name}] nnz={gkey.shape[0]} F={F} B={B} n={n}:"
          f" |kernel-plain| {err_p:.3e}, |kernel-oracle| {err_o:.3e}, "
          f"|plain-oracle| {err_po:.3e}, tol {tol:.3e}; two launches bitwise"
          " equal")
    check(err_o <= tol and err_p <= tol and err_po <= tol,
          f"sparse histogram {name}: error past {tol}")
    return err_p, plain


def missing_aware_gains(torch, present, node, lam, mcw):
    """[n, F, B, 2] gains of the sparse split finder (dir 0: missing mass
    left, dir 1: right) from a present-entry histogram and node totals."""
    gl = torch.cumsum(present, 2)
    miss = node[:, None, :] - present.sum(2)
    gt, ht = node[:, 0][:, None, None], node[:, 1][:, None, None]

    def gain(gl_, hl_):
        gr, hr = gt - gl_, ht - hl_
        g = gl_ ** 2 / (hl_ + lam) + gr ** 2 / (hr + lam) - gt ** 2 / (ht + lam)
        return torch.where((hl_ >= mcw) & (hr >= mcw), g, -torch.inf)

    return torch.stack([gain(gl[..., 0] + miss[:, :, None, 0],
                             gl[..., 1] + miss[:, :, None, 1]),
                        gain(gl[..., 0], gl[..., 1])], dim=3)


def dense_missing_gains(torch, h, lam, mcw):
    """[n, F, B, 2] gains of ``GBDT._find_splits`` over a dense fit's
    missing-aware candidates, from a histogram whose bin 0 holds the
    missing mass."""
    gl, hl = torch.cumsum(h[..., 0], 2), torch.cumsum(h[..., 1], 2)
    gt, ht = gl[:, :, -1:], hl[:, :, -1:]

    def gain(gl_, hl_):
        gr, hr = gt - gl_, ht - hl_
        g = gl_ ** 2 / (hl_ + lam) + gr ** 2 / (hr + lam) - gt ** 2 / (ht + lam)
        return torch.where((hl_ >= mcw) & (hr >= mcw), g, -torch.inf)

    return torch.stack([gain(gl, hl), gain(gl - h[:, :, 0:1, 0],
                                           hl - h[:, :, 0:1, 1])], dim=3)


def sparse_split_audit(torch, model, forest, ent, layout, label,
                       dense_bins=None) -> dict:
    """``split_audit`` for a missing-aware fit of the Bosch batch: every
    level of every tree against float64 on the fit's own inputs.  The f32
    side is the sparse kernel's histogram and the segment-sum kernel's node
    totals (``dense_bins`` None: the fit_batch route, replayed through
    ``GBDT._find_splits``), or the dense kernel's histogram of
    ``dense_bins`` (the ``fit`` route).  The float64 side is the same for
    both: present-entry sums and node totals by ``index_add``, missing mass
    as their difference.  A split is within rounding when its float64
    regret is at most twice the node's largest |f32 - float64| gain."""
    from dmlc_core_tpu_torch.models.gbdt import _SparseRows
    from dmlc_core_tpu_torch.ops import histogram as hg
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    from dmlc_core_tpu_torch.ops.fixed_point import lane_amax
    from dmlc_core_tpu_torch.ops.segment_sum import segment_sum
    B, F = model.num_bins, model.num_features
    lam, mcw, lr = model.lambda_, model.min_child_weight, model.learning_rate
    rid_l = layout.rid.long()
    out = dict(hist_err=0.0, leaf_err=0.0, leaf_max=0.0, nodes=0,
               off_best=0, beyond=0, worst=0.0, replay=0)
    scale = []
    for t, (gh, levels, leaf_rel, col_mask, col_key) in enumerate(
            sparse_tree_inputs(torch, model, forest, ent, label)):
        gh_e = gh[rid_l].contiguous()
        gh64 = gh.double()
        for depth, (rel, n) in enumerate(levels):
            mask = model._level_feature_mask(col_mask, col_key, depth, None)
            rel_e = rel[rid_l].contiguous()
            h64 = sparse_oracle64(torch, layout, rel_e, gh_e, n, F, B)
            node64 = torch.zeros(n, 2, dtype=torch.float64,
                                 device=gh.device).index_add_(
                0, rel.long(), gh64)
            big = max(1.0, float(h64.abs().max()))
            first = n - 1
            f = forest["feature"][t, first:first + n].long()
            b = forest["threshold"][t, first:first + n].long()
            d = forest["default_right"][t, first:first + n].long()
            if dense_bins is None:
                h32 = hs.histogram_gh_sparse_kernel(
                    layout.gkey, rel_e, gh_e, layout.starts, n, F, B,
                    layout=layout, gh_amax=lane_amax(gh))
                node32 = segment_sum(gh, rel, n, force="pallas")
                g32 = missing_aware_gains(torch, h32, node32, lam, mcw)
                err = (h32.double() - h64).abs().max()
                dirs, g_tot, h_tot, _ = _SparseRows.candidates((h32, node32))
                rf, rb, rd, *_ = model._find_splits(
                    dirs, g_tot, h_tot, torch.full((1,), -torch.inf,
                                                   device=gh.device),
                    torch.full((1,), torch.inf, device=gh.device), None,
                    col_mask, col_key, depth)
            else:
                h32 = hg.histogram_gh(dense_bins, rel, gh, n, B,
                                      force="pallas")
                miss64 = node64[:, None, :] - h64.sum(2)
                err = torch.maximum((h32[:, :, 1:].double()
                                     - h64[:, :, 1:]).abs().max(),
                                    (h32[:, :, 0].double()
                                     - miss64).abs().max())
                g32 = dense_missing_gains(torch, h32, lam, mcw)
                rf, rb, rd, _ = model._pick_splits(
                    model._collapse_dir_ties(g32), mask)
                big = max(big, float(miss64.abs().max()))
            out["hist_err"] = max(out["hist_err"], float(err) / big)
            g64 = missing_aware_gains(torch, h64, node64, lam, mcw)
            if mask is not None:  # a level's candidates: its features
                g32 = torch.where(mask[None, :, None, None], g32, -torch.inf)
                g64 = torch.where(mask[None, :, None, None], g64, -torch.inf)
            g32, g64 = g32.reshape(n, -1), g64.reshape(n, -1)
            both = torch.isfinite(g32) & torch.isfinite(g64)
            noise = torch.where(both, (g32.double() - g64).abs(),
                                0.0).amax(1)
            null = b >= B
            pick = ((f * B + b.clamp(max=B - 1)) * 2 + d)[:, None]
            chosen = torch.where(null, 0.0, g64.gather(1, pick)[:, 0])
            regret = g64.amax(1).clamp(min=0.0) - chosen
            out["replay"] += int(((rf.long() != f) | (rb.long() != b)
                                  | ((rd.long() != d) & ~null)).sum())
            out["nodes"] += n
            out["off_best"] += int((regret > 0).sum())
            out["beyond"] += int((regret > 2.0 * noise).sum())
            out["worst"] = max(out["worst"], float(
                (regret / noise.clamp(min=1e-30)).max()))
        s = torch.zeros(2 ** model.max_depth, 2, dtype=torch.float64,
                        device=gh.device).index_add_(0, leaf_rel.long(), gh64)
        leaf64 = -lr * s[:, 0] / (s[:, 1] + lam)
        leaf = forest["leaf"][t].double()
        out["leaf_err"] = max(out["leaf_err"],
                              float((leaf - leaf64).abs().max()))
        out["leaf_max"] = max(out["leaf_max"], float(leaf64.abs().max()))
        big = leaf64.abs() > 1e-3
        scale.append((leaf[big] / leaf64[big]).cpu())
    out["leaf_scale"] = float(torch.cat(scale).mean()) - 1.0
    return out


def print_audit(name, a, trees):
    print(f"gbdt_sparse audit [{name}, every level of {trees} trees]: "
          f"histogram vs float64 {a['hist_err']:.3e} of the largest bin; "
          f"{a['off_best']} of {a['nodes']} splits off the float64 best, "
          f"{a['beyond']} beyond rounding (worst regret/noise "
          f"{a['worst']:.2f}); replay mismatches {a['replay']}; |leaf - "
          f"float64 leaf| {a['leaf_err']:.3e}, leaf/float64 leaf - 1 "
          f"{a['leaf_scale']:+.3e}")


def sparse_predict_oracle(forest, rid, fi, ebin, rows, depth) -> np.ndarray:
    """float64 probabilities of a missing-aware forest, every row routed
    through every tree in numpy over dense codes made from the entries."""
    bins = np.zeros((rows, int(fi.max()) + 1), np.int32)
    bins[rid, fi] = ebin
    feat = forest["feature"].cpu().numpy()
    thr = forest["threshold"].cpu().numpy()
    dflt = forest["default_right"].cpu().numpy()
    leaf = forest["leaf"].cpu().numpy().astype(np.float64)
    r = np.arange(rows)
    m = np.full(rows, float(forest["base"]))
    for t in range(feat.shape[0]):
        node = np.zeros(rows, np.int64)
        for _ in range(depth):
            b = bins[r, np.minimum(feat[t, node], bins.shape[1] - 1)]
            b = np.where(feat[t, node] < bins.shape[1], b, 0)
            right = np.where(b == 0, dflt[t, node] == 1, b > thr[t, node])
            node = 2 * node + 1 + right
        m += leaf[t, node - (2 ** depth - 1)]
    return 1.0 / (1.0 + np.exp(-m))


def sub_batch(torch, PaddedBatch, data, r0, r1):
    """Rows [r0, r1) of the Bosch CSR arrays as a PaddedBatch."""
    rp = data["row_ptr"]
    e0, e1 = int(rp[r0]), int(rp[r1])
    return PaddedBatch(label=data["label"][r0:r1],
                       weight=torch.ones(r1 - r0, device=rp.device),
                       row_ptr=(rp[r0:r1 + 1] - e0).contiguous(),
                       index=data["index"][e0:e1],
                       value=data["value"][e0:e1], num_rows=r1 - r0)


PREDICT_STAGED_ROWS, PREDICT_STAGED_BATCH = 50_000, 16_384


def phase_gbdt_sparse(torch, ss_mod, dev, build_dir: Path) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from dmlc_core_tpu_torch.data.staging import PaddedBatch
    from dmlc_core_tpu_torch.models import GBDT, QuantileBinner, logistic_nll
    from dmlc_core_tpu_torch.models.gbdt import _SparseRows
    from dmlc_core_tpu_torch.ops import histogram as hg
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    from dmlc_core_tpu_torch.ops.fixed_point import lane_amax
    from dmlc_core_tpu_torch.ops.sparse import csr_to_dense_missing
    from dmlc_core_tpu_torch.serving import (ScoringServer, pack_snapshot,
                                             push_snapshot, snapshot_digest)
    R, F, B = BOSCH_ROWS, BOSCH_FEATURES, GBDT_KW["num_bins"]
    depth, trees = GBDT_KW["max_depth"], GBDT_KW["num_trees"]

    torch.cuda.synchronize()
    t0 = time.monotonic()
    data = bosch_like(torch, dev)
    torch.cuda.synchronize()
    t_gen = time.monotonic() - t0
    nnz = data["index"].shape[0]
    batch = PaddedBatch(label=data["label"], weight=torch.ones(R, device=dev),
                        row_ptr=data["row_ptr"], index=data["index"],
                        value=data["value"], num_rows=R)
    t0 = time.monotonic()
    e_s = int(data["row_ptr"][BOSCH_SKETCH_ROWS])
    binner = QuantileBinner(num_bins=B, missing_aware=True,
                            device=dev).fit_sparse(
        data["index"][:e_s].cpu().numpy(), data["value"][:e_s].cpu().numpy(),
        F)
    t_sketch = time.monotonic() - t0
    model = GBDT(num_features=F, missing_aware=True, device=dev, **GBDT_KW)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ent = model._sparse_entries(*model._entry_bins(batch, binner))
    torch.cuda.synchronize()
    t_bin = time.monotonic() - t0
    t0 = time.monotonic()
    layout = hs.sparse_hist_layout(ent[0], ent[1], ent[2], ent[3], F, B)
    torch.cuda.synchronize()
    t_layout = time.monotonic() - t0
    rid, fi, ebin, emask = ent[:4]
    check(bool(emask.all()) and int(ebin.min()) >= 1
          and layout.nnz_live == nnz, "Bosch entries: a masked or bin-0 entry")
    check(abs(nnz / (R * F) - BOSCH_DENSITY) < 2e-3,
          f"Bosch density {nnz / (R * F)}, want {BOSCH_DENSITY}")
    print(f"gbdt_sparse data: {R} x {F} Bosch-width rows, {nnz} entries "
          f"(density {nnz / (R * F):.4f}), {float(data['label'].mean()):.3f}"
          f" positive; generate on the card {t_gen:.2f} s, fit_sparse sketch "
          f"of {BOSCH_SKETCH_ROWS} rows ({e_s} entries) {t_sketch:.1f} s "
          f"(host), transform_entries + row ids {t_bin:.3f} s, layout sort "
          f"{t_layout:.3f} s (card)")

    def fit_sparse_timed():
        hs.histogram_gh_sparse_kernel.launches = 0
        ss_mod.segment_sum_kernel.launches = 0
        hg.histogram_gh_kernel.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        forest = model.fit_batch(batch, binner)
        torch.cuda.synchronize()
        return (forest, time.monotonic() - t0,
                hs.histogram_gh_sparse_kernel.launches,
                ss_mod.segment_sum_kernel.launches,
                hg.histogram_gh_kernel.launches,
                torch.cuda.max_memory_allocated())

    warm, t_warm, *_ = fit_sparse_timed()

    # the kernel on the first tree's own levels, against its plain version
    # and float64; per-level times beside the previous kernel's, the plain
    # version, index_add over the flattened keys and the bound; the
    # launches take the rows' amax as the fit's do
    rid_l = layout.rid.long()
    gh, levels, leaf_rel, *_ = next(sparse_tree_inputs(
        torch, model, warm, ent, data["label"]))
    gh_e = gh[rid_l].contiguous()
    amax = lane_amax(gh)
    node_tot = check_leaf_sums(torch, ss_mod, gh, levels[-1][0],
                               levels[-1][1],
                               what=f"node totals (depth {depth - 1})")
    root_tot = check_leaf_sums(torch, ss_mod, gh, levels[0][0], levels[0][1],
                               what="node totals (depth 0, one segment)")
    max_err, per_level = 0.0, []
    for d, (rel, n) in enumerate(levels):
        rel_e = rel[rid_l].contiguous()
        ms, cov = device_ms(torch, lambda: hs.histogram_gh_sparse_kernel(
            layout.gkey, rel_e, gh_e, layout.starts, n, F, B,
            layout=layout, gh_amax=amax), 20)
        plain_ms, _ = device_ms(torch, lambda: hs.histogram_gh_sparse_plain(
            layout.gkey, rel_e, gh_e, layout.starts, n, F, B), 1, warmup=1)
        gk = layout.gkey.long()
        keys = (rel_e.long() * F + gk // layout.nb) * B + gk % layout.nb
        del gk
        zeros = torch.zeros(n * F * B, 2, device=dev)
        lib_ms, _ = device_ms(
            torch, lambda: torch.index_add(zeros, 0, keys, gh_e), 3,
            warmup=1)
        del keys, zeros
        oracle = sparse_oracle64(torch, layout, rel_e, gh_e, n, F, B)
        err = level_error(hs.histogram_gh_sparse_kernel(
            layout.gkey, rel_e, gh_e, layout.starts, n, F, B, layout=layout,
            gh_amax=amax), oracle)
        nbytes = 16 * nnz + 8 * n * F * B
        byte_s, op_s = nbytes / HBM_BYTES_PER_S, 2 * nnz / F32_OPS_PER_S
        per_level.append(dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=max(byte_s, op_s) * 1e3,
                              bound_by="bytes" if byte_s >= op_s
                              else "operations"))
        print_level("sparse histogram", d, n, per_level[-1],
                    F64_WARP_SPARSE_MS[d], err, nbytes, cov,
                    PRIOR_MS["Bosch"][d])
        check(err <= HIST_TOL, f"sparse histogram depth {d}: {err} of the "
              "largest bin from float64")
        if d in CHECK_DEPTHS:
            err, _ = check_sparse_hist(
                torch, hs, f"Bosch depth {d}", layout.gkey, rel_e, gh_e,
                layout.starts, n, F, B, oracle)
            max_err = max(max_err, err)
        del oracle
    level_summary("sparse histogram", per_level, F64_WARP_SPARSE_MS,
                  PRIOR_MS["Bosch"])
    ops_line(torch, "histogram_gh_sparse, Bosch depth 5",
             lambda: hs.histogram_gh_sparse_kernel(
                 layout.gkey, rel_e, gh_e, layout.starts, n, F, B,
                 layout=layout, gh_amax=amax))
    rng = torch.Generator(device=dev).manual_seed(9)
    for name, (c_nnz, c_f, c_b, c_n) in {
            "512 nodes": (5_000_000, 100, 256, 512),
            "1000 bins, 40 nodes (two node tiles)": (2_000_000, 50, 1000, 40),
            "200 bins": (2_000_000, 50, 200, 16)}.items():
        c_fi = torch.sort(torch.randint(0, c_f, (c_nnz,), generator=rng,
                                        device=dev)).values
        c_nb = 1 << max(c_b - 1, 1).bit_length()
        c_l = hs.SparseHistLayout(
            num_features=c_f, num_bins=c_b, nb=c_nb,
            nnz_live=c_nnz, rid=None, gkey=(c_fi * c_nb + torch.randint(
                1, c_b, (c_nnz,), generator=rng, device=dev)).to(torch.int32),
            starts=torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(
                torch.bincount(c_fi, minlength=c_f), 0).cpu()]))
        c_rel = torch.randint(0, c_n, (c_nnz,), generator=rng, device=dev,
                              dtype=torch.int32)
        c_gh = torch.randn(c_nnz, 2, generator=rng, device=dev)
        err, _ = check_sparse_hist(
            torch, hs, name, c_l.gkey, c_rel, c_gh, c_l.starts, c_n, c_f, c_b,
            sparse_oracle64(torch, c_l, c_rel, c_gh, c_n, c_f, c_b))
        max_err = max(max_err, err)
    del gh, gh_e, levels, leaf_rel

    # the main path: two timed fits of the same forest
    fits = [fit_sparse_timed() for _ in range(2)]
    forest = fits[0][0]
    for f_i, secs, h_l, s_l, d_l, peak in fits:
        print(f"gbdt_sparse fit_batch: {secs:.3f} s wall, "
              f"{R * trees / secs:.0f} row_trees_s; launches: "
              f"histogram_gh_sparse {h_l}, segment_sum {s_l}, histogram_gh "
              f"{d_l}; peak device memory of the fit {peak / 2**30:.2f} GiB")
        check(h_l == trees * depth, f"histogram_gh_sparse launched {h_l} "
              f"times in a fit (want {trees * depth})")
        check(s_l == trees * (depth + 1), f"segment_sum launched {s_l} times "
              f"in a fit (want {trees * (depth + 1)}: {depth} node totals "
              "and one leaf sum a tree)")
        check(d_l == 0, "the sparse fit launched the dense histogram")
        check(all(torch.equal(f_i[k], forest[k]) and
                  torch.equal(warm[k], forest[k]) for k in forest),
              "two fit_batch fits gave different forests")
    print(f"gbdt_sparse: warm-up fit {t_warm:.3f} s; three fits bitwise "
          f"identical")
    label = data["label"]
    m = forest["base"].expand(R).clone()
    losses = [float(logistic_nll(m, label).mean())]
    for i in range(trees):
        m += model._tree_margins_sparse_one(
            forest["feature"][i], forest["threshold"][i],
            forest["default_right"][i], forest["leaf"][i], *ent[:4], R)
        losses.append(float(logistic_nll(m, label).mean()))
    print("gbdt_sparse train logloss after 0/1/5/10/20 trees: " + ", ".join(
        f"{losses[i]:.6f}" for i in (0, 1, 5, 10, trees)))
    check(all(b < a for a, b in zip(losses, losses[1:])),
          "train logloss did not fall with every tree")
    a = sparse_split_audit(torch, model, forest, ent, layout, label)
    print_audit("fit_batch on the kernel", a, trees)
    check(a["hist_err"] <= HIST_TOL and a["beyond"] == 0 and a["replay"] == 0
          and a["leaf_err"] <= LEAF_TOL, f"fit_batch audit: {a}")

    # sampled forests on the same batch
    sm = GBDT(num_features=F, missing_aware=True, device=dev, **GBDT_KW,
              **SAMPLE_KW)
    s_secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        s_i = sm.fit_batch(batch, binner)
        torch.cuda.synchronize()
        s_secs.append(time.monotonic() - t0)
        if len(s_secs) == 1:
            sforest = s_i
    check(all(torch.equal(s_i[k], sforest[k]) for k in sforest),
          "two sampled fit_batch fits gave different forests")
    check_draws(torch, sm, R, "gbdt_sparse")
    m = sforest["base"].expand(R).clone()
    for i in range(trees):
        m += sm._tree_margins_sparse_one(
            sforest["feature"][i], sforest["threshold"][i],
            sforest["default_right"][i], sforest["leaf"][i], *ent[:4], R)
    s_loss = float(logistic_nll(m, label).mean())
    a_s = sparse_split_audit(torch, sm, sforest, ent, layout, label)
    print(f"gbdt_sparse sampled fit_batch ({SAMPLE_KW}): {s_secs[0]:.3f} / "
          f"{s_secs[1]:.3f} s wall (unsampled {fits[0][1]:.3f}), two fits "
          f"bitwise equal; train logloss after 20 trees {s_loss:.6f} "
          f"(unsampled {losses[-1]:.6f})")
    print_audit("sampled fit_batch, over the sampled features", a_s, trees)
    check(a_s["hist_err"] <= HIST_TOL and a_s["beyond"] == 0
          and a_s["replay"] == 0 and a_s["leaf_err"] <= LEAF_TOL,
          f"sampled fit_batch audit: {a_s}")
    check(s_loss < losses[0], "the sampled fit's loss did not fall")
    del sforest, s_i, m

    # the dense cross-check: the same data densified with NaN for absent
    # cells, binned with the same cuts, and fit on the dense kernel
    t0 = time.monotonic()
    dense_bins = torch.empty(R, F, dtype=torch.uint8, device=dev)
    for r0 in range(0, R, BOSCH_CHUNK):
        r1 = min(r0 + BOSCH_CHUNK, R)
        sb = sub_batch(torch, PaddedBatch, data, r0, r1)
        dense_bins[r0:r1] = binner.transform(csr_to_dense_missing(
            sb.index, sb.value, sb.row_ids(), r1 - r0, F))
    torch.cuda.synchronize()
    t_dense = time.monotonic() - t0
    check(torch.equal(dense_bins[rid, fi.long()].to(torch.int32), ebin),
          "dense codes differ from transform_entries")
    hg.histogram_gh_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    forest_d = model.fit(dense_bins, label)
    torch.cuda.synchronize()
    t_fit_d = time.monotonic() - t0
    check(hg.histogram_gh_kernel.launches == trees * depth,
          "the dense fit did not run the dense kernel a level")
    loss_d = float(model.loss(forest_d, dense_bins, label))
    differs = ((forest["feature"] != forest_d["feature"])
               | (forest["threshold"] != forest_d["threshold"]))
    dflt = forest["default_right"] != forest_d["default_right"]
    tree_d = differs.any(dim=1).nonzero()
    print(f"gbdt_sparse dense cross-check: densify + bin {t_dense:.2f} s, "
          f"fit (dense kernel) {t_fit_d:.3f} s; {int(differs.sum())} of "
          f"{differs.numel()} split nodes differ from the sparse forest in "
          f"feature or threshold (first in tree "
          f"{int(tree_d[0]) if tree_d.numel() else None}), "
          f"{int((dflt & ~differs).sum())} more in default direction only; "
          f"train logloss {loss_d:.7f} vs {losses[-1]:.7f}")
    a_d = sparse_split_audit(torch, model, forest_d, ent, layout, label,
                             dense_bins=dense_bins)
    print_audit("dense fit", a_d, trees)
    check(a_d["hist_err"] <= HIST_TOL and a_d["beyond"] == 0,
          f"dense cross-check audit: {a_d}")
    del dense_bins

    # predict_batch on a sub-batch against float64 numpy routing
    sb = sub_batch(torch, PaddedBatch, data, 0, PREDICT_ROWS)
    got = model.predict_batch(forest, sb, binner)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = model.predict_batch(forest, sb, binner)
    torch.cuda.synchronize()
    t_pred = time.monotonic() - t0
    e1 = int(data["row_ptr"][PREDICT_ROWS])
    want = sparse_predict_oracle(forest, sb.row_ids().cpu().numpy(),
                                 fi[:e1].cpu().numpy(),
                                 ebin[:e1].cpu().numpy(), PREDICT_ROWS, depth)
    err = float(np.abs(got.cpu().numpy().astype(np.float64) - want).max())
    print(f"gbdt_sparse predict_batch: {PREDICT_ROWS} rows in "
          f"{t_pred * 1e3:.2f} ms (host clock), max |p - float64 oracle| "
          f"{err:.3e}")
    check(err <= 1e-5, f"predict_batch error {err}")

    # predict_staged: the first rows written to a libsvm file (values as
    # %.9g), staged and scored batch by batch, against predict_batch
    n = PREDICT_STAGED_ROWS
    e1 = int(data["row_ptr"][n])
    path = build_dir / f"bosch_{n}.libsvm"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(libsvm_text(
        data["label"][:n].cpu().numpy(),
        data["row_ptr"][:n + 1].cpu().numpy().astype(np.int64),
        data["index"][:e1].cpu().numpy(), data["value"][:e1].cpu().numpy()))
    model.predict_staged(forest, str(path), binner,
                         batch_size=PREDICT_STAGED_BATCH)  # warm
    torch.cuda.synchronize()
    t0 = time.monotonic()
    staged = model.predict_staged(forest, str(path), binner,
                                  batch_size=PREDICT_STAGED_BATCH)
    t_staged = time.monotonic() - t0
    direct = model.predict_batch(forest, sub_batch(
        torch, PaddedBatch, data, 0, n), binner).cpu().numpy()
    print(f"gbdt_sparse predict_staged: {n} rows from a "
          f"{path.stat().st_size / 2**20:.1f} MiB libsvm file in "
          f"{-(-n // PREDICT_STAGED_BATCH)} batches of {PREDICT_STAGED_BATCH}"
          f", {t_staged:.3f} s ({n / t_staged:.0f} rows/s, host clock); "
          f"equal to predict_batch bit for bit: "
          f"{np.array_equal(staged.view(np.int32), direct.view(np.int32))}")
    check(staged.shape == (n,) and np.array_equal(
        staged.view(np.int32), direct.view(np.int32)),
        "predict_staged differs from predict_batch")

    # serving the forest from a DTSNAP01 snapshot that carries its binner
    cfg = dict(num_features=F, missing_aware=True, **GBDT_KW)
    snap = pack_snapshot("gbdt", cfg, forest, binner=binner, seq=1)
    host = {k: data[k].cpu().numpy() for k in ("row_ptr", "index", "value")}
    gen = np.random.default_rng(12)
    lat = {n: [] for n in SPARSE_REQUEST_ROWS}
    worst = 0.0
    with ScoringServer(device=dev) as srv:
        url = f"http://127.0.0.1:{srv.http_port}"
        rep = push_snapshot("127.0.0.1", srv.port, snap, seq=1)
        check(rep.get("ok") and rep["digest"] == snapshot_digest(snap),
              f"push of the gbdt snapshot: {rep}")
        for n in SPARSE_REQUEST_ROWS:
            for _ in range(LATENCY_REPEATS):
                r0 = int(gen.integers(0, R - n))
                rows = [(host["index"][host["row_ptr"][r]:host["row_ptr"][
                    r + 1]].tolist(), host["value"][host["row_ptr"][r]:host[
                        "row_ptr"][r + 1]].tolist()) for r in range(r0, r0 + n)]
                doc, ms = post_score(url, rows)
                check(doc["model"] == snapshot_digest(snap),
                      "served model is not the gbdt snapshot")
                served = np.asarray(doc["scores"], np.float64)
                want = model.predict_batch(
                    forest, sub_batch(torch, PaddedBatch, data, r0, r0 + n),
                    binner).cpu().numpy()
                e = float(np.abs(served - want).max())
                check(served.shape == (n,) and e <= TOL,
                      f"{n}-row gbdt /score err {e}")
                worst = max(worst, e)
                lat[n].append(ms)
    print(f"gbdt_sparse serving: max |score - predict_batch| {worst:.3e}; " +
          ", ".join(f"/score {n} rows p50 {np.percentile(lat[n], 50):.3f} ms"
                    for n in SPARSE_REQUEST_ROWS) +
          f" ({LATENCY_REPEATS} requests each, host clock)")

    # where one sparse tree's time goes on the card
    g, h = model._grad_hess(forest["base"].expand(R).clone(), label)
    model._grow_tree(_SparseRows(model, ent, layout), g, h)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        model._grow_tree(_SparseRows(model, ent, layout), g, h)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    dev_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"profile [one sparse tree, under the profiler]: wall "
          f"{wall_ms:.2f} ms, device busy {dev_ms:.2f} ms "
          f"({100 * dev_ms / wall_ms:.1f}%), {len(events)} kernel kinds")
    if not events:
        print("  device time: not measured (no CUDA events in the trace)")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:10]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:<4} "
              f"{e.key[:90]}")
    segment_share(events, dev_ms)
    mean = {k: float(np.mean([lv[k] for lv in per_level]))
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"launches": fits[0][2], "max_abs_err": max_err, "nnz": nnz,
            "bound_by": per_level[0]["bound_by"], **mean,
            "node_totals": {**node_tot, "launches": fits[0][3]},
            "root_totals": {**root_tot, "launches": fits[0][3]},
            "data": data, "binner": binner, "forest": forest,
            "fit_s": fits[0][1]}


# ---- phase 7: the Bosch-width GBDT out of core (fit_streamed) ------------

# The first 2^18 rows of the Bosch-width data above, written once to libsvm
# (values as the shortest decimal that reads back as the same f32), staged
# into the binned epoch cache, and fit by fit_streamed with the model of the
# fit_batch phase.  Cut: rows, 262,144 of 1,183,747, for the time limit
STREAM_ROWS, STREAM_BATCH, STREAM_BUCKET = 1 << 18, 32_768, 1 << 16
STREAM_WORKERS = 8  # parse threads of the text replays
STREAM_CHUNK = 16_384  # rows a libsvm_text call writes
# trees of the text-replay fit held to a cache fit of as many trees: the
# replay parses the text once a pass (1 + 6 a tree), ~3.5 s a tree
TEXT_TREES = 4


def sparse_level_time(torch, hs, layout, rel_e, gh_e, amax, n: int, F: int,
                      B: int, what: str, prior_ms: float) -> tuple:
    """The sparse kernel at one level of a fit: against its plain version
    and float64, and its device time beside the previous kernel's, the plain
    version, ``index_add`` over the flattened keys and the bound.  Returns
    (the times, max |kernel - plain|)."""
    nnz = layout.nnz_live
    ms, _ = device_ms(torch, lambda: hs.histogram_gh_sparse_kernel(
        layout.gkey, rel_e, gh_e, layout.starts, n, F, B,
        layout=layout, gh_amax=amax), 20)
    plain_ms, _ = device_ms(torch, lambda: hs.histogram_gh_sparse_plain(
        layout.gkey, rel_e, gh_e, layout.starts, n, F, B), 1, warmup=1)
    gk = layout.gkey.long()
    keys = (rel_e.long() * F + gk // layout.nb) * B + gk % layout.nb
    del gk
    zeros = torch.zeros(n * F * B, 2, device=gh_e.device)
    lib_ms, _ = device_ms(
        torch, lambda: torch.index_add(zeros, 0, keys, gh_e), 3, warmup=1)
    del keys, zeros
    oracle = sparse_oracle64(torch, layout, rel_e, gh_e, n, F, B)
    err, _ = check_sparse_hist(torch, hs, what, layout.gkey, rel_e, gh_e,
                               layout.starts, n, F, B, oracle)
    del oracle
    nbytes = 16 * nnz + 8 * n * F * B
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, 2 * nnz / F32_OPS_PER_S
    lv = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
              bound_ms=max(byte_s, op_s) * 1e3,
              bound_by="bytes" if byte_s >= op_s else "operations")
    print(f"time [{what}, {n} nodes]: kernel {ms:.4f} ms (previous kernel: "
          f"{prior_ms:.3f}), plain {plain_ms:.1f} ms, index_add {lib_ms:.4f} "
          f"ms, bound {lv['bound_ms']:.4f} ms ({nbytes} bytes)")
    return lv, err


def streamed_kernel_levels(torch, ss_mod, model, forest, ent, layout,
                           label) -> dict:
    """The sparse kernel at the streamed fit's shape, on the first tree's
    own levels: against its plain version and float64, and its time
    beside the plain version, ``index_add`` over the flattened keys and
    the bound (means over depths 0-5); the segment-sum kernel at the node
    totals of depth 5."""
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    from dmlc_core_tpu_torch.ops.fixed_point import lane_amax
    F, B = model.num_features, model.num_bins
    nnz = layout.nnz_live
    rid_l = layout.rid.long()
    gh, levels, *_ = next(sparse_tree_inputs(torch, model, forest, ent,
                                             label))
    gh_e = gh[rid_l].contiguous()
    amax = lane_amax(gh)
    node = check_leaf_sums(torch, ss_mod, gh, levels[-1][0], levels[-1][1],
                           what="streamed node totals (depth 5)")
    max_err, per_level = 0.0, []
    for d, (rel, n) in enumerate(levels):
        rel_e = rel[rid_l].contiguous()
        lv, err = sparse_level_time(torch, hs, layout, rel_e, gh_e, amax, n,
                                    F, B,
                                    f"streamed sparse histogram, depth {d}",
                                    PRIOR_MS["streamed"][d])
        per_level.append(lv)
        max_err = max(max_err, err)
    level_summary("streamed sparse histogram", per_level,
                  prior_ms=PRIOR_MS["streamed"])
    ops_line(torch, "histogram_gh_sparse, streamed depth 5",
             lambda: hs.histogram_gh_sparse_kernel(
                 layout.gkey, rel_e, gh_e, layout.starts, n, F, B,
                 layout=layout, gh_amax=amax))
    mean = {k: float(np.mean([lv[k] for lv in per_level]))
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"hist": {"max_abs_err": max_err, "nnz": nnz,
                     "bound_by": per_level[0]["bound_by"], **mean},
            "node_totals": node}


def streamed_file(data, build_dir: Path) -> tuple:
    """The first STREAM_ROWS Bosch-width rows as libsvm under
    ``build_dir`` (values written shortest, so they read back bit for
    bit); returns (path, entries)."""
    R = STREAM_ROWS
    host = {k: data[k][:R + (k == "row_ptr")].cpu().numpy()
            for k in ("label", "row_ptr")}
    e1 = int(host["row_ptr"][R])
    index = data["index"][:e1].cpu().numpy()
    value = data["value"][:e1].cpu().numpy()
    path = build_dir / f"bosch_{R}.libsvm"
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        for r0 in range(0, R, STREAM_CHUNK):
            r1 = min(r0 + STREAM_CHUNK, R)
            e0, e = int(host["row_ptr"][r0]), int(host["row_ptr"][r1])
            f.write(libsvm_text(
                host["label"][r0:r1],
                host["row_ptr"][r0:r1 + 1].astype(np.int64) - e0,
                index[e0:e], value[e0:e], shortest=True))
    return path, e1


def phase_streamed(torch, ss_mod, dev, build_dir: Path, data, binner) -> dict:
    """The Bosch-width GBDT out of core: the first 2^18 rows written to
    libsvm, the binned epoch cache built by BinnedStagingIter (and a
    second open a hit), a cache epoch against a text epoch, fit_streamed
    over a callable replaying the cache (the main path: 120 sparse-
    histogram and 140 segment-sum launches), its forest against fit_batch
    on the same rows resident and against fit_streamed over the text file,
    bit for bit, and the float64 audit of every level."""
    import os

    from dmlc_core_tpu_torch import telemetry
    from dmlc_core_tpu_torch.data import (BinnedStagingIter,
                                          DeviceStagingIter, PaddedBatch)
    from dmlc_core_tpu_torch.models import GBDT
    from dmlc_core_tpu_torch.ops import histogram as hg
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    R, F = STREAM_ROWS, BOSCH_FEATURES
    depth, trees = GBDT_KW["max_depth"], GBDT_KW["num_trees"]
    t0 = time.monotonic()
    path, e1 = streamed_file(data, build_dir)
    t_write = time.monotonic() - t0
    size = path.stat().st_size
    uri = str(path)
    kw = dict(batch_size=STREAM_BATCH, nnz_bucket=STREAM_BUCKET)
    first = next(iter(DeviceStagingIter(uri, device=dev, **kw)))
    n0 = int(first.row_ptr[first.num_rows])
    check(torch.equal(first.value[:n0].view(torch.int32),
                      data["value"][:n0].view(torch.int32))
          and torch.equal(first.index[:n0], data["index"][:n0]),
          "the libsvm text does not read back as the card's values")
    print(f"streamed data: the first {R} Bosch-width rows, {e1} entries, "
          f"{size / 2**20:.1f} MiB of libsvm written in {t_write:.1f} s "
          "(host, numpy); values read back bit for bit")

    cache = str(build_dir / f"bosch_{R}.bincache")
    if os.path.exists(cache):
        os.remove(cache)
    names = ("cache.rebuilds", "cache.build_failed", "cache.hit_bytes",
             "cache.build_bytes")
    c0 = {k: telemetry.counter_get(k) for k in names}
    it = BinnedStagingIter(uri, binner, cache=cache, device=dev, **kw)
    t0 = time.monotonic()
    it.ensure_cache()
    t_build = time.monotonic() - t0
    c1 = {k: telemetry.counter_get(k) for k in names}
    d1 = {k: c1[k] - c0[k] for k in names}
    print(f"streamed cache build: {t_build:.2f} s, {os.path.getsize(cache)}"
          f" cache bytes ({os.path.getsize(cache) / size:.3f} of the text), "
          f"{it.meta['virtual_parts']} virtual parts; counters {d1}")
    check(not it.served_from_text and d1["cache.rebuilds"] == 0
          and d1["cache.build_failed"] == 0 and d1["cache.build_bytes"] > 0,
          f"the cache build: counters {d1}, text fallback "
          f"{it.served_from_text}")
    hit = BinnedStagingIter(uri, binner, cache=cache, device=dev, **kw)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rows_hit = sum(b.num_rows for b in hit)
    torch.cuda.synchronize()
    t_hit = time.monotonic() - t0
    d2 = {k: telemetry.counter_get(k) - c1[k] for k in names}
    check(rows_hit == R and not hit.served_from_text
          and d2["cache.rebuilds"] == 0 and d2["cache.hit_bytes"] > 0
          and d2["cache.build_bytes"] == 0,
          f"the second open is no cache hit: {rows_hit} rows, {d2}")
    text = DeviceStagingIter(uri, num_workers=STREAM_WORKERS, device=dev,
                             **kw)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rows_text = sum(b.num_rows for b in text)
    torch.cuda.synchronize()
    t_text = time.monotonic() - t0
    text.close()
    print(f"streamed epochs: cache hit {t_hit:.3f} s ({R / t_hit:.0f} "
          f"rows/s; counters {d2}), text parse with {STREAM_WORKERS} workers"
          f" {t_text:.3f} s ({rows_text / t_text:.0f} rows/s)")

    model = GBDT(num_features=F, missing_aware=True, device=dev, **GBDT_KW)
    passes, streamed = [0], [0]

    def replay_cache():
        passes[0] += 1
        for b in hit:
            streamed[0] += sum(t.numel() * t.element_size() for t in (
                b.label, b.weight, b.row_ptr, b.index, b.ebin, b.emask))
            yield b

    # the main path: counts to 0 here, read when the fit returns
    hs.histogram_gh_sparse_kernel.launches = 0
    ss_mod.segment_sum_kernel.launches = 0
    hg.histogram_gh_kernel.launches = 0
    c2 = {k: telemetry.counter_get(k) for k in names}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    forest = model.fit_streamed(replay_cache, binner)
    torch.cuda.synchronize()
    t_fit = time.monotonic() - t0
    h_l = hs.histogram_gh_sparse_kernel.launches
    s_l = ss_mod.segment_sum_kernel.launches
    d_l = hg.histogram_gh_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    d3 = {k: telemetry.counter_get(k) - c2[k] for k in names}
    print(f"streamed fit_streamed (cache): {t_fit:.3f} s wall, "
          f"{R * trees / t_fit:.0f} row_trees_s, {passes[0]} passes, "
          f"{streamed[0] / 2**30:.2f} GiB streamed to the card; launches: "
          f"histogram_gh_sparse {h_l}, segment_sum {s_l}, histogram_gh "
          f"{d_l}; peak device memory {peak / 2**30:.2f} GiB; counters {d3}")
    check(h_l == trees * depth and s_l == trees * (depth + 1) and d_l == 0,
          f"fit_streamed launches: {h_l} sparse histograms (want "
          f"{trees * depth}), {s_l} segment sums (want "
          f"{trees * (depth + 1)}), {d_l} dense histograms")
    check(passes[0] == 1 + trees * depth and d3["cache.rebuilds"] == 0
          and d3["cache.hit_bytes"] > 0, f"fit_streamed read {passes[0]} "
          f"passes (want {1 + trees * depth}); counters {d3}")

    sb = sub_batch(torch, PaddedBatch, data, 0, R)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    resident = model.fit_batch(sb, binner)
    torch.cuda.synchronize()
    t_res = time.monotonic() - t0
    same_r = all(torch.equal(forest[k], resident[k]) for k in resident)
    short = GBDT(num_features=F, missing_aware=True, device=dev,
                 **dict(GBDT_KW, num_trees=TEXT_TREES))
    t0 = time.monotonic()
    from_text = short.fit_streamed(uri, binner, staging_options=dict(
        num_workers=STREAM_WORKERS, **kw))
    torch.cuda.synchronize()
    t_txt = time.monotonic() - t0
    from_cache = short.fit_streamed(lambda: iter(hit), binner)
    same_t = all(torch.equal(from_cache[k], from_text[k]) for k in from_text)
    print(f"streamed forests: equal bit for bit to fit_batch on the same "
          f"rows resident ({t_res:.3f} s): {same_r}; a {TEXT_TREES}-tree "
          f"fit_streamed over the text file ({t_txt:.3f} s, "
          f"{STREAM_WORKERS} parse workers) to one over the cache: {same_t}")
    check(same_r and same_t, "the streamed forest differs from fit_batch's "
          "or from the text replay's")
    ent = model._sparse_entries(*model._entry_bins(sb, binner))
    layout = hs.sparse_hist_layout(*ent, F, GBDT_KW["num_bins"])
    a = sparse_split_audit(torch, model, forest, ent, layout, sb.label)
    print_audit("fit_streamed from the cache", a, trees)
    check(a["hist_err"] <= HIST_TOL and a["beyond"] == 0 and a["replay"] == 0
          and a["leaf_err"] <= LEAF_TOL, f"fit_streamed audit: {a}")
    kern = streamed_kernel_levels(torch, ss_mod, model, forest, ent, layout,
                                  sb.label)
    return {"launches": h_l, "seg_launches": s_l, "forest": forest,
            "fit_s": t_fit, "uri": uri, "hit_rows_s": R / t_hit, "ent": ent,
            "layout": layout, "label": sb.label, **kern}


# ---- phase 7b: the data service ---------------------------------------------

DS_WORKERS = 2  # staging workers, as submit(data_service=2) spawns them
DS_READY_S = 120  # seconds the workers have to register on the board


@contextlib.contextmanager
def service_fleet(cache_dir: Path):
    """The port's aggregator in this process and DS_WORKERS staging
    workers on the card, spawned by ``tracker.submit.spawn_data_service``
    (what ``submit(data_service=...)`` runs) over one cache directory,
    emptied first; yields (aggregator, worker processes) once every worker
    registered, and stops them all."""
    import shutil

    from dmlc_core_tpu_torch.tracker import metrics as tm
    from dmlc_core_tpu_torch.tracker.submit import spawn_data_service
    shutil.rmtree(cache_dir, ignore_errors=True)
    agg = tm.MetricsAggregator()
    envs = {"DMLC_TRACKER_URI": "127.0.0.1", tm.METRICS_PORT_ENV: agg.port,
            "DMLCTPU_DATASERVICE_CACHE_DIR": str(cache_dir),
            "PYTHONPATH": str(REPO)}
    procs = spawn_data_service(DS_WORKERS, envs)
    try:
        t0 = time.monotonic()
        while len(agg.leases.state()["workers"]) < DS_WORKERS:
            check(time.monotonic() - t0 < DS_READY_S
                  and all(p.poll() is None for p in procs),
                  "the staging workers did not register on the lease board")
            time.sleep(0.2)
        print(f"dataservice: {DS_WORKERS} workers registered in "
              f"{time.monotonic() - t0:.1f} s")
        yield agg, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        agg.close()


def service_client(dev, agg, uri, binner, **extra):
    """A DataServiceIter of the streamed cell's geometry on the fleet."""
    from dmlc_core_tpu_torch.dataservice import DataServiceIter
    from dmlc_core_tpu_torch.tracker import metrics as tm
    return DataServiceIter(
        uri, binner, retries=8, device=dev, batch_size=STREAM_BATCH,
        nnz_bucket=STREAM_BUCKET,
        shard_client=tm.ShardClient("127.0.0.1", agg.port, rank=0), **extra)


def same_batches(torch, got, want) -> bool:
    """Two BinnedBatch streams equal leaf by leaf on the card."""
    got, want = list(got), list(want)
    return len(got) == len(want) and all(
        a.num_rows == b.num_rows and a.cuts_digest == b.cuts_digest
        and all(torch.equal(getattr(a, k), getattr(b, k))
                for k in ("label", "weight", "row_ptr", "index", "ebin",
                          "emask"))
        for a, b in zip(got, want))


def epoch_rows(torch, batches) -> tuple:
    """An epoch's real rows, in order: (labels, row lengths, and each
    entry's index, ebin and emask), concatenated on the card."""
    lab, lens, idx, ebin, emask = [], [], [], [], []
    for b in batches:
        n, nnz = b.num_rows, int(b.row_ptr[b.num_rows])
        lab.append(b.label[:n])
        lens.append(b.row_ptr[1:n + 1] - b.row_ptr[:n])
        idx.append(b.index[:nnz])
        ebin.append(b.ebin[:nnz])
        emask.append(b.emask[:nnz])
    return tuple(torch.cat(x) for x in (lab, lens, idx, ebin, emask))


def phase_dataservice(torch, ss_mod, dev, build_dir: Path, streamed) -> dict:
    """The data service over the Bosch out-of-core cell's file: the port's
    aggregator in this process, two staging workers on the card spawned by
    ``tracker.submit.spawn_data_service`` (what ``submit(data_service=2)``
    runs) over one cache directory, and a ``DataServiceIter`` with an
    unfitted binner that adopts the service's cuts.  Checks: one cache file
    named by ``spec_key``; two service epochs equal a local cache hit over
    the worker's file bit for bit; a local build from the text sketches the
    worker's cuts; ``fit_streamed`` over the service (the main path: 120
    sparse-histogram and 140 segment-sum launches, 121 epochs) equals a fit
    over one local epoch bit for bit (and a shorter fit over that epoch is
    the mesh phase's one-process reference); a worker SIGKILLed partway
    through an epoch leaves the epoch whole on the survivor; the staged
    (text) mode gives the cache epoch's rows."""
    import signal

    from dmlc_core_tpu_torch import telemetry
    from dmlc_core_tpu_torch.data import BinnedStagingIter
    from dmlc_core_tpu_torch.dataservice.server import spec_key
    from dmlc_core_tpu_torch.models import GBDT, QuantileBinner
    from dmlc_core_tpu_torch.ops import histogram as hg
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    R, F = STREAM_ROWS, BOSCH_FEATURES
    depth, trees = GBDT_KW["max_depth"], GBDT_KW["num_trees"]
    kw = dict(batch_size=STREAM_BATCH, nnz_bucket=STREAM_BUCKET)
    uri = streamed["uri"]
    cache_dir = build_dir / "dataservice"
    with service_fleet(cache_dir) as (agg, procs):
        def counters():
            return {k: telemetry.counter_get(k) for k in (
                "dataservice.fetch_bytes", "dataservice.fetch_blocks",
                "dataservice.errors", "cache.rebuilds", "cache.build_bytes",
                "cache.hit_bytes")}

        def delta(c0):
            c1 = counters()
            return {k: c1[k] - c0[k] for k in c1}

        # 1. one parse: the meta request builds the worker's cache
        binner = QuantileBinner(GBDT_KW["num_bins"], missing_aware=True,
                                device=dev)
        ds = service_client(dev, agg, uri, binner)
        t0 = time.monotonic()
        ds.ensure_meta()
        t_build = time.monotonic() - t0
        c0 = counters()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        first = list(ds)
        torch.cuda.synchronize()
        t_epoch = time.monotonic() - t0
        d1 = delta(c0)
        rows = sum(b.num_rows for b in first)
        files = sorted(p.name for p in cache_dir.glob("*.bincache"))
        print(f"dataservice: the worker's cache build (the meta request)"
              f" {t_build:.2f} s; cache files {files}; epoch 1 {t_epoch:.3f}"
              f" s, {rows / t_epoch:.0f} rows/s, "
              f"{d1['dataservice.fetch_bytes'] / t_epoch / 1e6:.1f} MB/s of "
              f"frames ({d1['dataservice.fetch_blocks']} blocks), beside the"
              f" local cache hit's {streamed['hit_rows_s']:.0f} rows/s")
        check(rows == R and ds.meta is not None and binner.cuts is not None
              and files == [spec_key(ds.spec) + ".bincache"]
              and d1["dataservice.fetch_blocks"] > 0
              and d1["dataservice.errors"] == 0,
              f"the service epoch: {rows} rows, cache files {files}, "
              f"counters {d1}")

        # 2. bit identity with a local cache hit, in two epochs
        c0 = counters()
        local_it = BinnedStagingIter(
            uri, QuantileBinner(GBDT_KW["num_bins"], missing_aware=True,
                                device=dev),
            cache=str(cache_dir / files[0]), device=dev, **kw)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        local = list(local_it)
        torch.cuda.synchronize()
        t_local = time.monotonic() - t0
        d2 = delta(c0)
        same1 = same_batches(torch, first, local)
        del first
        c0 = counters()
        same2 = same_batches(torch, ds, local)
        d3 = delta(c0)
        print(f"dataservice batches: epoch 1 equal to the local cache hit "
              f"over the worker's file ({t_local:.3f} s, {R / t_local:.0f} "
              f"rows/s, counters {d2}) leaf by leaf: {same1}; epoch 2 under "
              f"a fresh lease ledger: {same2} ({d3})")
        check(same1 and same2 and d2["cache.rebuilds"] == 0
              and d2["cache.build_bytes"] == 0 and d2["cache.hit_bytes"] > 0
              and d3["dataservice.errors"] == 0,
              f"the service epochs differ from the local hit: {same1}, "
              f"{same2}; counters {d2}, {d3}")

        # 3. a local build on the card sketches the worker's cuts
        own = QuantileBinner(GBDT_KW["num_bins"], missing_aware=True,
                             device=dev)
        own_cache = build_dir / "dataservice_local.bincache"
        if own_cache.exists():
            own_cache.unlink()
        t0 = time.monotonic()
        BinnedStagingIter(uri, own, cache=str(own_cache), device=dev,
                          **kw).ensure_cache()
        t_own = time.monotonic() - t0
        print(f"dataservice cuts: a local build on the card ({t_own:.2f} s)"
              f" {own.cuts_digest()}, the worker's {ds.meta['cuts_digest']}")
        check(own.cuts_digest() == ds.meta["cuts_digest"],
              "a worker on the card and a local build sketch other cuts")

        # 4. the main path: fit_streamed over the service
        model = GBDT(num_features=F, missing_aware=True, device=dev,
                     **GBDT_KW)
        passes = [0]

        def replay():
            passes[0] += 1
            return iter(ds)

        log = {}
        timed = {(hs, "_run"): hs._run,
                 (hs, "histogram_gh_sparse_dequantize"):
                     hs.histogram_gh_sparse_dequantize,
                 (ss_mod, "_launch"): ss_mod._launch}
        for mod, name in timed:
            _event_timed(torch, mod, name, log)
        hs.histogram_gh_sparse_kernel.launches = 0
        ss_mod.segment_sum_kernel.launches = 0
        hg.histogram_gh_kernel.launches = 0
        c0 = counters()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        try:
            forest = model.fit_streamed(replay, binner)
            torch.cuda.synchronize()
        finally:
            for (mod, name), fn in timed.items():
                setattr(mod, name, fn)
        t_fit = time.monotonic() - t0
        h_l = hs.histogram_gh_sparse_kernel.launches
        s_l = ss_mod.segment_sum_kernel.launches
        d_l = hg.histogram_gh_kernel.launches
        kern_ms = _events_ms(torch, log)
        d4 = delta(c0)
        t0 = time.monotonic()
        want = model.fit_streamed(local, binner)
        torch.cuda.synchronize()
        t_want = time.monotonic() - t0
        same_f = all(torch.equal(forest[k], want[k]) for k in want)
        print(f"dataservice fit_streamed: {t_fit:.3f} s wall "
              f"({R * trees / t_fit:.0f} row_trees_s, {passes[0]} epochs, "
              f"{d4['dataservice.fetch_bytes'] / 2**30:.2f} GiB of frames), "
              f"beside {streamed['fit_s']:.3f} s over the local cache; "
              f"kernels {kern_ms:.1f} device ms, "
              f"{100 * kern_ms / 1e3 / t_fit:.2f}% of the wall; launches: "
              f"histogram_gh_sparse {h_l}, segment_sum {s_l}, histogram_gh "
              f"{d_l}; forest equal to a fit over one resident local epoch "
              f"({t_want:.3f} s) bit for bit: {same_f}")
        check(h_l == trees * depth and s_l == trees * (depth + 1)
              and d_l == 0 and passes[0] == 1 + trees * depth
              and d4["dataservice.errors"] == 0,
              f"fit over the service: {h_l} sparse histograms, {s_l} "
              f"segment sums, {d_l} dense, {passes[0]} epochs; {d4}")
        check(same_f, "the forest over the service differs from the local "
              "fit's")
        # the one-process forest the mesh phase's shorter fit over the
        # service is held to: as many trees over the same (resident) epoch
        short = GBDT(num_features=F, missing_aware=True, device=dev,
                     **dict(GBDT_KW, num_trees=SERVICE_TREES)).fit_streamed(
            local, binner)

        # 5. failover: SIGKILL a worker after the epoch's first batch (the
        # producer runs at most a few parts ahead of a fast consumer, so
        # dozens of parts are still to lease, about half placed on it)
        c0 = counters()
        epoch = ds._epoch
        got, victim = [], procs[0]
        for b in ds:
            got.append(b)
            if len(got) == 1:
                victim.send_signal(signal.SIGKILL)
                victim.wait(timeout=30)
        d5 = delta(c0)
        lease = agg.leases.state()["leases"][ds.client_id][str(epoch)]
        same5 = same_batches(torch, got, local)
        del got
        print(f"dataservice failover: a worker SIGKILLed after 1 of "
              f"{len(local)} batches; the epoch "
              f"equal to the local hit bit for bit: {same5}; ledger "
              f"{lease['done']} of {lease['shards']} parts done, "
              f"{len(lease['failovers'])} failovers; counters {d5}")
        check(same5 and lease["pending"] == 0 and lease["failovers"]
              and d5["dataservice.errors"] >= 1,
              f"the epoch over a killed worker: {same5}, ledger {lease}, "
              f"counters {d5}")

        # 6. the staged (text) mode, binned on the host with the cuts
        st = service_client(dev, agg, uri, binner, mode="staged")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        staged = list(st)
        torch.cuda.synchronize()
        t_staged = time.monotonic() - t0
        a, b = epoch_rows(torch, staged), epoch_rows(torch, local)
        same6 = all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"dataservice staged mode: {len(staged)} batches "
              f"({len(local)} from the cache) in {t_staged:.3f} s "
              f"({R / t_staged:.0f} rows/s); rows equal to the cache "
              f"epoch's (label, indices, ebin, emask): {same6}")
        check(same6 and int(a[0].numel()) == R,
              "the staged mode's rows differ from the cache epoch's")
        del staged, a, b, local
    kern = streamed_kernel_levels(torch, ss_mod, model, forest,
                                  streamed["ent"], streamed["layout"],
                                  streamed["label"])
    return {"launches": h_l, "seg_launches": s_l, "fit_s": t_fit,
            "forest_short": short, **kern}


# ---- phase 8: RecordIO staging ----------------------------------------------

# ImageNet-like records: lengths drawn around 110 KiB, the mean JPEG of
# MXNet's im2rec ImageNet-1k .rec; one record in 16 carries the RecordIO
# magic word at 4-aligned offsets, which the writer splits and the reader
# joins again
REC_COUNT, REC_MEAN = 4096, 110 * 1024
REC_RECORDS_CAP, REC_BYTES_CAP = 256, 32 << 20
REC_WORKERS = (1, 4)
RECORDIO_MAGIC = np.uint32(0xCED7230A).tobytes()


def record_file(path: Path) -> int:
    """Write the RecordIO file once (numpy-seeded payloads); returns how
    many payloads carry the magic word."""
    from dmlc_core_tpu_torch.io import RecordIOWriter
    rng = np.random.default_rng(1000)
    lens = np.clip(rng.lognormal(np.log(REC_MEAN), 0.35, REC_COUNT),
                   1024, 1 << 20).astype(np.int64)
    with_magic = 0
    path.parent.mkdir(parents=True, exist_ok=True)
    with RecordIOWriter(str(path)) as w:
        for i, n in enumerate(lens):
            p = bytearray(rng.bytes(int(n)))
            if i % 16 == 0:
                for off in (0, 4 * (int(n) // 8), 4 * (int(n) // 4 - 1)):
                    p[off:off + 4] = RECORDIO_MAGIC
                with_magic += 1
            w.write(bytes(p))
    return with_magic


def phase_records(torch, dev, build_dir: Path) -> None:
    """RecordStagingIter over an ImageNet-sized RecordIO file with 1 and 4
    workers: every staged record against RecordIOReader's, and MB/s."""
    from dmlc_core_tpu_torch.data import RecordStagingIter
    from dmlc_core_tpu_torch.io import RecordIOReader
    path = build_dir / f"records_{REC_COUNT}.rec"
    t0 = time.monotonic()
    with_magic = record_file(path)
    t_write = time.monotonic() - t0
    with RecordIOReader(str(path)) as reader:
        want = list(reader)
    total = sum(len(r) for r in want)
    check(len(want) == REC_COUNT, f"{len(want)} records read back")
    print(f"records: {REC_COUNT} records, {total / 2**20:.1f} MiB of "
          f"payload ({path.stat().st_size / 2**20:.1f} MiB of RecordIO, "
          f"{with_magic} payloads with the magic word at 4-aligned offsets),"
          f" written in {t_write:.1f} s")
    for nw in REC_WORKERS:
        it = RecordStagingIter(str(path), records_cap=REC_RECORDS_CAP,
                               bytes_cap=REC_BYTES_CAP, num_workers=nw,
                               device=dev)
        check(it.device.type == "cuda", "RecordStagingIter is not on the card")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        staged = sum(b.num_records for b in it)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        k = 0
        for b in it:
            raw = b.bytes.cpu().numpy()
            offs = b.offsets.cpu().numpy()
            for j in range(b.num_records):
                check(k < REC_COUNT and raw[offs[j]:offs[j + 1]].tobytes()
                      == want[k], f"staged record {k} ({nw} workers) "
                      "differs from RecordIOReader's")
                k += 1
        it.close()
        check(staged == REC_COUNT and k == REC_COUNT,
              f"{nw} workers staged {staged} / {k} records")
        print(f"records [RecordStagingIter, {nw} worker(s), records_cap "
              f"{REC_RECORDS_CAP}, bytes_cap {REC_BYTES_CAP >> 20} MiB]: "
              f"{it.batches_staged // 2} batches an epoch, {secs:.3f} s, "
              f"{total / 2**20 / secs:.1f} MB/s of payload to the card; "
              f"every record equal to RecordIOReader's")


# ---- phase 9: checkpoints ---------------------------------------------------

def phase_checkpoints(torch, dev, build_dir: Path, fm, ffm, forest) -> None:
    """Save and load the trained FM and the Bosch forest from the card
    through the port's checkpoint module (RecordIO): bit for bit back on
    the card, seconds and MB/s; the FFM's factor table is one record past
    the native writer's 2^29-byte limit and raises its error."""
    from dmlc_core_tpu_torch import checkpoint
    from dmlc_core_tpu_torch._native import NativeError
    for name, tree in (("Criteo-width FM", fm.state_dict()),
                       ("Bosch forest", forest)):
        path = str(build_dir / f"{name.split()[0].lower()}.ckpt")
        nbytes = sum(t.numel() * t.element_size() for t in tree.values())
        torch.cuda.synchronize()
        t0 = time.monotonic()
        n = checkpoint.save(tree, path)
        t_save = time.monotonic() - t0
        t0 = time.monotonic()
        back = checkpoint.load(path, like=tree, device=dev)
        torch.cuda.synchronize()
        t_load = time.monotonic() - t0
        same = all(back[k].device == tree[k].device
                   and back[k].dtype == tree[k].dtype
                   and torch.equal(back[k], tree[k]) for k in tree)
        print(f"checkpoint [{name}]: {n} leaves, {nbytes / 2**20:.1f} MiB; "
              f"save {t_save:.3f} s ({nbytes / 2**20 / t_save:.0f} MB/s), "
              f"load to the card {t_load:.3f} s "
              f"({nbytes / 2**20 / t_load:.0f} MB/s); bit for bit on the "
              f"card: {same}")
        check(same, f"{name}: the checkpoint did not load back bit for bit")
    v_bytes = ffm.v.numel() * ffm.v.element_size()
    err = None
    try:
        checkpoint.save(ffm.state_dict(), str(build_dir / "ffm.ckpt"))
    except NativeError as e:
        err = str(e)
    print(f"checkpoint [Criteo-width FFM]: the {v_bytes}-byte factor table "
          f"is one record; the native writer refuses it: {err!r}")
    check(err is not None and "2^29" in err,
          f"the FFM checkpoint did not raise the native limit: {err!r}")


# ---- phase 10: observability and the tuner (slice 8) ------------------------

OBS_WINDOW = 8        # DMLCTPU_AUTOTUNE_WINDOW: batches a tuner window
OBS_STALL_S = 3.0     # the consumer's sleep on one batch (watchdog at 1 s)
OBS_ENV = {"DMLCTPU_AUTOTUNE_WINDOW": str(OBS_WINDOW),
           "DMLCTPU_TIMESERIES": "1", "DMLCTPU_TS_TICK_MS": "100"}


def fm_epoch(torch, ss_mod, fm, it, want=None) -> dict:
    """One epoch of FM train steps over ``it``; with ``want`` (the host
    packing) every staged batch is copied back and compared on a host
    thread while the next steps run.  Returns the steps, rows, wall
    seconds, launches a step and the first mismatches."""
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(1) if want is not None else None
    pending, per_step, host_pin = [], [], {}
    rows = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i, batch in enumerate(it):
        before = ss_mod.segment_sum_kernel.launches
        fm.train_step(batch)
        per_step.append(ss_mod.segment_sum_kernel.launches - before)
        rows += batch.num_rows
        if pool is not None:
            out, ev = copy_back(torch, batch, host_pin, len(pending) % 8)
            pending.append(pool.submit(compare_back, out, ev,
                                       batch.num_rows, want[i]))
            if len(pending) >= 8:
                pending[-8].result()
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    bad = []
    if pool is not None:
        bad = [(i, r) for i, f in enumerate(pending) if (r := f.result())]
        pool.shutdown()
    return {"steps": len(per_step), "rows": rows, "secs": secs,
            "per_step": sorted(set(per_step)), "bad": bad,
            "compared": len(pending)}


def phase_observability(torch, ss_mod, dev, build_dir: Path, uri: str,
                        want: list, params) -> dict:
    """(a) one epoch of the Criteo-width FM through an autotuned
    DeviceStagingIter (a window of 8 batches), every batch held to the host
    parse while the tuner moves knobs, 3 launches a step, its decision log,
    knob paths and stall table, beside an untuned epoch; (b) the RecordIO
    file through an autotuned RecordStagingIter, every record held to the
    reader's; (c) the HBM gauges against torch.cuda; (d) a watchdog stall
    and its flight record at /flight; (e) /trace, /snapshot, /timeseries
    and /autotune of the FM ScoringServer."""
    import os

    from dmlc_core_tpu_torch import autotune, telemetry, telemetry_http
    from dmlc_core_tpu_torch.data import DeviceStagingIter, RecordStagingIter
    from dmlc_core_tpu_torch.io import RecordIOReader
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.serving import (ScoringServer, pack_snapshot,
                                             push_snapshot)
    t_phase = time.monotonic()
    os.environ.update(OBS_ENV)
    kw = dict(batch_size=TRAIN_BATCH, nnz_bucket=TRAIN_NNZ_BUCKET,
              num_workers=TRAIN_WORKERS, device=dev)

    def new_fm():
        return FactorizationMachine(NUM_FEATURES, num_factors=NUM_FACTORS,
                                    sdot_backend="pallas", device=dev).init(0)

    # (a) the untuned epoch, then the tuned one (the main path: counts to 0
    # just before it, read just after); both copy every batch back and
    # compare it, so their rows/s pay the same
    plain_it = DeviceStagingIter(uri, autotune=False, **kw)
    plain = fm_epoch(torch, ss_mod, new_fm(), plain_it, want)
    plain_it.close()
    check(plain["compared"] == len(want) and not plain["bad"],
          f"untuned batches differ from the host parse: {plain['bad'][:3]}")
    telemetry.trace_start()
    it = DeviceStagingIter(uri, autotune=True, **kw)
    fm = new_fm()
    log0 = len(autotune.decision_log())
    ss_mod.segment_sum_kernel.launches = 0
    with telemetry.window() as w:
        tuned = fm_epoch(torch, ss_mod, fm, it, want)
    launches = ss_mod.segment_sum_kernel.launches
    tuner = it._tuner
    decisions = autotune.decision_log()[log0:]
    it.close()
    check(tuned["compared"] == len(want) and not tuned["bad"],
          f"autotuned batches differ from the host parse: "
          f"{tuned['bad'][:3]} ({tuned['compared']} compared)")
    check(launches == 3 * tuned["steps"] and tuned["per_step"] == [3],
          f"autotuned epoch: {launches} launches in {tuned['steps']} steps")
    check(tuner is not None and tuner.windows >= len(want) // OBS_WINDOW
          and decisions, f"the tuner did not decide: {tuner and tuner.summary()}")
    print(f"observability [autotuned FM epoch, window {OBS_WINDOW}]: "
          f"{tuned['compared']} of {len(want)} staged batches equal to the "
          f"host parse bit for bit; {launches} segment_sum launches in "
          f"{tuned['steps']} steps ({tuned['per_step']} a step)")
    for d in decisions:
        print(f"  autotune {d['boundary']} {d['window']}: {d['action']}"
              + (f" {d['knob']} {d['frm']} -> {d['to']}" if "knob" in d
                 else "") + f", {d['mb_s']} MB/s, bound {d['bound_stage']}"
              + (f", settled {d['settled']}" if "settled" in d else ""))
    paths = {}
    for d in decisions:
        for rec in ([d["settled"]] if "settled" in d else []) + (
                [d] if "knob" in d else []):
            if rec["action"] in ("step", "revert"):
                paths.setdefault(rec["knob"], [rec["frm"]]).append(rec["to"])
    print("  knob paths: " + ("; ".join(
        f"{k} " + " -> ".join(map(str, v)) for k, v in paths.items())
        or "none moved") + f"; final knobs {tuner.summary()['knobs']}")
    print("  stall attribution of the tuned epoch (bound stage "
          f"{w.bound_stage}):\n    " + telemetry.format_stall_table(
              w.attribution).replace("\n", "\n    "))
    for name, e in (("untuned", plain), ("tuned", tuned)):
        print(f"  {name} epoch (every batch compared): {e['steps']} steps "
              f"in {e['secs']:.3f} s, {e['steps'] / e['secs']:.1f} steps/s, "
              f"{e['rows'] / e['secs']:.0f} rows/s")

    # (b) the RecordIO file through an autotuned RecordStagingIter
    path = build_dir / f"records_{REC_COUNT}.rec"
    rit = RecordStagingIter(str(path), records_cap=REC_RECORDS_CAP,
                            bytes_cap=REC_BYTES_CAP, autotune=True,
                            device=dev)
    k = 0
    t0 = time.monotonic()
    with RecordIOReader(str(path)) as reader:
        ref = iter(reader)
        for b in rit:
            raw, offs = b.bytes.cpu().numpy(), b.offsets.cpu().numpy()
            for j in range(b.num_records):
                check(raw[offs[j]:offs[j + 1]].tobytes() == next(ref),
                      f"autotuned staged record {k} differs from the "
                      "reader's")
                k += 1
        check(next(ref, None) is None, "the reader has records left")
    secs = time.monotonic() - t0
    check(k == REC_COUNT and rit._tuner is not None,
          f"autotuned RecordStagingIter staged {k} records")
    print(f"observability [autotuned RecordStagingIter]: {k} of {REC_COUNT} "
          f"records equal to RecordIOReader's in {secs:.3f} s (with the "
          f"copies back); tuner {rit._tuner.summary()}")
    rit.close()

    # (c) the HBM gauges
    torch.cuda.synchronize()
    pub = telemetry.resource_sample()
    in_use, limit = (torch.cuda.memory_allocated(),
                     torch.cuda.mem_get_info()[1])
    print(f"observability [resource_sample]: {pub}; "
          f"torch.cuda.memory_allocated {in_use}, total memory {limit}")
    check(pub == {"resource.hbm_bytes_in_use": in_use,
                  "resource.hbm_bytes_limit": limit}
          and telemetry.gauge_get("resource.hbm_bytes_in_use") == in_use,
          f"HBM gauges {pub} vs {in_use}, {limit}")

    # (d) a watchdog stall: the consumer sleeps on one batch
    os.environ["DMLCTPU_WATCHDOG_DEADLINE_S"] = "1"
    stalls0 = telemetry.watchdog_stall_count()
    try:
        with telemetry.capture_logs(min_severity=2) as logs:
            sit = DeviceStagingIter(uri, **kw)
            n = 0
            for i, b in enumerate(sit):
                n += 1
                if i == 1:
                    time.sleep(OBS_STALL_S)
            sit.close()
    finally:
        del os.environ["DMLCTPU_WATCHDOG_DEADLINE_S"]
    rec = telemetry.last_flight_record()
    with telemetry_http.serve() as srv:
        with urllib.request.urlopen(srv.url + "/flight", timeout=30) as r:
            served = json.loads(r.read())
    stage = (rec or {}).get("stalled_stage")
    print(f"observability [watchdog, deadline 1 s, a {OBS_STALL_S:.0f} s "
          f"sleep on batch 2 of {n}]: {telemetry.watchdog_stall_count() - stalls0}"
          f" stall(s), flight record stalled stage {stage!r}, "
          f"reason {(rec or {}).get('reason')!r}; log: "
          f"{logs[0][2][:160] if logs else None!r}")
    check(telemetry.watchdog_stall_count() > stalls0 and rec and stage,
          f"no flight record named a stalled stage: {rec and rec.keys()}")
    check(served.get("stalled_stage") == stage
          and served.get("stall_count") == rec.get("stall_count"),
          "/flight did not return the stall's flight record")

    # (e) the endpoints of the FM ScoringServer
    cfg = {"num_features": NUM_FEATURES, "num_factors": NUM_FACTORS,
           "sdot_backend": "pallas"}
    rng = np.random.default_rng(12)
    with ScoringServer(device=dev) as server:
        url = f"http://127.0.0.1:{server.http_port}"
        rep = push_snapshot("127.0.0.1", server.port,
                            pack_snapshot("fm", cfg, params, seq=1), seq=1)
        check(rep.get("ok"), f"snapshot push: {rep}")
        telemetry.trace_start()
        for n_rows in (1, 7, 64):
            rows = criteo_rows(rng, n_rows)
            doc, _ = post_score(url, rows)
            err = float(np.abs(np.asarray(doc["scores"], np.float64)
                               - fm_oracle(params, rows)).max())
            check(err <= TOL, f"/score error {err}")
        with urllib.request.urlopen(url + "/trace", timeout=30) as r:
            text = r.read().decode()
        names = {e["name"] for e in json.loads(text)["traceEvents"]}
        got = {}
        for p in ("/snapshot", "/timeseries", "/autotune"):
            with urllib.request.urlopen(url + p, timeout=30) as r:
                got[p] = (r.status, r.headers["Content-Type"],
                          json.loads(r.read()))
    telemetry.trace_stop()
    serve_spans = sorted(n for n in names if n.startswith("serve."))
    print(f"observability [ScoringServer endpoints]: /trace {len(text)} "
          f"bytes, valid by json_validate: {telemetry.json_validate(text)}, "
          f"serve spans {serve_spans}; " + ", ".join(
              f"{p} {s} {t}" for p, (s, t, _) in got.items())
          + f"; /timeseries holds {len(got['/timeseries'][2]['series'])} "
          f"series; /autotune {len(got['/autotune'][2]['decisions'])} "
          "decisions")
    check(telemetry.json_validate(text)
          and {"serve.request", "serve.device"} <= set(serve_spans),
          f"/trace: valid {telemetry.json_validate(text)}, {serve_spans}")
    check(all(s == 200 and t == "application/json"
              for s, t, _ in got.values())
          and got["/autotune"][2]["decisions"], f"endpoints: {got}")
    for key in OBS_ENV:
        del os.environ[key]
    secs = time.monotonic() - t_phase
    print(f"observability: phase {secs:.1f} s")
    return {"launches": launches, "steps": tuned["steps"], "secs": secs}


# ---- phase 11: a 2-rank job on the one card (slice 8) -----------------------

JOB_WORKER = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from dmlc_core_tpu_torch import parallel, telemetry
from dmlc_core_tpu_torch.data import DeviceStagingIter
from dmlc_core_tpu_torch.models import FactorizationMachine
from dmlc_core_tpu_torch.ops import segment_sum as ss_mod
from dmlc_core_tpu_torch.tracker import WorkerClient, metrics

uri, out, batch, bucket, nf, k = sys.argv[2], sys.argv[3], *map(int, sys.argv[4:8])
client = WorkerClient().start(world_size=int(os.environ["DMLC_NUM_WORKER"]))
# two ranks share one card: NCCL refuses that, gloo does not
info = parallel.init_from_env(backend="gloo")
dev = torch.device("cuda", 0)
telemetry.trace_start()
with telemetry.timeseries_from_env():  # held until the final push
    it = DeviceStagingIter(uri, batch_size=batch, nnz_bucket=bucket,
                           num_workers=2, part=info.task_id,
                           num_parts=info.num_workers, device=dev)
    fm = FactorizationMachine(nf, num_factors=k, sdot_backend="pallas",
                              device=dev).init(0)
    ss_mod.segment_sum_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rows = steps = 0
    for b in it:
        fm.train_step(b)
        rows += b.num_rows
        steps += 1
        if steps == 1:  # the process's first step: its warm-up
            torch.cuda.synchronize()
            t1 = time.monotonic()
    torch.cuda.synchronize()
    secs, first = time.monotonic() - t0, t1 - t0
    launches = ss_mod.segment_sum_kernel.launches
    it.close()
    total = torch.tensor([rows], dtype=torch.int64)
    dist.all_reduce(total)
    telemetry.trace_stop()
    # a probe push, then the final one: the clock offset the first
    # measures rides the second
    metrics.ensure_pusher().push()
    metrics.stop_pusher(final_push=True)
dist.destroy_process_group()
client.shutdown()
with open(out, "w") as f:
    json.dump({"task_id": info.task_id, "rabit_rank": client.rank,
               "rows": rows, "total": int(total), "steps": steps,
               "secs": secs, "first": first, "launches": launches}, f)
"""
JOB_RANKS = 2
JOB_TIMEOUT_S = 180


def phase_job(torch, dev, build_dir: Path, uri: str) -> dict:
    """The port's tracker runs a 2-rank local job on the one card: each rank
    rendezvouses (WorkerClient), joins a gloo process group from the DMLC_*
    contract (init_from_env), trains the FM over its half of the training
    file with the trace and time series on, all-reduces its row count,
    pushes its telemetry and shuts down; the tracker's job views hold both
    ranks."""
    import os

    from dmlc_core_tpu_torch import telemetry
    from dmlc_core_tpu_torch.tracker import submit
    t_job = time.monotonic()
    t_start = telemetry.now_us()
    procs, outs = [], []

    def spawn(num_workers, num_servers, envs):
        # the local backend's contract (tracker/launchers/local.py)
        for rank in range(num_workers):
            out = build_dir / f"job_rank{rank}.json"
            out.unlink(missing_ok=True)
            outs.append(out)
            env = dict(os.environ, **{k: str(v) for k, v in envs.items()},
                       DMLC_ROLE="worker", DMLC_TASK_ID=str(rank),
                       DMLC_JOB_CLUSTER="local", DMLCTPU_TIMESERIES="1",
                       DMLCTPU_TS_TICK_MS="100")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", JOB_WORKER, str(REPO), uri, str(out),
                 str(TRAIN_BATCH), str(TRAIN_NNZ_BUCKET), str(NUM_FEATURES),
                 str(NUM_FACTORS)], env=env))

    tracker = submit(JOB_RANKS, 0, spawn, host_ip="127.0.0.1")
    try:
        deadline = time.monotonic() + JOB_TIMEOUT_S
        while tracker.alive():
            failed = [p.returncode for p in procs
                      if p.poll() not in (None, 0)]
            check(not failed, f"a job rank failed: {failed}")
            check(time.monotonic() < deadline, "the job timed out")
            time.sleep(0.1)
        for p in procs:
            check(p.wait(timeout=60) == 0, f"a rank exited {p.returncode}")
        wall = time.monotonic() - t_job
        t_end = telemetry.now_us()
        snap = tracker.job_snapshot()
        trace = tracker.job_trace()
        series = tracker.metrics.job_timeseries()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        tracker.stop()
    ranks = [json.loads(o.read_text()) for o in outs]
    for r in ranks:
        rest = r["secs"] - r["first"]
        print(f"job rank {r['task_id']} (rabit rank {r['rabit_rank']}): "
              f"{r['steps']} FM steps, {r['rows']} rows in {r['secs']:.3f} s "
              f"({r['steps'] / r['secs']:.1f} steps/s); the first step "
              f"{r['first']:.3f} s (the process's warm-up), the other "
              f"{r['steps'] - 1} at {(r['steps'] - 1) / rest:.1f} steps/s; "
              f"{r['launches']} segment_sum launches; all-reduced rows "
              f"{r['total']}")
        check(r["total"] == TRAIN_ROWS,
              f"rank {r['task_id']}: all-reduced {r['total']} rows")
        check(r["launches"] == 3 * r["steps"],
              f"rank {r['task_id']}: {r['launches']} launches in "
              f"{r['steps']} steps")
    check(sum(r["rows"] for r in ranks) == TRAIN_ROWS, "ranks' rows")
    pids = {e["pid"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    od = trace["otherData"]
    spans = [e for e in trace["traceEvents"]
             if e.get("ph") == "X" and e["pid"] in (0, 1)]
    inside = all(t_start <= e["ts"] <= t_end for e in spans)
    fleet = snap["fleet"]["counters"]
    print(f"job: {JOB_RANKS} ranks, wall {wall:.1f} s (tracker up to "
          f"every rank's exit); job_snapshot hosts {sorted(snap['hosts'])}, "
          f"fleet h2d.batches {fleet.get('h2d.batches')}; job_trace pids "
          f"{sorted(pids)}, spans per rank {od['spans_per_host']}, clock "
          f"offsets {od['offsets_us']} us, every rank span inside the "
          f"tracker's window: {inside}; job_timeseries hosts "
          f"{sorted(series['hosts'])} ({series['num_hosts']})")
    check(sorted(snap["hosts"]) == [0, 1] and snap["num_hosts"] == 2,
          f"job_snapshot hosts {sorted(snap['hosts'])}")
    check({0, 1} <= pids and set(od["offsets_us"]) >= {"0", "1"} and inside,
          f"job_trace: pids {pids}, offsets {od['offsets_us']}, inside "
          f"{inside}")
    check(sorted(series["hosts"]) == ["0", "1"],
          f"job_timeseries hosts {sorted(series['hosts'])}")
    return {"launches": sum(r["launches"] for r in ranks),
            "steps": sum(r["steps"] for r in ranks), "wall": wall}


# ---- the mesh phase: the multi-process data plane ---------------------------

# Row-sharded fits and data-parallel steps over torch.distributed: each rank
# a process on the one card (gloo: NCCL refuses two ranks on one device),
# joined through the port's tracker as the job phase's ranks are.  Cut: 2
# and 4 ranks share one card here, so every collective is gloo through host
# memory; NCCL across cards is not measured.
MESH_TIMEOUT_S = 900
MESH_CHUNKS = 4  # DMLCTPU_MESH_OVERLAP_CHUNKS of the 4-rank job
MESH_BENCH_MIB = (0.25, 16.0)
MESH_FITS = {"dense": "Higgs-width fit", "sparse": "Bosch-width fit_batch",
             "streamed": "Bosch-width fit_streamed",
             "service": "Bosch-width fit_streamed over the data service"}
MESH_REPLACES = {"segment_sum": 67, "histogram_gh": 168,
                 "histogram_gh_sparse": 466}
# the 2-rank job's fit over the data service: its trees are cut to the text
# replay's (each level replays the ranks' shares of the epoch over the
# service), and a rank's batches hold up to SERVICE_NNZ_MAX entries (Bosch
# rows carry ~184)
SERVICE_TREES = TEXT_TREES
SERVICE_NNZ_MAX = STREAM_BATCH * 200


def share_rows(cache: Path, parts) -> list:
    """The rows of the global virtual ``parts`` of a binned cache file, in
    part order, as host lanes: labels, row lengths, and each entry's index,
    ebin and emask (``epoch_rows``'s lanes)."""
    from dmlc_core_tpu_torch.data.binned_cache import (_NativeReader,
                                                       unpack_block)
    lanes = ([], [], [], [], [])
    r = _NativeReader(str(cache))
    try:
        for g in parts:
            ent = r.part_map.get(g)
            if ent is None:
                continue
            r.seek_to(int(ent["offset"]))
            for _ in range(int(ent["records"])):
                b = unpack_block(r.next_block_view())
                n, nnz = int(b["num_rows"]), int(b["nnz"])
                for out, x in zip(lanes, (
                        b["label"][:n], np.diff(b["row_ptr"][:n + 1]),
                        b["index"][:nnz], b["ebin"][:nnz],
                        b["emask"][:nnz])):
                    out.append(np.array(x))
    finally:
        r.close()
    return [np.concatenate(x).astype(dt) if x else np.zeros(0, dt)
            for x, dt in zip(lanes, (np.float32, np.int32, np.int32,
                                     np.uint8, np.bool_))]


def lanes_digest(lanes) -> list:
    return [hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()
            for x in lanes]


def _wait_timed(it, log: dict):
    """``it``'s items, the consumer's wait for each added to
    ``log["service_wait_ms"]``."""
    try:
        while True:
            t0 = time.monotonic()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                log["service_wait_ms"] += (time.monotonic() - t0) * 1e3
            yield item
    finally:
        it.close()


def service_rank(torch, work: Path, rank: int, plan, dev, log: dict, fit,
                 out: dict) -> None:
    """The 2-rank job's fit over the data service, on one rank: wait for
    the job's staging workers; one epoch of this rank's share, held to the
    share's rows in the workers' cache file; ``fit_streamed`` over the
    service (``fit``'s counts and times, plus the consumer's wait on the
    service); then an epoch in which rank 0 SIGKILLs the worker of its
    first lease as it fetches."""
    import os
    import signal

    from dmlc_core_tpu_torch.dataservice import DataServiceIter
    from dmlc_core_tpu_torch.dataservice.server import spec_key
    from dmlc_core_tpu_torch.models import GBDT, QuantileBinner
    from dmlc_core_tpu_torch.tracker import metrics as tm
    board = tm.shard_client_from_env()

    def state():
        return board.data_req({"op": "state"})

    t0 = time.monotonic()
    while sum(not w["dead"] for w in state()["workers"].values()) \
            < DS_WORKERS:
        check(time.monotonic() - t0 < DS_READY_S, "the job's staging "
              "workers did not register on the lease board")
        time.sleep(0.2)
    binner = QuantileBinner(GBDT_KW["num_bins"], missing_aware=True,
                            device=dev)
    ds = DataServiceIter((work / "stream_uri.txt").read_text(), binner,
                         sharding=plan, nnz_max=SERVICE_NNZ_MAX, retries=8,
                         device=dev, batch_size=STREAM_BATCH,
                         nnz_bucket=STREAM_BUCKET, shard_client=board)
    t0 = time.monotonic()
    ds.ensure_meta()
    build_s = time.monotonic() - t0
    cache = work / "dataservice" / (spec_key(ds.spec) + ".bincache")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    mine = [x.cpu().numpy() for x in epoch_rows(torch, ds)]
    epoch_s = time.monotonic() - t0
    want = share_rows(cache, ds.share)
    out["service_rows"] = {
        "share": [ds.share.start, ds.share.stop],
        "parts": ds.meta["virtual_parts"], "rows": int(mine[0].size),
        "digest": lanes_digest(mine), "cache": cache.name,
        "own": all(np.array_equal(a, b) for a, b in zip(mine, want)),
        "epoch_s": epoch_s, "build_s": build_s}
    del mine, want

    model = GBDT(num_features=BOSCH_FEATURES, missing_aware=True, device=dev,
                 histogram_mesh=plan,
                 **dict(GBDT_KW, num_trees=SERVICE_TREES))
    host_iter = ds._stager.host_iter
    ds._stager.host_iter = lambda produce, prefetch: _wait_timed(
        host_iter(produce, prefetch), log)
    log["service_wait_ms"] = 0.0
    epoch0 = ds._epoch
    fit("service", lambda: model.fit_streamed(lambda: iter(ds), binner),
        model, "_level_histogram_sparse")
    ds._stager.host_iter = host_iter
    out["service"].update(wait_ms=log["service_wait_ms"],
                          epochs=ds._epoch - epoch0)

    # the failover epoch: rank 0 SIGKILLs the worker its first lease was
    # placed on just before fetching it (a worker dying mid-epoch: leases
    # are out, parts in flight), then fetches the part from it all the same
    epoch, killed = ds._epoch, []
    fetch_from, lock = ds._fetch_from, threading.Lock()

    def killing_fetch(worker, part):
        with lock:
            if not killed:
                killed.append(worker["id"])
                os.kill(int(worker["id"].rsplit("-", 1)[1]), signal.SIGKILL)
        return fetch_from(worker, part)

    if rank == 0:
        ds._fetch_from = killing_fetch
    lanes = [x.cpu().numpy() for x in epoch_rows(torch, ds)]
    ds._fetch_from = fetch_from
    lease = state()["leases"][ds.client_id][str(epoch)]
    out["service_failover"] = {
        "digest": lanes_digest(lanes), "killed": killed[0] if killed else None,
        "failovers": len(lease["failovers"]),
        "parts": sorted({f["part"] for f in lease["failovers"]}),
        "pending": lease["pending"], "shards": lease["shards"],
        "done": lease["done"]}


def _timed_plan(torch, plan, log: dict, keep_big: bool = True):
    """Wrap the plan's collectives: host-blocking ms (the call through the
    result's wait) into ``log["collective_ms"]``, their input bytes into
    ``log["collective_bytes"]``, the all-reduces' count into
    ``log["collectives"]`` and routes into ``log["strategies"]``; with
    ``keep_big``, the
    first reduction of more than 1M values is kept in ``log["big"]`` (a
    data-parallel step's flat gradient)."""
    log.setdefault("collective_ms", 0.0)
    log.setdefault("collectives", 0)
    log.setdefault("collective_bytes", 0)
    log.setdefault("strategies", set())
    orig_async, orig_gather = plan.allreduce_async, plan.all_gather

    class Timed:
        def __init__(self, work, t0, x):
            self.work, self.t0, self.x = work, t0, x

        def wait(self):
            out = self.work.wait()
            if out.is_cuda:
                torch.cuda.current_stream().synchronize()
            log["collective_ms"] += (time.monotonic() - self.t0) * 1e3
            log["collectives"] += 1
            log["collective_bytes"] += self.x.numel() * self.x.element_size()
            if keep_big and self.x.numel() > (1 << 20) and "big" not in log:
                log["big"] = out.detach().cpu().clone()
            return out

    def allreduce_async(x, op="sum", strategy=None):
        log["strategies"].add(strategy or plan.strategy_for(
            x.numel() * x.element_size()))
        t0 = time.monotonic()
        return Timed(orig_async(x, op, strategy), t0, x)

    def all_gather(x):
        t0 = time.monotonic()
        out = orig_gather(x)
        log["collective_ms"] += (time.monotonic() - t0) * 1e3
        log["collective_bytes"] += x.numel() * x.element_size()
        return out

    plan.allreduce_async, plan.all_gather = allreduce_async, all_gather


def _event_timed(torch, mod, name: str, log: dict) -> None:
    """Sum the device ms of every ``mod.name`` launch (CUDA events around
    it on the current stream) into ``log[name]``, read at :func:`_events_ms`
    time."""
    fn = getattr(mod, name)
    log.setdefault("events", []).append(name)
    log.setdefault(name, [])

    def timed(*a, **k):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fn(*a, **k)
        e1.record()
        log[name].append((e0, e1))
        return out

    setattr(mod, name, timed)


def _events_ms(torch, log: dict) -> float:
    torch.cuda.synchronize()
    ms = 0.0
    for name in log.get("events", []):
        ms += sum(a.elapsed_time(b) for a, b in log[name])
        log[name] = []
    return ms


# the dp x tp runs of the 4-rank job: (data, model) plan shapes, and each
# family's steps on each (a few: gloo stages every exchange through host
# memory, and the FFM's model-axis sums are 199 MB a step)
TP_SHAPES = ((2, 2), (1, 4))
TP_STEPS = {"fm": 5, "ffm": 4}


def tp_rank(torch, work: Path, rank: int, dev, out: dict) -> None:
    """This rank's dp x tp runs (the 4-rank job): the Criteo-width FM and
    FFM sharded by feature over a (data, model) plan of each TP_SHAPES
    shape, staged from the training files' parts (part d of D), TP_STEPS
    steps with ``sdot_backend="pallas"``.  Each run's counts are set to 0
    just before it and read just after: segment-sum launches and
    one-process kernel launches (``segment_sum._launch``); each step's wall
    (host clock, synchronised) and each axis's collectives in it (ms,
    bytes); the first step's margins, each step's staged-batch digest and
    global rows, the resident table's size and the blocks after the steps
    are kept (the blocks under WORK for the parent).  The 2 x 2 FM then
    stages the rest of its epoch (no steps) for the parent's row count."""
    from dmlc_core_tpu_torch import parallel
    from dmlc_core_tpu_torch.data import DeviceStagingIter
    from dmlc_core_tpu_torch.models import (FactorizationMachine,
                                            FieldAwareFactorizationMachine)
    from dmlc_core_tpu_torch.ops import segment_sum as ss_mod
    uris = {"fm": (work / "uri.txt").read_text(),
            "ffm": (work / "ffm_uri.txt").read_text()}
    nnz_max = TRAIN_BATCH * NNZ_PER_ROW
    one_process = [0]
    launch = ss_mod._launch

    def counted(*a):
        one_process[0] += 1
        return launch(*a)

    ss_mod._launch = counted

    def host_batch(b, leaves):
        got = {k: getattr(b, k).cpu().numpy() for k in leaves}
        got["num_rows"] = b.num_rows
        return got

    for D, M in TP_SHAPES:
        plan = parallel.MeshPlan(parallel.make_mesh((D, M),
                                                    ("data", "model")),
                                 ("data",), collective="flat")
        logs = {"data": {}, "model": {}}
        _timed_plan(torch, plan, logs["data"], keep_big=False)
        _timed_plan(torch, plan.model, logs["model"], keep_big=False)
        for family, steps in TP_STEPS.items():
            leaves = FFM_LEAVES if family == "ffm" else STAGED_LEAVES
            if family == "fm":
                model = FactorizationMachine(
                    NUM_FEATURES, num_factors=NUM_FACTORS,
                    sdot_backend="pallas", mesh_plan=plan, device=dev)
            else:
                model = FieldAwareFactorizationMachine(
                    learning_rate=FFM_LR, l2=FFM_L2, mesh_plan=plan,
                    device=dev, **FFM_CFG)
            model.init(0)
            it = DeviceStagingIter(
                uris[family], batch_size=TRAIN_BATCH,
                nnz_bucket=TRAIN_NNZ_BUCKET, nnz_max=nnz_max, num_workers=2,
                part=plan.shard_index, num_parts=plan.num_shards,
                sharding=plan, with_field=family == "ffm", device=dev)
            margins = model.margins
            kept = []

            def keep(b, margins=margins, kept=kept):
                m = margins(b)
                if not kept:
                    kept.append(m.detach().cpu().numpy())
                return m

            model.margins = keep
            batches, losses, per_step = [], [], []
            ss_mod.segment_sum_kernel.launches = one_process[0] = 0
            batch_iter = iter(it)
            for _ in range(steps):
                b = next(batch_iter)
                batches.append((leaves_digest(host_batch(b, leaves), leaves),
                                b.num_rows, b.global_num_rows))
                for log in logs.values():
                    log.update(collective_ms=0.0, collective_bytes=0)
                torch.cuda.synchronize()
                t0 = time.monotonic()
                losses.append(float(model.train_step(b)))
                torch.cuda.synchronize()
                per_step.append({"secs": time.monotonic() - t0, **{
                    f"{axis}_{k}": logs[axis][f"collective_{k}"]
                    for axis in logs for k in ("ms", "bytes")}})
            run = {"steps": steps, "per_step": per_step, "losses": losses,
                   "segment_sum": ss_mod.segment_sum_kernel.launches,
                   "one_process": one_process[0], "batches": batches,
                   "block": list(model.table_block),
                   "numel": {k: model.get_parameter(k).numel()
                             for k in ("w", "v")}}
            if (D, M) == (2, 2) and family == "fm":
                rest = [(leaves_digest(host_batch(b, leaves), leaves),
                         b.num_rows, b.global_num_rows) for b in batch_iter]
                run["rest"] = rest
            batch_iter.close()  # stops the epoch's producer threads
            it.close()
            np.savez(work / f"tp_{family}_{D}x{M}_rank{rank}.npz",
                     margins=kept[0],
                     **{k: v.detach().cpu().numpy()
                        for k, v in model.state_dict().items()})
            out[f"tp_{family}_{D}x{M}"] = run
            del model, it, batch_iter
            torch.cuda.empty_cache()
    ss_mod._launch = launch


def mesh_worker(argv) -> int:
    """One rank of the mesh phase's job (``chip_smoke.py --mesh-rank WORK
    JOB``): joins the tracker and a gloo process group from the DMLC_*
    contract, fits the Higgs-width forest on its contiguous rows, the
    Bosch-width one by fit_batch and by fit_streamed, in the 2-rank job
    trains the FM data-parallel from its part of the training file,
    checkpoints it and benches the collectives, and in the 4-rank job
    trains the FM and FFM sharded by feature (:func:`tp_rank`); writes its
    readings and forests under WORK."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from dmlc_core_tpu_torch import checkpoint, parallel
    from dmlc_core_tpu_torch.data import DeviceStagingIter, PaddedBatch
    from dmlc_core_tpu_torch.models import (GBDT, FactorizationMachine,
                                            QuantileBinner)
    from dmlc_core_tpu_torch.ops import histogram as hg
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    from dmlc_core_tpu_torch.ops import segment_sum as ss_mod
    from dmlc_core_tpu_torch.tracker import WorkerClient

    work, job = Path(argv[0]), argv[1]
    client = WorkerClient().start(world_size=int(os.environ["DMLC_NUM_WORKER"]))
    info = parallel.init_from_env(backend="gloo")
    rank, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    plan = parallel.MeshPlan.build()
    log: dict = {}
    _timed_plan(torch, plan, log)
    _event_timed(torch, hg, "histogram_gh_accumulate", log)
    _event_timed(torch, hs, "histogram_gh_sparse_accumulate", log)
    _event_timed(torch, ss_mod, "segment_sum_accumulate", log)
    out = {"rank": rank, "n": n, "task_id": info.task_id,
           "plan": plan.describe()}

    def fit(what, run, levels_of, hook):
        """A timed fit with the launch counts set to 0 just before it and
        read just after, its first tree's reduced histograms kept."""
        levels = []
        orig = getattr(levels_of, hook)

        def keep(*a):
            h = orig(*a)
            if len(levels) < GBDT_KW["max_depth"]:
                levels.append(h.cpu().numpy())
            return h

        setattr(levels_of, hook, keep)
        for kern in (hg.histogram_gh_kernel, hs.histogram_gh_sparse_kernel,
                     ss_mod.segment_sum_kernel):
            kern.launches = 0
        _events_ms(torch, log)
        log["collective_ms"], log["collectives"] = 0.0, 0
        log["strategies"] = set()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.monotonic()
        forest = run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        setattr(levels_of, hook, orig)
        np.savez(work / f"{what}_{job}_rank{rank}.npz",
                 **{k: v.cpu().numpy() for k, v in forest.items()},
                 **{f"level{d}": h for d, h in enumerate(levels)})
        out[what] = {
            "secs": wall, "kernel_ms": _events_ms(torch, log),
            "collective_ms": log["collective_ms"],
            "collectives": log["collectives"],
            "strategies": sorted(log["strategies"]),
            "histogram_gh": hg.histogram_gh_kernel.launches,
            "histogram_gh_sparse": hs.histogram_gh_sparse_kernel.launches,
            "segment_sum": ss_mod.segment_sum_kernel.launches}

    # (a) the Higgs-width dense fit on this rank's contiguous rows
    bins_all = np.load(work / "higgs_bins.npy", mmap_mode="r")
    label_all = np.load(work / "higgs_label.npy", mmap_mode="r")
    rows = bins_all.shape[0]
    lo, hi = rows * rank // n, rows * (rank + 1) // n
    bins = torch.from_numpy(np.array(bins_all[lo:hi])).to(dev)
    label = torch.from_numpy(np.array(label_all[lo:hi])).to(dev)
    del bins_all, label_all
    model = GBDT(num_features=HIGGS_FEATURES, device=dev, histogram_mesh=plan,
                 **GBDT_KW)
    fit("dense", lambda: model.fit(bins, label), model, "_level_histogram")
    del bins, label

    # (b) the Bosch-width sparse fit_batch on this rank's contiguous rows
    data = bosch_like(torch, dev)
    lo, hi = BOSCH_ROWS * rank // n, BOSCH_ROWS * (rank + 1) // n
    rp = data["row_ptr"]
    e0, e1 = int(rp[lo]), int(rp[hi])
    batch = PaddedBatch(label=data["label"][lo:hi].contiguous(),
                        weight=torch.ones(hi - lo, device=dev),
                        row_ptr=(rp[lo:hi + 1] - e0).contiguous(),
                        index=data["index"][e0:e1].contiguous(),
                        value=data["value"][e0:e1].contiguous(),
                        num_rows=hi - lo)
    binner = QuantileBinner.from_cuts(np.load(work / "bosch_cuts.npy"),
                                      GBDT_KW["num_bins"],
                                      missing_aware=True, device=dev)
    smodel = GBDT(num_features=BOSCH_FEATURES, missing_aware=True,
                  device=dev, histogram_mesh=plan, **GBDT_KW)
    fit("sparse", lambda: smodel.fit_batch(batch, binner), smodel,
        "_level_histogram_sparse")
    del batch

    # (b2) fit_streamed over this rank's share of the streamed phase's
    # rows, replayed in STREAM_BATCH-row batches
    lo, hi = STREAM_ROWS * rank // n, STREAM_ROWS * (rank + 1) // n
    parts = [sub_batch(torch, PaddedBatch, data, a, min(a + STREAM_BATCH, hi))
             for a in range(lo, hi, STREAM_BATCH)]
    del data
    fit("streamed", lambda: smodel.fit_streamed(parts, binner), smodel,
        "_level_histogram_sparse")
    del parts

    if job == "quad":
        # (b4) the FM and FFM tables sharded by feature (dp x tp)
        tp_rank(torch, work, rank, dev, out)

    if job == "pair":
        # (b3) fit_streamed over the data service, each rank on its share
        service_rank(torch, work, rank, plan, dev, log, fit, out)

        # (c) the FM, data-parallel, one epoch of this rank's part
        uri = (work / "uri.txt").read_text()
        nnz_max = TRAIN_BATCH * NNZ_PER_ROW
        want = host_packed(uri, TRAIN_BATCH, nnz_max, part=rank,
                           num_parts=n)
        it = DeviceStagingIter(uri, batch_size=TRAIN_BATCH,
                               nnz_bucket=TRAIN_NNZ_BUCKET, nnz_max=nnz_max,
                               num_workers=2, part=rank, num_parts=n,
                               sharding=plan, device=dev)
        fm = FactorizationMachine(NUM_FEATURES, num_factors=NUM_FACTORS,
                                  sdot_backend="pallas", device=dev).init(0)
        ss_mod.segment_sum_kernel.launches = 0
        log["collective_ms"], log["collectives"] = 0.0, 0
        log.pop("big", None)  # the first step's flat gradient is kept
        steps = padding = mismatched = 0
        first = None
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.monotonic()
        for b in it:
            if steps < len(want):
                got = {k: getattr(b, k).cpu().numpy() for k in STAGED_LEAVES}
                got["num_rows"] = b.num_rows
                mismatched += batch_mismatch(got, want[steps]) is not None
            else:
                padding += 1
            loss = fm.train_step(b)
            steps += 1
            if steps == 1:
                torch.cuda.synchronize()
                first = time.monotonic() - t0
                torch.save(log.pop("big"), work / f"fm_grad_rank{rank}.pt")
                out["fm_first_loss"] = float(loss)
                out["fm_first_global_rows"] = b.global_num_rows
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        it.close()
        flat = torch.cat([p.detach().reshape(-1) for p in fm.parameters()])
        out["fm"] = {
            "steps": steps, "local_batches": len(want), "padding": padding,
            "rows": sum(int(w["num_rows"]) for w in want),
            "mismatched": mismatched, "secs": secs, "first": first,
            "launches": ss_mod.segment_sum_kernel.launches,
            "collective_ms": log["collective_ms"],
            "digest": hashlib.sha256(flat.cpu().numpy().tobytes())
            .hexdigest()}
        # (d) the checkpoint from both ranks, loaded back on both
        path = work / "fm_two_rank.ckpt"
        out["ckpt_leaves"] = checkpoint.save(fm.state_dict(), str(path))
        back = checkpoint.load(str(path), like=fm.state_dict(), device=dev)
        out["ckpt_loaded"] = all(torch.equal(back[k], v)
                                 for k, v in fm.state_dict().items())
        # (e) the collectives over the 2-rank gloo group
        out["bench"] = (
            [parallel.collective_bench(None, op, mib, 5, 2)
             for op in ("allreduce", "allgather", "reducescatter",
                        "ppermute") for mib in MESH_BENCH_MIB]
            + [parallel.plan_allreduce_bench(plan, s, mib, 5, 2)
               for s in ("flat", "hier") for mib in MESH_BENCH_MIB])
    dist.destroy_process_group()
    client.shutdown()
    (work / f"{job}_rank{rank}.json").write_text(json.dumps(out))
    return 0


def run_mesh_job(work: Path, job: str, ranks: int, env: dict,
                 data_service: int = 0) -> tuple:
    """The tracker's local job of ``ranks`` mesh workers, and with
    ``data_service`` that many staging workers on the card under the job's
    tracker (``submit(data_service=...)``, caching under WORK/dataservice,
    emptied first); the ranks' readings and the staging workers' exit
    codes."""
    import os
    import shutil

    from dmlc_core_tpu_torch.tracker import submit
    procs, extra = [], None
    if data_service:
        cache_dir = work / "dataservice"
        shutil.rmtree(cache_dir, ignore_errors=True)
        extra = {"DMLCTPU_DATASERVICE_CACHE_DIR": str(cache_dir),
                 "PYTHONPATH": str(REPO)}

    def spawn(num_workers, num_servers, envs):
        for rank in range(num_workers):
            (work / f"{job}_rank{rank}.json").unlink(missing_ok=True)
            e = dict(os.environ, **{k: str(v) for k, v in envs.items()},
                     **env, DMLC_ROLE="worker", DMLC_TASK_ID=str(rank),
                     DMLC_JOB_CLUSTER="local")
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--mesh-rank",
                 str(work), job], env=e))

    t0 = time.monotonic()
    tracker = submit(ranks, 0, spawn, host_ip="127.0.0.1", extra_envs=extra,
                     data_service=data_service)
    service = tracker.data_service_procs
    try:
        deadline = time.monotonic() + MESH_TIMEOUT_S
        while tracker.alive():
            failed = [p.returncode for p in procs
                      if p.poll() not in (None, 0)]
            check(not failed, f"a {job} rank failed: {failed}")
            check(time.monotonic() < deadline, f"the {job} job timed out")
            time.sleep(0.2)
        for p in procs:
            check(p.wait(timeout=120) == 0, f"a {job} rank exited "
                  f"{p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        exits = [p.poll() for p in service]
        for p in service:
            if p.poll() is None:
                p.terminate()
        for p in service:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        tracker.stop()
    out = [json.loads((work / f"{job}_rank{r}.json").read_text())
           for r in range(ranks)]
    print(f"mesh {job}: {ranks} ranks, wall {time.monotonic() - t0:.1f} s "
          f"(processes up to exit); plan {out[0]['plan']}")
    return out, exits


def _forests(work: Path, what: str, job: str, ranks: int) -> list:
    return [dict(np.load(work / f"{what}_{job}_rank{r}.npz"))
            for r in range(ranks)]


def _same(a: dict, b: dict, keys=None) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in (keys or a))


def global_batch(torch, PaddedBatch, parts: list, dev) -> object:
    """The JAX package's global batch of the data groups' host batches:
    rows and lanes concatenated, each group's row boundaries shifted into
    its own lanes (as multi-process staging's ``global_row_ptr``)."""
    leaves = [k for k in ("label", "weight", "index", "value", "field")
              if k in parts[0]]
    g = {k: np.concatenate([p[k] for p in parts]) for k in leaves}
    shift = np.cumsum([0] + [len(p["index"]) for p in parts])
    g["row_ptr"] = np.concatenate(
        [p["row_ptr"][:-1] + shift[d] for d, p in enumerate(parts)]
        + [[shift[-1]]]).astype(np.int32)
    return PaddedBatch(num_rows=sum(int(p["num_rows"]) for p in parts), **{
        k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        for k, v in g.items()})


def tp_checks(torch, dev, work: Path, quad: list, fms: list,
              dp_bytes: int, smi: str) -> dict:
    """The 4-rank job's dp x tp runs against a one-process run of the same
    global batches on the card: (a) every rank's blocks after the steps
    within TOL of the block's largest entry, b equal on every rank; (b) on
    the 1 x 4 plan, the first FM step's margins bit for bit the one-process
    kernel's; (c) 3 segment-sum launches an FM step and 1 an FFM step, all
    accumulate launches (no one-process launch); (d) resident blocks of
    F/M rows; (e) each rank's staged batches equal to its data group's
    part's host packing (so equal within the group), their global rows
    counting each group once, and the 2 x 2 FM groups' epochs together the
    training file's rows; (f) steps/s and each axis's collectives a step
    beside the 2-rank data-parallel FM's.  Returns each shape's first FM
    batch and the one-process FM's params after its steps."""
    from dmlc_core_tpu_torch.data import PaddedBatch
    from dmlc_core_tpu_torch.models import (FactorizationMachine,
                                            FieldAwareFactorizationMachine)
    uris = {"fm": (work / "uri.txt").read_text(),
            "ffm": (work / "ffm_uri.txt").read_text()}
    nnz_max = TRAIN_BATCH * NNZ_PER_ROW
    inputs = {}
    for D, M in TP_SHAPES:
        for family, steps in TP_STEPS.items():
            ffm = family == "ffm"
            leaves = FFM_LEAVES if ffm else STAGED_LEAVES
            tag = f"{D}x{M} dp x tp {family.upper()}"
            parts = [host_packed(uris[family], TRAIN_BATCH, nnz_max,
                                 with_field=ffm, part=d, num_parts=D,
                                 limit=steps) for d in range(D)]
            if ffm:
                one = FieldAwareFactorizationMachine(
                    learning_rate=FFM_LR, l2=FFM_L2, device=dev, **FFM_CFG)
            else:
                one = FactorizationMachine(NUM_FEATURES,
                                           num_factors=NUM_FACTORS,
                                           sdot_backend="pallas", device=dev)
            one.init(0)
            losses = []
            for i in range(steps):
                gb = global_batch(torch, PaddedBatch, [p[i] for p in parts],
                                  dev)
                if i == 0:
                    with torch.no_grad():
                        margins = one.margins(gb).cpu().numpy()
                    if not ffm:  # a rank's batch: its data group's
                        first = global_batch(torch, PaddedBatch,
                                             [parts[0][0]], dev)
                losses.append(float(one.train_step(gb)))
            want = {k: v.detach() for k, v in one.state_dict().items()}
            if not ffm:
                inputs[(D, M)] = (first, want)
            runs = [r[f"tp_{family}_{D}x{M}"] for r in quad]
            worst = 0.0
            for r, run in zip(quad, runs):
                d, lo, hi = r["rank"] // M, *run["block"]
                got = np.load(work / f"tp_{family}_{D}x{M}_rank{r['rank']}"
                              ".npz")
                for k in ("w", "v"):
                    blk = want[k][lo:hi].cpu().numpy()
                    err = float(np.abs(got[k] - blk).max()
                                / max(np.abs(blk).max(), 1e-30))
                    worst = max(worst, err)
                    check(err <= TOL, f"{tag} rank {r['rank']}: {k} block "
                          f"{err:.3e} of its largest entry from the "
                          "one-process run")
                check(np.array_equal(got["b"], np.load(
                    work / f"tp_{family}_{D}x{M}_rank0.npz")["b"])
                    and abs(float(got["b"]) - float(want["b"])) <= TOL,
                    f"{tag} rank {r['rank']}: b {got['b']} (one-process "
                    f"{float(want['b'])})")
                np.testing.assert_allclose(run["losses"], losses,
                                           rtol=1e-5, err_msg=tag)
                if (D, M) == (1, 4) and not ffm:
                    check(np.array_equal(got["margins"], margins),
                          f"{tag} rank {r['rank']}: the first step's "
                          "margins differ from the one-process kernel's")
                per = {"fm": 3, "ffm": 1}[family]
                check(run["segment_sum"] == per * steps
                      and run["one_process"] == 0,
                      f"{tag} rank {r['rank']}: {run['segment_sum']} "
                      f"segment-sum launches ({run['one_process']} "
                      f"one-process) in {steps} steps, want {per} "
                      "accumulate launches a step")
                rows = NUM_FEATURES // M
                check(run["block"] == [(r["rank"] % M) * rows,
                                       (r["rank"] % M + 1) * rows]
                      and run["numel"]["w"] == rows
                      and run["numel"]["v"] == rows * (
                          FFM_FIELDS * FFM_FACTORS if ffm else NUM_FACTORS),
                      f"{tag} rank {r['rank']}: block {run['block']}, "
                      f"resident {run['numel']}")
                for i, (digest, n, glob) in enumerate(run["batches"]):
                    check(digest == leaves_digest(parts[d][i], leaves)
                          and n == parts[d][i]["num_rows"]
                          and glob == (None if D == 1 else sum(
                              int(p[i]["num_rows"]) for p in parts)),
                          f"{tag} rank {r['rank']} batch {i}: not its data "
                          f"group's part {d} of {D} (rows {n}, global "
                          f"{glob})")
            if "rest" in runs[0]:
                for r, run in zip(quad, runs):
                    peer = runs[(r["rank"] // M) * M]
                    check(run["rest"] == peer["rest"],
                          f"{tag} rank {r['rank']}: the rest of its epoch "
                          "differs from its data group's first rank's")
                total = sum(n for run in runs[::M]
                            for _, n, _ in run["batches"] + run["rest"])
                check(total == TRAIN_ROWS and all(
                    g == sum(runs[d * M][key][i][1] for d in range(D))
                    for key in ("batches", "rest")
                    for i, (_, _, g) in enumerate(runs[0][key])),
                    f"{tag}: the groups' epochs hold {total} rows, want "
                    f"{TRAIN_ROWS}, or a batch's global rows count a group "
                    "twice")
            # after the first step (which pays the first launches, pinned
            # buffers and groups' first use), every rank's mean a step
            mean = {k: float(np.mean([x[k] for run in runs
                                      for x in run["per_step"][1:]]))
                    for k in runs[0]["per_step"][0]}
            first_s = float(np.mean([run["per_step"][0]["secs"]
                                     for run in runs]))
            print(f"mesh {tag}: {steps} steps a rank, blocks of "
                  f"{NUM_FEATURES // M} features ({runs[0]['numel']} "
                  f"resident), within {worst:.2e} of their largest entry "
                  f"from a one-process run of the same global batches; "
                  + ("first-step margins bit for bit the one-process "
                     "kernel's; " if (D, M) == (1, 4) and not ffm else "")
                  + f"{runs[0]['segment_sum'] // steps} accumulate launch(es)"
                  f" a step, no one-process launch; each rank's batches = "
                  f"its data group's part (d of {D}) bit for bit; "
                  f"{1 / mean['secs']:.2f} steps/s a rank after "
                  f"{first_s:.3f} s for the first; a step's model-axis "
                  f"collectives {mean['model_ms']:.1f} ms, "
                  f"{mean['model_bytes'] / 2**20:.2f} MiB, data-axis "
                  f"{mean['data_ms']:.1f} ms, "
                  f"{mean['data_bytes'] / 2**20:.2f} MiB (host-blocking; "
                  f"gloo through host memory, 4 ranks on one card); card "
                  f"{smi}")
            del one
    dp = fms[0]
    print(f"mesh tp baseline beside the 2-rank data-parallel FM: "
          f"{dp['steps'] / dp['secs']:.2f} steps/s a rank, all-reduce "
          f"{dp['collective_ms'] / dp['steps']:.1f} ms and "
          f"{dp_bytes / 2**20:.2f} MiB a step (the whole gradient); card "
          f"{smi}")
    return {"inputs": inputs}


def tp_accumulate_cases(torch, ss_mod, inputs: dict, quad: list) -> list:
    """The dp x tp steps' accumulate launch at a model rank's share of each
    plan shape's first FM batch (the last block's entries, where indices
    past the table land; the one-process FM's params after its steps), at
    the whole batch's scale, L=16 and L=1: for the mesh phase's ``held``,
    with the launches of every rank's run at that lane count."""
    from dmlc_core_tpu_torch.ops.fixed_point import (fixed_point_scale,
                                                     lane_amax, value_limit)
    from dmlc_core_tpu_torch.ops.segment_sum import clamp_index
    cases = []
    for (D, M), (gb, fm_p) in inputs.items():
        B = gb.batch_size
        c_all = clamp_index(gb.index, NUM_FEATURES)
        own = c_all >= NUM_FEATURES // M * (M - 1)
        rid = gb.row_ids()[own].contiguous()
        fm_l, ffm_l = (sum(r[f"tp_{f}_{D}x{M}"]["segment_sum"] for r in quad)
                       for f in ("fm", "ffm"))
        for lanes in (NUM_FACTORS, 1):
            tab = fm_p["v"] if lanes > 1 else fm_p["w"][:, None]
            full = (tab[c_all] * gb.value[:, None]).contiguous()
            c_m = full[own].contiguous()
            nnz = full.shape[0]
            sc = fixed_point_scale(lane_amax(full), nnz)
            q = value_limit(nnz)
            z = torch.zeros(B, lanes, device=full.device)
            cases.append(dict(
                share=f"a {M}-way model share of the {D}x{M} dp x tp FM's "
                      f"first batch ({c_m.shape[0]} of {nnz} entries x "
                      f"L={lanes} into {B} rows, the last block's)",
                fns=(lambda c=c_m, r=rid, sc=sc, q=q:
                     ss_mod.segment_sum_accumulate(c, r, B, sc, q),
                     lambda c=c_m, r=rid, sc=sc, q=q:
                     ss_mod.segment_sum_accumulate_plain(c, r, B, sc, q),
                     lambda a, sc=sc, n=lanes:
                     ss_mod.segment_sum_dequantize(a, sc, B, n),
                     lambda z=z, i=rid.long(), c=c_m:
                     torch.index_add(z, 0, i, c)),
                nbytes=(4 * lanes + 4) * c_m.shape[0] + 8 * lanes * (B + 1),
                scale=sc, lanes=lanes,
                launches=fm_l * 2 // 3 if lanes > 1 else fm_l // 3 + ffm_l,
                of=f"every rank of the 4-rank job's {D}x{M} dp x tp "
                   + ("FM and FFM steps (their linear terms)" if lanes == 1
                      else "FM steps (the two factor sums)")))
    return cases


def phase_mesh(torch, ss_mod, dev, build_dir: Path, gbdt: dict,
               sparse: dict, sparse_data: dict, streamed: dict,
               train: dict, served_fit: dict) -> dict:
    """The multi-process data plane on the card: the Higgs-width fit on 2
    ranks (flat) and 4 ranks (DMLCTPU_MESH_HOSTS=2, the hier route, and
    DMLCTPU_MESH_OVERLAP_CHUNKS=4), the Bosch-width fit_batch and the
    streamed phase's fit_streamed on both, held to the one-process kernels
    (each rank's first-tree histograms bit for bit, forests equal on every
    rank and across the jobs, splits equal to the one-process forest); the
    FM trained data-parallel from the training file (staged batches vs the
    host parse, the first reduced gradient vs the one-process gradient of
    the global batch, replicas bitwise equal), its 2-rank checkpoint
    against a one-process save; the 4-rank job's dp x tp FM and FFM runs
    (:func:`tp_checks`); collective benches over gloo and over a 1-rank
    NCCL group; each kernel's accumulate half at the ranks' shapes (the
    dp x tp model shares included) against its plain version."""
    import torch.distributed as dist

    from dmlc_core_tpu_torch import checkpoint, parallel
    from dmlc_core_tpu_torch.data import PaddedBatch
    from dmlc_core_tpu_torch.models import (GBDT, FactorizationMachine,
                                            logistic_nll)
    from dmlc_core_tpu_torch.ops import histogram as hg
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    from dmlc_core_tpu_torch.ops.fixed_point import (dequantize_plain,
                                                     fixed_point_scale,
                                                     lane_amax, value_limit)
    from dmlc_core_tpu_torch.ops.sparse import padded_row_mean

    work = build_dir / "mesh"
    work.mkdir(parents=True, exist_ok=True)
    bins, label, forest1 = gbdt["bins"], gbdt["label"], gbdt["forest"]
    t0 = time.monotonic()
    np.save(work / "higgs_bins.npy", bins.cpu().numpy())
    np.save(work / "higgs_label.npy", label.cpu().numpy())
    np.save(work / "bosch_cuts.npy", sparse["binner"].cuts.cpu().numpy())
    (work / "uri.txt").write_text(train["uri"])
    (work / "ffm_uri.txt").write_text(ffm_file_uri(build_dir))
    (work / "stream_uri.txt").write_text(streamed["uri"])
    print(f"mesh inputs: Higgs codes and labels written for the ranks in "
          f"{time.monotonic() - t0:.1f} s")
    pair, service_exits = run_mesh_job(work, "pair", 2, {},
                                       data_service=DS_WORKERS)
    quad, _ = run_mesh_job(work, "quad", 4, {
        "DMLCTPU_MESH_HOSTS": "2", "DMLCTPU_MESH_COLLECTIVE": "hier",
        "DMLCTPU_MESH_OVERLAP_CHUNKS": str(MESH_CHUNKS)})
    check(pair[0]["plan"]["hosts"] == 1 and pair[0]["plan"]["collective"]
          == "auto", f"2-rank plan {pair[0]['plan']}")
    check(quad[0]["plan"]["hosts"] == 2 and quad[0]["plan"]["collective"]
          == "hier" and quad[0]["plan"]["overlap_chunks"] == MESH_CHUNKS,
          f"4-rank plan {quad[0]['plan']}")
    jobs = {"pair": pair, "quad": quad}
    depth, trees = GBDT_KW["max_depth"], GBDT_KW["num_trees"]
    readings = {}
    for what, one in (("dense", forest1), ("sparse", sparse["forest"]),
                      ("streamed", streamed["forest"])):
        fp, fq = _forests(work, what, "pair", 2), _forests(work, what,
                                                           "quad", 4)
        keys = list(one)
        # the route each all-reduce took: "auto" on the 1-D plan is flat
        for job, route in (("pair", ["flat"]), ("quad", ["hier"])):
            for r in jobs[job]:
                check(r[what]["strategies"] == route, f"{what} {job} rank "
                      f"{r['rank']}: all-reduce routes "
                      f"{r[what]['strategies']}, want {route}")
        check(all(_same(f, fp[0], keys) for f in fp[1:] + fq),
              f"{what}: the ranks' forests differ (2 ranks flat vs 4 ranks "
              "hier + overlap, or between ranks)")
        split_keys = ("feature", "threshold", "default_right")
        check(_same(fp[0], {k: v.cpu().numpy() for k, v in one.items()},
                    split_keys),
              f"{what}: splits differ from the one-process forest")
        leaf1 = one["leaf"].cpu().numpy()
        rel = float(np.max(np.abs(fp[0]["leaf"] - leaf1))
                    / np.max(np.abs(leaf1)))
        bitwise = _same(fp[0], {k: v.cpu().numpy() for k, v in one.items()},
                        keys)
        base_eq = bool(np.array_equal(fp[0]["base"],
                                      one["base"].cpu().numpy()))
        check(rel <= 1e-6, f"{what}: leaves {rel:.3e} relative from the "
              "one-process forest")
        kind = "histogram_gh" if what == "dense" else "histogram_gh_sparse"
        want_s = trees + 1 if what == "dense" else trees * (depth + 1) + 1
        for job, res, n in (("pair", pair, 2), ("quad", quad, 4)):
            for r in res:
                got = r[what]
                want_h = trees * depth * (MESH_CHUNKS if job == "quad"
                                          and what == "dense" else 1)
                check(got[kind] == want_h and got["segment_sum"] == want_s,
                      f"{what} {job} rank {r['rank']}: {got[kind]} {kind} "
                      f"and {got['segment_sum']} segment_sum launches, want "
                      f"{want_h} and {want_s}")
            mean = {k: float(np.mean([r[what][k] for r in res]))
                    for k in ("secs", "kernel_ms", "collective_ms")}
            readings[(what, job)] = mean
            r0 = res[0][what]
            one_s = {"dense": gbdt["fit_s"], "sparse": sparse["fit_s"],
                     "streamed": streamed["fit_s"]}[what]
            print(f"mesh {what} fit, {n} ranks ({job}, "
                  f"{'+'.join(r0['strategies'])} all-reduces): wall "
                  f"{mean['secs']:.2f} s a rank (one-process kernel fit "
                  f"{one_s:.2f} s), kernels "
                  f"{mean['kernel_ms']:.0f} ms (accumulate launches, device),"
                  f" collectives {mean['collective_ms']:.0f} ms "
                  f"({r0['collectives']} a rank; host-blocking, gloo through"
                  f" host memory), the rest (host, routing, split finding) "
                  f"{mean['secs'] * 1e3 - mean['kernel_ms'] - mean['collective_ms']:.0f}"
                  f" ms; launches a rank: {r0['histogram_gh']} histogram_gh,"
                  f" {r0['histogram_gh_sparse']} histogram_gh_sparse, "
                  f"{r0['segment_sum']} segment_sum")
        print(f"mesh {what}: forests equal on every rank, 2 ranks flat = 4 "
              f"ranks hier + overlap bit for bit; splits equal to the "
              f"one-process forest; leaves {rel:.2e} relative from it "
              f"(bitwise: {bitwise}; base margin equal: {base_eq})")

    # every level of the first tree: the reduced histograms against the
    # one-process kernels on the same level inputs (the inputs routed
    # through the sharded forest)
    ref = GBDT(num_features=HIGGS_FEATURES, device=dev, **GBDT_KW)
    fp = _forests(work, "dense", "pair", 2)[0]
    gh, levels, leaf_rel, _ = next(tree_inputs(
        torch, ref, {k: torch.from_numpy(v).to(dev) for k, v in fp.items()},
        bins, label))
    for d, (rel_d, n_nodes) in enumerate(levels):
        h1 = hg.histogram_gh_kernel(bins, rel_d, gh, n_nodes,
                                    GBDT_KW["num_bins"]).cpu().numpy()
        for job, ranks in (("pair", 2), ("quad", 4)):
            for r in range(ranks):
                got = np.load(work / f"dense_{job}_rank{r}.npz")[f"level{d}"]
                check(np.array_equal(got, h1), f"dense depth {d}, {job} "
                      f"rank {r}: reduced histogram != the one-process "
                      "kernel's")
    sp_model = GBDT(num_features=BOSCH_FEATURES, missing_aware=True,
                    device=dev, **GBDT_KW)
    for what, n_rows in (("streamed", STREAM_ROWS), ("sparse", BOSCH_ROWS)):
        batch_all = sub_batch(torch, PaddedBatch, sparse_data, 0, n_rows)
        ent = sp_model._sparse_entries(*sp_model._entry_bins(
            batch_all, sparse["binner"]))
        layout = hs.sparse_hist_layout(*ent[:4], BOSCH_FEATURES,
                                       GBDT_KW["num_bins"])
        fs = _forests(work, what, "pair", 2)[0]
        gh_s, levels_s, _, _, _ = next(sparse_tree_inputs(
            torch, sp_model, {k: torch.from_numpy(v).to(dev)
                              for k, v in fs.items()}, ent, batch_all.label))
        gh_e = hs.entry_gh(gh_s, layout=layout)
        for d, (rel_d, n_nodes) in enumerate(levels_s):
            h1 = hs.histogram_gh_sparse_kernel(
                layout.gkey, rel_d[layout.rid].contiguous(), gh_e,
                layout.starts, n_nodes, BOSCH_FEATURES, GBDT_KW["num_bins"],
                layout=layout, gh_amax=lane_amax(gh_s)).cpu().numpy()
            for job, ranks in (("pair", 2), ("quad", 4)):
                for r in range(ranks):
                    got = np.load(work / f"{what}_{job}_rank{r}.npz")[
                        f"level{d}"]
                    check(np.array_equal(got, h1), f"{what} depth {d}, "
                          f"{job} rank {r}: reduced histogram != the "
                          "one-process kernel's")
        del batch_all, ent, gh_e
    print("mesh: every level of the first tree, dense, sparse and "
          "streamed, on 2 and 4 ranks: the reduced histogram equals the "
          "one-process kernel's on the same level inputs bit for bit")

    # (b3) the 2-rank fit over the data service: launches, route and epochs
    # a rank; every rank's forest = the one-process fit_streamed's of as
    # many trees over the service's epoch (the workers sketch their own
    # cuts, so not the streamed phase's forest); each rank's rows = its
    # share's, and the two in rank order = a
    # one-process epoch over the workers' file (which the dataservice phase
    # held to the one-process service epoch); the epoch over a worker
    # SIGKILLed as rank 0 fetches its first part = the clean one, with its
    # failovers inside each rank's share
    from dmlc_core_tpu_torch.data import BinnedStagingIter
    from dmlc_core_tpu_torch.models import QuantileBinner
    for r in pair:
        got = r["service"]
        check(got["histogram_gh_sparse"] == SERVICE_TREES * depth
              and got["segment_sum"] == SERVICE_TREES * (depth + 1) + 1
              and got["histogram_gh"] == 0 and got["strategies"] == ["flat"]
              and got["epochs"] == 1 + SERVICE_TREES * depth,
              f"the fit over the service, rank {r['rank']}: "
              f"{got['histogram_gh_sparse']} sparse histograms, "
              f"{got['segment_sum']} segment sums, {got['histogram_gh']} "
              f"dense, routes {got['strategies']}, {got['epochs']} epochs")
    one_short = {k: v.cpu().numpy()
                 for k, v in served_fit["forest_short"].items()}
    fsv = _forests(work, "service", "pair", 2)
    differ = [k for k in one_short if not np.array_equal(fsv[0][k],
                                                         one_short[k])]
    check(_same(fsv[1], fsv[0], list(one_short)) and not differ,
          "the 2-rank forest over the service differs from the one-process "
          f"{SERVICE_TREES}-tree fit_streamed's over the service's epoch: "
          f"{differ}")
    rows = [r["service_rows"] for r in pair]
    V = rows[0]["parts"]
    check(rows[0]["share"] == [0, V // 2] and rows[1]["share"] == [V // 2, V]
          and all(x["own"] for x in rows), "service shares: "
          f"{[(x['share'], x['own']) for x in rows]} of {V} parts")
    local = BinnedStagingIter(
        streamed["uri"], QuantileBinner(GBDT_KW["num_bins"],
                                        missing_aware=True, device=dev),
        cache=str(work / "dataservice" / rows[0]["cache"]), device=dev,
        batch_size=STREAM_BATCH, nnz_bucket=STREAM_BUCKET)
    lanes = [x.cpu().numpy() for x in epoch_rows(torch, local)]
    n0 = rows[0]["rows"]
    e0 = int(lanes[1][:n0].sum())
    cut = [n0, n0, e0, e0, e0]
    halves = ([x[:c] for x, c in zip(lanes, cut)],
              [x[c:] for x, c in zip(lanes, cut)])
    check(n0 + rows[1]["rows"] == STREAM_ROWS == lanes[0].size
          and all(lanes_digest(h) == x["digest"]
                  for h, x in zip(halves, rows)),
          "the ranks' service rows are not the one-process epoch's in "
          "order")
    del lanes, halves
    fo = [r["service_failover"] for r in pair]
    check(fo[0]["killed"] is not None and -9 in service_exits
          and all(f["digest"] == x["digest"] for f, x in zip(fo, rows))
          and all(f["pending"] == 0 and f["done"] == f["shards"]
                  == x["share"][1] - x["share"][0] for f, x in zip(fo, rows))
          and all(set(f["parts"]) <= set(range(*x["share"]))
                  for f, x in zip(fo, rows))
          and fo[0]["failovers"] >= 1,
          f"the service epoch over a killed worker: {fo}, worker exits "
          f"{service_exits}")
    sv = {k: float(np.mean([r["service"][k] for r in pair]))
          for k in ("secs", "kernel_ms", "collective_ms", "wait_ms")}
    readings[("service", "pair")] = sv
    one_s, pair_s = served_fit["fit_s"], readings[("streamed", "pair")][
        "secs"]
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    print(f"mesh service: {V} parts, shares {rows[0]['share']} and "
          f"{rows[1]['share']} ({rows[0]['rows']} and {rows[1]['rows']} "
          f"rows), each rank's rows equal to its share of the workers' "
          f"cache file and the two in rank order to the one-process epoch; "
          f"the workers' cache build (the meta request) "
          f"{max(x['build_s'] for x in rows):.2f} s, a sharded epoch "
          f"{max(x['epoch_s'] for x in rows):.3f} s; the epoch over a "
          f"worker SIGKILLed as rank 0 fetched its first part equal to the "
          f"clean one, failovers a rank {[f['failovers'] for f in fo]} "
          f"(parts {[f['parts'] for f in fo]}), ledgers whole")
    rest_ms = (sv["secs"] * 1e3 - sv["kernel_ms"] - sv["collective_ms"]
               - sv["wait_ms"])
    print(f"mesh service fit, 2 ranks (pair, flat all-reduces), "
          f"{SERVICE_TREES} trees: wall {sv['secs']:.2f} s a rank "
          f"({sv['secs'] / SERVICE_TREES:.3f} s a tree), kernels "
          f"{sv['kernel_ms']:.0f} ms (accumulate launches, device), "
          f"collectives {sv['collective_ms']:.0f} ms (host-blocking), "
          f"service wait {sv['wait_ms']:.0f} ms (the consumer waiting on "
          f"fetched, repacked parts), the rest {rest_ms:.0f} ms; launches "
          f"a rank: {pair[0]['service']['histogram_gh_sparse']}"
          f" histogram_gh_sparse, {pair[0]['service']['segment_sum']} "
          f"segment_sum; forests equal to the one-process "
          f"{SERVICE_TREES}-tree fit_streamed bit for bit on every rank. "
          f"Beside it, a tree in this run: the one-process fit over the "
          f"service {one_s / trees:.3f} s ({one_s:.2f} s for {trees} "
          f"trees), the 2-rank local fit_streamed {pair_s / trees:.3f} s "
          f"({pair_s:.2f} s for {trees}); card {smi}")

    # (c) the data-parallel FM
    fms = [r["fm"] for r in pair]
    for r, f in zip(pair, fms):
        check(f["mismatched"] == 0, f"FM rank {r['rank']}: "
              f"{f['mismatched']} staged batches differ from the host parse")
        check(f["launches"] == 3 * f["steps"], f"FM rank {r['rank']}: "
              f"{f['launches']} launches in {f['steps']} steps")
    check(fms[0]["steps"] == fms[1]["steps"], "FM ranks' step counts differ")
    check(fms[0]["digest"] == fms[1]["digest"],
          "FM replicas differ after the epoch")
    check(sum(f["rows"] for f in fms) == TRAIN_ROWS, "FM: the parts' rows")
    uri = train["uri"]
    nnz_max = TRAIN_BATCH * NNZ_PER_ROW
    firsts = [host_packed(uri, TRAIN_BATCH, nnz_max, part=p, num_parts=2)[0]
              for p in (0, 1)]
    g = {k: np.concatenate([firsts[0][k], firsts[1][k]])
         for k in ("label", "weight", "index", "value")}
    g["row_ptr"] = np.concatenate([firsts[0]["row_ptr"][:-1],
                                   firsts[1]["row_ptr"]
                                   + len(firsts[0]["index"])])
    gb = PaddedBatch(num_rows=2 * TRAIN_BATCH, **{
        k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        for k, v in g.items()})
    fm1 = FactorizationMachine(NUM_FEATURES, num_factors=NUM_FACTORS,
                               sdot_backend="pallas", device=dev).init(0)
    loss = padded_row_mean(logistic_nll(fm1.margins(gb), gb.label),
                           gb.weight)
    grads = torch.autograd.grad(loss, list(fm1.parameters()))
    want = torch.cat([x.reshape(-1) for x in grads]).cpu()
    for p in (0, 1):
        got = torch.load(work / f"fm_grad_rank{p}.pt")[:-1]
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= 1e-5 * scale, f"FM rank {p}: the first reduced "
              f"gradient {err:.3e} from the one-process one (largest "
              f"{scale:.3e})")
    print(f"mesh FM: {fms[0]['steps']} data-parallel steps a rank "
          f"({fms[0]['local_batches']} and {fms[1]['local_batches']} local "
          f"batches, {fms[0]['padding']} and {fms[1]['padding']} all-padding"
          f"), every staged batch equal to its part's host parse, "
          f"{fms[0]['steps'] / fms[0]['secs']:.2f} steps/s a rank after "
          f"{fms[0]['first']:.2f} s for the first; all-reduce of the "
          f"{sum(p.numel() for p in fm1.parameters()) * 4 / 2**20:.0f} MiB "
          f"gradient {fms[0]['collective_ms'] / fms[0]['steps']:.1f} ms a "
          f"step (gloo through host memory); first reduced gradient within "
          f"{err:.2e} of the one-process gradient of the global batch "
          f"(largest {scale:.2e}); replicas bitwise equal; 3 launches a "
          f"step")

    # (c2) the dp x tp runs of the 4-rank job
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    tp = tp_checks(torch, dev, work, quad, fms, 4 * (1 + sum(
        p.numel() for p in fm1.parameters())), smi)

    # (d) the 2-rank checkpoint against a one-process save of its values
    path = work / "fm_two_rank.ckpt"
    check([r["ckpt_leaves"] for r in pair] == [3, 0] and all(
        r["ckpt_loaded"] for r in pair), "2-rank checkpoint: leaves written "
          "or loaded back")
    back = checkpoint.load(str(path), like=fm1.state_dict(), device=dev)
    flat = torch.cat([back[k].reshape(-1) for k in ("w", "v", "b")])
    digest = hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()
    check(digest == fms[0]["digest"], "2-rank checkpoint: not the ranks' "
          "params")
    one_path = work / "fm_one_process.ckpt"
    checkpoint.save(back, str(one_path))
    check(path.read_bytes() == one_path.read_bytes(),
          "2-rank checkpoint differs from a one-process save")
    print(f"mesh checkpoint: the 2-rank save ({path.stat().st_size} bytes) "
          f"equals a one-process save byte for byte; loaded back on both "
          f"ranks")

    # (e) collectives: gloo over the 2 ranks, NCCL over a 1-rank group
    for b in pair[0]["bench"]:
        print(f"mesh bench [gloo, 2 ranks, one card, through host memory] "
              f"{b['op']}{' ' + b['strategy'] if 'strategy' in b else ''} "
              f"{b['bytes'] / 2**20:.2f} MiB: {b['seconds_per_iter'] * 1e3:.3f}"
              f" ms, algbw {b['algo_gbps']:.3f} GB/s, busbw "
              f"{b['bus_gbps']:.3f} GB/s")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for op in ("allreduce", "allgather", "reducescatter"):
            b = parallel.collective_bench(None, op, 16.0, 5, 2)
            print(f"mesh bench [NCCL, 1 rank] {op} {b['bytes'] / 2**20:.2f}"
                  f" MiB: {b['seconds_per_iter'] * 1e3:.3f} ms (a 1-rank "
                  f"group moves nothing between cards)")
    finally:
        dist.destroy_process_group()

    # each kernel's accumulate half at the ranks' shapes (2-rank and 4-rank
    # shares; the 4-rank job's dense levels in 7-feature chunks): against
    # its plain version (int64 accumulators equal, and the dequantized
    # sums), times, bound, library call
    def held(name, share, acc, plain, deq, lib, nbytes, iters, jobs_of,
             prior_ms=None, lanes=2, launches=None, of=None, **extra):
        a, p = acc(), plain()
        check(torch.equal(a, p), f"{name} accumulate at {share} != plain")
        got, want = deq(a), dequantize_plain(p, scale_of[name], lanes)
        check(bool(torch.isfinite(got).all()), f"{name} at {share}: "
              "non-finite sums")
        ms, _ = device_ms(torch, acc, iters)
        plain_ms, _ = device_ms(torch, plain, 2, warmup=1)
        lib_ms, _ = device_ms(torch, lib, 5, warmup=1)
        if launches is None:
            launches = sum(r[what][name] for job, whats in jobs_of
                           for r in jobs[job] for what in whats)
        if of is None:
            of = "; ".join(f"every rank of the {len(jobs[job])}-rank job's "
                           + " and ".join(MESH_FITS[w] for w in whats)
                           for job, whats in jobs_of)
        out = dict(name=name, share=share, of=of, launches=launches,
                   max_abs_err=float((got.reshape(-1) - want).abs().max()),
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                   **extra)
        if prior_ms is not None:
            ops_line(torch, f"mesh {name} accumulate at {share}", acc)
        print(f"mesh {name} accumulate at {share}: kernel {ms:.4f} ms"
              + (f" (previous: {prior_ms:.3f})" if prior_ms is not None else "")
              + f", plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms, bound "
              f"{out['bound_ms']:.4f} ms; int64 accumulators equal to the "
              f"plain version's, dequantized sums {out['max_abs_err']:.3e} "
              f"apart; launches {launches}")
        return out

    kern = []
    rows, B = bins.shape[0], GBDT_KW["num_bins"]
    rel5, n5 = levels[depth - 1]
    scale_of = {"histogram_gh": fixed_point_scale(lane_amax(gh), rows)}
    qmax = value_limit(rows)
    for n, f1, job in ((2, HIGGS_FEATURES, "pair"),
                       (4, HIGGS_FEATURES // MESH_CHUNKS, "quad")):
        r1 = rows // n
        b_h = bins[:r1, :f1].contiguous()
        r_h, g_h = rel5[:r1].contiguous(), gh[:r1].contiguous()
        sc = scale_of["histogram_gh"]
        kern.append(held(
            "histogram_gh", f"a {n}-rank share ({r1} Higgs rows x {f1} "
            f"features at depth 5)",
            lambda: hg.histogram_gh_accumulate(b_h, r_h, g_h, n5, B, sc,
                                               qmax),
            lambda: hg.histogram_gh_accumulate_plain(b_h, r_h, g_h, n5, B,
                                                     sc, qmax),
            lambda a, f1=f1: hg.histogram_gh_dequantize(a, sc, (n5, f1, B,
                                                                2)),
            lambda: hg._histogram_gh_xla(b_h, r_h, g_h, n5, B),
            r1 * f1 + 12 * r1 + 16 * n5 * f1 * B, 10,
            [(job, ("dense",))], PRIOR_ACCUMULATE_MS[("histogram_gh", n)]))
    rel_s, n_s = levels_s[depth - 1]
    n_max = int(hs.feature_counts(layout).max())
    scale_of["histogram_gh_sparse"] = fixed_point_scale(lane_amax(gh_s),
                                                        n_max)
    s_qmax = value_limit(n_max)
    for rs, share, job_of, prior in (
            (BOSCH_ROWS // 2, "a 2-rank share", [("pair", ("sparse",))], 2),
            (BOSCH_ROWS // 4, "a 4-rank share", [("quad", ("sparse",))], 4),
            (STREAM_ROWS // 2, "a 2-rank share of the streamed rows",
             [("pair", ("streamed", "service")),
              ("quad", ("streamed",))], "streamed")):
        sub = sub_batch(torch, PaddedBatch, sparse_data, 0, rs)
        ent_h = sp_model._sparse_entries(*sp_model._entry_bins(
            sub, sparse["binner"]))
        lay_h = hs.sparse_hist_layout(*ent_h[:4], BOSCH_FEATURES, B)
        ge_h = hs.entry_gh(gh_s[:rs], layout=lay_h)
        re_h = rel_s[:rs][lay_h.rid].contiguous()
        sc = scale_of["histogram_gh_sparse"]
        keys = ((re_h.long() * BOSCH_FEATURES) * B + lay_h.gkey.long()
                ).clamp(0, n_s * BOSCH_FEATURES * B - 1)
        zeros = torch.zeros(n_s * BOSCH_FEATURES * B, 2, device=dev)
        nnz_h = lay_h.nnz_live
        kern.append(held(
            "histogram_gh_sparse", f"{share} ({rs} rows, {nnz_h} Bosch "
            "entries at depth 5)",
            lambda: hs.histogram_gh_sparse_accumulate(lay_h, re_h, ge_h, n_s,
                                                      sc, s_qmax),
            lambda: hs.histogram_gh_sparse_accumulate_plain(
                lay_h.gkey, re_h, ge_h, lay_h.starts, n_s, BOSCH_FEATURES, B,
                sc, s_qmax),
            lambda a: hs.histogram_gh_sparse_dequantize(
                a, sc, (n_s, BOSCH_FEATURES, B, 2)),
            lambda: torch.index_add(zeros, 0, keys, ge_h),
            16 * nnz_h + 16 * n_s * BOSCH_FEATURES * B, 10, job_of,
            PRIOR_ACCUMULATE_MS[("histogram_gh_sparse", prior)], nnz=nnz_h))
        del sub, ent_h, lay_h, ge_h, re_h, keys, zeros
    n_leaves = 2 ** depth
    scale_of["segment_sum"] = fixed_point_scale(lane_amax(gh), rows)
    for n, job in ((2, "pair"), (4, "quad")):
        r1 = rows // n
        lr, g2 = leaf_rel[:r1].contiguous(), gh[:r1].contiguous()
        sc = scale_of["segment_sum"]
        z = torch.zeros(n_leaves, 2, device=dev)
        idx = lr.long()
        kern.append(held(
            "segment_sum", f"a {n}-rank share ({r1} rows x L=2 into "
            f"{n_leaves} leaves)",
            lambda: ss_mod.segment_sum_accumulate(g2, lr, n_leaves, sc, qmax),
            lambda: ss_mod.segment_sum_accumulate_plain(g2, lr, n_leaves, sc,
                                                        qmax),
            lambda a: ss_mod.segment_sum_dequantize(a, sc, n_leaves, 2),
            lambda: torch.index_add(z, 0, idx, g2),
            12 * r1 + 16 * n_leaves, 20,
            [(job, ("dense", "sparse", "streamed")
                   + (("service",) if job == "pair" else ()))]))
    # the dp x tp steps' accumulate at the FM's model shares
    for case in tp_accumulate_cases(torch, ss_mod, tp["inputs"], quad):
        scale_of["segment_sum"] = case.pop("scale")
        kern.append(held("segment_sum", case.pop("share"), *case.pop("fns"),
                         case.pop("nbytes"), 20, [], **case))
    return {"kern": kern, "fm_launches": sum(f["launches"] for f in fms),
            "fm_steps": sum(f["steps"] for f in fms), "readings": readings}


# ---- --service-sweep: parts in flight of a data-service epoch --------------

SERVICE_FETCH_AHEAD = (1, 2, 4, 8)
SERVICE_SWEEP_EPOCHS = 3


def service_sweep(torch, dev) -> None:
    """Times epochs of the Bosch out-of-core cell over the data service
    (two workers on the card, the streamed cell's file and geometry) with
    1, 2, 4 and 8 parts in flight (``dataservice.client._FETCH_AHEAD``,
    the client's constant), beside a local cache hit over the worker's
    file; then a lease call and a worker round trip alone.  Readings
    only."""
    from dmlc_core_tpu_torch.data import BinnedStagingIter
    from dmlc_core_tpu_torch.dataservice import client as ds_client
    from dmlc_core_tpu_torch.dataservice.server import spec_key
    from dmlc_core_tpu_torch.models import QuantileBinner
    from dmlc_core_tpu_torch.tracker import metrics as tm
    build_dir = REPO / "build" / "chip_smoke"
    path, _ = streamed_file(bosch_like(torch, dev), build_dir)
    torch.cuda.empty_cache()
    uri = str(path)
    cache_dir = build_dir / "dataservice_sweep"

    def epoch_s(it) -> float:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rows = sum(b.num_rows for b in it)
        torch.cuda.synchronize()
        check(rows == STREAM_ROWS, f"an epoch of {rows} rows")
        return time.monotonic() - t0

    def line(what, times):
        best = STREAM_ROWS / min(times)
        print(f"service sweep [{what}]: "
              + ", ".join(f"{t:.3f}" for t in times)
              + f" s; best {best:.0f} rows/s")

    with service_fleet(cache_dir) as (agg, _):
        ds = service_client(dev, agg, uri, QuantileBinner(
            GBDT_KW["num_bins"], missing_aware=True, device=dev))
        ds.ensure_meta()
        local = BinnedStagingIter(
            uri, QuantileBinner(GBDT_KW["num_bins"], missing_aware=True,
                                device=dev),
            cache=str(cache_dir / (spec_key(ds.spec) + ".bincache")),
            device=dev, batch_size=STREAM_BATCH, nnz_bucket=STREAM_BUCKET)
        line("local cache hit", [epoch_s(local)
                                 for _ in range(SERVICE_SWEEP_EPOCHS)])
        default = ds_client._FETCH_AHEAD
        try:
            for depth in SERVICE_FETCH_AHEAD:
                ds_client._FETCH_AHEAD = depth
                line(f"{depth} parts in flight"
                     + (" (the default)" if depth == default else ""),
                     [epoch_s(ds) for _ in range(SERVICE_SWEEP_EPOCHS)])
        finally:
            ds_client._FETCH_AHEAD = default
        sc = tm.ShardClient("127.0.0.1", agg.port, rank=0)
        worker = ds._any_worker()
        t0 = time.monotonic()
        for _ in range(100):
            sc.data_req({"op": "state"})
        t1 = time.monotonic()
        for _ in range(100):
            ds._req_reply(worker, {"op": "ping"})
        t2 = time.monotonic()
        for g in range(20):
            ds._fetch_from(worker, g)
        t3 = time.monotonic()
        print(f"service sweep: a lease call {(t1 - t0) * 10:.3f} ms, a "
              f"worker ping {(t2 - t1) * 10:.3f} ms, a part's fetch alone "
              f"{(t3 - t2) * 50:.2f} ms ({ds.meta['virtual_parts']} parts "
              "an epoch)")


# ---- --geometry-sweep: the dense kernel's launch geometry -------------------

# ---- synthetic levels: --geometry-sweep and --ab --------------------------

# (rows, F, num_bins, one-hot columns, missing share, depths): the dense
# shapes chip_smoke's phases time, with codes drawn on the card: Higgs and
# MSLR any of 256 codes; Covertype 10 such columns, then 4 + 40 one-hot
# columns whose two codes sit where quantile cuts of a 0/1 column put them
# (242 and 255); gbdt_train --missing 64 bins, 41% in the missing bin 0
SYNTH_DENSE = {
    "Higgs": (HIGGS_ROWS, HIGGS_FEATURES, 256, 0, 0.0, range(6)),
    "Covertype": (581_012, 54, 256, 44, 0.0, range(6)),
    "MSLR": (723_412, 136, 256, 0, 0.0, range(6)),
    "--missing": (50_000, 32, 64, 0, 0.41, range(5)),
}
# (rows, F, num_bins, entries a row, depths): Bosch width (19% of 968
# present), its streamed rows, gbdt_train --rank (8 of 32 features, 1,500
# queries of ~9.5 documents)
SYNTH_SPARSE = {
    "Bosch": (1_183_747, 968, 256, 184, range(6)),
    "streamed": (1 << 18, 968, 256, 184, range(6)),
    "--rank": (14_285, 32, 64, 8, range(5)),
}


def synth_dense(torch, dev, name: str, rows=None, seed: int = 5) -> tuple:
    """(bins uint8 [rows, F], gh f32 [rows, 2], num_bins) of SYNTH_DENSE's
    ``name`` on the card (its first ``rows`` rows)."""
    full, F, B, hot, missing, _ = SYNTH_DENSE[name]
    rows = rows or full
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, B, (rows, F - hot), generator=g, device=dev)
    if missing:
        codes = torch.where(torch.rand(rows, F - hot, generator=g,
                                       device=dev) < missing, 0,
                            codes.clamp(min=1))
    parts = [codes]
    if hot:
        oh = torch.nn.functional.one_hot
        wild = torch.multinomial(torch.tensor(COVER_WILD_SHARES, device=dev),
                                 rows, replacement=True, generator=g)
        soil = torch.randint(0, hot - 4, (rows,), generator=g, device=dev)
        parts.append(torch.where(torch.cat([oh(wild, 4), oh(soil, hot - 4)],
                                           1) == 1, 255, 242))
    bins = torch.cat(parts, 1).to(torch.uint8).contiguous()
    gh = torch.stack([torch.randn(rows, generator=g, device=dev),
                      0.05 + 0.2 * torch.rand(rows, generator=g, device=dev)],
                     1).contiguous()
    return bins, gh, B


def synth_sparse(torch, hs_mod, dev, name: str, rows=None,
                 seed: int = 6) -> tuple:
    """(layout fields, row ids of the entries, gh f32 [rows, 2]) of
    SYNTH_SPARSE's ``name`` on the card: every feature ``rows * per_row /
    F`` entries, bins 1..B-1 uniform, rows uniform; ``hs_mod`` makes the
    layout (this tree's or a parent's module)."""
    full, F, B, per_row, _ = SYNTH_SPARSE[name]
    rows = rows or full
    g = torch.Generator(device=dev).manual_seed(seed)
    each = rows * per_row // F
    nb = 1 << max(B - 1, 1).bit_length()
    fi = torch.arange(F, device=dev).repeat_interleave(each)
    gkey = (fi * nb + torch.randint(1, B, (fi.numel(),), generator=g,
                                    device=dev)).to(torch.int32)
    del fi
    starts = torch.arange(F + 1, dtype=torch.int64) * each
    rid = torch.randint(0, rows, (gkey.numel(),), generator=g, device=dev)
    gh = torch.stack([torch.randn(rows, generator=g, device=dev),
                      0.05 + 0.2 * torch.rand(rows, generator=g, device=dev)],
                     1).contiguous()
    fields = dict(num_features=F, num_bins=B, nb=nb, nnz_live=gkey.numel(),
                  gkey=gkey, rid=None, starts=starts)
    return fields, rid, gh


def load_parent_ops(parent: Path) -> tuple:
    """The parent commit's ``histogram`` and ``histogram_sparse`` modules,
    from a checkout at ``parent`` (``git archive`` unpacked), imported as
    the package ``parent_ops`` beside this tree's (the ops package imports
    nothing outside itself); its kernels build under ``parent/build``."""
    import importlib
    import importlib.util
    pkg = parent / "dmlc_core_tpu_torch" / "ops"
    spec = importlib.util.spec_from_file_location(
        "parent_ops", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_ops"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("parent_ops.histogram"),
            importlib.import_module("parent_ops.histogram_sparse"))


AB_ITERS = 20


def ab_parent(torch, dev, parent: Path) -> None:
    """Both histogram kernels of this tree against the parent commit's, in
    one process on the same synthetic levels (SYNTH_DENSE, SYNTH_SPARSE,
    and the mesh phase's accumulate shares), timed in turns parent,
    change, change, parent (device_ms, AB_ITERS calls each); every output
    equal bit for bit (both sum exact int64 fixed point at the same scale),
    beside index_add at the example shapes.  Prints its readings and no
    result line."""
    from dmlc_core_tpu_torch.ops import histogram as hg
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    from dmlc_core_tpu_torch.ops.fixed_point import (fixed_point_scale,
                                                     lane_amax, value_limit)
    p_hg, p_hs = load_parent_ops(parent)
    t0 = time.monotonic()
    for k in ("histogram_gh", "histogram_gh_sparse"):
        sys.modules["parent_ops._build"].build(k)
    print(f"ab: the parent's kernels built in {time.monotonic() - t0:.1f} s "
          f"from {parent}")

    def turns(what, parent_fn, change_fn, lib_fn=None):
        a, b = parent_fn(), change_fn()
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"ab {what}: the parent's and this tree's "
              "kernels differ")
        p1 = device_ms(torch, parent_fn, AB_ITERS)[0]
        c1 = device_ms(torch, change_fn, AB_ITERS)[0]
        c2 = device_ms(torch, change_fn, AB_ITERS)[0]
        p2 = device_ms(torch, parent_fn, AB_ITERS)[0]
        lib = device_ms(torch, lib_fn, AB_ITERS)[0] if lib_fn else None
        p, c = (p1 + p2) / 2, (c1 + c2) / 2
        print(f"ab [{what}]: parent {p1:.4f} / {p2:.4f} ms, change "
              f"{c1:.4f} / {c2:.4f} ms, change / parent {c / p:.3f}"
              + (f", index_add {lib:.4f} ms" if lib is not None else "")
              + "; outputs bitwise equal")
        return p, c, lib

    summary = {}
    for name, (rows, F, B, *_rest, depths) in SYNTH_DENSE.items():
        bins, gh, B = synth_dense(torch, dev, name)
        layout = hg.dense_hist_layout(bins, B)
        g = torch.Generator(device=dev).manual_seed(8)
        got = []
        for d in depths:
            n = 2 ** d
            rel = torch.randint(0, n, (rows,), generator=g, device=dev,
                                dtype=torch.int32)
            lib_fn = None
            if rows <= 1_000_000:
                keys = ((rel.long()[:, None] * F + torch.arange(
                    F, device=dev)) * B + bins.long()).reshape(-1)
                src = gh[:, None, :].expand(rows, F, 2).reshape(-1, 2)
                zeros = torch.zeros(n * F * B, 2, device=dev)
                lib_fn = (lambda z=zeros, k=keys, s=src:
                          torch.index_add(z, 0, k, s))
            got.append(turns(
                f"histogram_gh {name}, depth {d}",
                lambda: p_hg.histogram_gh_kernel(bins, rel, gh, n, B),
                lambda: hg.histogram_gh_kernel(bins, rel, gh, n, B, layout),
                lib_fn))
            if d in (0, depths[-1]):
                for who, fn in (
                        ("parent",
                         lambda: p_hg.histogram_gh_kernel(bins, rel, gh, n, B)),
                        ("change", lambda: hg.histogram_gh_kernel(
                            bins, rel, gh, n, B, layout))):
                    print(f"ab ops [histogram_gh {name}, depth {d}, {who}]: "
                          + op_times(torch, fn))
                ops_line(torch, f"histogram_gh {name}, depth {d}",
                         lambda: hg.histogram_gh_kernel(bins, rel, gh, n, B,
                                                        layout))
            lib_fn = keys = src = zeros = None
        summary[f"histogram_gh {name}"] = got
        del bins, gh, layout
    for name, (rows, F, B, _, depths) in SYNTH_SPARSE.items():
        fields, rid, gh = synth_sparse(torch, hs, dev, name)
        lay, p_lay = hs.SparseHistLayout(**fields), p_hs.SparseHistLayout(
            **fields)
        gh_e = gh[rid].contiguous()
        amax = lane_amax(gh)
        g = torch.Generator(device=dev).manual_seed(9)
        got = []
        for d in depths:
            n = 2 ** d
            rel_e = torch.randint(0, n, (rows,), generator=g, device=dev,
                                  dtype=torch.int32)[rid].contiguous()
            lib_fn = None
            if lay.nnz_live <= 1_000_000:
                gk = lay.gkey.long()
                keys = (rel_e.long() * F + gk // lay.nb) * B + gk % lay.nb
                zeros = torch.zeros(n * F * B, 2, device=dev)
                lib_fn = (lambda z=zeros, k=keys: torch.index_add(z, 0, k,
                                                                  gh_e))
            if d in (0, depths[-1]):
                ops_line(torch, f"histogram_gh_sparse {name}, depth {d}",
                         lambda: hs.histogram_gh_sparse_kernel(
                             lay.gkey, rel_e, gh_e, lay.starts, n, F, B,
                             layout=lay, gh_amax=amax))
            got.append(turns(
                f"histogram_gh_sparse {name}, depth {d}",
                lambda: p_hs.histogram_gh_sparse_kernel(
                    lay.gkey, rel_e, gh_e, lay.starts, n, F, B, layout=p_lay,
                    gh_amax=amax),
                lambda: hs.histogram_gh_sparse_kernel(
                    lay.gkey, rel_e, gh_e, lay.starts, n, F, B, layout=lay,
                    gh_amax=amax), lib_fn))
            lib_fn = keys = zeros = None
        summary[f"histogram_gh_sparse {name}"] = got
        del fields, rid, gh, gh_e, lay, p_lay
    # the mesh phase's accumulate shares at depth 5
    for share, rows, F in (("2-rank", HIGGS_ROWS // 2, HIGGS_FEATURES),
                           ("4-rank chunk", HIGGS_ROWS // 4,
                            HIGGS_FEATURES // MESH_CHUNKS)):
        bins, gh, B = synth_dense(torch, dev, "Higgs", rows)
        bins = bins[:, :F].contiguous()
        rel = torch.randint(0, 32, (rows,), device=dev, dtype=torch.int32)
        sc, qmax = fixed_point_scale(lane_amax(gh), 2 * rows), value_limit(
            2 * rows)
        for who, fn in (("parent", lambda: p_hg.histogram_gh_accumulate(
                bins, rel, gh, 32, B, sc, qmax)),
                        ("change", lambda: hg.histogram_gh_accumulate(
                            bins, rel, gh, 32, B, sc, qmax))):
            print(f"ab ops [histogram_gh accumulate, {share}, {who}]: "
                  + op_times(torch, fn))
        summary[f"histogram_gh accumulate {share}"] = [turns(
            f"histogram_gh accumulate, {share} share ({rows} x {F}, depth 5)",
            lambda: p_hg.histogram_gh_accumulate(bins, rel, gh, 32, B, sc,
                                                 qmax),
            lambda: hg.histogram_gh_accumulate(bins, rel, gh, 32, B, sc,
                                               qmax))]
        del bins, gh, rel
    for share, name, rows in (("2-rank", "Bosch", 1_183_747 // 2),
                              ("4-rank", "Bosch", 1_183_747 // 4),
                              ("2-rank streamed", "streamed", (1 << 18) // 2)):
        fields, rid, gh = synth_sparse(torch, hs, dev, name, rows)
        lay, p_lay = hs.SparseHistLayout(**fields), p_hs.SparseHistLayout(
            **fields)
        gh_e = gh[rid].contiguous()
        rel_e = torch.randint(0, 32, (rows,), device=dev,
                              dtype=torch.int32)[rid].contiguous()
        n_max = int((fields["starts"][1:] - fields["starts"][:-1]).max())
        sc, qmax = fixed_point_scale(lane_amax(gh), 2 * n_max), value_limit(
            2 * n_max)
        summary[f"histogram_gh_sparse accumulate {share}"] = [turns(
            f"histogram_gh_sparse accumulate, {share} share "
            f"({lay.nnz_live} entries, depth 5)",
            lambda: p_hs.histogram_gh_sparse_accumulate(p_lay, rel_e, gh_e,
                                                        32, sc, qmax),
            lambda: hs.histogram_gh_sparse_accumulate(lay, rel_e, gh_e, 32,
                                                      sc, qmax))]
        for who, fn in (("parent", lambda: p_hs.histogram_gh_sparse_accumulate(
                p_lay, rel_e, gh_e, 32, sc, qmax)),
                        ("change", lambda: hs.histogram_gh_sparse_accumulate(
                            lay, rel_e, gh_e, 32, sc, qmax))):
            print(f"ab ops [histogram_gh_sparse accumulate, {share}, {who}]: "
                  + op_times(torch, fn))
        del fields, rid, gh, gh_e, lay, p_lay
    for what, got in summary.items():
        p = float(np.mean([r[0] for r in got]))
        c = float(np.mean([r[1] for r in got]))
        libs = [r[2] for r in got if r[2] is not None]
        print(f"ab mean [{what}]: parent {p:.4f} ms, change {c:.4f} ms, "
              f"change / parent {c / p:.3f}"
              + (f", index_add {np.mean(libs):.4f} ms" if libs else ""))


SWEEP_FEW = (0, 8)                    # _FEW_BINS: a few-bin feature's bins
SWEEP_REDUCE = (0, 2, 4, 8, 16)       # _REDUCE_KEYS: keys that pre-reduce
SWEEP_CHUNK = (512, 1024, 2048, 4096)  # _MIN_CHUNK: rows a block at least
SWEEP_SPAN = ((264, 1024), (264, 2048), (264, 4096), (264, 8192))
# sparse (_SMALL_SPANS, _SPAN_FLOOR)
SWEEP_SPARSE_REDUCE = (0, 2, 8)       # sparse _REDUCE_KEYS at --rank
SWEEP_PROLOGUE = (264, 2112)          # _PROLOGUE_BLOCKS at Higgs width
SWEEP_DEEP = (528, 1056, 2112)        # _DEEP_BLOCKS at Higgs and MSLR width


def geometry_sweep(torch, dev) -> None:
    """The constants of the redesigned launch geometries, at the synthetic
    levels of ``--ab`` (SYNTH_DENSE, SYNTH_SPARSE): the dense kernel under
    each few-bin bound (SWEEP_FEW; 0: no feature is few-bin) and each
    pre-reduction bound (SWEEP_REDUCE; 0: no warp pre-reduces) at
    Covertype width, and each least chunk (SWEEP_CHUNK) at --missing and
    Covertype width; the sparse kernel under each (spans a small launch
    aims at, least span) (SWEEP_SPAN) and pre-reduction bound
    (SWEEP_SPARSE_REDUCE) at the --rank shape.  Each setting gives the
    histogram of the picked one bit for bit; prints device times by depth
    and their means.  (The many-bin geometry's constants, _WIDE_PAIRS,
    _DEEP_GROUP and the block targets, were swept at Higgs width before;
    PERF.md.)"""
    from dmlc_core_tpu_torch.ops import histogram as hg
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    from dmlc_core_tpu_torch.ops.fixed_point import lane_amax

    def sweep(what, attr_vals, mod, cases, run, fresh):
        picked = {a: getattr(mod, a) for a in attr_vals[0][0]}
        want = [run(c, fresh()) for c in cases]
        rows = []
        try:
            for names, vals in attr_vals:
                for a, v in zip(names, vals):
                    setattr(mod, a, v)
                lay = fresh()
                ms = []
                for c, w in zip(cases, want):
                    check(torch.equal(run(c, lay), w),
                          f"{what} {dict(zip(names, vals))} changed bits")
                    ms.append(device_ms(torch, lambda: run(c, lay), 10)[0])
                rows.append((dict(zip(names, vals)), ms))
        finally:
            for a, v in picked.items():
                setattr(mod, a, v)
        print(f"sweep [{what}]: picked {picked}")
        for setting, ms in rows:
            print(f"  {setting}: mean {np.mean(ms):.4f} ms; by depth "
                  + ", ".join(f"{m:.4f}" for m in ms))

    g = torch.Generator(device=dev).manual_seed(10)
    values = {"_FEW_BINS": SWEEP_FEW, "_REDUCE_KEYS": SWEEP_REDUCE,
              "_MIN_CHUNK": SWEEP_CHUNK, "_PROLOGUE_BLOCKS": SWEEP_PROLOGUE,
              "_DEEP_BLOCKS": SWEEP_DEEP}
    for name, params in (("Covertype", ("_FEW_BINS", "_REDUCE_KEYS",
                                        "_MIN_CHUNK")),
                         ("--missing", ("_MIN_CHUNK",)),
                         ("Higgs", ("_PROLOGUE_BLOCKS", "_DEEP_BLOCKS")),
                         ("MSLR", ("_DEEP_BLOCKS",))):
        rows, F, B, *_r, depths = SYNTH_DENSE[name]
        if name in ("Higgs", "MSLR"):
            depths = range(3, 6)
        bins, gh, B = synth_dense(torch, dev, name)
        present = hg.dense_hist_layout(bins, B).present
        cases = [(torch.randint(0, 2 ** d, (rows,), generator=g, device=dev,
                                dtype=torch.int32), 2 ** d) for d in depths]

        def run(c, lay):
            return hg.histogram_gh_kernel(bins, c[0], gh, c[1], B, lay)

        def fresh():
            return hg.DenseHistLayout(present, dev)

        for attr in params:
            sweep(f"histogram_gh {name}, {attr}",
                  [((attr,), (v,)) for v in values[attr]], hg, cases, run,
                  fresh)
        del bins, gh, cases
    fields, rid, gh = synth_sparse(torch, hs, dev, "--rank")
    gh_e = gh[rid].contiguous()
    amax = lane_amax(gh)
    rows, F, B, _, depths = SYNTH_SPARSE["--rank"]
    cases = [(torch.randint(0, 2 ** d, (rows,), generator=g, device=dev,
                            dtype=torch.int32)[rid].contiguous(), 2 ** d)
             for d in depths]

    def run_s(c, lay):
        return hs.histogram_gh_sparse_kernel(
            lay.gkey, c[0], gh_e, lay.starts, c[1], F, B, layout=lay,
            gh_amax=amax)

    sweep("histogram_gh_sparse --rank, (_SMALL_SPANS, _SPAN_FLOOR)",
          [(("_SMALL_SPANS", "_SPAN_FLOOR"), v) for v in SWEEP_SPAN], hs,
          cases, run_s, lambda: hs.SparseHistLayout(**fields))
    sweep("histogram_gh_sparse --rank, _REDUCE_KEYS",
          [(("_REDUCE_KEYS",), (v,)) for v in SWEEP_SPARSE_REDUCE], hs,
          cases, run_s, lambda: hs.SparseHistLayout(**fields))


# ---- --segment-sweep: the segment-sum kernel's launch geometry ---------------

SEGMENT_RUNS = (1, 2, 4, 8)  # runs of entries a thread takes (before a block)


def segment_sweep(torch, dev) -> None:
    """The segment-sum kernel at the five main-path shapes (served L=1 and
    L=16, leaf sums, node totals into 32 and into one segment; the GBDT
    shapes on random ids and (grad, hess)-like values) under every
    ``_RUNS_PER_THREAD`` in SEGMENT_RUNS, adding in shared memory (where
    the outputs fit) or straight into the global buffer, beside the
    geometry ``launch_geometry`` picks.  Every geometry gives the picked
    one's result bit for bit."""
    from dmlc_core_tpu_torch.ops import segment_sum as ss
    R, rid_s, served = served_inputs(torch, fm_params(1), dev)
    g = torch.Generator(device=dev).manual_seed(5)

    def gbdt(nnz, segments):
        gh = torch.stack([torch.rand(nnz, generator=g, device=dev) - 0.5,
                          0.2 + 0.05 * torch.rand(nnz, generator=g,
                                                  device=dev)], 1)
        rid = torch.randint(0, segments, (nnz,), generator=g, device=dev,
                            dtype=torch.int32)
        return segments, rid, gh.contiguous()

    shapes = {"served L=1": (R, rid_s, served[1]),
              "served L=16": (R, rid_s, served[NUM_FACTORS]),
              "leaf sums, 11M into 64": gbdt(HIGGS_ROWS, 64),
              "node totals, 1.18M into 32": gbdt(BOSCH_ROWS, 32),
              "node totals, 1.18M into 1": gbdt(BOSCH_ROWS, 1)}
    picked, runs0 = ss.launch_geometry, ss._RUNS_PER_THREAD
    try:
        for name, (rows, rid, c) in shapes.items():
            lanes = 1 if c.dim() == 1 else c.shape[1]
            ss._RUNS_PER_THREAD = runs0
            want = ss.segment_sum_kernel(c, rid, rows)
            base = device_ms(torch, lambda: ss.segment_sum_kernel(c, rid,
                                                                  rows), 50)[0]
            geo0 = picked(c.shape[0], rows, lanes)
            timed = []
            for runs in SEGMENT_RUNS:
                ss._RUNS_PER_THREAD = runs
                for shared in (True, False):
                    geo = dict(picked(c.shape[0], rows, lanes), shared=shared,
                               smem=8 * lanes * (1 + rows * shared))
                    if geo["smem"] > 227 * 1024:
                        continue
                    ss.launch_geometry = lambda *_, geo=geo: geo
                    got = ss.segment_sum_kernel(c, rid, rows)
                    check(torch.equal(got.view(torch.int32),
                                      want.view(torch.int32)),
                          f"segment sweep {name}: {geo} changed the result")
                    timed.append((device_ms(
                        torch, lambda: ss.segment_sum_kernel(c, rid, rows),
                        50)[0], runs, geo))
                    ss.launch_geometry = picked
            timed.sort(key=lambda r: r[0])

            def show(ms, r, gg):
                return (f"{ms * 1e3:.2f} us (runs {r}, "
                        f"{'shared' if gg['shared'] else 'global'}, "
                        f"{gg['blocks']} blocks asked)")

            print(f"segment sweep [{name}]: picked {show(base, runs0, geo0)};"
                  f" {len(timed)} geometries, all bitwise equal; fastest "
                  + ", ".join(show(*t) for t in timed[:3])
                  + f"; slowest {show(*timed[-1])}")
    finally:
        ss.launch_geometry, ss._RUNS_PER_THREAD = picked, runs0


# ---- the objectives: softmax and rank:pairwise at full width ---------------

# UCI Covertype (Blackard 1998), the multi-class set of XGBoost's
# demo/gpu_acceleration/cover_type.py: 581,012 rows x 54 features, 10
# continuous, 4 wilderness-area and 40 soil-type one-hot columns, 7 classes
# at the dataset's counts.  Made on the card from a seed: the classes cut
# from a latent elevation that a continuous column, the wilderness area and
# the soil type set, at the order of the classes' mean elevations.  Cut:
# rounds, 20.
COVER_ROWS, COVER_CONT, COVER_SOILS = 581_012, 10, 40
COVER_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367, 20_510)
COVER_ELEVATION_ORDER = (3, 2, 5, 4, 1, 0, 6)   # classes, lowest first
COVER_WILD_SHARES = (0.449, 0.051, 0.436, 0.064)  # the four areas' rows
# Microsoft Learning to Rank MSLR-WEB10K Fold1 train (Qin & Liu 2013):
# 723,412 rows x 136 features, 6,000 queries (mean 120.6 documents, a
# long tail up to 908), relevance 0-4 at its shares, rows contiguous by
# qid.  Made on the card from a seed.  Cut: trees, 20.
MSLR_ROWS, MSLR_FEATURES, MSLR_QUERIES, MSLR_MAX_DOCS = (723_412, 136,
                                                         6_000, 908)
MSLR_SHARES = (0.522, 0.321, 0.131, 0.017, 0.009)
OBJ_KW = dict(num_trees=20, max_depth=6, num_bins=256, learning_rate=0.3)
OBJ_BINNER_ROWS = 200_000  # the binner's host sample
OBJ_ROUNDS = (0, 1, 5, 10, 20)
OBJ_EARLY_STOP = 5
GH_TOL = 1e-5  # first-round (grad, hess) vs float64, of the largest


def covertype_on_card(torch, dev, seed: int = 1998) -> tuple:
    """(x f32 [rows, 54], label f32 [rows]) on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = COVER_ROWS
    cont = torch.randn(rows, COVER_CONT, generator=g, device=dev)
    wild = torch.multinomial(torch.tensor(COVER_WILD_SHARES, device=dev),
                             rows, replacement=True, generator=g)
    soil = torch.randint(0, COVER_SOILS, (rows,), generator=g, device=dev)
    latent = (cont[:, 0] + 0.6 * (wild == 2) - 0.8 * (wild == 3)
              + 0.5 * torch.sin(soil.float()) + 0.3 * cont[:, 1] * cont[:, 2])
    order = torch.argsort(latent, stable=True)
    label = torch.empty(rows, device=dev)
    e0 = 0
    for c in COVER_ELEVATION_ORDER:
        label[order[e0:e0 + COVER_COUNTS[c]]] = c
        e0 += COVER_COUNTS[c]
    oh = torch.nn.functional.one_hot
    x = torch.cat([cont, oh(wild, 4).float(), oh(soil, COVER_SOILS).float()],
                  dim=1).contiguous()
    return x, label


def mslr_on_card(torch, dev, seed: int = 2013) -> tuple:
    """(x f32 [rows, 136], relevance f32, qid i32, the group sizes (host))
    on the card: lognormal query sizes scaled to the rows, the largest at
    MSLR_MAX_DOCS; relevance from a latent (a few features, a query offset
    and noise) cut at MSLR_SHARES."""
    rng = np.random.default_rng(seed)
    s = rng.lognormal(0.0, 0.75, MSLR_QUERIES)
    sizes = np.clip(np.round(s * MSLR_ROWS / s.sum()), 1,
                    MSLR_MAX_DOCS).astype(np.int64)
    sizes[np.argmax(sizes)] = MSLR_MAX_DOCS
    while sizes.sum() != MSLR_ROWS:  # spread the rounding over the groups
        diff = MSLR_ROWS - int(sizes.sum())
        free = np.flatnonzero((sizes > 1) & (sizes < MSLR_MAX_DOCS))
        pick = rng.choice(free, min(abs(diff), free.size), replace=False)
        sizes[pick] += np.sign(diff)
    g = torch.Generator(device=dev).manual_seed(seed)
    qid = torch.repeat_interleave(
        torch.arange(MSLR_QUERIES, dtype=torch.int32, device=dev),
        torch.from_numpy(sizes).to(dev))
    x = torch.randn(MSLR_ROWS, MSLR_FEATURES, generator=g, device=dev)
    offset = 0.5 * torch.randn(MSLR_QUERIES, generator=g, device=dev)
    latent = (x[:, 0] + 0.7 * x[:, 1] * (x[:, 2] > 0) - 0.5 * x[:, 3]
              + 0.4 * x[:, 4] * x[:, 5] + offset[qid.long()]
              + 0.3 * torch.randn(MSLR_ROWS, generator=g, device=dev))
    cuts = torch.quantile(latent, torch.tensor(
        np.cumsum(MSLR_SHARES)[:-1], dtype=torch.float32, device=dev))
    rel = torch.bucketize(latent, cuts).to(torch.float32)
    return x, rel, qid, sizes


def softmax_gh64(margin: np.ndarray, label: np.ndarray) -> np.ndarray:
    """float64 [rows, K, 2]: ``p - onehot`` and ``p(1-p)`` per class."""
    m = margin.astype(np.float64)
    p = np.exp(m - m.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    onehot = np.eye(m.shape[1])[label.astype(np.int64)]
    return np.stack([p - onehot, np.maximum(p * (1 - p), 1e-16)], -1)


def group_spans(sizes: np.ndarray):
    ends = np.cumsum(sizes)
    return zip(ends - sizes, ends)


def ranknet_gh64(margin: np.ndarray, label: np.ndarray,
                 sizes: np.ndarray) -> np.ndarray:
    """float64 [rows, 2]: RankNet over every same-query pair of differing
    relevance, XGBoost's signs (the winner's grad falls, the loser's
    rises)."""
    m, y = margin.astype(np.float64), label.astype(np.float64)
    out = np.zeros((m.size, 2))
    for a, b in group_spans(sizes):
        d = m[a:b, None] - m[None, a:b]          # d[i, j] = m_i - m_j
        win = y[a:b, None] > y[None, a:b]        # i beats j
        p = np.where(win, 1.0 / (1.0 + np.exp(d)), 0.0)
        hh = np.where(win, np.maximum(p * (1 - p), 1e-16), 0.0)
        out[a:b, 0] = -p.sum(1) + p.sum(0)
        out[a:b, 1] = hh.sum(1) + hh.sum(0)
    return out


def rank_metrics(scores: np.ndarray, label: np.ndarray,
                 sizes: np.ndarray) -> tuple:
    """(pairwise accuracy over every same-query pair of differing
    relevance, mean NDCG@10 over the queries with a relevant document)."""
    good = total = 0
    ndcg = []
    disc = 1.0 / np.log2(np.arange(2, 12))
    for a, b in group_spans(sizes):
        s, y = scores[a:b], label[a:b]
        win = y[:, None] > y[None, :]
        total += int(win.sum())
        good += int((win & (s[:, None] > s[None, :])).sum())
        gain = 2.0 ** y - 1.0
        ideal = np.sort(gain)[::-1][:10]
        if ideal[0] > 0:
            top = gain[np.argsort(-s, kind="stable")][:10]
            ndcg.append((top * disc[:top.size]).sum()
                        / (ideal * disc[:ideal.size]).sum())
    return good / max(total, 1), float(np.mean(ndcg))


def objective_tree_inputs(torch, model, forest, bins, label, qid=None):
    """``tree_inputs`` for the softmax and pairwise drivers: tree by tree,
    the (grad, hess) the fit gave its tree builder (softmax: round r's
    class k tree from the round's ``softmax``, ``p - onehot`` and
    ``p(1-p)``; rank: the pairwise scan over the margins so far), each
    row's node at every depth and its leaf, routed through the fitted
    forest, and no feature masks (the fits do not sample).  The margins
    add up as the drivers add them, so the inputs are the fit's own, bit
    for bit."""
    rows, depth = label.shape[0], model.max_depth

    def route(t):
        feat, thr = forest["feature"][t], forest["threshold"][t]
        node = torch.zeros(rows, dtype=torch.int64, device=label.device)
        levels = []
        for d in range(depth):
            levels.append(((node - (2 ** d - 1)).to(torch.int32)
                           .contiguous(), 2 ** d))
            b = torch.gather(bins, 1, feat[node].long()[:, None])[:, 0]
            node = 2 * node + 1 + (b.to(torch.int32) > thr[node]).long()
        return levels, node - (2 ** depth - 1)

    ones = torch.ones_like(label)
    masks = [None] * depth
    if model.objective == "softmax":
        K = model.num_class
        margin = forest["base"].expand(rows, K).clone()
        onehot = torch.nn.functional.one_hot(label.long(), K).float()
        for r in range(model.num_trees):
            p = torch.softmax(margin, dim=1)
            for k in range(K):
                g = p[:, k] - onehot[:, k]
                h = torch.clamp(p[:, k] * (1.0 - p[:, k]), min=1e-16)
                gh = torch.stack([g * ones, h * ones], dim=-1).contiguous()
                levels, leaf_rel = route(r * K + k)
                yield gh, levels, leaf_rel.to(torch.int32).contiguous(), masks
                margin[:, k] += forest["leaf"][r * K + k][leaf_rel]
        return
    grad_hess, _ = model._rank_fns(qid, ones)
    margin = forest["base"].expand(rows).clone()
    for t in range(model.num_trees):
        g, h = grad_hess(margin, label)
        gh = torch.stack([g * ones, h * ones], dim=-1).contiguous()
        levels, leaf_rel = route(t)
        yield gh, levels, leaf_rel.to(torch.int32).contiguous(), masks
        margin = margin + forest["leaf"][t][leaf_rel]


def forest_leaves64(forest: dict, bins: np.ndarray, depth: int) -> np.ndarray:
    """float64 [rows, trees]: each row's leaf value in every tree, routed
    in numpy."""
    feat = forest["feature"].cpu().numpy()
    thr = forest["threshold"].cpu().numpy()
    leaf = forest["leaf"].cpu().numpy().astype(np.float64)
    rows = np.arange(bins.shape[0])
    out = np.empty((bins.shape[0], feat.shape[0]))
    for t in range(feat.shape[0]):
        node = np.zeros(bins.shape[0], np.int64)
        for _ in range(depth):
            node = 2 * node + 1 + (bins[rows, feat[t, node]] > thr[t, node])
        out[:, t] = leaf[t, node - (2 ** depth - 1)]
    return out


def round_margins(torch, model, forest, bins, rounds):
    """Yield (round, margins after it) for the rounds asked, adding the
    trees' margins on the card as ``margins``/``margins_multi`` do."""
    K = max(model.num_class, 1)
    rows = bins.shape[0]
    m = (forest["base"].expand(rows, K) if K > 1
         else forest["base"].expand(rows)).clone()
    if 0 in rounds:
        yield 0, m
    for r in range(model.num_trees):
        for k in range(K):
            t = r * K + k
            tm = model._tree_margins(forest["feature"][t],
                                     forest["threshold"][t],
                                     forest["default_right"][t],
                                     forest["leaf"][t], bins)
            if K > 1:
                m[:, k] += tm
            else:
                m += tm
        if r + 1 in rounds:
            yield r + 1, m


def objective_fit(torch, hg, ss_mod, model, bins, label, qid, what: str,
                  trees: int) -> tuple:
    """Two timed fits of the main path (the kernels are built and warm by
    now) with the launch counts set to 0 just before each and read just
    after; the forests bitwise equal.  Returns (forest, [(seconds,
    histogram launches, segment-sum launches, peak bytes)] of the
    fits)."""
    from dmlc_core_tpu_torch import telemetry
    kw = {} if qid is None else {"qid": qid}
    warm, out = None, []
    for _ in range(2):
        hg.histogram_gh_kernel.launches = 0
        hg.histogram_gh_kernel.subtracted = 0
        ss_mod.segment_sum_kernel.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        forest = model.fit(bins, label, **kw)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        out.append((secs, hg.histogram_gh_kernel.launches,
                    ss_mod.segment_sum_kernel.launches,
                    torch.cuda.max_memory_allocated(),
                    hg.histogram_gh_kernel.subtracted))
        warm = forest if warm is None else warm
        check(all(torch.equal(forest[k], warm[k]) for k in warm),
              f"{what}: two fits gave different forests")
    rows = bins.shape[0]
    for secs, h_l, s_l, peak, sub_l in out:
        print(f"{what} fit: {secs:.3f} s wall, {rows * trees / secs:.0f} "
              f"row_trees_s ({trees} trees); launches: histogram_gh {h_l} "
              f"({sub_l} levels subtracted, gbdt.hist_built_permille "
              f"{telemetry.gauge_get('gbdt.hist_built_permille')}), "
              f"segment_sum {s_l}; peak device memory {peak / 2**30:.2f} "
              "GiB")
    return forest, out


def objective_kernel_levels(torch, hg, ss_mod, model, forest, bins, label,
                            qid, what: str) -> dict:
    """The first tree's own levels: the dense kernel's time at each depth
    beside the plain version, ``index_add`` and the bound, its error
    against float64 (means over depths 0-5), and the leaf sums on the
    segment-sum kernel."""
    gh, levels, leaf_rel, _ = next(objective_tree_inputs(
        torch, model, forest, bins, label, qid))
    B = model.num_bins
    leaf = check_leaf_sums(torch, ss_mod, gh, leaf_rel, 2 ** model.max_depth,
                           what=f"{what} leaf sums")
    layout = hg.dense_hist_layout(bins, B)  # as the fit builds it
    print(f"{what} layout: used bins a feature {np.bincount(layout.used)}"
          f"[count of features with 0, 1, 2, ... used bins]")
    max_err, per_level = 0.0, []
    for d in (0, 3, 5):
        rel, n = levels[d]
        max_err = max(max_err, check_hist(torch, hg, f"{what} depth {d}",
                                          bins, rel, gh, n, B, layout))
    for d, (lv, err, nbytes, cov) in enumerate(level_times(
            torch, hg, bins, levels, gh, B, layout)):
        n = levels[d][1]
        per_level.append(lv)
        print(f"time [{what} histogram, depth {d}, n={n}]: kernel "
              f"{lv['ms']:.4f} ms (previous kernel: {PRIOR_MS[what][d]:.3f}), "
              f"plain {lv['plain_ms']:.1f} ms, index_add "
              f"{lv['library_ms']:.4f} ms, bound {lv['bound_ms']:.4f} ms "
              f"({nbytes} bytes, {lv['bound_by']}); |kernel - float64| "
              f"{err:.3e} of the largest bin; queue covered: {cov}"
              + subtraction_text(lv))
        check(err <= HIST_TOL, f"{what} depth {d}: {err} from float64")
    level_summary(f"{what} histogram", per_level, prior_ms=PRIOR_MS[what])
    ops_line(torch, f"histogram_gh, {what} depth 5",
             lambda: hg.histogram_gh_kernel(bins, rel, gh, n, B, layout))
    mean = {k: float(np.mean([lv[k] for lv in per_level]))
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"max_abs_err": max_err, "bound_by": per_level[0]["bound_by"],
            **mean, **tree_ms(per_level), "leaf": leaf}


def objective_audit(torch, hg, model, forest, bins, label, qid,
                    what: str) -> None:
    a = split_audit(torch, hg, model, forest, bins, label, "pallas",
                    inputs=objective_tree_inputs(torch, model, forest, bins,
                                                 label, qid))
    trees = forest["feature"].shape[0]
    # a rare class's leaves run far past 1 (-G/(H + lambda) over rows with
    # p(1-p) near 0), so the leaves are held relative to the largest
    leaf_tol = LEAF_TOL * max(1.0, a["leaf_max"])
    print(f"{what} audit [every level of {trees} trees]: histogram vs "
          f"float64 {a['hist_err']:.3e} of the largest bin; {a['off_best']} "
          f"of {a['nodes']} splits off the float64 best, {a['beyond']} "
          f"beyond rounding (worst regret/noise {a['worst']:.2f}); replay "
          f"mismatches {a['replay']}; |leaf - float64 leaf| "
          f"{a['leaf_err']:.3e} (largest leaf {a['leaf_max']:.3f}, tol "
          f"{leaf_tol:.3e})")
    check(a["hist_err"] <= HIST_TOL and a["beyond"] == 0
          and a["replay"] == 0 and a["leaf_err"] <= leaf_tol,
          f"{what} audit: {a}")


def profile_one_round(torch, model_cls, kw, bins, label, qid, what: str):
    """One round (softmax: K trees) under the profiler: wall, device busy
    and the kernels; returns the wall in ms."""
    from torch.profiler import ProfilerActivity, profile
    one = model_cls(**{**kw, "num_trees": 1})
    fit_kw = {} if qid is None else {"qid": qid}
    one.fit(bins, label, **fit_kw)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        one.fit(bins, label, **fit_kw)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    dev_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"profile [{what}, one round under the profiler]: wall "
          f"{wall_ms:.2f} ms, device busy {dev_ms:.2f} ms "
          f"({100 * dev_ms / wall_ms:.1f}%), {len(events)} kernel kinds")
    if not events:
        print("  device time: not measured (no CUDA events in the trace)")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:6]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:<6} "
              f"{e.key[:90]}")
    return wall_ms


def phase_objectives(torch, ss_mod, dev) -> dict:
    """The softmax and rank:pairwise GBDT at Covertype and MSLR-WEB10K
    width on the dense kernel: exact launches, two fits bitwise, the first
    round's (grad, hess) against float64, an audit of every level of every
    tree, predictions against a float64 routing oracle, baselines, times,
    a profile of one round, and Covertype's early stopping at the round a
    float64 replay picks."""
    from dmlc_core_tpu_torch.models import GBDT, QuantileBinner
    from dmlc_core_tpu_torch.ops import histogram as hg
    B, depth, rounds = OBJ_KW["num_bins"], OBJ_KW["max_depth"], \
        OBJ_KW["num_trees"]
    out = {}

    # ---- Covertype, softmax
    t0 = time.monotonic()
    x, label = covertype_on_card(torch, dev)
    torch.cuda.synchronize()
    t_gen = time.monotonic() - t0
    counts = torch.bincount(label.long(), minlength=7).tolist()
    check(tuple(counts) == COVER_COUNTS, f"Covertype counts {counts}")
    check(bool((x[:, 10:14].sum(1) == 1).all()
               and (x[:, 14:].sum(1) == 1).all()), "one-hot columns")
    binner = QuantileBinner(num_bins=B, device=dev).fit(
        x[:OBJ_BINNER_ROWS].cpu().numpy())
    bins = binner.transform(x)
    del x
    print(f"objectives data [Covertype]: {COVER_ROWS} x {bins.shape[1]} "
          f"(10 continuous, 4 + 40 one-hot), classes {counts}; generated on "
          f"the card in {t_gen:.2f} s; codes a one-hot column takes: "
          f"{sorted({len(torch.unique(bins[:, f])) for f in range(10, 54)})}")
    K = 7
    kw = dict(num_features=54, objective="softmax", num_class=K, device=dev,
              **OBJ_KW)
    model = GBDT(**kw)
    forest, fits = objective_fit(torch, hg, ss_mod, model, bins, label, None,
                                 "Covertype softmax", rounds * K)
    for _, h_l, s_l, _, sub_l in fits:
        check(h_l == rounds * K * depth and s_l == rounds * K
              and sub_l == rounds * K * (depth - 1),
              f"Covertype: {h_l} histogram and {s_l} segment-sum launches, "
              f"{sub_l} levels subtracted (want {rounds * K * depth}, "
              f"{rounds * K} and {rounds * K * (depth - 1)})")
    full = GBDT(**kw)
    full._SUBTRACT = False
    f_full, fits_full = objective_fit(
        torch, hg, ss_mod, full, bins, label, None,
        "Covertype softmax, every level in full", rounds * K)
    check(fits_full[1][4] == 0 and all(torch.equal(f_full[k], forest[k])
                                       for k in forest),
          "Covertype: the fit with every level in full differs from the "
          "subtracted fit")
    print(f"Covertype fit, every level in full: {fits_full[1][0]:.3f} s "
          f"(subtracted {fits[1][0]:.3f} s, {fits_full[1][0] / fits[1][0]:.3f}"
          " x faster); forest bitwise the subtracted fit's")
    del full, f_full
    # the first round's (grad, hess) against float64
    gh0 = next(objective_tree_inputs(torch, model, forest, bins, label))[0]
    p0 = torch.softmax(forest["base"].expand(COVER_ROWS, K), dim=1)
    onehot = torch.nn.functional.one_hot(label.long(), K).float()
    got = torch.stack([p0 - onehot, torch.clamp(p0 * (1 - p0), min=1e-16)],
                      -1).cpu().numpy()
    want = softmax_gh64(forest["base"].expand(COVER_ROWS, K).cpu().numpy(),
                        label.cpu().numpy())
    err = float(np.abs(got - want).max() / np.abs(want).max())
    check(torch.equal(gh0, torch.stack([p0[:, 0] - onehot[:, 0], torch.clamp(
        p0[:, 0] * (1 - p0[:, 0]), min=1e-16)], -1)),
          "Covertype: the replayed class-0 (grad, hess) is not the round's")
    print(f"Covertype first round (grad, hess) vs float64: {err:.3e} of the "
          f"largest (tol {GH_TOL})")
    check(err <= GH_TOL, f"Covertype first-round gh error {err}")
    out["cover"] = objective_kernel_levels(torch, hg, ss_mod, model, forest,
                                           bins, label, None, "Covertype")
    out["cover"].update(launches=fits[0][1], seg=fits[0][2], fit_s=fits[0][0])
    objective_audit(torch, hg, model, forest, bins, label, None,
                    "Covertype softmax")
    # predictions on 100k rows against float64 routing
    pb = bins[:PREDICT_ROWS]
    prob = model.predict(forest, pb)
    m = model.margins_multi(forest, pb).cpu().numpy().astype(np.float64)
    leaves = forest_leaves64(forest, pb.cpu().numpy(), depth)
    base64 = forest["base"].cpu().numpy().astype(np.float64)[None, :]
    m64 = base64 + leaves.reshape(PREDICT_ROWS, rounds, K).sum(1)
    # the rare classes' leaves run into the hundreds and cancel, so a
    # margin is held relative to the size of its terms (|base| + the sum
    # of |leaf| over its trees: f32 adds round at ~6e-8 of that each), and
    # the probabilities to a float64 softmax of the card's margins
    terms = np.abs(base64) + np.abs(leaves.reshape(PREDICT_ROWS, rounds,
                                                   K)).sum(1)
    err_m = float((np.abs(m - m64) / np.maximum(1.0, terms)).max())
    p64 = np.exp(m - m.max(1, keepdims=True))
    p64 /= p64.sum(1, keepdims=True)
    err_p = float(np.abs(prob.cpu().numpy() - p64).max())
    print(f"Covertype predict: {PREDICT_ROWS} rows, max |margin - float64 "
          f"routing| / max(1, |base| + sum |leaf|) {err_m:.3e} (largest "
          f"|margin| {np.abs(m64).max():.1f}, largest term sum "
          f"{terms.max():.1f}), max |p - float64 softmax of the margins| "
          f"{err_p:.3e}")
    check(err_p <= 1e-5 and err_m <= 1e-5, "Covertype predictions")
    base = []
    y = label.long()
    for r, mr in round_margins(torch, model, forest, bins, OBJ_ROUNDS):
        md = mr.double()
        logp = md - torch.logsumexp(md, dim=1, keepdim=True)
        base.append((r, float(-logp.gather(1, y[:, None]).mean()),
                     float((mr.argmax(1) == y).float().mean())))
    print("Covertype train mlogloss / accuracy after "
          + ", ".join(f"{r} rounds {l:.6f} / {a:.4f}" for r, l, a in base))
    # baselines, no limit: the rare classes' large leaves overshoot in
    # early rounds, so the loss need not fall every round
    check(base[-1][2] > base[0][2], "Covertype accuracy did not rise")
    profile_one_round(torch, GBDT, kw, bins, label, None, "Covertype softmax")
    # early stopping on a held-out fifth
    cut = COVER_ROWS * 4 // 5
    es = GBDT(**kw).fit(bins[:cut], label[:cut],
                        eval_set=(bins[cut:], label[cut:]),
                        early_stopping_rounds=OBJ_EARLY_STOP)
    full = model.fit(bins[:cut], label[:cut])
    used = int(es["trees_used"])
    check(all(torch.equal(es[k][:used], full[k][:used])
              for k in ("feature", "threshold", "leaf")),
          "the early-stopped forest's trees are not the full fit's")
    leaves = forest_leaves64(full, bins[cut:].cpu().numpy(), depth)
    ev_y = label[cut:].long().cpu().numpy()
    losses = []
    m64 = np.broadcast_to(full["base"].cpu().numpy().astype(np.float64),
                          (ev_y.size, K)).copy()
    for r in range(rounds):
        m64 += leaves[:, r * K:(r + 1) * K]
        z = m64 - m64.max(1, keepdims=True)
        logp = z - np.log(np.exp(z).sum(1, keepdims=True))
        losses.append(float(-logp[np.arange(ev_y.size), ev_y].mean()))
    ran = min(rounds, used // K + OBJ_EARLY_STOP)
    pick = 1 + int(np.argmin(losses[:ran]))
    print(f"Covertype early stopping (eval {COVER_ROWS - cut} rows, "
          f"{OBJ_EARLY_STOP} rounds): trees_used {used} ({used // K} rounds); "
          f"the float64 held-out mlogloss is least after round {pick} of the "
          f"{ran} run ({losses[pick - 1]:.6f}; last {losses[ran - 1]:.6f})")
    check(used == pick * K, f"trees_used {used}, float64 picks round {pick}")
    del bins, label, es, full

    # ---- MSLR-WEB10K, rank:pairwise
    t0 = time.monotonic()
    x, rel, qid, sizes = mslr_on_card(torch, dev)
    torch.cuda.synchronize()
    t_gen = time.monotonic() - t0
    shares = (torch.bincount(rel.long(), minlength=5).double()
              / MSLR_ROWS).tolist()
    binner = QuantileBinner(num_bins=B, device=dev).fit(
        x[:OBJ_BINNER_ROWS].cpu().numpy())
    bins = binner.transform(x)
    del x
    print(f"objectives data [MSLR-WEB10K]: {MSLR_ROWS} x {MSLR_FEATURES}, "
          f"{MSLR_QUERIES} queries (documents: mean {sizes.mean():.1f}, "
          f"median {int(np.median(sizes))}, max {int(sizes.max())}), "
          f"relevance shares {[round(s, 4) for s in shares]}; generated on "
          f"the card in {t_gen:.2f} s")
    kw = dict(num_features=MSLR_FEATURES, objective="rank:pairwise",
              device=dev, **OBJ_KW)
    model = GBDT(**kw)
    forest, fits = objective_fit(torch, hg, ss_mod, model, bins, rel, qid,
                                 "MSLR rank:pairwise", rounds)
    for _, h_l, s_l, _, sub_l in fits:
        check(h_l == rounds * depth and s_l == rounds
              and sub_l == rounds * (depth - 1),
              f"MSLR: {h_l} histogram and {s_l} segment-sum launches, "
              f"{sub_l} levels subtracted (want {rounds * depth}, {rounds} "
              f"and {rounds * (depth - 1)})")
    ones = torch.ones_like(rel)
    grad_hess, _ = model._rank_fns(qid, ones)
    host_rel = rel.cpu().numpy()
    margin = forest["base"].expand(MSLR_ROWS).clone()
    for r in (0, 1):  # the first round's, and the second's off its margins
        g, h = grad_hess(margin, rel)
        want = ranknet_gh64(margin.cpu().numpy(), host_rel, sizes)
        err = float(np.abs(torch.stack([g, h], -1).cpu().numpy() - want).max()
                    / np.abs(want).max())
        print(f"MSLR round {r} (grad, hess) vs float64 RankNet: {err:.3e} of "
              f"the largest (tol {GH_TOL})")
        check(err <= GH_TOL, f"MSLR round {r} gh error {err}")
        margin = margin + model._tree_margins(
            forest["feature"][0], forest["threshold"][0],
            forest["default_right"][0], forest["leaf"][0], bins)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    grad_hess(margin, rel)
    torch.cuda.synchronize()
    scan_ms = (time.monotonic() - t0) * 1e3
    out["mslr"] = objective_kernel_levels(torch, hg, ss_mod, model, forest,
                                          bins, rel, qid, "MSLR")
    out["mslr"].update(launches=fits[0][1], seg=fits[0][2], fit_s=fits[0][0])
    objective_audit(torch, hg, model, forest, bins, rel, qid,
                    "MSLR rank:pairwise")
    pb = bins[:PREDICT_ROWS]
    m = model.margins(forest, pb).cpu().numpy().astype(np.float64)
    leaves = forest_leaves64(forest, pb.cpu().numpy(), depth)
    m64 = float(forest["base"]) + leaves.sum(1)
    terms = abs(float(forest["base"])) + np.abs(leaves).sum(1)
    err_m = float((np.abs(m - m64) / np.maximum(1.0, terms)).max())
    print(f"MSLR predict: {PREDICT_ROWS} rows, max |score - float64 "
          f"routing| / max(1, |base| + sum |leaf|) {err_m:.3e} (largest "
          f"|score| {np.abs(m64).max():.2f})")
    check(err_m <= 1e-5, "MSLR predictions")
    base = []
    for r, mr in round_margins(torch, model, forest, bins, OBJ_ROUNDS):
        base.append((r, *rank_metrics(mr.cpu().numpy(), host_rel, sizes)))
    print("MSLR train pairwise accuracy / NDCG@10 after " + ", ".join(
        f"{r} trees {a:.4f} / {n:.4f}" for r, a, n in base))
    check(base[-1][1] > base[1][1], "MSLR pairwise accuracy did not rise "
          "past the first tree's")
    wall = profile_one_round(torch, GBDT, kw, bins, rel, qid,
                             "MSLR rank:pairwise")
    depth_scan = int(sizes.max())
    print(f"MSLR pairwise scan: {depth_scan} shifts a round, "
          f"{scan_ms:.1f} ms (host clock), {100 * scan_ms / wall:.1f}% of a "
          f"one-tree round's {wall:.1f} ms")
    out["mslr"]["scan_ms"], out["mslr"]["round_ms"] = scan_ms, wall
    return out


# ---- the examples: the port's programs on the card ---------------------------

EX_EPOCHS = 2          # train_linear's and train_ffm's (cut from 3 and 30)
EX_DIST_BATCH = 4096   # distributed_train's rows a rank a global batch
EX_DIST_NNZ_MAX = EX_DIST_BATCH * (NNZ_PER_ROW + 1)  # no batch closes early
EX_TIMEOUT_S = 300


@contextlib.contextmanager
def first_calls(mod, name: str, keep: int):
    """Keep the arguments of the first ``keep`` calls of ``mod.name`` (a
    kernel's wrapper) while the block runs.  The wrapper counts its launches
    (the dense one also its subtracted levels) on the object the module's
    name holds, so the spy carries the counts and hands them back when the
    block ends."""
    orig = getattr(mod, name)
    calls = []
    counters = [c for c in ("launches", "subtracted") if hasattr(orig, c)]

    def spy(*args, **kwargs):
        if len(calls) < keep:
            calls.append((args, kwargs))
        return orig(*args, **kwargs)

    for c in counters:
        setattr(spy, c, getattr(orig, c))
    setattr(mod, name, spy)
    try:
        yield calls
    finally:
        for c in counters:
            setattr(orig, c, getattr(spy, c))
        setattr(mod, name, orig)


def run_example(torch, main, argv: list, what: str) -> tuple:
    """An example's ``main(argv)`` in this process: its exit code must be 0
    and its output hold a ``final`` line.  Returns (stdout, seconds)."""
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    text = out.getvalue()
    final = [ln for ln in text.splitlines() if ln.startswith("final")]
    print(f"example [{what}]: exit {rc}, {secs:.2f} s; "
          + (final[-1] if final else "no final line"))
    check(rc == 0 and final, f"example {what}: exit {rc}\n{text[-2000:]}")
    return text, secs


def phase_examples(torch, ss_mod, dev, build_dir: Path, train_uri: str,
                   ffm_uri: str, bosch_uri: str, bosch_rule) -> dict:
    """The port's example programs on the card: train_linear on the
    Criteo-width training file, train_ffm on the libffm file, gbdt_train
    --native-sparse on the Bosch-width rows, --rank and --missing on their
    own synthetic data under ``build_dir``, each in process with the
    launch counts set to 0 just before and read just after; and
    distributed_train as a 2-rank ``dmlc_submit`` job on the one card
    (gloo).  Each exits 0 and prints its final line; each launches its
    kernels (a segment sum at least every step, a histogram every level of
    every tree), and each kernel is timed at the first launch's inputs
    beside its plain version."""
    from dmlc_core_tpu_torch.examples import (gbdt_train, train_ffm,
                                              train_linear)
    from dmlc_core_tpu_torch.ops import histogram as hg
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    out, runs = {}, {}

    def counts():
        return (ss_mod.segment_sum_kernel.launches,
                hg.histogram_gh_kernel.launches,
                hs.histogram_gh_sparse_kernel.launches)

    def reset():
        ss_mod.segment_sum_kernel.launches = 0
        hg.histogram_gh_kernel.launches = 0
        hs.histogram_gh_sparse_kernel.launches = 0

    # the linear model: 64 steps an epoch of 8192 rows, one launch a step
    reset()
    with first_calls(ss_mod, "segment_sum_kernel", 1) as seg:
        text, secs = run_example(
            torch, train_linear.main,
            ["--data", train_uri, "--epochs", str(EX_EPOCHS)],
            "train_linear")
    steps = sum(int(n) for n in re.findall(r"\((\d+) batches", text))
    runs["train_linear"] = dict(secs=secs, steps=steps, launches=counts())
    check(steps == EX_EPOCHS * TRAIN_ROWS // TRAIN_BATCH
          and counts()[0] >= steps, f"train_linear: {counts()} launches in "
          f"{steps} steps")
    (c, rid, R), _ = seg[0]
    out["linear"] = segment_timing(torch, ss_mod, c.detach(), rid, R,
                                   "train_linear step")
    del seg

    # the FFM: 64 steps an epoch of 4096 rows, one launch a step
    reset()
    with first_calls(ss_mod, "segment_sum_kernel", 1) as seg:
        text, secs = run_example(
            torch, train_ffm.main,
            ["--data", ffm_uri, "--epochs", str(EX_EPOCHS)], "train_ffm")
    steps = EX_EPOCHS * -(-FFM_ROWS // 4096)
    runs["train_ffm"] = dict(secs=secs, steps=steps, launches=counts())
    check(counts()[0] >= steps, f"train_ffm: {counts()} launches in {steps}"
          " steps")
    (c, rid, R), _ = seg[0]
    out["ffm"] = segment_timing(torch, ss_mod, c.detach(), rid, R,
                                "train_ffm step")
    del seg

    # the GBDT paths: 10 trees of depth 5, one histogram a level
    trees, depth = 10, 5
    rank_uri = build_dir / "gbdt_rank_example.libsvm"
    miss_uri = build_dir / "gbdt_example.libsvm"
    t0 = time.monotonic()
    gbdt_train.synth_rank_dataset(str(rank_uri))
    gbdt_train.synth_dataset(str(miss_uri))
    # the Bosch-width rows labelled by the planted rule's sign: the file's
    # labels are Bernoulli draws from it, which no model gets past the
    # example's 0.8 accuracy gate
    blob = np.fromfile(bosch_uri, np.uint8)
    starts = np.r_[0, np.flatnonzero(blob == ord("\n"))[:-1] + 1]
    check(starts.size == bosch_rule.size, "Bosch rows")
    blob[starts] = np.where(bosch_rule, ord("1"), ord("0"))
    bosch_uri = str(build_dir / f"bosch_{STREAM_ROWS}_rule.libsvm")
    blob.tofile(bosch_uri)
    del blob, starts
    print(f"examples data: the gbdt --rank and --missing synthetic files "
          f"and the Bosch rows under the rule's labels ({bosch_rule.mean():.4f}"
          f" positive) under {build_dir.name}/ in "
          f"{time.monotonic() - t0:.1f} s (host)")
    gbdt_seg = 0
    for name, argv, mod, kname in (
            ("gbdt_train --native-sparse",
             ["--native-sparse", "--dim", str(BOSCH_FEATURES), "--data",
              bosch_uri], hs, "histogram_gh_sparse_kernel"),
            ("gbdt_train --rank", ["--rank", "--data", str(rank_uri)], hs,
             "histogram_gh_sparse_kernel"),
            ("gbdt_train --missing", ["--missing", "--data", str(miss_uri)],
             hg, "histogram_gh_kernel")):
        reset()
        with first_calls(mod, kname, depth) as hist, \
                first_calls(ss_mod, "segment_sum_kernel", 1) as seg:
            text, secs = run_example(torch, gbdt_train.main, argv, name)
        seg_l, dense_l, sparse_l = counts()
        hist_l = dense_l if mod is hg else sparse_l
        runs[name] = dict(secs=secs, launches=counts())
        check(hist_l == trees * depth and (dense_l if mod is hs else
                                           sparse_l) == 0,
              f"{name}: launches (segment, dense, sparse) {counts()}, want "
              f"{trees * depth} histograms")
        gbdt_seg += seg_l
        per_level, max_err = [], 0.0
        for d, (args, kw) in enumerate(hist):
            if mod is hs:
                gkey, rel_e, gh_e, starts, n, F, B = args
                lv, err = sparse_level_time(
                    torch, hs, kw["layout"], rel_e, gh_e, kw["gh_amax"], n, F,
                    B, f"{name} sparse histogram, depth {d}",
                    PRIOR_MS[name][d])
                call = (lambda a=args, k=kw: hs.histogram_gh_sparse_kernel(
                    *a, **k))
            else:
                bins, rel, gh, n, B, layout = args
                check(layout is not None, f"{name}: the fit passed no layout")
                lv, err, nbytes, cov = dense_level_time(torch, hg, bins, rel,
                                                        gh, n, B, layout)
                print(f"time [{name} histogram, depth {d}, n={n}]: kernel "
                      f"{lv['ms']:.4f} ms (previous kernel: "
                      f"{PRIOR_MS[name][d]:.3f}), plain {lv['plain_ms']:.1f} "
                      f"ms, index_add {lv['library_ms']:.4f} ms, bound "
                      f"{lv['bound_ms']:.4f} ms ({nbytes} bytes); |kernel - "
                      f"float64| {err:.3e}; queue covered: {cov}")
                check(err <= HIST_TOL, f"{name} depth {d}: {err}")
                call = (lambda a=args: hg.histogram_gh_kernel(*a))
            per_level.append(lv)
            max_err = max(max_err, err)
        level_summary(f"{name} histogram", per_level, prior_ms=PRIOR_MS[name])
        ops_line(torch, f"{name} histogram, depth {len(hist) - 1}", call)
        out[name] = {"max_abs_err": max_err, "launches": hist_l,
                     "bound_by": per_level[0]["bound_by"],
                     "shape": f"{tuple(args[0].shape)} "
                              f"{'entries' if mod is hs else 'codes'}",
                     **{k: float(np.mean([lv[k] for lv in per_level]))
                        for k in ("ms", "plain_ms", "library_ms",
                                  "bound_ms")}}
        if name == "gbdt_train --native-sparse":
            (c, rid, R), _ = seg[0]
            out["gbdt_seg"] = check_leaf_sums(
                torch, ss_mod, c, rid, R, what=f"{name} node totals")
        del hist, seg
    out["gbdt_seg"]["launches"] = gbdt_seg

    # distributed_train: a 2-rank job under the port's dmlc_submit, both
    # ranks on the one card (gloo: NCCL refuses two ranks on one device)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.dmlc_submit",
         "--cluster=local", "-n", "2", "--", sys.executable, "-m",
         "dmlc_core_tpu_torch.examples.distributed_train", "--data",
         train_uri, "--batch-size", str(EX_DIST_BATCH), "--nnz-max",
         str(EX_DIST_NNZ_MAX), "--device", "cuda"],
        cwd=REPO, capture_output=True, text=True, timeout=EX_TIMEOUT_S)
    secs = time.monotonic() - t0
    ranks = re.findall(r"^rank (\d): (\d+) steps, segment_sum launches "
                       r"(\d+)$", proc.stdout, re.M)
    final = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("final")]
    print(f"example [distributed_train, 2 ranks under dmlc_submit]: exit "
          f"{proc.returncode}, {secs:.2f} s (job wall); "
          + (final[-1] if final else "no final line") + "; "
          + "; ".join(f"rank {r}: {s} steps, {n} segment_sum launches"
                      for r, s, n in ranks))
    check(proc.returncode == 0 and final and len(ranks) == 2
          and all(int(n) >= int(s) > 0 for _, s, n in ranks),
          f"distributed_train: exit {proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    runs["distributed_train"] = dict(secs=secs, steps=sum(
        int(s) for _, s, _ in ranks), launches=(sum(
            int(n) for _, _, n in ranks), 0, 0))
    # a rank's step: its part's rows in nnz_max lanes
    from dmlc_core_tpu_torch.data import DeviceStagingIter
    it = DeviceStagingIter(train_uri, batch_size=EX_DIST_BATCH,
                           nnz_bucket=EX_DIST_NNZ_MAX, part=0, num_parts=2,
                           device=dev)
    b = next(iter(it))
    it.close()
    w = torch.randn(NUM_FEATURES, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    out["dist"] = segment_timing(
        torch, ss_mod, w[b.index.long()] * b.value, b.row_ids(),
        b.batch_size, "distributed_train rank step")
    print("examples: " + "; ".join(
        f"{k} {v['secs']:.2f} s, launches (segment_sum, histogram_gh, "
        f"histogram_gh_sparse) {v['launches']}" for k, v in runs.items()))
    out["runs"] = runs
    return out


# ---- --label-study: where a kernel fit and an index_add fit part ------------

STUDY_SEEDS = (2014, 2015, 2016)


def split_gains(torch, h, lam: float, min_child_weight: float):
    """[n, F, B] gains of "go right if bin > b" from a [n, F, B, 2]
    histogram, by GBDT._find_splits' formula (no missing lane), in h's
    dtype."""
    gl, hl = torch.cumsum(h[..., 0], 2), torch.cumsum(h[..., 1], 2)
    gt, ht = gl[:, :, -1:], hl[:, :, -1:]
    gr, hr = gt - gl, ht - hl
    g = gl ** 2 / (hl + lam) + gr ** 2 / (hr + lam) - gt ** 2 / (ht + lam)
    return torch.where((hl >= min_child_weight) & (hr >= min_child_weight),
                       g, -torch.inf)


def split_audit(torch, hg, model, forest, bins, label, hist_force,
                inputs=None) -> dict:
    """Every level of every tree of a fit against float64, on the fit's
    own inputs (``inputs``: ``tree_inputs``' tuples, tree by tree; by
    default a logistic fit's, else ``objective_tree_inputs``'): the route's f32 histogram against a float64 one
    (``hist_err``, relative to the level's largest bin); each node's split
    against the float64 best split.  A node's rounding noise is the largest
    |f32 gain - float64 gain| over its candidates; a split is within
    rounding when its float64 regret (best gain minus the chosen one's) is
    at most twice that noise.  ``replay`` counts nodes where the recomputed
    f32 gains pick another split than the fit did (0 on a deterministic
    route); ``leaf_err`` is the largest |leaf - float64 leaf|, and
    ``leaf_scale`` the mean of leaf / float64 leaf, less 1, over leaves
    past 1e-3 (above 0: the fit's steps are longer than exact sums give).
    A sampling model's candidates are each level's sampled features, and
    its (grad, hess) carry the tree's row mask."""
    B, F = model.num_bins, bins.shape[1]
    lam, mcw, lr = model.lambda_, model.min_child_weight, model.learning_rate
    dev = bins.device
    fidx = torch.arange(F, device=dev)
    out = dict(hist_err=0.0, leaf_err=0.0, leaf_max=0.0, nodes=0,
               off_best=0, beyond=0, worst=0.0, replay=0)
    scale = []
    if inputs is None:
        inputs = tree_inputs(torch, model, forest, bins, label)
    for t, (gh, levels, leaf_rel, masks) in enumerate(inputs):
        gh64 = gh.double()
        for (rel, n), mask in zip(levels, masks):
            h32 = hg.histogram_gh(bins, rel, gh, n, B, force=hist_force)
            keys = ((rel.long()[:, None] * F + fidx) * B
                    + bins.long()).reshape(-1)
            h64 = torch.zeros(n * F * B, 2, dtype=torch.float64, device=dev)
            h64.index_add_(0, keys, gh64[:, None, :].expand(-1, F, 2)
                           .reshape(-1, 2))
            del keys
            h64 = h64.reshape(n, F, B, 2)
            out["hist_err"] = max(out["hist_err"], float(
                (h32.double() - h64).abs().max()
                / max(1.0, float(h64.abs().max()))))
            g32 = split_gains(torch, h32, lam, mcw)
            g64 = split_gains(torch, h64, lam, mcw)
            if mask is not None:  # a level's candidates: its features
                g32 = torch.where(mask[None, :, None], g32, -torch.inf)
                g64 = torch.where(mask[None, :, None], g64, -torch.inf)
            g32, g64 = g32.reshape(n, -1), g64.reshape(n, -1)
            both = torch.isfinite(g32) & torch.isfinite(g64)
            noise = torch.where(both, (g32.double() - g64).abs(),
                                0.0).amax(1)
            first = n - 1
            f = forest["feature"][t, first:first + n].long()
            b = forest["threshold"][t, first:first + n].long()
            null = b >= B
            pick = (f * B + b.clamp(max=B - 1))[:, None]
            chosen = torch.where(null, 0.0, g64.gather(1, pick)[:, 0])
            best = g64.amax(1).clamp(min=0.0)
            regret = best - chosen
            b32 = torch.argmax(g32, 1)
            null32 = g32.gather(1, b32[:, None])[:, 0] <= 2.0 * model.gamma
            out["replay"] += int(((null32 != null) | (~null & (
                b32 != pick[:, 0]))).sum())
            out["nodes"] += n
            out["off_best"] += int((regret > 0).sum())
            out["beyond"] += int((regret > 2.0 * noise).sum())
            out["worst"] = max(out["worst"], float(
                (regret / noise.clamp(min=1e-30)).max()))
        s = torch.zeros(2 ** model.max_depth, 2, dtype=torch.float64,
                        device=dev).index_add_(0, leaf_rel.long(), gh64)
        leaf64 = -lr * s[:, 0] / (s[:, 1] + lam)
        leaf = forest["leaf"][t].double()
        out["leaf_err"] = max(out["leaf_err"],
                              float((leaf - leaf64).abs().max()))
        out["leaf_max"] = max(out["leaf_max"], float(leaf64.abs().max()))
        big = leaf64.abs() > 1e-3
        scale.append((leaf[big] / leaf64[big]).cpu())
    out["leaf_scale"] = float(torch.cat(scale).mean()) - 1.0
    return out


def label_study(torch, dev) -> None:
    """Four fits per data set, the histogram and the leaf sums each on the
    kernel or on ``index_add``, for bench.py's XOR label and chip_smoke's
    threshold label over STUDY_SEEDS: train logloss, how far each differs
    from the all-kernel fit, and its split audit against float64."""
    from dmlc_core_tpu_torch.models import GBDT, QuantileBinner
    from dmlc_core_tpu_torch.ops import histogram as hg

    class IndexAddLeaves(GBDT):
        @staticmethod
        def _leaf_impl(grad):
            return None

    routes = {"hist kernel, leaves kernel": (GBDT, "pallas"),
              "hist index_add, leaves kernel": (GBDT, "xla"),
              "hist kernel, leaves index_add": (IndexAddLeaves, "pallas"),
              "hist index_add, leaves index_add": (IndexAddLeaves, "xla")}
    F, B = HIGGS_FEATURES, GBDT_KW["num_bins"]
    for name in ("xor", "steps"):
        for seed in STUDY_SEEDS:
            x, y = higgs_like(HIGGS_ROWS, seed, name)
            binner = QuantileBinner(num_bins=B, device=dev).fit(
                x[:BINNER_SAMPLE])
            bins = binner.transform(torch.from_numpy(x).to(dev))
            label = torch.from_numpy(y).to(dev)
            del x
            print(f"study [{name}, seed {seed}]: {y.mean():.4f} positive")
            ref = None
            for route, (cls, hist) in routes.items():
                model = cls(num_features=F, device=dev, histogram=hist,
                            **GBDT_KW)
                forest = model.fit(bins, label)
                loss = float(model.loss(forest, bins, label))
                a = split_audit(torch, hg, model, forest, bins, label, hist)
                if ref is None:
                    ref = (forest, loss)
                differs = ((forest["feature"] != ref[0]["feature"])
                           | (forest["threshold"] != ref[0]["threshold"]))
                trees = differs.any(dim=1).nonzero()
                first = int(trees[0]) if trees.numel() else None
                print(f"  {route}: train logloss {loss:.7f} "
                      f"({loss - ref[1]:+.3e} vs the first route; "
                      f"{int(differs.sum())} split nodes differ, first in "
                      f"tree {first}); audit: hist err {a['hist_err']:.2e}, "
                      f"leaf err {a['leaf_err']:.2e} (leaf/float64 leaf - 1:"
                      f" {a['leaf_scale']:+.2e}), {a['off_best']} of "
                      f"{a['nodes']} splits off the float64 best, "
                      f"{a['beyond']} beyond rounding (worst regret/noise "
                      f"{a['worst']:.2f}), replay mismatches {a['replay']}")
            del bins, label


def main(argv) -> int:
    import torch
    if argv[:1] == ["--mesh-rank"]:
        return mesh_worker(argv[1:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from dmlc_core_tpu_torch import _native
    from dmlc_core_tpu_torch.ops import _build
    from dmlc_core_tpu_torch.ops import segment_sum as ss_mod

    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    nvcc = run_text([_build.nvcc_path(), "--version"]).splitlines()[-1]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; nvcc: {nvcc}")
    phase_builds(_native, _build)
    if "--label-study" in argv:
        label_study(torch, torch.device("cuda"))
        return 0
    if "--segment-sweep" in argv:
        segment_sweep(torch, torch.device("cuda"))
        return 0
    if "--route" in argv:
        phase_route(torch, torch.device("cuda"))
        return 0
    if "--service-sweep" in argv:
        service_sweep(torch, torch.device("cuda"))
        return 0
    if "--ab" in argv or "--geometry-sweep" in argv:
        if "--ab" in argv:
            ab_parent(torch, torch.device("cuda"),
                      Path(argv[argv.index("--ab") + 1]).resolve())
        if "--geometry-sweep" in argv:
            geometry_sweep(torch, torch.device("cuda"))
        return 0

    dev = torch.device("cuda")
    build_dir = REPO / "build" / "chip_smoke"
    params_a, params_b = fm_params(1), fm_params(2)
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.monotonic()
        result = fn(*args)
        seconds[name] = time.monotonic() - t0
        return result

    kern = timed("kernel", phase_kernel, torch, ss_mod, params_a, dev)
    served = timed("serving", phase_serving, torch, ss_mod, params_a,
                   params_b, "cuda")
    timed("profile", phase_profile, torch, params_a)
    train = timed("training", phase_training, torch, ss_mod, dev, build_dir)
    ffm = timed("ffm", phase_ffm, torch, ss_mod, dev, build_dir)
    ffm_served = timed("ffm serving", phase_ffm_serving, torch, ss_mod,
                       ffm["model"], dev)
    gbdt = timed("gbdt", phase_gbdt, torch, ss_mod, dev)
    route = timed("route", phase_route, torch, dev)
    sparse = timed("gbdt sparse", phase_gbdt_sparse, torch, ss_mod, dev,
                   build_dir)
    sparse_data = sparse.pop("data")
    streamed = timed("streamed", phase_streamed, torch, ss_mod, dev,
                     build_dir, sparse_data, sparse["binner"])
    # the planted rule's sign on the streamed rows: the labels the gbdt
    # example learns (the Bernoulli labels sit under its 0.8 accuracy gate)
    bosch_rule = sparse_data["rule"][:STREAM_ROWS].cpu().numpy()
    served_fit = timed("dataservice", phase_dataservice, torch, ss_mod, dev,
                       build_dir, streamed)
    for k in ("ent", "layout", "label"):
        streamed.pop(k)
    timed("records", phase_records, torch, dev, build_dir)
    timed("checkpoints", phase_checkpoints, torch, dev, build_dir,
          train["model"], ffm["model"], sparse["forest"])
    obs = timed("observability", phase_observability, torch, ss_mod, dev,
                build_dir, train["uri"], train.pop("want"), params_a)
    job = timed("job", phase_job, torch, dev, build_dir, train["uri"])
    mesh = timed("mesh", phase_mesh, torch, ss_mod, dev, build_dir, gbdt,
                 sparse, sparse_data, streamed, train, served_fit)
    del sparse_data, gbdt["bins"], gbdt["label"]
    obj = timed("objectives", phase_objectives, torch, ss_mod, dev)
    ffm_uri = ffm_file_uri(build_dir)
    ex = timed("examples", phase_examples, torch, ss_mod, dev, build_dir,
               train["uri"], ffm_uri, streamed["uri"], bosch_rule)
    print("phases, seconds: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in seconds.items()))

    t, leaf = kern["timings"][NUM_FACTORS], gbdt["leaf"]
    node, root = sparse["node_totals"], sparse["root_totals"]
    segment_sum = {
        "name": "segment_sum",
        "route": "cuda",
        "source": "dmlc_core_tpu_torch/ops/csrc/segment_sum.cu",
        "replaces": "dmlc_core_tpu/ops/pallas_segment.py:67",
    }
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{
        **segment_sum,
        "shape": "served FM micro-batch, L=16",
        "launches": served["launches"],
        "max_abs_err": kern["max_abs_err"],
        **{k: t[k] for k in keys},
    }, {
        **segment_sum,
        "shape": "GBDT leaf sums, 11M rows x L=2 into 64 leaves",
        "launches": leaf["launches"],
        "max_abs_err": leaf["max_abs_err"],
        **{k: leaf[k] for k in keys},
    }, {
        **segment_sum,
        "shape": "sparse GBDT node totals, 1.18M rows x L=2 into 32 nodes;"
                 " launches: a fit_batch's node totals (6 a tree) and leaf "
                 "sums (1 a tree)",
        "launches": node["launches"],
        "max_abs_err": node["max_abs_err"],
        **{k: node[k] for k in keys},
    }, {
        **segment_sum,
        "shape": "sparse GBDT node totals at depth 0, 1.18M rows x L=2 into "
                 "one segment; launches: as the 32-node entry",
        "launches": root["launches"],
        "max_abs_err": root["max_abs_err"],
        **{k: root[k] for k in keys},
    }] + [{
        **segment_sum,
        "shape": f"FM training step, {TRAIN_BATCH} rows x {NNZ_PER_ROW} "
                 f"nonzeros ({train['timings'][lanes]['nnz']} entries with "
                 f"the padding lanes), L={lanes}; launches: the training "
                 f"run's ({train['steps']} steps), the autotuned epoch's "
                 f"({obs['steps']} steps), the 2-rank job's "
                 f"({job['steps']} steps) and the mesh phase's "
                 f"data-parallel epoch ({mesh['fm_steps']} steps over 2 "
                 f"ranks), one L=1 and two L={NUM_FACTORS} a step",
        "launches": (train["launches"] + obs["launches"] + job["launches"]
                     + mesh["fm_launches"]),
        "max_abs_err": train["timings"][lanes]["max_abs_err"],
        **{k: train["timings"][lanes][k] for k in keys},
    } for lanes in (1, NUM_FACTORS)] + [{
        **segment_sum,
        "shape": f"FFM training step, linear term, {TRAIN_BATCH} rows x "
                 f"{NNZ_PER_ROW} nonzeros ({ffm['timings'][1]['nnz']} "
                 f"entries with the padding lanes), L=1; launches: the FFM "
                 f"run's ({ffm['steps']} steps, one a step)",
        "launches": ffm["launches"],
        "max_abs_err": ffm["timings"][1]["max_abs_err"],
        **{k: ffm["timings"][1][k] for k in keys},
    }, {
        **segment_sum,
        "shape": f"served FFM micro-batch, 256 rows, L=1 "
                 f"({ffm_served['timing']['nnz']} entries); launches: the "
                 f"FFM serving run's ({ffm_served['batches']} micro-batches,"
                 f" one each)",
        "launches": ffm_served["launches"],
        "max_abs_err": ffm_served["timing"]["max_abs_err"],
        **{k: ffm_served["timing"][k] for k in keys},
    }, {
        **segment_sum,
        "shape": f"fit_streamed node totals, {STREAM_ROWS} rows x L=2 into "
                 "32 nodes; launches: a fit_streamed's node totals (6 a "
                 "tree) and leaf sums (1 a tree)",
        "launches": streamed["seg_launches"],
        "max_abs_err": streamed["node_totals"]["max_abs_err"],
        **{k: streamed["node_totals"][k] for k in keys},
    }, {
        **segment_sum,
        "shape": f"fit_streamed over the data service, node totals, "
                 f"{STREAM_ROWS} rows x L=2 into 32 nodes; launches: its "
                 "node totals (6 a tree) and leaf sums (1 a tree)",
        "launches": served_fit["seg_launches"],
        "max_abs_err": served_fit["node_totals"]["max_abs_err"],
        **{k: served_fit["node_totals"][k] for k in keys},
    }] + [{
        "name": "histogram_gh",
        "route": "cuda",
        "source": "dmlc_core_tpu_torch/ops/csrc/histogram_gh.cu",
        "replaces": "dmlc_core_tpu/ops/pallas_segment.py:168",
        "launches": gbdt["launches"],
        "max_abs_err": gbdt["max_abs_err"],
        "ms": gbdt["ms"],
        "plain_ms": gbdt["plain_ms"],
        "bound_ms": gbdt["bound_ms"],
        "bound_by": gbdt["bound_by"],
        "library_ms": gbdt["library_ms"],
        "tree_ms": gbdt["tree_ms"],
        "tree_ms_subtracted": gbdt["tree_ms_subtracted"],
    }, {
        "name": "threefry",
        "route": "cuda",
        "source": "dmlc_core_tpu_torch/ops/csrc/threefry.cu",
        "replaces": None,
        "shape": f"a sampled tree's row draw, {HIGGS_ROWS} rows, subsample "
                 "0.8; launches: a sampled Higgs fit's (one a tree)",
        **{k: gbdt["draws"][k] for k in ("launches", "max_abs_err", *keys)},
    }, {
        "name": "route_dense",
        "route": "cuda",
        "source": "dmlc_core_tpu_torch/ops/csrc/route_dense.cu",
        "replaces": None,
        "shape": f"a Higgs training level at depth 5, {HIGGS_ROWS} rows x "
                 f"{HIGGS_FEATURES} uint8 codes; launches: a Higgs fit's "
                 "(one a level)",
        "launches": gbdt["route_launches"],
        **route,
    }, {
        "name": "histogram_gh_sparse",
        "route": "cuda",
        "source": "dmlc_core_tpu_torch/ops/csrc/histogram_gh_sparse.cu",
        "replaces": "dmlc_core_tpu/ops/pallas_segment.py:466",
        "shape": f"Bosch width, {sparse['nnz']} entries x 256 bins, mean "
                 "of depths 0-5",
        "launches": sparse["launches"],
        **{k: sparse[k] for k in ("max_abs_err", *keys)},
    }, {
        "name": "histogram_gh_sparse",
        "route": "cuda",
        "source": "dmlc_core_tpu_torch/ops/csrc/histogram_gh_sparse.cu",
        "replaces": "dmlc_core_tpu/ops/pallas_segment.py:466",
        "shape": f"Bosch width out of core, {STREAM_ROWS} rows, "
                 f"{streamed['hist']['nnz']} entries x 256 bins, mean of "
                 "depths 0-5; launches: a fit_streamed over the binned "
                 "epoch cache",
        "launches": streamed["launches"],
        **{k: streamed["hist"][k] for k in ("max_abs_err", *keys)},
    }, {
        "name": "histogram_gh_sparse",
        "route": "cuda",
        "source": "dmlc_core_tpu_torch/ops/csrc/histogram_gh_sparse.cu",
        "replaces": "dmlc_core_tpu/ops/pallas_segment.py:466",
        "shape": f"fit_streamed over the data service, {STREAM_ROWS} rows, "
                 f"{served_fit['hist']['nnz']} entries x 256 bins, mean of "
                 "depths 0-5",
        "launches": served_fit["launches"],
        **{k: served_fit["hist"][k] for k in ("max_abs_err", *keys)},
    }] + [{
        "name": k["name"],
        "route": "cuda",
        "source": f"dmlc_core_tpu_torch/ops/csrc/{k['name']}.cu",
        "replaces": "dmlc_core_tpu/ops/pallas_segment.py:"
                    f"{MESH_REPLACES[k['name']]}",
        "shape": f"mesh phase: the accumulate half at {k['share']}; "
                 f"launches: {k['of']}",
        "launches": k["launches"],
        **{key: k[key] for key in ("max_abs_err", *keys)},
    } for k in mesh["kern"]] + [{
        **segment_sum,
        "shape": f"{what} GBDT leaf sums, {rows} rows x L=2 into 64 leaves; "
                 f"launches: a fit's (one a tree, {trees} trees)",
        "launches": o["seg"],
        **{k: o["leaf"][k] for k in ("max_abs_err", *keys)},
    } for what, rows, trees, o in (
        ("Covertype softmax", COVER_ROWS, 140, obj["cover"]),
        ("MSLR-WEB10K rank:pairwise", MSLR_ROWS, 20, obj["mslr"]))] + [{
        "name": "histogram_gh",
        "route": "cuda",
        "source": "dmlc_core_tpu_torch/ops/csrc/histogram_gh.cu",
        "replaces": "dmlc_core_tpu/ops/pallas_segment.py:168",
        "shape": f"{what}, {rows} rows x {F} features x 256 bins, mean of "
                 f"depths 0-5 of the first tree (tree_ms: their sum, "
                 f"tree_ms_subtracted: with depths 1-5 subtracted); "
                 f"launches: a fit's",
        "launches": o["launches"],
        **{k: o[k] for k in ("max_abs_err", *keys, "tree_ms",
                             "tree_ms_subtracted")},
    } for what, rows, F, o in (
        ("Covertype softmax", COVER_ROWS, 54, obj["cover"]),
        ("MSLR-WEB10K rank:pairwise", MSLR_ROWS, MSLR_FEATURES,
         obj["mslr"]))] + [{
        **segment_sum,
        "shape": f"{what}; launches: {of}",
        "launches": launches,
        **{k: ex[key][k] for k in ("max_abs_err", *keys)},
    } for key, what, of, launches in (
        ("linear", f"train_linear example step, {TRAIN_BATCH} rows, L=1",
         "its two epochs and evaluation pass",
         ex["runs"]["train_linear"]["launches"][0]),
        ("ffm", "train_ffm example step, 4096 rows, linear term, L=1",
         "its two epochs and accuracy pass",
         ex["runs"]["train_ffm"]["launches"][0]),
        ("dist", f"distributed_train rank step, {EX_DIST_BATCH} rows in "
                 f"{EX_DIST_NNZ_MAX} lanes, L=1",
         "both ranks of the 2-rank job",
         ex["runs"]["distributed_train"]["launches"][0]),
        ("gbdt_seg", "gbdt_train --native-sparse example node totals, "
                     "the first launch's rows x L=2",
         "the --native-sparse, --rank and --missing runs' node totals and "
         "leaf sums", ex["gbdt_seg"]["launches"]))] + [{
        "name": "histogram_gh" if "missing" in name else "histogram_gh_sparse",
        "route": "cuda",
        "source": "dmlc_core_tpu_torch/ops/csrc/" + (
            "histogram_gh.cu" if "missing" in name
            else "histogram_gh_sparse.cu"),
        "replaces": "dmlc_core_tpu/ops/pallas_segment.py:"
                    + ("168" if "missing" in name else "466"),
        "shape": f"{name} example, {ex[name]['shape']}, mean of depths 0-4 "
                 "of the first tree; launches: its fit's",
        "launches": ex[name]["launches"],
        **{k: ex[name][k] for k in ("max_abs_err", *keys)},
    } for name in ("gbdt_train --native-sparse", "gbdt_train --rank",
                   "gbdt_train --missing")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
