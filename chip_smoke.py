#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``dmlc_core_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the native runtime and every CUDA kernel from the checkout (side
by side) and prints each kernel's atomic instructions from the SASS, holds
each kernel against its plain PyTorch version on the card,
serves a Criteo-width factorization machine (2^20 hashed features, 16
factors, 39 nonzeros a row) over HTTP through the port's ``ScoringServer``
and checks every score against a float64 numpy oracle, then trains a
Higgs-width histogram GBDT (11M rows x 28 features, 256 bins, 20 trees of
depth 6) through ``GBDT.fit`` and checks its histograms (every level of
the first tree timed beside the previous kernel, ``index_add`` and the
bound),
forests and predictions against float64 oracles, then trains a Bosch-width
sparse GBDT
(1,183,747 rows x 968 features, ~19% present) on a CSR batch through
``GBDT.fit_batch``, audits it against float64, cross-checks it against a
dense fit of the densified data, and serves it from a snapshot through
``ScoringServer``.  Any failed check raises and the script exits non-zero.
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

    python3 chip_smoke.py --geometry-sweep

builds the kernels, then times the dense histogram kernel at every level
of a Higgs-width first tree under every launch geometry that fits (see
``geometry_sweep``), beside the one ``launch_geometry`` picks.  It prints
its readings and no result line.
"""
from __future__ import annotations

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
    body = json.dumps({"rows": [{"index": i, "value": v}
                                for i, v in rows]}).encode()
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
    tree builder: (grad, hess) [rows, 2], each row's node at every depth as
    (rel, n_nodes), and each row's leaf, routed through the fitted forest.
    Margins add up tree by tree as the fit adds them, so the inputs are
    the fit's own, bit for bit."""
    margin = forest["base"].expand(label.shape[0]).clone()
    for t in range(model.num_trees):
        g, h = model._grad_hess(margin, label)
        gh = torch.stack([g, h], dim=-1).contiguous()
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
        yield gh, levels, leaf_rel.to(torch.int32).contiguous()
        margin = margin + forest["leaf"][t][leaf_rel]


def check_hist(torch, hg, name, bins, rel, gh, n, B) -> float:
    """Kernel vs plain vs the float64 oracle, and two launches bitwise
    equal.  Returns max |kernel - plain|."""
    a = hg.histogram_gh_kernel(bins, rel, gh, n, B)
    b = hg.histogram_gh_kernel(bins, rel, gh, n, B)
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


def level_error(h32, h64) -> float:
    """max |f32 histogram - float64 sums| relative to max(1, the largest
    float64 bin)."""
    h64 = h64.reshape(h32.shape)
    return float((h32.double() - h64).abs().max()) / max(
        1.0, float(h64.abs().max()))


def print_level(what, d, n, lv, before_ms, err, nbytes, cov) -> None:
    print(f"time [{what}, depth {d}, n={n}]: kernel {lv['ms']:.3f} ms "
          f"(per-warp f64 kernel: {before_ms:.3f}), plain "
          f"{lv['plain_ms']:.1f} ms, index_add {lv['library_ms']:.3f} ms, bound {lv['bound_ms']:.4f} ms "
          f"({nbytes} bytes, {lv['bound_by']}); |kernel - float64| "
          f"{err:.3e} of the largest bin; queue covered: {cov}")


def level_summary(what, per_level, before_ms) -> None:
    ms = [lv["ms"] for lv in per_level]
    lib = [lv["library_ms"] for lv in per_level]
    print(f"{what} per level: mean {np.mean(ms):.3f} ms (per-warp f64 "
          f"kernel: {np.mean(before_ms):.3f}, index_add {np.mean(lib):.3f}); "
          f"faster than the per-warp f64 kernel at depths "
          f"{[d for d, (a, b) in enumerate(zip(ms, before_ms)) if a < b]}, "
          f"than index_add at depths "
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
    bytes)."""
    hg.histogram_gh_kernel.launches = 0
    ss_mod.segment_sum_kernel.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    forest = model.fit(bins, label)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    return (forest, secs, hg.histogram_gh_kernel.launches,
            ss_mod.segment_sum_kernel.launches,
            torch.cuda.max_memory_allocated())


def phase_gbdt(torch, ss_mod, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile

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
    gh, levels, leaf_rel = next(tree_inputs(torch, model, warm, bins, label))
    leaf = check_leaf_sums(torch, ss_mod, gh, leaf_rel, 2 ** depth)
    max_err = 0.0
    for d in CHECK_DEPTHS:
        rel, n = levels[d]
        max_err = max(max_err, check_hist(torch, hg, f"Higgs depth {d}",
                                          bins, rel, gh, n, B))
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
    for d, (rel, n) in enumerate(levels):
        ms, cov = device_ms(
            torch, lambda: hg.histogram_gh_kernel(bins, rel, gh, n, B), 20)
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
        err = level_error(hg.histogram_gh_kernel(bins, rel, gh, n, B), h64)
        del keys, src, h64
        nbytes = rows * F + 4 * rows + 8 * rows + 8 * n * F * B
        byte_s, op_s = nbytes / HBM_BYTES_PER_S, 2 * rows * F / F32_OPS_PER_S
        per_level.append(dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=max(byte_s, op_s) * 1e3,
                              bound_by="bytes" if byte_s >= op_s
                              else "operations"))
        print_level("histogram", d, n, per_level[-1], F64_WARP_DENSE_MS[d], err,
                    nbytes, cov)
        check(err <= HIST_TOL, f"histogram depth {d}: {err} of the largest "
              "bin from float64")
    level_summary("histogram", per_level, F64_WARP_DENSE_MS)
    del gh, levels, leaf_rel

    # the main path: two timed fits of the same forest
    fits = [fit_timed(torch, hg, ss_mod, model, bins, label)
            for _ in range(2)]
    forest = fits[0][0]
    for f_i, secs, h_l, s_l, peak in fits:
        print(f"gbdt fit: {secs:.3f} s wall, {rows * trees / secs:.0f} "
              f"row_trees_s; launches: histogram_gh {h_l}, segment_sum "
              f"{s_l}; peak device memory of the fit {peak / 2**30:.2f} GiB "
              f"(codes {bins.numel() / 2**30:.2f} GiB)")
        check(h_l == trees * depth, f"histogram_gh launched {h_l} times in "
              f"a fit (want {trees * depth})")
        check(s_l == trees, f"segment_sum launched {s_l} times in a fit "
              f"(want {trees}: one leaf sum a tree)")
        check(all(torch.equal(f_i[k], forest[k]) and
                  torch.equal(warm[k], forest[k]) for k in forest),
              "two fits gave different forests")
    print(f"gbdt: warm-up fit {t_warm:.3f} s; three fits bitwise identical")
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
            "leaf": {**leaf, "launches": fits[0][3]}}


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
                index=torch.cat(index), value=torch.cat(value))


def sparse_tree_inputs(torch, model, forest, ent, label):
    """Yield, tree by tree, what a logistic fit with unit weights gave its
    sparse tree builder: gh_row [rows, 2], (rel, n_nodes) at every depth
    and each row's leaf, routed by sparse routing through the fitted forest
    (the dense missing-aware route sends every row the same way), margins
    added tree by tree as the fit adds them."""
    rows = label.shape[0]
    rid, fi, ebin, emask = ent[:4]
    margin = forest["base"].expand(rows).clone()
    for t in range(model.num_trees):
        g, h = model._grad_hess(margin, label)
        gh = torch.stack([g, h], dim=-1).contiguous()
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
        yield gh, levels, leaf_rel.to(torch.int32).contiguous()
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
    """[n, F, B, 2] gains of ``GBDT._build_tree``'s missing-aware split
    finder from a dense histogram whose bin 0 holds the missing mass."""
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
    ``GBDT._level_splits_from_hist``), or the dense kernel's histogram of
    ``dense_bins`` (the ``fit`` route).  The float64 side is the same for
    both: present-entry sums and node totals by ``index_add``, missing mass
    as their difference.  A split is within rounding when its float64
    regret is at most twice the node's largest |f32 - float64| gain."""
    from dmlc_core_tpu_torch.ops import histogram as hg
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    from dmlc_core_tpu_torch.ops.fixed_point import lane_amax
    from dmlc_core_tpu_torch.ops.segment_sum import segment_sum
    B, F = model.num_bins, model.num_features
    lam, mcw, lr = model.lambda_, model.min_child_weight, model.learning_rate
    rid_l = layout.rid.long()
    out = dict(hist_err=0.0, leaf_err=0.0, nodes=0, off_best=0, beyond=0,
               worst=0.0, replay=0)
    scale = []
    for t, (gh, levels, leaf_rel) in enumerate(
            sparse_tree_inputs(torch, model, forest, ent, label)):
        gh_e = gh[rid_l].contiguous()
        gh64 = gh.double()
        for rel, n in levels:
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
                rf, rb, rd, *_ = model._level_splits_from_hist(
                    h32, node32, torch.full((1,), -torch.inf,
                                            device=gh.device),
                    torch.full((1,), torch.inf, device=gh.device), None)
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
                    model._collapse_dir_ties(g32), None)
                big = max(big, float(miss64.abs().max()))
            out["hist_err"] = max(out["hist_err"], float(err) / big)
            g64 = missing_aware_gains(torch, h64, node64, lam, mcw)
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


def phase_gbdt_sparse(torch, ss_mod, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from dmlc_core_tpu_torch.data.staging import PaddedBatch
    from dmlc_core_tpu_torch.models import GBDT, QuantileBinner, logistic_nll
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
    gh, levels, leaf_rel = next(sparse_tree_inputs(torch, model, warm, ent,
                                                   data["label"]))
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
                    F64_WARP_SPARSE_MS[d], err, nbytes, cov)
        check(err <= HIST_TOL, f"sparse histogram depth {d}: {err} of the "
              "largest bin from float64")
        if d in CHECK_DEPTHS:
            err, _ = check_sparse_hist(
                torch, hs, f"Bosch depth {d}", layout.gkey, rel_e, gh_e,
                layout.starts, n, F, B, oracle)
            max_err = max(max_err, err)
        del oracle
    level_summary("sparse histogram", per_level, F64_WARP_SPARSE_MS)
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
    model._build_tree_sparse(ent, g, h, layout=layout)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        model._build_tree_sparse(ent, g, h, layout=layout)
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
            "root_totals": {**root_tot, "launches": fits[0][3]}}


# ---- --geometry-sweep: the dense kernel's launch geometry -------------------

SWEEP_GROUPS = (1, 3, 7, 14, 28)        # features a block takes
SWEEP_BLOCKS = (264, 528, 1056, 2112)   # blocks a launch aims at
SWEEP_SHOW = 6


def geometry_sweep(torch, dev) -> None:
    """The dense kernel at each level of a Higgs-width first tree under
    every geometry that fits a block's shared memory: node tile (a power of
    two up to the level's nodes) x feature group (SWEEP_GROUPS) x block
    count (SWEEP_BLOCKS).  Each gives the histogram of the geometry
    ``launch_geometry`` picks, bit for bit; prints the picked geometry's
    device time, the SWEEP_SHOW fastest and the slowest."""
    from dmlc_core_tpu_torch.models import GBDT, QuantileBinner
    from dmlc_core_tpu_torch.ops import histogram as hg
    rows, F, B = HIGGS_ROWS, HIGGS_FEATURES, GBDT_KW["num_bins"]
    x, y = higgs_like(rows, seed=2014)
    binner = QuantileBinner(num_bins=B, device=dev).fit(x[:BINNER_SAMPLE])
    bins = binner.transform(torch.from_numpy(x).to(dev))
    label = torch.from_numpy(y).to(dev)
    del x
    model = GBDT(num_features=F, device=dev, **GBDT_KW)
    gh, levels, _ = next(tree_inputs(torch, model, model.fit(bins, label),
                                     bins, label))
    picked, most = hg.launch_geometry, hg._SMEM_MAX // (16 * B)

    def run(rel, n):
        return hg.histogram_gh_kernel(bins, rel, gh, n, B)

    def show(ms, g):
        return (f"{ms:.3f} ms: node_tile {g['node_tile']} x feat_group "
                f"{g['feat_group']}, {g['blocks']} blocks, "
                f"{g['smem'] // 1024} KB")

    try:
        for d, (rel, n) in enumerate(levels):
            want = run(rel, n)
            base = device_ms(torch, lambda: run(rel, n), 10)[0]
            timed = []
            for fg in SWEEP_GROUPS:
                groups = -(-F // fg)
                fg = -(-F // groups)
                t = 1
                while t <= n and t * fg <= most:
                    tiles = -(-n // t)
                    for target in SWEEP_BLOCKS:
                        chunk = -(-rows // max(1, -(-target
                                                    // (groups * tiles))))
                        g = dict(node_tile=t, feat_group=fg, chunk=chunk,
                                 blocks=-(-rows // chunk) * groups * tiles,
                                 smem=16 * B * t * fg)
                        hg.launch_geometry = lambda *_, g=g: g
                        check(torch.equal(run(rel, n), want),
                              f"geometry {g} changed the histogram")
                        timed.append((device_ms(torch, lambda: run(rel, n),
                                                10)[0], g))
                    t *= 2
                hg.launch_geometry = picked
            timed.sort(key=lambda r: r[0])
            print(f"geometry [Higgs depth {d}, n={n}]: picked "
                  f"{show(base, picked(rows, F, B, n))}; {len(timed)} "
                  "geometries, all bitwise equal")
            for ms, g in timed[:SWEEP_SHOW]:
                print(f"  {show(ms, g)}")
            print(f"  slowest {show(*timed[-1])}")
    finally:
        hg.launch_geometry = picked


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


# ---- --label-study: where a kernel fit and an index_add fit part ------------

STUDY_SEEDS = (2014, 2015, 2016)


def split_gains(torch, h, lam: float, min_child_weight: float):
    """[n, F, B] gains of "go right if bin > b" from a [n, F, B, 2]
    histogram, by GBDT._build_tree's formula (no missing lane), in h's
    dtype."""
    gl, hl = torch.cumsum(h[..., 0], 2), torch.cumsum(h[..., 1], 2)
    gt, ht = gl[:, :, -1:], hl[:, :, -1:]
    gr, hr = gt - gl, ht - hl
    g = gl ** 2 / (hl + lam) + gr ** 2 / (hr + lam) - gt ** 2 / (ht + lam)
    return torch.where((hl >= min_child_weight) & (hr >= min_child_weight),
                       g, -torch.inf)


def split_audit(torch, hg, model, forest, bins, label, hist_force) -> dict:
    """Every level of every tree of a logistic fit against float64, on the
    fit's own inputs: the route's f32 histogram against a float64 one
    (``hist_err``, relative to the level's largest bin); each node's split
    against the float64 best split.  A node's rounding noise is the largest
    |f32 gain - float64 gain| over its candidates; a split is within
    rounding when its float64 regret (best gain minus the chosen one's) is
    at most twice that noise.  ``replay`` counts nodes where the recomputed
    f32 gains pick another split than the fit did (0 on a deterministic
    route); ``leaf_err`` is the largest |leaf - float64 leaf|, and
    ``leaf_scale`` the mean of leaf / float64 leaf, less 1, over leaves
    past 1e-3 (above 0: the fit's steps are longer than exact sums give)."""
    B, F = model.num_bins, bins.shape[1]
    lam, mcw, lr = model.lambda_, model.min_child_weight, model.learning_rate
    dev = bins.device
    fidx = torch.arange(F, device=dev)
    out = dict(hist_err=0.0, leaf_err=0.0, nodes=0, off_best=0, beyond=0,
               worst=0.0, replay=0)
    scale = []
    for t, (gh, levels, leaf_rel) in enumerate(
            tree_inputs(torch, model, forest, bins, label)):
        gh64 = gh.double()
        for rel, n in levels:
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
            g32 = split_gains(torch, h32, lam, mcw).reshape(n, -1)
            g64 = split_gains(torch, h64, lam, mcw).reshape(n, -1)
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
    if "--geometry-sweep" in argv:
        geometry_sweep(torch, torch.device("cuda"))
        return 0

    params_a, params_b = fm_params(1), fm_params(2)
    kern = phase_kernel(torch, ss_mod, params_a, torch.device("cuda"))
    served = phase_serving(torch, ss_mod, params_a, params_b, "cuda")
    phase_profile(torch, params_a)
    gbdt = phase_gbdt(torch, ss_mod, torch.device("cuda"))
    sparse = phase_gbdt_sparse(torch, ss_mod, torch.device("cuda"))

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
    }, {
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
    }, {
        "name": "histogram_gh_sparse",
        "route": "cuda",
        "source": "dmlc_core_tpu_torch/ops/csrc/histogram_gh_sparse.cu",
        "replaces": "dmlc_core_tpu/ops/pallas_segment.py:466",
        "shape": f"Bosch width, {sparse['nnz']} entries x 256 bins, mean "
                 "of depths 0-5",
        "launches": sparse["launches"],
        **{k: sparse[k] for k in ("max_abs_err", *keys)},
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
