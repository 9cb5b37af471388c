#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``dmlc_core_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the native runtime and every CUDA kernel of the serving path
from the checkout, holds each kernel against its plain PyTorch version on
the card, then serves a Criteo-width factorization machine (2^20 hashed
features, 16 factors, 39 nonzeros a row) over HTTP through the port's
``ScoringServer`` and checks every score against a float64 numpy oracle.
Any failed check raises and the script exits non-zero.  The last two
lines of its output are the card's name and power limit, and one JSON
object with ``"ok": true``; the line before them is the per-kernel JSON
(times, bound, launches on the served path, error against the plain
version).  It imports nothing of JAX.
"""
from __future__ import annotations

import json
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

def phase_builds(native, build):
    """Build the native runtime (a thread) and the kernel (nvcc) at once."""
    times = {}
    errors = []

    def native_build():
        t0 = time.monotonic()
        try:
            native.build()
        except Exception as exc:  # re-raised on the main thread below
            errors.append(exc)
        times["native"] = time.monotonic() - t0

    th = threading.Thread(target=native_build)
    th.start()
    t0 = time.monotonic()
    build.build("segment_sum")
    times["segment_sum"] = time.monotonic() - t0
    th.join()
    if errors:
        raise errors[0]
    print(f"build: libdmlctpu.so {times['native']:.1f} s, "
          f"segment_sum.cu {times['segment_sum']:.1f} s")
    for line in build.build_log("segment_sum").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")


# ---- phase 2: the kernel against its plain version ----------------------------

def device_ms(torch, fn, iters: int) -> tuple:
    """Device time of one ``fn()`` in ms: ``iters`` calls queued behind a
    sleep kernel so they run back to back, between two CUDA events.
    Returns (ms, covered): covered is False when the host took longer to
    queue the calls than the sleep lasted (then host gaps may count)."""
    for _ in range(3):
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
    }
    max_err = 0.0
    for name, (rows, rid, c) in cases.items():
        a = kernel(c, rid, rows)
        b = kernel(c, rid, rows)
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"{name}: two launches differ")
        want = plain(c, rid, rows)
        err = float((a - want).abs().max()) if a.numel() else 0.0
        print(f"kernel vs plain [{name}] rows={rows} "
              f"contrib={tuple(c.shape)}: max abs err {err:.3e}")
        check(err <= TOL, f"{name}: max abs err {err} > {TOL}")
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


def main() -> int:
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

    params_a, params_b = fm_params(1), fm_params(2)
    kern = phase_kernel(torch, ss_mod, params_a, torch.device("cuda"))
    served = phase_serving(torch, ss_mod, params_a, params_b, "cuda")
    phase_profile(torch, params_a)

    t = kern["timings"][NUM_FACTORS]
    print(json.dumps({"kernels": [{
        "name": "segment_sum",
        "route": "cuda",
        "source": "dmlc_core_tpu_torch/ops/csrc/segment_sum.cu",
        "replaces": "dmlc_core_tpu/ops/pallas_segment.py:67",
        "launches": served["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
