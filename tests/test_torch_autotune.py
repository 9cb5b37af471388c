"""The port's autotuner against the JAX package's, and tuned CPU epochs
against untuned ones.

* The same scripted sequence of windows, fed to both tuners over a stub
  target, gives equal decision logs and equal knob paths.
* ``autotune=True`` with a window of 2 batches moves knobs in the middle of
  epochs of ``DeviceStagingIter`` (its native pool, live),
  ``RecordStagingIter`` and ``BinnedStagingIter`` (next epoch), and every
  batch stays bit for bit an untuned epoch's.
* The ``DMLCTPU_AUTOTUNE*`` environment arms and bounds the tuner as it
  does the JAX package's.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

from dmlc_core_tpu import autotune as jautotune
from dmlc_core_tpu import telemetry as jtel
from dmlc_core_tpu_torch import autotune, telemetry, telemetry_http
from dmlc_core_tpu_torch.data import (BinnedStagingIter, DeviceStagingIter,
                                      RecordStagingIter)
from dmlc_core_tpu_torch.io import RecordIOWriter
from dmlc_core_tpu_torch.models import QuantileBinner

STAGES = ("shard", "parse", "io", "pack", "h2d", None)


class StubTarget:
    """The knob surface the staging iterators expose."""

    def __init__(self, **knobs):
        self.knobs = dict({"num_workers": 1, "buffer_mb": 4,
                           "prefetch_depth": 1, "chunk_bytes": 0}, **knobs)
        self.path = []

    def set_knobs(self, **kw):
        self.path.append(dict(kw))
        self.knobs.update(kw)
        return dict(self.knobs, pool_live=True)


def _window(mod, mb, wall, stage, restarted):
    w = mod.Window()
    w.before = {"counters": {}}
    w.after = {"counters": {}}
    w.wall_s = wall
    w.delta = {"shard.bytes": int(mb * (1 << 20) * wall)}
    w.attribution = {
        "stages": {}, "bound": {stage: 100.0} if stage else {},
        "bound_stage": stage, "table": f"{stage}-bound 100%" if stage else "",
        "wall_s": wall, "restarted": restarted, "io": {}}
    w.restarted = restarted
    return w


def _script(seed, n=40):
    """Windows of a random walk in throughput, with bottleneck moves,
    restarts and a few windows too short to count."""
    rng = np.random.default_rng(seed)
    mb, out = 100.0, []
    stage = STAGES[int(rng.integers(len(STAGES)))]
    for _ in range(n):
        mb = max(mb * float(rng.uniform(0.85, 1.2)), 1.0)
        if rng.random() < 0.2:
            stage = STAGES[int(rng.integers(len(STAGES)))]
        wall = 0.005 if rng.random() < 0.05 else float(rng.uniform(0.05, 2))
        out.append((mb, wall, stage, bool(rng.random() < 0.05)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_scripted_windows_give_the_jax_decisions(seed):
    kw = dict(window_batches=0, max_workers=8, max_buffer_mb=64,
              max_prefetch=5, max_chunk_mb=4, margin=0.05)
    logs, paths, knobs = [], [], []
    for mod, tel in ((autotune, telemetry), (jautotune, jtel)):
        target = StubTarget()
        tuner = mod.AutoTuner(target, **kw)
        log = []
        for mb, wall, stage, restarted in _script(seed):
            rec = tuner.decide(_window(tel, mb, wall, stage, restarted))
            rec.pop("t")
            log.append(rec)
        logs.append(log)
        paths.append(target.path)
        knobs.append((target.knobs, tuner.summary()))
    assert logs[0] == logs[1]
    assert paths[0] == paths[1] and paths[0]
    assert knobs[0] == knobs[1]
    actions = {r["action"] for r in logs[0]}
    assert "step" in actions


def _libsvm(tmp_path, rows=4000, seed=3):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        idx = np.sort(rng.choice(64, size=1 + i % 9, replace=False))
        lines.append(f"{i % 2} " + " ".join(
            f"{j}:{v:.4f}" for j, v in zip(idx, rng.normal(size=idx.size))))
    p = tmp_path / "tune.libsvm"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _records(tmp_path, n=600, seed=4):
    rng = np.random.default_rng(seed)
    p = tmp_path / "tune.rec"
    with RecordIOWriter(str(p)) as w:
        for _ in range(n):
            w.write(rng.integers(0, 256, int(rng.integers(16, 400)),
                                 dtype=np.uint8).tobytes())
    return str(p)


def _bits(batch):
    """Every field of a batch, tensors as bytes (the lineage id is
    provenance, not data: a one-worker pool mints it, a single reader does
    not)."""
    return tuple(v.numpy().tobytes() if isinstance(v, torch.Tensor) else v
                 for k, v in vars(batch).items() if not k.startswith("_"))


def _make(kind, tmp_path, **kw):
    if kind.startswith("device"):
        return DeviceStagingIter(
            _libsvm(tmp_path), batch_size=128, nnz_bucket=1024,
            num_workers=int(kind[-1]), buffer_mb=1, device="cpu", **kw)
    if kind == "record":
        return RecordStagingIter(_records(tmp_path), records_cap=16,
                                 bytes_cap=8192, device="cpu", **kw)
    binner = QuantileBinner(num_bins=16, missing_aware=True, sketch_size=64,
                            sketch_seed=3, device="cpu")
    return BinnedStagingIter(_libsvm(tmp_path), binner, batch_size=128,
                             nnz_bucket=1024, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["device1", "device2", "record", "binned"])
def test_tuned_epochs_equal_an_untuned_epoch(kind, tmp_path, monkeypatch):
    # every 2-batch window decides (the CPU windows are shorter than the
    # tuner's noise floors), so the knobs move in the middle of epochs
    monkeypatch.setattr(autotune, "_MIN_WINDOW_BYTES", 0)
    monkeypatch.setattr(autotune, "_MIN_WINDOW_WALL_S", 0.0)
    monkeypatch.setenv("DMLCTPU_AUTOTUNE_WINDOW", "2")
    monkeypatch.setenv("DMLCTPU_AUTOTUNE_MAX_WORKERS", "4")
    want = [_bits(b) for b in _make(kind, tmp_path, autotune=False)]
    assert len(want) > 8
    it = _make(kind, tmp_path, autotune=True)
    start = dict(it.knobs)
    for _ in range(3):
        assert [_bits(b) for b in it] == want
    tuner = it._tuner
    assert tuner.epochs == 3 and tuner.windows >= 3 * (len(want) // 2)
    if kind.startswith("device"):
        assert tuner.steps > 0 and it.knobs != start


def test_env_arms_and_bounds_the_tuner(tmp_path, monkeypatch):
    env = {"DMLCTPU_AUTOTUNE": "1", "DMLCTPU_AUTOTUNE_WINDOW": "3",
           "DMLCTPU_AUTOTUNE_MAX_WORKERS": "6",
           "DMLCTPU_AUTOTUNE_MAX_BUFFER_MB": "32",
           "DMLCTPU_AUTOTUNE_MAX_PREFETCH": "5",
           "DMLCTPU_AUTOTUNE_MAX_CHUNK_MB": "2",
           "DMLCTPU_AUTOTUNE_MARGIN": "0.1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert autotune.armed() and jautotune.armed()
    attrs = ("window_batches", "max_workers", "max_buffer_mb",
             "max_prefetch", "max_chunk_bytes", "margin")
    want = [getattr(jautotune.AutoTuner(StubTarget()), a) for a in attrs]
    assert want == [3, 6, 32, 5, 2 << 20, 0.1]
    for kind in ("device1", "record", "binned"):
        it = _make(kind, tmp_path)  # autotune=None: the env arms it
        assert it._autotune
        n = sum(1 for _ in it)
        tuner = it._tuner
        assert tuner is not None and tuner.epochs == 1 and n > 0
        assert [getattr(tuner, a) for a in attrs] == want
    state = autotune.state()
    assert state["armed"] and state["window_batches_env"] == 3
    with telemetry_http.serve() as srv:
        served = json.loads(urllib.request.urlopen(
            srv.url + "/autotune").read())
    assert served["armed"] and served["decisions"]
    monkeypatch.setenv("DMLCTPU_AUTOTUNE", "0")
    assert not autotune.armed()
    assert _make("device1", tmp_path)._autotune is False
