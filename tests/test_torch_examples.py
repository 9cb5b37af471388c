"""The port's example programs (``dmlc_core_tpu_torch.examples``) and its
fs CLI (``python -m dmlc_core_tpu_torch.fs``) against the JAX package's
``examples/`` and ``bin/dmlctpu-fs``, on the CPU, at
tests/test_examples.py's sizes.

* Each ``synth_dataset`` writes the JAX example's bytes from the same seed.
* Each example runs in process (``main(argv)``, ``--device cpu``) beside
  the JAX example's ``main`` in process (patched ``sys.argv``, captured
  stdout) on the same file: the same sizing line, every printed epoch
  loss and the final linear and FFM losses within 1e-4, GBDT accuracy
  and pairwise accuracy within 0.005 (forests grown by two packages may
  part at exact gain ties), the same exit code.  The port's ``--shard``
  runs outside a job are 1-rank plans and give the unsharded numbers; as
  a 2-rank job, ``gbdt_train --shard --kernel-mesh`` prints the
  one-process final line on both ranks.
* ``distributed_train`` as a 2-rank ``dmlc_submit`` job on gloo: rank 0's
  epoch losses within 1e-5 of a one-process port run over the same global
  batches (each rank's part, padded to ``nnz_max``, side by side), and
  every rank's step count.
* The fs CLI prints what ``bin/dmlctpu-fs`` prints, with its exit codes.
"""
import ast
import contextlib
import functools
import hashlib
import importlib.util
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.examples import gbdt_train, train_ffm, train_linear

REPO = Path(__file__).resolve().parent.parent
LOSS_TOL = 1e-4   # linear and FFM losses, port vs JAX
ACC_TOL = 0.005   # GBDT accuracies, port vs JAX (forests may part at ties)


@functools.lru_cache(maxsize=None)
def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(name: str, argv: list) -> tuple:
    """The JAX example's ``main`` in process: (exit code, stdout)."""
    mod = _jax_example(name)
    out = io.StringIO()
    old = sys.argv
    sys.argv = [f"{name}.py"] + argv
    try:
        with contextlib.redirect_stdout(out):
            rc = mod.main()
    finally:
        sys.argv = old
    return rc or 0, out.getvalue()


def _run_port(main, argv: list) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv + ["--device", "cpu"])
    return rc, out.getvalue()


def _final(text: str) -> str:
    return text.rsplit("final", 1)[1].split("\n", 1)[0]


@functools.lru_cache(maxsize=None)
def _files(root: str) -> dict:
    """The tests' data files, each written by the JAX example's
    ``synth_dataset`` at tests/test_examples.py's sizes."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    paths = {"linear": root / "tiny.libsvm", "ffm": root / "tiny.libfm",
             "gbdt": root / "tiny_gbdt.libsvm", "rank": root / "rank.libsvm"}
    _jax_example("train_linear").synth_dataset(str(paths["linear"]),
                                               rows=2000, dim=100)
    _jax_example("train_ffm").synth_dataset(str(paths["ffm"]), rows=4000)
    _jax_example("gbdt_train").synth_dataset(str(paths["gbdt"]), rows=4000,
                                             dim=16)
    # tests/test_examples.py's qid-grouped rows
    rng = np.random.default_rng(5)
    lines = []
    for q in range(120):
        for _ in range(8):
            v = {int(i): float(rng.uniform(0.1, 2.0))
                 for i in np.sort(rng.choice(8, size=4, replace=False))}
            rel = round(2 * v.get(0, 0.0) + v.get(1, 0.0) ** 2, 4)
            lines.append(f"{rel} qid:{q} " +
                         " ".join(f"{i}:{val:.4f}" for i, val in v.items()))
    paths["rank"].write_text("\n".join(lines) + "\n")
    return {k: str(v) for k, v in paths.items()}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _files(str(tmp_path_factory.mktemp("example_data")))


def _sha(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


@pytest.mark.parametrize("name,kw", [
    ("train_linear", dict(rows=2000, dim=100)),
    ("train_ffm", dict(rows=4000)),
    ("gbdt_train", dict(rows=4000, dim=16)),
])
def test_synth_dataset_bytes_equal_jax(name, kw, tmp_path):
    port = {"train_linear": train_linear, "train_ffm": train_ffm,
            "gbdt_train": gbdt_train}[name]
    a, b = tmp_path / "port", tmp_path / "jax"
    ra = port.synth_dataset(str(a), **kw)
    rb = _jax_example(name).synth_dataset(str(b), **kw)
    assert ra == rb
    assert a.stat().st_size > 0 and _sha(a) == _sha(b)


def test_synth_rank_dataset_is_the_jax_examples_rows(tmp_path):
    """The JAX example writes its ranking rows inline in ``main``: its
    first rows, recomputed from the same seed by the code there, are the
    port's."""
    path = tmp_path / "rank.libsvm"
    gbdt_train.synth_rank_dataset(str(path), dim=32)
    lines = path.read_text().splitlines()
    assert len({ln.split()[1] for ln in lines}) == 1500
    src = (REPO / "examples" / "gbdt_train.py").read_text()
    assert "for q in range(1500):" in src and \
        "rng.integers(6, 14)" in src and "rng.normal(0, 0.05)" in src
    rng = np.random.default_rng(0)
    want = []
    for q in range(2):
        for _ in range(int(rng.integers(6, 14))):
            v = {int(i): float(rng.uniform(0.1, 2.0))
                 for i in np.sort(rng.choice(32, size=8, replace=False))}
            rel = round(2 * v.get(0, 0.0) + v.get(1, 0.0) ** 2
                        + float(rng.normal(0, 0.05)), 4)
            want.append(f"{rel} qid:{q} " + " ".join(
                f"{i}:{val:.4f}" for i, val in v.items()))
    assert lines[:len(want)] == want


def _epoch_losses(text: str) -> list:
    return [float(m) for m in re.findall(r"^epoch \d+: loss ([0-9.]+)",
                                         text, re.M)]


def test_train_linear_matches_jax(files):
    argv = ["--data", files["linear"], "--epochs", "2", "--batch-size",
            "512"]
    rc, port = _run_port(train_linear.main, argv)
    jrc, jax = _run_jax("train_linear", argv)
    assert rc == jrc == 0
    got = ast.literal_eval(_final(port).lstrip(": "))
    want = ast.literal_eval(_final(jax).lstrip(": "))
    assert sorted(got) == sorted(want) == ["accuracy", "loss"]
    assert abs(got["loss"] - want["loss"]) <= LOSS_TOL, (got, want)
    assert abs(got["accuracy"] - want["accuracy"]) <= ACC_TOL
    np.testing.assert_allclose(_epoch_losses(port), _epoch_losses(jax),
                               atol=LOSS_TOL)
    assert port.splitlines()[0] == jax.splitlines()[0] == "100 features"
    # --shard outside a job: a 1-rank plan, the same numbers
    rc, shard = _run_port(train_linear.main, argv + ["--shard"])
    assert rc == 0 and "over 1 ranks" in shard
    assert _final(shard) == _final(port)


def test_train_ffm_matches_jax(files):
    argv = ["--data", files["ffm"], "--epochs", "60", "--batch-size", "4096"]
    rc, port = _run_port(train_ffm.main, argv)
    jrc, jax = _run_jax("train_ffm", argv)
    assert rc == jrc == 0
    assert port.splitlines()[0] == jax.splitlines()[0] == \
        "16 features, 2 fields"
    got, want = _epoch_losses(port), _epoch_losses(jax)
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, atol=LOSS_TOL)
    acc = float(port.rsplit("final accuracy:", 1)[1])
    assert abs(acc - float(jax.rsplit("final accuracy:", 1)[1])) <= ACC_TOL
    assert acc > 0.95


GBDT_ARGS = ["--dim", "16", "--trees", "5", "--depth", "4", "--bins", "32",
             "--batch-size", "1024"]
RANK_ARGS = ["--rank", "--dim", "8", "--trees", "12", "--depth", "3",
             "--bins", "16"]


def _accuracies(text: str) -> dict:
    return {k: float(v) for k, v in re.findall(r"(\w+)=([0-9.]+)",
                                               _final(text))}


@functools.lru_cache(maxsize=None)
def _jax_gbdt(argv: tuple) -> tuple:
    return _run_jax("gbdt_train", list(argv))


@pytest.mark.parametrize("flags,jax_flags", [
    ([], []),
    (["--missing"], ["--missing"]),
    (["--native-sparse"], ["--native-sparse"]),
    (["--rank"], ["--rank"]),
    (["--shard"], []),
    (["--shard", "--kernel-mesh"], []),
], ids=["dense", "missing", "native-sparse", "rank", "shard", "kernel-mesh"])
def test_gbdt_train_matches_jax(files, flags, jax_flags):
    if "--rank" in flags:
        base, jbase = RANK_ARGS[1:], RANK_ARGS[1:]
        data = files["rank"]
    else:
        base, jbase = GBDT_ARGS, GBDT_ARGS
        data = files["gbdt"]
    rc, port = _run_port(gbdt_train.main, ["--data", data] + base + flags)
    jrc, jax = _jax_gbdt(tuple(["--data", data] + jbase + jax_flags))
    assert rc == jrc == 0, port
    got, want = _accuracies(port), _accuracies(jax)
    assert sorted(got) == sorted(want)
    for k in want:
        tol = LOSS_TOL if k == "loss" else ACC_TOL
        assert abs(got[k] - want[k]) <= tol, (k, got, want)
    if "--shard" in flags:
        assert "over 1 ranks" in port


def _submit(n: int, argv: list) -> subprocess.CompletedProcess:
    """``python -m dmlc_core_tpu_torch.examples.<argv>`` as an ``n``-rank
    ``dmlc_submit`` job on the CPU.  The job's process group listens on
    the tracker's port + 1 (the DMLC_* contract); a tracker another test
    starts meanwhile may take that port first, so a job that lost it runs
    again, whether it exited or hung (the rank that lost the port exits,
    and its peer waits on the store it never opened)."""
    proc = None
    for _ in range(3):
        try:
            proc = subprocess.run(
                [sys.executable, "-m",
                 "dmlc_core_tpu_torch.tracker.dmlc_submit",
                 "--cluster=local", "-n", str(n), "--", sys.executable, "-m",
                 f"dmlc_core_tpu_torch.examples.{argv[0]}", *argv[1:],
                 "--device", "cpu"],
                cwd=REPO, capture_output=True, text=True, timeout=120,
                env={k: v for k, v in os.environ.items()
                     if not k.startswith("DMLC_")})
        except subprocess.TimeoutExpired as e:
            if b"address already in use" in (e.stderr or b"").lower():
                continue
            raise
        if "address already in use" not in proc.stderr.lower():
            break
    assert proc is not None, "the job lost its port on every attempt"
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


def test_gbdt_train_shard_over_two_ranks(files):
    """``--shard --kernel-mesh`` as a 2-rank job: each rank fits its half
    of the rows on the kernel route (its plain version here) with exact
    all-reduces, so both ranks print the one-process run's final line."""
    proc = _submit(2, ["gbdt_train", "--data", files["gbdt"], *GBDT_ARGS,
                       "--shard", "--kernel-mesh"])
    _, one = _run_port(gbdt_train.main, ["--data", files["gbdt"]]
                       + GBDT_ARGS)
    finals = re.findall(r"^final: .*$", proc.stdout, re.M)
    assert re.findall(r"over 2 ranks \((\d+) on rank (\d)\)",
                      proc.stdout) and len(finals) == 2
    assert set(finals) == {"final" + _final(one)}


def test_gbdt_train_refuses_kernel_mesh_without_shard(files):
    with pytest.raises(SystemExit, match="--kernel-mesh requires --shard"):
        _run_port(gbdt_train.main, ["--data", files["gbdt"], "--kernel-mesh"]
                  + GBDT_ARGS)


DIST_BATCH, DIST_NNZ = 256, 8192


def _global_batches(data: str, ranks: int) -> list:
    """The global batches of a ``ranks``-rank ``distributed_train`` epoch,
    built in one process: each rank's part staged alone, padded to
    ``nnz_max`` lanes, side by side (a rank out of rows adds padding)."""
    from dmlc_core_tpu_torch.data import DeviceStagingIter, PaddedBatch
    parts = []
    for r in range(ranks):
        it = DeviceStagingIter(data, batch_size=DIST_BATCH,
                               nnz_bucket=1 << 14, part=r, num_parts=ranks,
                               device="cpu")
        parts.append(list(it))
        it.close()
    out = []
    for i in range(max(map(len, parts))):
        label, weight, rp, index, value = [], [], [], [], []
        for r, batches in enumerate(parts):
            if i < len(batches):
                b = batches[i]
                pad = DIST_NNZ - b.index.shape[0]
                label.append(b.label)
                weight.append(b.weight)
                rp.append(b.row_ptr[:-1] + r * DIST_NNZ)
                index.append(torch.nn.functional.pad(b.index, (0, pad)))
                value.append(torch.nn.functional.pad(b.value, (0, pad)))
            else:
                label.append(torch.zeros(DIST_BATCH))
                weight.append(torch.zeros(DIST_BATCH))
                rp.append(torch.full((DIST_BATCH,), r * DIST_NNZ,
                                     dtype=torch.int32))
                index.append(torch.zeros(DIST_NNZ, dtype=torch.int32))
                value.append(torch.zeros(DIST_NNZ))
        rp.append(torch.tensor([ranks * DIST_NNZ], dtype=torch.int32))
        out.append(PaddedBatch(
            label=torch.cat(label), weight=torch.cat(weight),
            row_ptr=torch.cat(rp).to(torch.int32), index=torch.cat(index),
            value=torch.cat(value),
            num_rows=int(sum(int((w > 0).sum()) for w in weight))))
    return out


def test_distributed_train_two_rank_job(files):
    """A 2-rank ``dmlc_submit`` job (gloo on the CPU): rank 0's losses are
    a one-process run's over the same global batches."""
    from dmlc_core_tpu_torch.models import SparseLinearModel
    proc = _submit(2, ["distributed_train", "--data", files["linear"],
                       "--batch-size", str(DIST_BATCH), "--nnz-max",
                       str(DIST_NNZ)])
    got = ast.literal_eval(proc.stdout.rsplit("final: losses=", 1)[1]
                           .split("\n", 1)[0])
    assert re.findall(r"^epoch (\d+): loss [0-9.]+ \(2 processes, 1 "
                      r"devices\)$", proc.stdout, re.M) == ["0", "1"]
    steps = re.findall(r"^rank (\d): (\d+) steps", proc.stdout, re.M)
    batches = _global_batches(files["linear"], 2)
    assert sorted(steps) == [("0", str(2 * len(batches))),
                             ("1", str(2 * len(batches)))]
    model = SparseLinearModel(100, learning_rate=0.5, device="cpu").init()
    want = []
    for _ in range(2):
        for b in batches:
            loss = model.train_step(b)
        want.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---- the fs CLI ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fs():
    import runpy
    return runpy.run_path(str(REPO / "bin" / "dmlctpu-fs"),
                          run_name="dmlctpu_fs")


def _fs_jax(argv: list, capfd) -> tuple:
    old = sys.argv
    sys.argv = ["dmlctpu-fs"] + argv
    try:
        rc = _jax_fs()["main"]()
    except Exception as e:  # noqa: BLE001 — the script's own boundary
        print(f"dmlctpu-fs: {e}", file=sys.stderr)
        rc = 1
    finally:
        sys.argv = old
    sys.stdout.flush()
    out = capfd.readouterr()
    return rc, out.out, out.err


def _fs_port(argv: list, capfd) -> tuple:
    from dmlc_core_tpu_torch import fs
    rc = fs.main(argv)
    sys.stdout.flush()
    out = capfd.readouterr()
    return rc, out.out, out.err


def test_fs_cli_matches_dmlctpu_fs(tmp_path, capfd):
    tree = tmp_path / "tree"
    (tree / "sub").mkdir(parents=True)
    (tree / "a.txt").write_text("hello\nworld\n")
    (tree / "sub" / "b.bin").write_bytes(bytes(range(256)) * 9)
    cases = [["ls", str(tree)], ["ls", "-r", str(tree)],
             ["ls", "--recursive", f"file://{tree}"],
             ["cat", str(tree / "a.txt")], ["stat", str(tree / "sub")],
             ["stat", str(tree / "a.txt")],
             ["cp", str(tree / "a.txt"), f"file://{tree / 'a.txt'}"],
             ["stat", str(tree / "missing")]]
    for argv in cases:
        port, jax = _fs_port(argv, capfd), _fs_jax(argv, capfd)
        assert port[:2] == jax[:2], argv
        # native errors carry a timestamp: compare their message lines
        strip = lambda s: [ln for ln in s.splitlines()  # noqa: E731
                           if ln.startswith("dmlctpu-fs:")]
        assert strip(port[2]) == strip(jax[2]), argv
    rc = [_fs_port(["stat", str(tree / "missing")], capfd)[0],
          _fs_port(["cp", str(tree / "a.txt"), str(tree / "a.txt")],
                   capfd)[0]]
    assert rc == [1, 1]
    for argv, dst in ((["cp", str(tree / "sub" / "b.bin"),
                        str(tree / "port.bin")], "port.bin"),):
        rc, _, err = _fs_port(argv, capfd)
        assert rc == 0 and err.strip() == "copied 2304 bytes"
        assert (tree / dst).read_bytes() == (tree / "sub" /
                                             "b.bin").read_bytes()
        rc, _, err = _fs_jax([argv[0], argv[1], str(tree / "jax.bin")],
                             capfd)
        assert rc == 0 and err.strip() == "copied 2304 bytes"
    rc, out, _ = _fs_port(["cat", str(tree / "sub" / "b.bin")], capfd)
    assert rc == 0


@pytest.mark.parametrize("env, coord, want", [
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, None, (1, 2)),
    ({"DMLC_JOB_CLUSTER": "local"}, None, (3, 4)),
    ({}, "127.0.0.1:9355", (3, 4)),
    ({"DMLC_JOB_CLUSTER": "ssh"}, None, (0, 1)),
    ({}, "10.0.0.2:9355", (0, 1)),
], ids=["launcher", "local-job", "loopback", "multi-host", "remote-coord"])
def test_local_ranks(monkeypatch, env, coord, want):
    """A rank's card and backend follow its host's ranks, not the job's:
    rank 3 of 4 is local rank 3 of 4 when the job runs on this host, and
    one rank a host otherwise."""
    from dmlc_core_tpu_torch.examples._common import local_ranks
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "DMLC_JOB_CLUSTER"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert local_ranks(3, 4, coord) == want
