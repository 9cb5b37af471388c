"""The DMLC_* bootstrap into ``torch.distributed``: the ``dmlc_env_info``
contract (the JAX package's), ``init_from_env``'s no-op for one worker and
its backend choice, and a 2-rank local job launched by the port's
``dmlc_submit`` on the CPU: each rank rendezvouses with the tracker, joins
a gloo process group through ``init_from_env(backend="gloo")``, stages its
part of a libsvm file, and the all-reduced row count is the file's.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from dmlc_core_tpu.parallel.bootstrap import dmlc_env_info as jax_env_info
from dmlc_core_tpu_torch import parallel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTRACT = ("DMLC_ROLE", "DMLC_TASK_ID", "DMLC_NUM_WORKER",
            "DMLC_TRACKER_URI", "DMLC_TRACKER_PORT")


@pytest.mark.parametrize("env", [
    {},
    {"DMLC_ROLE": "worker", "DMLC_TASK_ID": "3", "DMLC_NUM_WORKER": "8",
     "DMLC_TRACKER_URI": "10.0.0.1", "DMLC_TRACKER_PORT": "9091"},
    {"DMLC_ROLE": "server", "DMLC_NUM_WORKER": "2",
     "DMLC_TRACKER_URI": "host"},
], ids=["standalone", "worker", "no-port"])
def test_dmlc_env_info_contract(env, monkeypatch):
    for k in CONTRACT:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mine, theirs = parallel.dmlc_env_info(), jax_env_info()
    assert vars(mine) == vars(theirs)
    assert mine.coordinator_address == theirs.coordinator_address
    if env.get("DMLC_TASK_ID") == "3":
        assert (mine.task_id, mine.num_workers) == (3, 8)
        assert mine.coordinator_address == "10.0.0.1:9091"


def test_init_from_env_is_a_no_op_for_one_worker(monkeypatch):
    import torch.distributed as dist
    for k in CONTRACT:
        monkeypatch.delenv(k, raising=False)
    info = parallel.init_from_env(device="cpu")
    assert info.num_workers == 1 and not dist.is_initialized()
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    monkeypatch.setenv("DMLC_TRACKER_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_TRACKER_PORT", "1")
    assert parallel.init_from_env(backend="gloo", device="cpu").task_id == 0
    assert not dist.is_initialized()


_WORKER = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from dmlc_core_tpu_torch import parallel
from dmlc_core_tpu_torch.data import DeviceStagingIter
from dmlc_core_tpu_torch.tracker import WorkerClient

client = WorkerClient().start(world_size=int(os.environ["DMLC_NUM_WORKER"]))
# the test binds the process group's store on a port it found free
offset = int(os.environ["STORE_PORT"]) - int(os.environ["DMLC_TRACKER_PORT"])
info = parallel.init_from_env(coordinator_port_offset=offset,
                              backend="gloo", device="cpu")
assert dist.get_backend() == "gloo"
assert (dist.get_rank(), dist.get_world_size()) == (info.task_id, 2)
it = DeviceStagingIter(sys.argv[2], batch_size=64, nnz_bucket=1024,
                       part=info.task_id, num_parts=info.num_workers,
                       device="cpu")
rows = sum(b.num_rows for b in it)
total = torch.tensor([rows], dtype=torch.int64)
dist.all_reduce(total)
with open(os.path.join(sys.argv[3], f"rank-{info.task_id}.json"), "w") as f:
    json.dump({"rabit_rank": client.rank, "rows": rows,
               "total": int(total)}, f)
dist.destroy_process_group()
client.shutdown()
"""


def test_two_rank_gloo_job_through_dmlc_submit(tmp_path):
    rng = np.random.default_rng(8)
    rows = 1000
    data = tmp_path / "job.libsvm"
    data.write_text("".join(
        f"{i % 2} " + " ".join(f"{j}:{rng.random():.3f}" for j in sorted(
            rng.choice(100, 1 + i % 5, replace=False))) + "\n"
        for i in range(rows)))
    out = tmp_path / "out"
    out.mkdir()
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        store_port = s.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.dmlc_submit",
         "--cluster=local", "-n", "2", "--env", f"STORE_PORT={store_port}",
         "--", sys.executable, str(worker), REPO, str(data), str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = [json.loads((out / f"rank-{r}.json").read_text()) for r in (0, 1)]
    assert sorted(g["rabit_rank"] for g in got) == [0, 1]
    assert all(g["total"] == rows for g in got)
    assert sum(g["rows"] for g in got) == rows
    assert all(g["rows"] > 0 for g in got)
