"""The port's dmlc-submit backends against the JAX package's: for each
cluster backend the same arguments give the same scheduler command lines,
env and submit() call, with the subprocess layer and the rendezvous
stubbed out (the rendezvous has its own tests).  ``--cluster=tpu`` is
refused, naming its reason; ``--data-service N`` parses and
``submit(data_service=N)`` spawns the port's staging workers.
"""
import importlib
import json
import uuid
from pathlib import Path

import pytest

ENVS = {"DMLC_TRACKER_URI": "10.0.0.9", "DMLC_TRACKER_PORT": 9091,
        "DMLC_NUM_WORKER": 2, "DMLC_NUM_SERVER": 0}
PACKAGES = ("dmlc_core_tpu", "dmlc_core_tpu_torch")


class FakeTracker:
    def alive(self):
        return False

    def join(self, timeout=None):
        pass

    def stop(self):
        pass


class FakeProc:
    returncode = 0
    stdout = ""

    def poll(self):
        return 0

    def wait(self):
        return 0


def _capture(pkg, backend, argv, monkeypatch, kubectl=True,
             mpi_version="mpirun (Open MPI) 4.1.4"):
    """Run one backend of ``pkg`` on ``argv`` and return what it asked the
    scheduler layer for: each submit() call and each subprocess call, with
    the wrapper scripts it wrote read back."""
    mod = importlib.import_module(f"{pkg}.tracker.launchers.{backend}")
    parse = importlib.import_module(f"{pkg}.tracker.opts").parse
    calls = []

    def submit(num_workers, num_servers, fun_submit, **kw):
        calls.append({"submit": [num_workers, num_servers],
                      **{k: v for k, v in kw.items()}})
        envs = dict(ENVS, DMLC_NUM_WORKER=num_workers,
                    DMLC_NUM_SERVER=num_servers)
        fun_submit(num_workers, num_servers, envs)
        return FakeTracker()

    def run(cmd, **kw):
        if cmd == ["mpirun", "--version"]:
            out = FakeProc()
            out.stdout = mpi_version
            return out
        if cmd and cmd[0] == "qsub":  # the wrapper script, by content
            cmd = cmd[:-1] + [Path(cmd[-1]).read_text()]
        calls.append({"cmd": list(cmd),
                      **{k: kw[k] for k in ("env", "input") if k in kw}})
        return FakeProc()

    monkeypatch.setattr(mod, "submit", submit)
    if hasattr(mod, "subprocess"):
        monkeypatch.setattr(mod.subprocess, "run", run)
        monkeypatch.setattr(mod.subprocess, "Popen",
                            lambda cmd, **kw: run(cmd, **kw))
    if hasattr(mod, "shutil"):
        monkeypatch.setattr(
            mod.shutil, "which",
            lambda name: None if name == "kubectl" and not kubectl
            else f"/usr/bin/{name}")
    if hasattr(mod, "uuid"):
        monkeypatch.setattr(mod.uuid, "uuid4", lambda: uuid.UUID(int=7))
    mod.run(parse(argv))
    if backend == "mesos":  # one thread a rank: wait for every call
        import time
        for _ in range(100):
            if len(calls) >= 3:
                break
            time.sleep(0.05)
    return sorted(json.dumps(c, sort_keys=True, default=str) for c in calls)


def _hosts(tmp_path):
    p = tmp_path / "hosts"
    p.write_text("nodeA:2222 slots=4\nnodeB  # comment\nnodeC\n")
    return str(p)


CASES = {
    "local": ["--cluster=local", "-n", "2", "-s", "1",
              "--local-num-attempt", "2", "--env", "A=1", "--", "true"],
    "ssh": ["--cluster=ssh", "-n", "2", "-s", "1", "-H", "{hosts}",
            "--", "python", "train.py"],
    "mpi": ["--cluster=mpi", "-n", "3", "-s", "1", "-H", "{hosts}",
            "--", "python", "train.py"],
    "slurm": ["--cluster=slurm", "-n", "4", "-s", "1", "--jobname", "exp1",
              "--", "python", "train.py"],
    "sge": ["--cluster=sge", "-n", "5", "-s", "2", "--jobname", "grid",
            "--", "python", "train.py"],
    "mesos": ["--cluster=mesos", "-n", "2", "-s", "1", "--worker-cores", "2",
              "--worker-memory-mb", "2048", "--env",
              "MESOS_MASTER=zk://zk1/mesos", "--", "python", "train.py"],
    "yarn": ["--cluster=yarn", "-n", "6", "-s", "1", "--queue", "prod",
             "--container-retries", "5", "--", "python", "train.py"],
    "kubernetes": ["--cluster=kubernetes", "-n", "3", "-s", "1",
                   "--jobname", "kjob", "--container-retries", "2",
                   "--env", "DMLC_K8S_IMAGE=myrepo/train:1",
                   "--", "python", "train.py"],
}


@pytest.mark.parametrize("backend,variant", [
    ("local", None), ("ssh", None), ("mpi", "openmpi"), ("mpi", "mpich"),
    ("slurm", None), ("sge", None), ("mesos", None), ("yarn", None),
    ("kubernetes", "kubectl"), ("kubernetes", "dry-run")])
def test_backend_commands_equal_the_jax_backend(backend, variant, tmp_path,
                                                monkeypatch, capsys):
    monkeypatch.setenv("HADOOP_YARN_DS_JAR", "/opt/ds.jar")
    argv = [a.replace("{hosts}", _hosts(tmp_path)) for a in CASES[backend]]
    kw = {"kubectl": variant != "dry-run",
          "mpi_version": "HYDRA build details: mpich version 4.0"
          if variant == "mpich" else "mpirun (Open MPI) 4.1.4"}
    got = []
    for pkg in PACKAGES:
        calls = _capture(pkg, backend, argv, monkeypatch, **kw)
        printed = capsys.readouterr().out
        got.append(([c.replace("dmlc_core_tpu.", "dmlc_core_tpu_torch.")
                     for c in calls], printed))
    assert got[0] == got[1]
    if variant == "dry-run":  # the manifests are printed, not applied
        manifests = [json.loads(x) for x in got[1][1].splitlines()]
        assert [m["metadata"]["name"] for m in manifests] == [
            "kjob-server", "kjob-worker"]
    else:
        assert len(got[1][0]) >= 2  # submit() and at least one launch


def test_in_container_bootstrap_equals_the_jax_one():
    from dmlc_core_tpu.tracker import launcher as jlauncher
    from dmlc_core_tpu_torch.tracker import launcher
    for env in ({"SGE_TASK_ID": "3"}, {"SGE_TASK_ID": "undefined"},
                {"SLURM_PROCID": "2"}, {"JOB_COMPLETION_INDEX": "5"},
                {"OMPI_COMM_WORLD_RANK": "1"}, {"PMI_RANK": "4"},
                {"DMLC_TASK_ID": "9", "PMI_RANK": "4"}, {},
                {"HADOOP_HOME": "/nonexistent/hadoop"}):
        mine, theirs = dict(env), dict(env)
        launcher.derive_task_id(mine)
        launcher.extend_hadoop_paths(mine)
        jlauncher.derive_task_id(theirs)
        jlauncher.extend_hadoop_paths(theirs)
        assert mine == theirs
    assert launcher.main([]) == 2


def test_tpu_cluster_is_refused():
    from dmlc_core_tpu_torch.tracker import launchers
    from dmlc_core_tpu_torch.tracker.opts import parse
    args = parse(["--cluster=tpu", "-n", "2", "--", "python", "train.py"])
    with pytest.raises(ValueError, match="NVIDIA"):
        launchers.get(args.cluster)(args)
    with pytest.raises(ValueError, match="unknown cluster backend"):
        launchers.get("nope")


def test_data_service_option_parses():
    from dmlc_core_tpu_torch.tracker.opts import parse
    args = parse(["--cluster=local", "-n", "1", "--data-service", "2",
                  "--", "true"])
    assert args.data_service == 2 and args.command == ["true"]


# stop() closes the rendezvous socket under its accept loop, which then
# ends on EBADF
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_submit_spawns_the_data_service(monkeypatch):
    """``submit(data_service=1)`` starts one staging worker of the port
    beside the tracker, under the job's env contract."""
    import sys
    submit_mod = importlib.import_module("dmlc_core_tpu_torch.tracker.submit")

    class Proc:
        def poll(self):
            return 0

        def wait(self, timeout=None):
            return 0

    spawned = []
    monkeypatch.setattr(submit_mod.subprocess, "Popen",
                        lambda cmd, **kw: spawned.append((cmd, kw)) or Proc())
    tracker = submit_mod.submit(1, 0, lambda *a: None, host_ip="127.0.0.1",
                                data_service=1)
    try:
        assert [cmd for cmd, _ in spawned] == [
            [sys.executable, "-m", "dmlc_core_tpu_torch.dataservice.server"]]
        env = spawned[0][1]["env"]
        assert env["DMLC_TRACKER_METRICS_PORT"] == str(tracker.metrics.port)
        assert env["DMLC_TRACKER_URI"] == "127.0.0.1"
        assert len(tracker.data_service_procs) == 1
    finally:
        tracker.stop()
