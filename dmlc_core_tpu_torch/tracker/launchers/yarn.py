"""YARN launcher.

Parity: reference tracker/dmlc_tracker/yarn.py + the Java ApplicationMaster
(tracker/yarn/ — container negotiation, failed-task restart, app attempts;
the restart loop lives at ApplicationMaster.java:560-578 upstream).
This build ships no Java: it drives YARN's stock distributed-shell AM
(part of every Hadoop install) with the DMLC_* env exported per container,
and keeps the AM's restart duty HERE, in the launcher.  The mapping:

  * container negotiation   -> -num_containers/-container_memory/-container_vcores
  * in-app container retry  -> -container_retry_policy RETRY_ON_ALL_ERRORS
                               with --container-retries max retries (the NM
                               relaunches a crashed container in place)
  * failed-task restart     -> when retries are exhausted the DS app FAILS
                               and its `yarn jar` client exits non-zero;
                               run() then RESUBMITS that application.  Each
                               role gets at most DMLC_MAX_ATTEMPT total
                               submissions (default 3: the initial one plus
                               up to two restarts — the same total-attempts
                               knob the reference AM reads).  Restarted
                               ranks re-rendezvous through the tracker's
                               `recover` path, reclaiming their rank.
  * AM restart              -> the RM re-attempts the DS AM per the
                               cluster's yarn.resourcemanager.am.max-attempts

Rank assignment never needed the custom AM: workers rendezvous through the
rabit tracker, which assigns ranks on connect.  Requires `yarn` on PATH.
"""
from __future__ import annotations

import logging
import os
import shutil
import subprocess
import time
import uuid

from ..submit import submit

LOGGER = logging.getLogger("dmlc_tpu.yarn")

# poll cadence for submission-client liveness (tests shrink this)
_POLL_S = 1.0


def _kill_stale_applications(appname: str) -> None:
    """Best-effort kill of live applications named ``appname``.

    A non-zero submission-client exit usually means the application
    failed, but the client can also die (OOM, lost RM connection) while
    its application is still healthy on the RM; resubmitting without this
    sweep would run TWO live applications whose containers contend for
    the same ranks at the tracker.  Errors are logged, not raised — the
    resubmission itself is the primary recovery action."""
    try:
        out = subprocess.run(
            ["yarn", "application", "-list", "-appStates", "ACCEPTED,RUNNING"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        LOGGER.warning("could not list yarn applications before "
                       "resubmission: %s", e)
        return
    for line in out.splitlines():
        cols = line.split("\t")
        if len(cols) >= 2 and cols[1].strip() == appname:
            app_id = cols[0].strip()
            LOGGER.warning("killing stale application %s (%s) before "
                           "resubmission", app_id, appname)
            try:
                subprocess.run(["yarn", "application", "-kill", app_id],
                               capture_output=True, timeout=60)
            except (OSError, subprocess.SubprocessError) as e:
                LOGGER.warning("kill of %s failed: %s", app_id, e)


def run(args) -> None:
    if shutil.which("yarn") is None:
        raise SystemExit("--cluster=yarn requires the yarn CLI on PATH")
    max_attempt = max(int(os.environ.get("DMLC_MAX_ATTEMPT", "3")), 1)
    # unique per-job suffix: the stale-app kill sweep matches by appname,
    # and a bare "<jobname>-worker" would collide with (and kill) another
    # job submitted under the same default name on the same cluster
    job_tag = uuid.uuid4().hex[:8]
    # one entry per submitted application: the client command (for
    # resubmission), the live client process, and the attempt counter
    subs: list[dict] = []

    def spawn_all(num_workers: int, num_servers: int, envs: dict) -> None:
        def launch(role: str, n: int) -> None:
            if n == 0:
                return
            pairs = dict(envs)
            pairs.update(args.extra_env)
            pairs.update({"DMLC_ROLE": role, "DMLC_JOB_CLUSTER": "yarn"})
            shell_env = ",".join(f"{k}={v}" for k, v in pairs.items())
            ds_jar = os.environ.get("HADOOP_YARN_DS_JAR", "distributedshell.jar")
            appname = (args.jobname or "dmlc") + "-" + role + "-" + job_tag
            cmd = [
                "yarn", "jar", ds_jar,
                "-jar", ds_jar,
                "-appname", appname,
                "-queue", args.queue,
                "-num_containers", str(n),
                "-container_memory", str(args.worker_memory_mb),
                "-container_vcores", str(args.worker_cores),
                "-container_retry_policy", "RETRY_ON_ALL_ERRORS",
                "-container_max_retries",
                str(args.container_retries if args.container_retries is not None else 3),
                "-container_retry_interval", "1000",
                "-shell_env", shell_env,
                "-shell_command", " ".join(args.command),
            ]
            LOGGER.info("yarn submit: %s", " ".join(cmd))
            subs.append({"cmd": cmd, "role": role, "appname": appname,
                         "attempt": 1, "proc": subprocess.Popen(cmd)})

        launch("server", num_servers)
        launch("worker", num_workers)

    tracker = submit(args.num_workers, args.num_servers, spawn_all,
                     host_ip=args.host_ip, extra_envs=args.extra_env)
    # Poll the submission clients while the job runs.  A client exiting
    # non-zero means its application failed (container retries exhausted,
    # AM attempts exhausted, or submission error): resubmit it while
    # attempts remain — the reference AM's failed-task relaunch, one level
    # up.  Only when a role burns through DMLC_MAX_ATTEMPT applications is
    # the job declared dead.
    while tracker.alive():
        for s in subs:
            rc = s["proc"].poll()
            if rc is None or rc == 0:  # running, or app completed clean
                continue
            if s["attempt"] < max_attempt:
                s["attempt"] += 1
                LOGGER.warning(
                    "yarn %s application failed (client rc=%d); "
                    "resubmitting, attempt %d/%d", s["role"], rc,
                    s["attempt"], max_attempt)
                # the client may have died while its app lives on the RM;
                # never run two applications' containers for one role
                _kill_stale_applications(s["appname"])
                s["proc"] = subprocess.Popen(s["cmd"])
                continue
            # give-up: terminating a client does NOT stop its application
            # on the RM, so sweep every role's live apps (including this
            # failed role's, whose last client may have died client-side)
            for other in subs:
                if other is not s and other["proc"].poll() is None:
                    other["proc"].terminate()
            for entry in subs:
                _kill_stale_applications(entry["appname"])
            LOGGER.warning(
                "yarn %s application failed %d time(s) (max attempts "
                "reached); job killed", s["role"], max_attempt)
            raise SystemExit(
                f"yarn {s['role']} application failed after "
                f"{max_attempt} attempt(s), client rc={rc}")
        time.sleep(_POLL_S)
    tracker.join()
    failures = [s["proc"].wait() for s in subs]
    if any(rc != 0 for rc in failures):
        raise SystemExit(f"yarn submission client(s) exited with {failures}")
