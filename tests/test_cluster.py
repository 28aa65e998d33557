"""Cluster-level fault-tolerance suite (ISSUE 7,
``bigdl_tpu/parallel/cluster.py`` + docs/fault_tolerance.md
"Distributed failures").

Unit layer: heartbeat publish/stale detection, incarnation hygiene,
the two-phase commit barrier (certify / bounded timeout), the
manifest-capped restore walk, /healthz turning 503 on degradation, the
supervisor's bounded-restart loop, and the interruptible retry
backoff.

E2E layer (real multi-process gloo clusters, every test carrying an
explicit ``deadline`` marker so a deadlocked collective can never eat
the tier-1 budget): ``peer_wedge`` → every host EXITS with the
distinct peer-lost code instead of hanging in the all-reduce;
``commit_crash`` → the cluster manifest makes the uncertified step-4
checkpoint structurally invisible, every host restores the SAME step,
and the finished run still matches the uninterrupted one;
``peer_kill`` under the supervisor → watchdog abort within the
deadline, full-cluster restart from the cluster-consistent
checkpoint, final params equal the uninterrupted run.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import bigdl_tpu.nn as nn
import bigdl_tpu.optim as optim
from bigdl_tpu import faults, telemetry
from bigdl_tpu.dataset.sample import Sample
from bigdl_tpu.parallel import cluster
from bigdl_tpu.utils.config import set_config
from bigdl_tpu.utils.rng import RNG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def setup_function(_fn):
    faults.reset()
    cluster.deactivate()


def teardown_function(_fn):
    telemetry.end_run()
    set_config(None)
    faults.reset()
    cluster.deactivate()


# -- heartbeat + watchdog ----------------------------------------------------
def test_derive_deadline(monkeypatch):
    monkeypatch.setenv("BIGDL_CLUSTER_DEADLINE", "7.5")
    assert cluster.derive_deadline() == 7.5
    monkeypatch.delenv("BIGDL_CLUSTER_DEADLINE")
    monkeypatch.setenv("BIGDL_ITERATION_TIMEOUT", "30")
    assert cluster.derive_deadline() == 60.0  # 2x the straggler budget
    monkeypatch.setenv("BIGDL_ITERATION_TIMEOUT", "auto")
    assert cluster.derive_deadline() == 120.0  # conservative default


def test_heartbeat_stale_peer_detected_and_clean_exit_ignored(tmp_path):
    d = str(tmp_path)
    # monitor first: beats older than the monitor's start read as
    # previous-incarnation leftovers by design
    mon = cluster.ClusterMonitor(d, 0, 2, deadline=0.4, interval=0.1,
                                 abort=False)
    hb0 = cluster.HeartbeatPublisher(d, 0, interval=0.05).start()
    hb1 = cluster.HeartbeatPublisher(d, 1, interval=0.05).start()
    time.sleep(0.06)  # step beats ride the interval throttle
    hb0.beat(1)
    hb1.beat(1)
    mon._check(time.time())
    assert not mon.degraded()
    table = mon.peer_table()
    assert table["p1"]["step"] == 1 and table["p1"]["status"] == "running"
    time.sleep(0.6)  # p1 goes silent past the deadline
    mon._check(time.time())
    assert mon.degraded()
    assert "no heartbeat" in mon.peer_table()["p1"]["lost"]
    # a refreshed beat clears the verdict...
    hb1.beat(2)
    mon._check(time.time())
    assert not mon.degraded()
    # ...and a clean final status is NEVER a loss, however stale
    hb1.stop("done")
    time.sleep(0.6)
    mon._check(time.time())
    assert not mon.degraded()
    assert mon.peer_table()["p1"]["status"] == "done"


def test_failed_status_is_an_immediate_loss(tmp_path):
    d = str(tmp_path)
    mon = cluster.ClusterMonitor(d, 0, 2, deadline=30.0, interval=0.1,
                                 abort=False)
    cluster.HeartbeatPublisher(d, 1, interval=0.05).start().stop("failed")
    mon._check(time.time())
    assert mon.degraded()
    assert mon.peer_table()["p1"]["lost"] == "peer reported failed"


def test_monitor_ignores_previous_incarnation_heartbeats(tmp_path):
    """Stale files from a dead incarnation must not speak for a fresh
    one: the monitor only tracks beats newer than its own start."""
    d = str(tmp_path)
    path = os.path.join(d, "heartbeat.p1.json")
    with open(path, "w") as fh:
        json.dump({"process_index": 1, "step": 7, "status": "running",
                   "pid": 1, "ts": time.time() - 3600}, fh)
    mon = cluster.ClusterMonitor(d, 0, 2, deadline=0.2, interval=0.1,
                                 abort=False)
    time.sleep(0.3)
    mon._check(time.time())
    assert not mon.degraded()
    assert mon.peer_table()["p1"]["status"] == "unseen" or \
        "lost" not in mon.peer_table()["p1"]


def test_peer_lost_fire_emits_instant_and_flight_dump(tmp_path,
                                                      monkeypatch):
    """The (abort-disabled) firing path: ``cluster/peer_lost`` instant
    with the liveness snapshot + a flight dump with the peer table as
    evidence."""
    monkeypatch.setenv("BIGDL_TELEMETRY", str(tmp_path / "tele"))
    d = str(tmp_path / "hb")
    mon = cluster.ClusterMonitor(d, 0, 2, deadline=0.1, interval=0.05,
                                 abort=False)
    hb1 = cluster.HeartbeatPublisher(d, 1, interval=0.05).start()
    time.sleep(0.06)  # step beats ride the interval throttle
    hb1.beat(3)
    sink = telemetry.MemorySink()
    with telemetry.run(str(tmp_path / "tele"), sinks=[sink]):
        time.sleep(0.3)
        mon._check(time.time())
        assert mon.degraded()
        mon._fire()
    lost = [e for e in sink.events if e.get("kind") == "event"
            and e.get("name") == "cluster/peer_lost"]
    assert len(lost) == 1 and lost[0]["peers"] == [1]
    dumps = [f for f in os.listdir(tmp_path / "tele")
             if f.startswith("flight-")]
    assert len(dumps) == 1
    payload = json.loads((tmp_path / "tele" / dumps[0]).read_text())
    assert payload["reason"] == "peer_lost"
    assert payload["evidence"]["peer_table"]["p1"]["step"] == 3


# -- the commit barrier ------------------------------------------------------
def test_commit_barrier_certifies_only_with_all_acks(tmp_path):
    svc0 = cluster.ClusterService(str(tmp_path / "hb"), 0, 2,
                                  deadline=1.0, abort=False)
    svc1 = cluster.ClusterService(str(tmp_path / "hb"), 1, 2,
                                  deadline=1.0, abort=False)
    ck = str(tmp_path / "ckpt")
    os.makedirs(ck)
    assert cluster.manifest_step(ck) is None
    assert svc1.commit_step(ck, 4)                 # phase 1: peer ack
    assert svc0.commit_step(ck, 4,                 # phase 2: manifest
                            digests={"model.4": "sha"})
    assert cluster.manifest_step(ck) == 4
    manifest = json.loads(
        (tmp_path / "ckpt" / "cluster_manifest.json").read_text())
    assert manifest["acks"]["p0"]["digests"] == {"model.4": "sha"}
    # a missing ack leaves the manifest at the PREVIOUS step (bounded)
    t0 = time.time()
    assert not svc0.commit_step(ck, 8, timeout=0.3)
    assert time.time() - t0 < 2.0
    assert cluster.manifest_step(ck) == 4
    # committed-step acks pruned, newer (uncertified) acks retained
    names = sorted(os.listdir(ck))
    assert "commit.p0.8.json" in names


def test_latest_verified_step_dir_max_step_cap(tmp_path):
    """The cluster-consistent restore walk: steps above the manifest
    cap are skipped WITHOUT quarantine — intact, merely uncertified."""
    from bigdl_tpu.utils.sharded_ckpt import latest_verified_step_dir

    for n in (2, 4):
        d = tmp_path / f"sharded.{n}"
        d.mkdir()
        (d / "bigdl_meta.json").write_text(
            json.dumps({"extra": {"neval": n}, "digests": {}}))
    assert latest_verified_step_dir(str(tmp_path)).endswith("sharded.4")
    capped = latest_verified_step_dir(str(tmp_path), max_step=2)
    assert capped.endswith("sharded.2")
    # nothing was quarantined by the capped walk
    assert sorted(os.listdir(tmp_path)) == ["sharded.2", "sharded.4"]
    svc = cluster.ClusterService(str(tmp_path / "hb"), 0, 2,
                                 deadline=1.0, abort=False)
    # no manifest -> uncapped (pre-cluster dirs stay restorable)
    assert svc.latest_consistent_step_dir(
        str(tmp_path)).endswith("sharded.4")
    cluster._atomic_write_json(str(tmp_path / "cluster_manifest.json"),
                               {"step": 2})
    assert svc.latest_consistent_step_dir(
        str(tmp_path)).endswith("sharded.2")


def test_prune_old_never_deletes_the_manifest_step(tmp_path):
    """Retention must not strand the cluster: the manifest step stays
    on disk even when newer (possibly uncertified) checkpoints fill
    the keep window — cluster restores CAP at the manifest step, so
    deleting it would leave them nothing to restore."""
    from bigdl_tpu.utils.sharded_ckpt import prune_old

    for n in (2, 4, 6):
        d = tmp_path / f"sharded.{n}"
        d.mkdir()
        (d / "bigdl_meta.json").write_text(
            json.dumps({"extra": {"neval": n}, "digests": {}}))
    pruned = prune_old(str(tmp_path), keep=1, keep_step=2)
    assert [os.path.basename(p) for p in pruned] == ["sharded.4"]
    assert sorted(os.listdir(tmp_path)) == ["sharded.2", "sharded.6"]


# -- /healthz + /status ------------------------------------------------------
def test_healthz_503_and_status_peer_table_when_degraded(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("BIGDL_METRICS_PORT", "0")
    d = str(tmp_path / "hb")
    svc = cluster.ClusterService(d, 0, 2, deadline=0.2, abort=False)
    svc.heartbeat.start()
    hb1 = cluster.HeartbeatPublisher(d, 1, interval=0.05).start()
    time.sleep(0.06)  # step beats ride the interval throttle
    hb1.beat(5)
    cluster._service = svc  # install without a full activate()
    try:
        with telemetry.run(str(tmp_path / "tele")):
            server = telemetry.metrics_server()
            assert server is not None
            base = f"http://127.0.0.1:{server.port}"

            def get(path):
                try:
                    with urllib.request.urlopen(base + path,
                                                timeout=5) as r:
                        return r.status, r.read().decode()
                except urllib.error.HTTPError as e:
                    return e.code, e.read().decode()

            code, _ = get("/healthz")
            assert code == 200
            time.sleep(0.4)  # p1 stalls past the deadline
            svc.monitor._check(time.time())
            assert svc.degraded()
            code, body = get("/healthz")
            assert code == 503 and "degraded" in body
            _, body = get("/status")
            st = json.loads(body)
            assert st["cluster"]["state"] == "degraded"
            assert st["cluster"]["peers"]["p1"]["lost"]
            assert st["cluster"]["peers"]["p1"]["step"] == 5
    finally:
        cluster._service = None


# -- the supervisor ----------------------------------------------------------
def _toy_worker(body: str) -> list:
    return [sys.executable, "-c", body]


def test_supervisor_restarts_until_clean_and_reports_history(tmp_path,
                                                             monkeypatch):
    """First incarnation fails, second succeeds: one restart, exit 0,
    and the exit history records both."""
    monkeypatch.setenv("BIGDL_RETRY_BACKOFF", "0.01")
    # marker is PER-PROCESS: a shared marker would race (whichever
    # worker starts first plants it before the other checks)
    marker = tmp_path / "already_failed"
    body = (f"import os, sys\n"
            f"m = {str(marker)!r} + os.environ['BIGDL_PROCESS_ID']\n"
            f"if not os.path.exists(m):\n"
            f"    open(m, 'w').close()\n"
            f"    sys.exit(7 if os.environ['BIGDL_PROCESS_ID'] == '1' "
            f"else 0)\n")
    sup = cluster.Supervisor(2, _toy_worker(body), max_restarts=3,
                             cluster_dir=str(tmp_path / "cl"),
                             settle_grace=5.0)
    assert sup.run() == 0
    assert sup.restarts == 1
    assert len(sup.exit_history) == 2
    assert 7 in sup.exit_history[0]
    assert sup.exit_history[1] == [0, 0]


def test_supervisor_restart_budget_exhausts(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_RETRY_BACKOFF", "0.01")
    sup = cluster.Supervisor(2, _toy_worker("import sys; sys.exit(5)"),
                             max_restarts=1,
                             cluster_dir=str(tmp_path / "cl"),
                             settle_grace=5.0)
    assert sup.run() == 1
    assert len(sup.exit_history) == 2  # original + 1 restart


def test_supervisor_clears_fault_plan_on_restart(tmp_path, monkeypatch):
    """An injected fault plan describes ONE scenario: replaying it every
    incarnation would make recovery impossible, so restarts clear
    ``BIGDL_FAULTS`` (``--keep-faults`` opts out)."""
    monkeypatch.setenv("BIGDL_RETRY_BACKOFF", "0.01")
    out = tmp_path / "plans"
    out.mkdir()
    body = (f"import os, sys\n"
            f"inc = os.environ['BIGDL_SUPERVISOR_INCARNATION']\n"
            f"pid = os.environ['BIGDL_PROCESS_ID']\n"
            f"open(os.path.join({str(out)!r}, f'inc{{inc}}.p{{pid}}'), "
            f"'w').write(os.environ.get('BIGDL_FAULTS', '<unset>'))\n"
            f"sys.exit(3 if inc == '0' and pid == '0' else 0)\n")
    env = dict(os.environ)
    env["BIGDL_FAULTS"] = "peer_kill@6:p2"
    sup = cluster.Supervisor(2, _toy_worker(body), max_restarts=2,
                             cluster_dir=str(tmp_path / "cl"),
                             settle_grace=5.0, env=env)
    assert sup.run() == 0
    assert (out / "inc0.p0").read_text() == "peer_kill@6:p2"
    assert (out / "inc1.p0").read_text() == ""


# -- interruptible retry backoff ---------------------------------------------
@pytest.mark.deadline(60)
def test_sigterm_interrupts_retry_backoff(tmp_path, monkeypatch):
    """Satellite bugfix: a SIGTERM during the retry-backoff sleep used
    to wait out the FULL sleep before the grace handler could act.  Now
    the backoff waits on the preempt guard's event: a crash with a
    ~15-30s backoff plus a SIGTERM at ~1.5s must return preempted in a
    few seconds, not tens."""
    monkeypatch.setenv("BIGDL_RETRY_BACKOFF", "60")  # >=15s after jitter
    monkeypatch.setenv("BIGDL_FAULTS", "crash@1")
    faults.reset()
    RNG.set_seed(11)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    samples = [Sample(x[i], np.int64(i % 2)) for i in range(64)]
    model = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 2),
                          nn.LogSoftMax())
    o = optim.LocalOptimizer(model, samples, nn.ClassNLLCriterion(),
                             batch_size=16,
                             end_trigger=optim.Trigger.max_iteration(4))
    o.set_optim_method(optim.SGD(learning_rate=0.1))
    sink = telemetry.MemorySink()
    timer = threading.Timer(
        1.5, lambda: os.kill(os.getpid(), signal.SIGTERM))
    t0 = time.perf_counter()
    timer.start()
    try:
        with telemetry.run(sinks=[sink]):
            o.optimize()
    finally:
        timer.cancel()
    elapsed = time.perf_counter() - t0
    assert o.preempted
    assert elapsed < 12.0, (
        f"backoff was not interrupted: took {elapsed:.1f}s")
    marks = [e for e in sink.events if e.get("kind") == "event"
             and e.get("name") == "run/preempted"]
    assert len(marks) == 1 and marks[0]["signum"] == signal.SIGTERM


# -- E2E: the distributed fault matrix on live clusters ----------------------
# the flock-serialized allocator with the recent-port ledger: concurrent
# test processes (and back-to-back clusters in one test) no longer race
# each other into the same coordinator port (deflake, ISSUE 20)
_free_port = cluster._free_port


def _worker_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "BIGDL_FAULTS")}
    env["BIGDL_REPO"] = REPO
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _launch_cluster(nproc: int, **extra) -> list:
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, WORKER],
        env=_worker_env(BIGDL_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                        BIGDL_NUM_PROCESSES=nproc, BIGDL_PROCESS_ID=pid,
                        **extra),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(nproc)]


def _wait_all(procs, timeout: int):
    outs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=timeout)
            outs.append(stdout.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _events_by_process(tele_dir: str):
    """kind=='event' telemetry events per process index, from the
    per-process run logs."""
    from bigdl_tpu.telemetry.schema import read_events

    out = {}
    for f in sorted(os.listdir(tele_dir)):
        if not (f.startswith("run-") and f.endswith(".jsonl")):
            continue
        pidx = int(f.split("-p")[1].split("-")[0])
        events, _errs = read_events(os.path.join(tele_dir, f))
        out.setdefault(pidx, []).extend(
            e for e in events if e.get("kind") == "event")
    return out


def _assert_same_params(path_a: str, path_b: str, tol=1e-6):
    a, b = np.load(path_a), np.load(path_b)
    assert set(a.files) == set(b.files) and len(a.files) > 0
    for k in a.files:
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol,
                                   err_msg=f"param {k} diverged")


@pytest.mark.deadline(66)
def test_peer_wedge_surviving_hosts_exit_instead_of_hanging(tmp_path):
    """``peer_wedge@3:p1`` on a live 2-process cluster with NO straggler
    budget set: the wedged host stalls inside its iteration, the
    survivor blocks in the dead all-reduce — and within the cluster
    deadline EVERY process exits with the distinct peer-lost code
    instead of hanging until the harness timeout.  The run logs carry
    ``cluster/peer_lost`` and a flight dump."""
    tele = tmp_path / "tele"
    procs = _launch_cluster(
        2, BIGDL_TEST_OUT=str(tmp_path / "never.npz"),
        BIGDL_TEST_ITERS=8, BIGDL_TEST_CKPT=str(tmp_path / "ckpt"),
        BIGDL_TEST_CKPT_EVERY=2, BIGDL_FAULTS="peer_wedge@3:p1",
        BIGDL_CLUSTER_DIR=str(tmp_path / "hb"),
        # deadline 6 not 3: under a loaded CI host the first tracing
        # step alone can stall a worker past 3 s of missed heartbeats
        # and fire a spurious peer_lost (deflake, ISSUE 20)
        BIGDL_CLUSTER_DEADLINE=6, BIGDL_HEARTBEAT_INTERVAL=0.2,
        BIGDL_TELEMETRY=str(tele), BIGDL_ASYNC_CHECKPOINT=0,
        BIGDL_RETRY_BACKOFF=0.05)
    codes, outs = _wait_all(procs, timeout=120)
    # the FIRST watchdog abort (43) takes the jax coordinator down with
    # it, and the other host's distributed-runtime client may then
    # SIGABRT on coordinator loss before its own watchdog wins the
    # race — either way it EXITED, which is the property: no hang
    assert all(c in (cluster.EXIT_PEER_LOST, -signal.SIGABRT)
               for c in codes), (codes, outs[0][-2000:],
                                 outs[1][-2000:])
    assert cluster.EXIT_PEER_LOST in codes, (codes, outs[0][-2000:])
    assert not (tmp_path / "never.npz").exists()
    by_proc = _events_by_process(str(tele))
    names = [e["name"] for events in by_proc.values() for e in events]
    assert "cluster/peer_lost" in names, names
    assert any(f.startswith("flight-") for f in os.listdir(tele))


@pytest.mark.deadline(360)
@pytest.mark.slow
def test_commit_crash_never_yields_mixed_step_restore(tmp_path):
    """``commit_crash@4:p1``: p1 dies AFTER reaching the step-4 commit
    point but BEFORE its barrier ack, so the manifest stays at step 2
    even though the coordinator's step-4 checkpoint is durable and
    digest-verifies.  The restarted cluster must restore the SAME
    step-2 checkpoint on every host — model.4 exists on disk, and is
    still structurally invisible — and the finished run must match an
    uninterrupted one."""
    base = dict(BIGDL_TEST_ITERS=8, BIGDL_TEST_CKPT_EVERY=2,
                BIGDL_CLUSTER_DEADLINE=6, BIGDL_HEARTBEAT_INTERVAL=0.2,
                BIGDL_ASYNC_CHECKPOINT=0, BIGDL_RETRY_BACKOFF=0.05)
    # uninterrupted control
    un = str(tmp_path / "un.npz")
    codes, outs = _wait_all(_launch_cluster(
        2, BIGDL_TEST_OUT=un, BIGDL_TEST_CKPT=str(tmp_path / "ckpt_un"),
        BIGDL_CLUSTER_DIR=str(tmp_path / "hb_un"), **base), timeout=120)
    assert codes == [0, 0], (codes, outs[0][-2000:], outs[1][-2000:])
    # incarnation 0: dies in the commit window
    ckpt = str(tmp_path / "ckpt")
    codes, outs = _wait_all(_launch_cluster(
        2, BIGDL_TEST_OUT=str(tmp_path / "crashed.npz"),
        BIGDL_TEST_CKPT=ckpt, BIGDL_CLUSTER_DIR=str(tmp_path / "hb"),
        BIGDL_FAULTS="commit_crash@4:p1", **base), timeout=120)
    assert codes[1] == -signal.SIGKILL, (codes, outs[1][-2000:])
    assert codes[0] != 0, codes  # the survivor must NOT report success
    # the step-4 pair is durable, complete, digest-marked — yet
    # uncertified: a restore without the manifest WOULD pick it
    assert os.path.exists(os.path.join(ckpt, "model.4"))
    assert os.path.exists(os.path.join(ckpt, "ckptmeta.4.json"))
    assert cluster.manifest_step(ckpt) == 2, \
        "the barrier must not certify a step missing an ack"
    # incarnation 1: fresh cluster, no faults, same dirs
    tele = tmp_path / "tele"
    out = str(tmp_path / "resumed.npz")
    codes, outs = _wait_all(_launch_cluster(
        2, BIGDL_TEST_OUT=out, BIGDL_TEST_CKPT=ckpt,
        BIGDL_CLUSTER_DIR=str(tmp_path / "hb"),
        BIGDL_TELEMETRY=str(tele), **base), timeout=120)
    assert codes == [0, 0], (codes, outs[0][-2000:], outs[1][-2000:])
    by_proc = _events_by_process(str(tele))
    sources = {}
    for pidx, events in by_proc.items():
        resumed = [e for e in events if e["name"] == "run/resumed"]
        assert len(resumed) == 1, (pidx, [e["name"] for e in events])
        sources[pidx] = resumed[0]["step"]
    # NO MIXED STEPS: every host resumed at the manifest step, not at
    # the newer-but-uncertified one
    assert sources == {0: 2, 1: 2}, sources
    _assert_same_params(out, un)


@pytest.mark.deadline(420)
@pytest.mark.slow
def test_supervised_peer_kill_restart_matches_uninterrupted(tmp_path):
    """The ISSUE 7 acceptance path, on the live 4-process cluster:
    SIGKILL one of 4 workers mid-epoch under the supervisor.  The
    surviving hosts' watchdogs fire within the deadline (distinct exit
    code — no indefinite collective hang), the supervisor restarts the
    full cluster, auto-resume lands on the cluster-consistent step-4
    checkpoint, and the final params equal the uninterrupted run's."""
    base = dict(BIGDL_TEST_ITERS=8, BIGDL_TEST_CKPT_EVERY=4,
                BIGDL_CLUSTER_DEADLINE=6, BIGDL_HEARTBEAT_INTERVAL=0.2,
                BIGDL_ASYNC_CHECKPOINT=0, BIGDL_RETRY_BACKOFF=0.05)
    un = str(tmp_path / "un.npz")
    codes, outs = _wait_all(_launch_cluster(
        4, BIGDL_TEST_OUT=un, BIGDL_TEST_CKPT=str(tmp_path / "ckpt_un"),
        BIGDL_CLUSTER_DIR=str(tmp_path / "hb_un"), **base), timeout=180)
    assert codes == [0, 0, 0, 0], (codes, outs[0][-2000:])
    for attempt in ("first", "last"):
        out = str(tmp_path / f"supervised_{attempt}.npz")
        env = _worker_env(BIGDL_TEST_OUT=out,
                          BIGDL_TEST_CKPT=str(tmp_path /
                                              f"ckpt_{attempt}"),
                          BIGDL_FAULTS="peer_kill@6:p2", **base)
        sup = cluster.Supervisor(4, [sys.executable, WORKER],
                                 max_restarts=3,
                                 cluster_dir=str(tmp_path /
                                                 f"cl_{attempt}"),
                                 settle_grace=30.0, env=env,
                                 log_dir=str(tmp_path /
                                             f"logs_{attempt}"))
        rc = sup.run()
        first = sup.exit_history[0]
        if -signal.SIGKILL not in first and attempt == "first":
            # incarnation 0 died before iteration 6 (a startup infra
            # flake under suite load — the injected kill never fired,
            # so none of the kill-specific properties apply); the
            # supervisor itself must still have recovered the cluster
            assert rc == 0, (sup.exit_history, rc)
            continue
        assert rc == 0, sup.exit_history
        assert sup.restarts == 1, sup.exit_history
        assert -signal.SIGKILL in first, first  # the injected kill
        # every survivor EXITED (no hang): via its own watchdog (43)
        # or SIGABRTed by the jax runtime when the first watchdog
        # abort took the coordinator down — and at least one abort
        # came from the watchdog itself, within its settle window
        survivors = [c for c in first if c != -signal.SIGKILL]
        assert all(c in (cluster.EXIT_PEER_LOST, -signal.SIGABRT)
                   for c in survivors), first
        assert cluster.EXIT_PEER_LOST in first, first
        assert sup.exit_history[1] == [0, 0, 0, 0], sup.exit_history
        assert os.path.exists(out), \
            "restarted cluster must publish params"
        _assert_same_params(out, un)
        break


# -- capacity-aware width (supervise --min-n, ISSUE 12) ----------------------
def test_supervisor_min_n_shrinks_after_repeated_same_casualty(
        tmp_path, monkeypatch):
    """Two consecutive incarnations dying on the SAME peer slot = the
    host isn't coming back: the next incarnation launches DEGRADED at
    --min-n instead of burning the restart budget at a doomed width."""
    monkeypatch.setenv("BIGDL_RETRY_BACKOFF", "0.01")
    body = ("import os, sys\n"
            "sys.exit(9 if os.environ['BIGDL_NUM_PROCESSES'] == '4' "
            "and os.environ['BIGDL_PROCESS_ID'] == '2' else 0)\n")
    sup = cluster.Supervisor(4, _toy_worker(body), max_restarts=3,
                             cluster_dir=str(tmp_path / "cl"),
                             settle_grace=5.0, min_nprocs=2)
    assert sup.run() == 0
    assert sup.width_history == [4, 4, 2]
    assert sup.restarts == 2
    assert [len(c) for c in sup.exit_history] == [4, 4, 2]
    assert sup.exit_history[0][2] == 9 and sup.exit_history[1][2] == 9
    assert sup.exit_history[2] == [0, 0]


def test_supervisor_min_n_grows_back_after_degraded_failure(
        tmp_path, monkeypatch):
    """A failure at degraded width retries the FULL -n first (capacity
    may have returned) — the cluster is never pinned small forever by a
    stale casualty verdict."""
    monkeypatch.setenv("BIGDL_RETRY_BACKOFF", "0.01")
    body = ("import os, sys\n"
            "n = os.environ['BIGDL_NUM_PROCESSES']\n"
            "pid = os.environ['BIGDL_PROCESS_ID']\n"
            "inc = os.environ['BIGDL_SUPERVISOR_INCARNATION']\n"
            "if n == '4' and pid == '2' and inc in ('0', '1'):\n"
            "    sys.exit(9)\n"
            "sys.exit(5 if n == '2' else 0)\n")
    sup = cluster.Supervisor(4, _toy_worker(body), max_restarts=4,
                             cluster_dir=str(tmp_path / "cl"),
                             settle_grace=5.0, min_nprocs=2)
    assert sup.run() == 0
    assert sup.width_history == [4, 4, 2, 4]
    assert sup.exit_history[3] == [0, 0, 0, 0]


def test_supervisor_min_n_distinct_casualties_do_not_shrink(
        tmp_path, monkeypatch):
    """Different slots dying in consecutive incarnations is churn, not
    a missing host — the width stays declared."""
    monkeypatch.setenv("BIGDL_RETRY_BACKOFF", "0.01")
    body = ("import os, sys\n"
            "inc = os.environ['BIGDL_SUPERVISOR_INCARNATION']\n"
            "pid = os.environ['BIGDL_PROCESS_ID']\n"
            "sys.exit(9 if (inc, pid) in (('0', '1'), ('1', '2')) "
            "else 0)\n")
    sup = cluster.Supervisor(3, _toy_worker(body), max_restarts=3,
                             cluster_dir=str(tmp_path / "cl"),
                             settle_grace=5.0, min_nprocs=1)
    assert sup.run() == 0
    assert sup.width_history == [3, 3, 3]


def test_supervisor_shed_exit_is_clean_completion(tmp_path, monkeypatch):
    """A ``shed.p<idx>.json`` marker (the staleness barrier's verdict,
    parallel/local_sync.py) makes that slot's exit-43 a PLANNED
    departure: survivors finishing 0 means the cluster COMPLETED
    (degraded) — no restart, exit 0."""
    monkeypatch.setenv("BIGDL_RETRY_BACKOFF", "0.01")
    body = ("import json, os, sys\n"
            "d = os.environ['BIGDL_CLUSTER_DIR']\n"
            "if os.environ['BIGDL_PROCESS_ID'] == '1':\n"
            "    with open(os.path.join(d, 'shed.p1.json'), 'w') as f:\n"
            "        json.dump({'peer': 1, 'by': 0, 'round': 3,\n"
            "                   'lag': 2, 'stale': 2}, f)\n"
            f"    sys.exit({cluster.EXIT_PEER_LOST})\n"
            "sys.exit(0)\n")
    sup = cluster.Supervisor(3, _toy_worker(body), max_restarts=2,
                             cluster_dir=str(tmp_path / "cl"),
                             settle_grace=5.0)
    assert sup.run() == 0
    assert sup.restarts == 0
    assert sup.width_history == [3]
    assert sup.exit_history == [[0, cluster.EXIT_PEER_LOST, 0]]


def test_supervisor_shed_failure_shrinks_to_min_n_immediately(
        tmp_path, monkeypatch):
    """Shrink-then-grow-back wiring for the shed verdict: a shed marker
    is an AFFIRMATIVE "this host is not coming back", so when the
    incarnation still fails the supervisor relaunches DEGRADED at
    ``--min-n`` at once — no two-round same-casualty signature needed."""
    monkeypatch.setenv("BIGDL_RETRY_BACKOFF", "0.01")
    body = ("import json, os, sys\n"
            "pid = os.environ['BIGDL_PROCESS_ID']\n"
            "d = os.environ['BIGDL_CLUSTER_DIR']\n"
            "if os.environ['BIGDL_NUM_PROCESSES'] == '3':\n"
            "    if pid == '1':\n"
            "        with open(os.path.join(d, 'shed.p1.json'), 'w') "
            "as f:\n"
            "            json.dump({'peer': 1, 'by': 0}, f)\n"
            f"        sys.exit({cluster.EXIT_PEER_LOST})\n"
            "    if pid == '0':\n"
            "        sys.exit(9)\n"
            "sys.exit(0)\n")
    sup = cluster.Supervisor(3, _toy_worker(body), max_restarts=3,
                             cluster_dir=str(tmp_path / "cl"),
                             settle_grace=5.0, min_nprocs=2)
    assert sup.run() == 0
    assert sup.restarts == 1
    assert sup.width_history == [3, 2], sup.exit_history
    assert sup.exit_history[1] == [0, 0]


def test_supervisor_min_n_validation():
    with pytest.raises(ValueError, match="min_nprocs"):
        cluster.Supervisor(4, _toy_worker("pass"), min_nprocs=5)
    with pytest.raises(ValueError, match="min_nprocs"):
        cluster.Supervisor(4, _toy_worker("pass"), min_nprocs=0)


@pytest.mark.deadline(420)
@pytest.mark.slow
def test_supervised_peer_kill_min_n_recovers_at_reduced_width(tmp_path):
    """The ISSUE 12 acceptance path: on the live 4-process cluster a
    kept ``peer_kill@6:p2`` fault models a host that NEVER comes back
    (it fires in every full-width incarnation).  With ``--min-n 2`` the
    supervisor relaunches DEGRADED at width 2 after two consecutive
    losses of the same peer, the width-2 workers restore the width-4
    BTPU checkpoint (topology-portable — announced as cluster/reshard),
    and the finished run's params equal an uninterrupted run's, with
    zero manual intervention."""
    base = dict(BIGDL_TEST_ITERS=8, BIGDL_TEST_CKPT_EVERY=4,
                BIGDL_CLUSTER_DEADLINE=6, BIGDL_HEARTBEAT_INTERVAL=0.2,
                BIGDL_ASYNC_CHECKPOINT=0, BIGDL_RETRY_BACKOFF=0.05)
    un = str(tmp_path / "un.npz")
    codes, outs = _wait_all(_launch_cluster(
        2, BIGDL_TEST_OUT=un, BIGDL_TEST_CKPT=str(tmp_path / "ckpt_un"),
        BIGDL_CLUSTER_DIR=str(tmp_path / "hb_un"), **base), timeout=120)
    assert codes == [0, 0], (codes, outs[0][-2000:], outs[1][-2000:])
    tele = tmp_path / "tele"
    out = str(tmp_path / "degraded.npz")
    env = _worker_env(BIGDL_TEST_OUT=out,
                      BIGDL_TEST_CKPT=str(tmp_path / "ckpt"),
                      BIGDL_TELEMETRY=str(tele),
                      BIGDL_FAULTS="peer_kill@6:p2", **base)
    sup = cluster.Supervisor(4, [sys.executable, WORKER],
                             max_restarts=3, min_nprocs=2,
                             keep_faults=True,  # the host NEVER returns
                             cluster_dir=str(tmp_path / "cl"),
                             settle_grace=30.0, env=env,
                             log_dir=str(tmp_path / "logs"))
    rc = sup.run()
    assert rc == 0, sup.exit_history
    killed_incs = [i for i, codes in enumerate(sup.exit_history)
                   if -signal.SIGKILL in codes]
    if not killed_incs:
        # startup infra flake under suite load: the injected kill never
        # fired, so none of the width properties apply — the supervisor
        # itself still recovered the cluster
        return
    # two full-width incarnations lost the same peer, then the degraded
    # width-2 incarnation finished the job
    assert sup.width_history[:2] == [4, 4], sup.width_history
    assert sup.width_history[-1] == 2, sup.width_history
    assert sup.exit_history[-1] == [0, 0], sup.exit_history
    assert os.path.exists(out), "degraded cluster must publish params"
    # mixed-width trajectory (iters 1-4 at width 4, 5-8 at width 2) vs
    # the width-2 uninterrupted control: the cross-width tolerance the
    # process-count-invariance tests (tests/test_multihost.py) pin
    _assert_same_params(out, un, tol=2e-4)
    # the width-2 workers announced the reshard on restore
    by_proc = _events_by_process(str(tele))
    marks = [e for events in by_proc.values() for e in events
             if e["name"] == "cluster/reshard"]
    assert marks, "no cluster/reshard instant in the degraded run logs"
    assert any(e.get("from_processes") == 4 and e.get("to_processes") == 2
               for e in marks), marks


def test_supervisor_min_n_signature_survives_racing_survivors(
        tmp_path, monkeypatch):
    """Review hardening: which SURVIVOR reacts how is a race (watchdog
    43 vs gloo connection-reset generic exit), so the casualty sets of
    consecutive incarnations need not be EQUAL — the persistent slot
    (their intersection) is the missing host, and the shrink must still
    fire."""
    monkeypatch.setenv("BIGDL_RETRY_BACKOFF", "0.01")
    body = ("import os, sys\n"
            "n = os.environ['BIGDL_NUM_PROCESSES']\n"
            "pid = os.environ['BIGDL_PROCESS_ID']\n"
            "inc = os.environ['BIGDL_SUPERVISOR_INCARNATION']\n"
            "if n == '4' and pid == '2':\n"
            "    sys.exit(9)  # the host that never comes back\n"
            "if (inc, pid) in (('0', '1'), ('1', '3')):\n"
            "    sys.exit(7)  # a racing survivor, different each round\n"
            "sys.exit(0)\n")
    sup = cluster.Supervisor(4, _toy_worker(body), max_restarts=3,
                             cluster_dir=str(tmp_path / "cl"),
                             settle_grace=5.0, min_nprocs=2)
    assert sup.run() == 0
    assert sup.width_history == [4, 4, 2]
    assert sup.exit_history[2] == [0, 0]
