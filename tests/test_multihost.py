"""Multi-host runtime tests (VERDICT r1 item 1).

The reference coordinates N executors through Spark
(``utils/Engine.scala:93-106,344-418``); the TPU build joins processes via
``jax.distributed`` and feeds per-process shards of the global batch.
These tests spin up a REAL 2-process CPU cluster (each process with 2
virtual devices -> a 4-device global mesh) and assert it trains to the
same weights as a single process — the reference's RefDistriOptimizer
equivalence discipline (SURVEY §4) applied across a process boundary.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

# the flock-serialized allocator with the recent-port ledger: two tests
# (or two pytest workers) grabbing ports back-to-back can otherwise race
# the same ephemeral port into both clusters (deflake, ISSUE 20)
from bigdl_tpu.parallel.cluster import _free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _worker_env(**extra) -> dict:
    # the worker sets its own XLA_FLAGS/platform before importing jax
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["BIGDL_REPO"] = REPO
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _run_cluster(tmp_path, tag: str, nproc: int = 2, expect_out: bool = True,
                 timeout: int = 420, codes=None, **extra) -> str:
    """Run the worker on an ``nproc``-process cluster; return the
    coordinator's saved-params path.  ``expect_out=False`` for runs that
    legitimately end without publishing params (graceful preemption).
    ``codes`` maps process index -> expected returncode for runs where a
    nonzero exit IS the asserted behavior (a shed straggler exits 43).
    The generous default ``timeout`` is deliberate: these tests spin
    real jax.distributed clusters and must stay green on loaded CI
    machines (deflake budget, ISSUE 5)."""
    port = _free_port()
    out = str(tmp_path / f"{tag}.npz")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER],
            env=_worker_env(BIGDL_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                            BIGDL_NUM_PROCESSES=nproc, BIGDL_PROCESS_ID=pid,
                            BIGDL_TEST_OUT=out, **extra),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(nproc)
    ]
    outputs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=timeout)
            outputs.append(stdout.decode(errors="replace"))
    finally:
        for p in procs:  # a hung collective must not leak live workers
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, text) in enumerate(zip(procs, outputs)):
        want = (codes or {}).get(pid, 0)
        assert p.returncode == want, (
            f"cluster worker p{pid} exited {p.returncode} "
            f"(expected {want}):\n{text[-4000:]}")
    if expect_out:
        assert os.path.exists(out), "coordinator did not write params"
    return out


def _run_single(tmp_path, tag: str, **extra) -> str:
    out = str(tmp_path / f"{tag}.npz")
    r = subprocess.run([sys.executable, WORKER],
                       env=_worker_env(BIGDL_TEST_OUT=out, **extra),
                       capture_output=True, timeout=420)
    text = r.stdout.decode(errors="replace") + r.stderr.decode(errors="replace")
    assert r.returncode == 0, f"single-process worker failed:\n{text[-4000:]}"
    return out


def _assert_same_params(path_a: str, path_b: str):
    a, b = np.load(path_a), np.load(path_b)
    assert set(a.files) == set(b.files) and len(a.files) > 0
    for k in a.files:
        np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=1e-5,
                                   err_msg=f"param {k} diverged")


@pytest.mark.deadline(60)
def test_two_process_training_matches_single_process(tmp_path):
    mp = _run_cluster(tmp_path, "mp")
    sp = _run_single(tmp_path, "sp")
    _assert_same_params(mp, sp)


@pytest.mark.deadline(68)
def test_four_process_training_matches_single_process(tmp_path):
    """Scale the control-plane test to 4 processes (4 x 2 virtual devices
    = an 8-device global mesh): the trajectory must still match the
    single process — the multi-host path's behavior is process-count
    invariant, the property pod-scale training rests on."""
    mp = _run_cluster(tmp_path, "mp4", nproc=4)
    sp = _run_single(tmp_path, "sp4")
    _assert_same_params(mp, sp)


@pytest.mark.deadline(60)
def test_two_process_sparse_sync_matches_dense_single_process(tmp_path):
    """The sparse-sync acceptance (ISSUE 15, docs/sparse.md) on the
    REAL 2-process gloo cluster: the embedding classifier trained under
    the row-sparse (indices, rows) sync equals the single-process run
    forced DENSE (``BIGDL_SPARSE=off``) — cross-process sync exactness
    and sparse-vs-dense numerics in one trajectory, duplicate indices
    and the padding index included."""
    mp = _run_cluster(tmp_path, "mp_sparse", BIGDL_TEST_SPARSE=1)
    sp = _run_single(tmp_path, "sp_sparse", BIGDL_TEST_SPARSE=1,
                     BIGDL_SPARSE="off")
    _assert_same_params(mp, sp)


@pytest.mark.deadline(60)
def test_two_process_zero1_matches_single_process(tmp_path):
    """ZeRO-1 optimizer-state sharding across the process boundary."""
    mp = _run_cluster(tmp_path, "mp_z1", BIGDL_TEST_ZERO1=1)
    sp = _run_single(tmp_path, "sp_z1")
    _assert_same_params(mp, sp)


@pytest.mark.deadline(63)
def test_two_process_fsdp_matches_single_process(tmp_path):
    """ZeRO-3: the PARAMETERS shard across the process boundary — no
    process holds a whole replica — and the trajectory still equals the
    single-process run (gather_replicated reassembles for the save)."""
    mp = _run_cluster(tmp_path, "mp_fsdp", BIGDL_TEST_FSDP=1)
    sp = _run_single(tmp_path, "sp_fsdp")
    _assert_same_params(mp, sp)


@pytest.mark.deadline(60)
def test_two_process_checkpoint_single_writer(tmp_path):
    """Checkpointing on a cluster: every process participates in the
    gathers but only the coordinator writes files."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    _run_cluster(tmp_path, "mp_ck", BIGDL_TEST_CKPT=str(ckpt))
    files = sorted(os.listdir(ckpt))
    assert any(f.startswith("model.") for f in files), files
    assert any(f.startswith("optimMethod.") for f in files), files


@pytest.mark.deadline(60)
def test_two_process_batch_feed_non_dp_layouts(tmp_path):
    """shard_local_batch must scale the global batch by how far the DATA
    axis spans processes, not by the raw process count (a multi-host
    model-parallel mesh feeds the full batch from every process)."""
    _run_cluster(tmp_path, "mp_scale", BIGDL_TEST_PROBE_SCALE=1)


def test_distributed_dataset_shards_partition():
    """Per-process shards cover the dataset exactly once."""
    from bigdl_tpu.dataset.dataset import DistributedDataSet

    data = list(range(10))
    shards = [DistributedDataSet(data, num_shards=3, shard_index=i)
              for i in range(3)]
    seen = sorted(x for s in shards for x in s._data)
    assert seen == data
    assert all(s.global_size() == 10 for s in shards)


def test_engine_single_process_defaults():
    from bigdl_tpu.utils.engine import Engine

    assert Engine.process_count() == 1
    assert Engine.process_index() == 0
    assert Engine.is_coordinator()
    assert len(Engine.local_devices()) == Engine.device_count()


@pytest.mark.deadline(600)
@pytest.mark.slow
def test_two_process_preempt_resume_matches_uninterrupted(tmp_path):
    """The ISSUE 5 acceptance path: SIGTERM mid-run on the 2-process
    cluster, restart the cluster, and the resumed run's final params
    equal an uninterrupted run's — byte-for-byte training continuity
    across a preemption boundary.

    The SIGTERM is delivered by the fault plan (``preempt@6``: every
    worker signals ITSELF at the start of iteration 6 — the shape of a
    TPU-slice preemption notice, where every host gets the signal), so
    the kill lands mid-epoch-2 deterministically instead of racing the
    test harness against the training loop.  The grace handler finishes
    iteration 6, commits a final checkpoint whose meta carries the
    dataset/epoch position + RNG state, and the workers exit 0 WITHOUT
    publishing params.  The restarted cluster auto-resumes from that
    checkpoint, fast-forwards 32 records into epoch 2, and runs
    iterations 7 and 8."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    base = dict(BIGDL_TEST_ITERS=8, BIGDL_TEST_CKPT_EVERY=4)
    # 8 iterations x global batch 16 over 64 records = 2 epochs; epoch 2
    # is SHUFFLED (deterministically by (seed, epoch)) so the resume
    # must reproduce the mid-epoch order, not just a fresh epoch
    un = _run_cluster(tmp_path, "preempt_un",
                      BIGDL_TEST_CKPT=str(tmp_path / "ckpt_un"), **base)
    pre = _run_cluster(tmp_path, "preempt_pre", expect_out=False,
                       BIGDL_TEST_CKPT=str(ckpt),
                       BIGDL_FAULTS="preempt@6", **base)
    assert not os.path.exists(pre), "preempted run must not publish params"
    # final checkpoint landed at the preempted iteration
    assert any(f.startswith("model.6") for f in os.listdir(ckpt)), \
        sorted(os.listdir(ckpt))
    resumed = _run_cluster(tmp_path, "preempt_res",
                           BIGDL_TEST_CKPT=str(ckpt), **base)
    _assert_same_params(resumed, un)


@pytest.mark.deadline(60)
def test_two_process_fleet_observability_blames_slow_host(tmp_path):
    """The ISSUE 10 acceptance path, one live 2-process run covering the
    whole comms/fleet stack: process 1 carries a 250 ms/batch
    data-pipeline stall injected by the ``straggle`` fault plan (the
    deterministic slow-host kind, bigdl_tpu/faults.py — the test-only
    slow-host env knobs are gone), both workers write telemetry into ONE
    shared dir, and

    - the coordinator's live ``/status`` shows the ``fleet`` block with
      per-host rows and ``bigdl_fleet_*`` gauges on ``/metrics``
      (asserted inside the worker — FLEET_STATUS_OK);
    - both run logs validate against the schema, including the new
      ``comms`` events with nonzero collective bytes on the sharded
      step and the coordinator's ``cluster/skew`` instants;
    - the one-shot fleet view over the dir blames p1 with cause
      ``data_wait`` — not p0, whose inflated compute is just the
      collective waiting on the straggler."""
    tele = tmp_path / "tele"
    tele.mkdir()
    _run_cluster(tmp_path, "fleet",
                 BIGDL_TEST_FLEET=1, BIGDL_TEST_ITERS=10,
                 BIGDL_FAULTS="straggle@1:p1:250",
                 BIGDL_TELEMETRY=str(tele), BIGDL_METRICS_PORT=0,
                 BIGDL_FLEET_INTERVAL="0.3")
    import glob

    from bigdl_tpu.telemetry import schema
    from bigdl_tpu.telemetry.fleet import fleet_view

    logs = sorted(glob.glob(str(tele / "run-*.jsonl")))
    assert len(logs) == 2, logs
    loaded = []
    by_pidx = {}
    for path in logs:
        events, parse_errors = schema.read_events(path)
        assert parse_errors == [], parse_errors
        assert schema.validate_events(events) == [], path
        loaded.append((path, events))
        pidx = next(e["meta"].get("process_index") for e in events
                    if e.get("kind") == "run_start")
        by_pidx[pidx] = events
    # comms events with nonzero collective bytes on the sharded step
    for pidx, events in by_pidx.items():
        comms = [e for e in events if e.get("kind") == "comms"]
        assert comms, f"p{pidx} emitted no comms event"
        assert comms[-1]["bytes"] > 0 and comms[-1]["count"] > 0
        assert "data" in comms[-1].get("by_axis", {}), comms[-1]
    # the coordinator's live watcher called the divergence
    skews = [e for e in by_pidx[0]
             if e.get("kind") == "event" and e.get("name") == "cluster/skew"]
    assert skews, "coordinator emitted no cluster/skew instant"
    assert skews[-1]["laggard"] == 1 and skews[-1]["cause"] == "data_wait"
    # the one-shot fleet view reaches the same verdict
    view = fleet_view(loaded)
    assert set(view["hosts"]) == {"p0", "p1"}
    verdict = view["blame"]
    assert verdict is not None, view
    assert verdict["laggard"] == 1 and verdict["cause"] == "data_wait", \
        verdict


@pytest.mark.deadline(73)
def test_two_process_local_sgd_sheds_straggler(tmp_path):
    """The ISSUE 20 acceptance path — straggler-tolerant local SGD on a
    REAL 2-process cluster: both workers train with
    ``parameter_sync=local`` (H=4 local steps between averaging rounds,
    staleness bound S=2), and the fault plan makes p1 a persistent
    250 ms/fetch straggler from fetch 4 on (``straggle@4:p1:250``).
    p1's averaging rounds fall behind; when its lag hits S and it fails
    to catch up within the grace window, the SURVIVOR sheds it:

    - p0 finishes all iterations and publishes finite, actually-trained
      params (exit 0); p1 reads its shed marker and exits 43
      (EXIT_PEER_LOST — the planned-departure code the supervisor
      treats as clean);
    - both run logs validate against the schema and carry the shed
      protocol: ``cluster/shed`` from the survivor (role=survivor,
      peer=1) AND from the victim (role=victim), ``sync/average``
      rounds, and ``sync/staleness`` with the grace wait the ledger
      charges to straggler badput;
    - p1's final heartbeat status is ``shed`` — peers read the exit as
      planned, like done/preempted;
    - the fleet view blames p1 with cause ``data_wait`` — the straggle
      delay lands in the data pipeline, exactly where the blame
      machinery looks."""
    import glob
    import json

    tele = tmp_path / "tele_shed"
    tele.mkdir()
    cluster = tmp_path / "cluster_shed"
    cluster.mkdir()
    base = dict(BIGDL_TEST_LOCAL_SYNC=1, BIGDL_TEST_ITERS=32,
                BIGDL_LOCAL_SYNC_H=4, BIGDL_LOCAL_SYNC_STALE=2,
                BIGDL_LOCAL_SYNC_GRACE="0.5",
                BIGDL_HEARTBEAT_INTERVAL="0.2")
    healthy = _run_cluster(
        tmp_path, "shed_healthy",
        BIGDL_CLUSTER_DIR=str(tmp_path / "cluster_healthy"), **base)
    out = _run_cluster(
        tmp_path, "shed", codes={1: 43},
        BIGDL_FAULTS="straggle@4:p1:250",
        BIGDL_CLUSTER_DIR=str(cluster),
        BIGDL_TELEMETRY=str(tele), **base)

    def dataset_nll(path):
        # the worker's exact data (rng order matters) pushed through its
        # MLP host-side: the whole-dataset loss, not one noisy batch
        z = np.load(path)
        rng = np.random.RandomState(0)
        x = rng.randn(64, 8).astype(np.float32)
        y = rng.randint(0, 4, 64)
        h = np.tanh(x @ z["0.weight"].T + z["0.bias"])
        logits = h @ z["2.weight"].T + z["2.bias"]
        m = logits.max(axis=1, keepdims=True)
        logp = logits - m - np.log(
            np.exp(logits - m).sum(axis=1, keepdims=True))
        return float(-logp[np.arange(64), y].mean())

    # the survivor's params are finite and actually trained: the run
    # that shed its slow half must land within tolerance of the healthy
    # 2-process run (it saw half the data from the shed point on)
    z = np.load(out)
    for k in z.files:
        assert np.isfinite(z[k]).all(), f"non-finite {k}"
    shed_nll, healthy_nll = dataset_nll(out), dataset_nll(healthy)
    init_nll = np.log(4.0)
    assert shed_nll < init_nll - 0.05, (shed_nll, init_nll)
    assert shed_nll < healthy_nll + 0.15, (shed_nll, healthy_nll)
    # the victim's heartbeat closed with the PLANNED-departure status
    hb = json.load(open(cluster / "heartbeat.p1.json"))
    assert hb["status"] == "shed", hb
    # the shed marker names the survivor's verdict
    marker = json.load(open(cluster / "shed.p1.json"))
    assert marker["peer"] == 1 and marker["by"] == 0, marker
    assert marker["lag"] >= marker["stale"] == 2, marker

    from bigdl_tpu.telemetry import schema
    from bigdl_tpu.telemetry.fleet import fleet_view

    logs = sorted(glob.glob(str(tele / "run-*.jsonl")))
    assert len(logs) == 2, logs
    loaded, by_pidx = [], {}
    for path in logs:
        events, parse_errors = schema.read_events(path)
        assert parse_errors == [], parse_errors
        assert schema.validate_events(events) == [], path
        loaded.append((path, events))
        pidx = next(e["meta"].get("process_index") for e in events
                    if e.get("kind") == "run_start")
        by_pidx[pidx] = events

    def named(events, name):
        return [e for e in events if e.get("kind") == "event"
                and e.get("name") == name]

    # both sides of the shed protocol announced themselves
    survivor = named(by_pidx[0], "cluster/shed")
    assert survivor and survivor[-1]["role"] == "survivor" \
        and survivor[-1]["peer"] == 1, survivor
    victim = named(by_pidx[1], "cluster/shed")
    assert victim and victim[-1]["role"] == "victim" \
        and victim[-1]["peer"] == 1, victim
    # averaging rounds ran, and the survivor paid a grace wait at least
    # once before the shed (the wait the ledger charges to straggler)
    assert named(by_pidx[0], "sync/average"), "no averaging rounds"
    waits = [e for e in named(by_pidx[0], "sync/staleness")
             if e.get("waited_s", 0) > 0]
    assert waits, "survivor never held the door before shedding"
    # the fleet view reaches the blame verdict the shed acted on
    view = fleet_view(loaded)
    verdict = view["blame"]
    assert verdict is not None, view
    assert verdict["laggard"] == 1 and verdict["cause"] == "data_wait", \
        verdict


@pytest.mark.deadline(63)
def test_two_process_sharded_validation_matches_full(tmp_path):
    """Validation shards round-robin over processes and merges
    collectively (optim/DistriValidator.scala:35 re-scope): the cluster's
    merged score must equal the single process evaluating the FULL set,
    and the trained weights must stay equivalent."""
    mp = _run_cluster(tmp_path, "mp_val", BIGDL_TEST_SHARDED_VAL=1)
    sp = _run_single(tmp_path, "sp_val", BIGDL_TEST_SHARDED_VAL=1)
    a, b = np.load(mp), np.load(sp)
    np.testing.assert_allclose(a["__score"], b["__score"], rtol=1e-6)
    _assert_same_params(mp, sp)


@pytest.mark.deadline(600)
@pytest.mark.slow
def test_four_process_preempt_resume_on_two_matches_uninterrupted(tmp_path):
    """The ISSUE 12 acceptance path — the PR-7 recovery contract
    GENERALIZED across mesh shapes: train on 4 processes, SIGTERM
    mid-epoch-2 (``preempt@6`` — the slice-wide preemption shape),
    then resume the SAME checkpoint dir on only 2 processes.  The
    checkpoint is topology-portable: the width-2 cluster restores the
    width-4 state (announced as a ``cluster/reshard`` instant),
    fast-forwards to the exact next global batch, and the final params
    equal the uninterrupted 4-process run's."""
    import glob

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    base = dict(BIGDL_TEST_ITERS=8, BIGDL_TEST_CKPT_EVERY=4)
    un = _run_cluster(tmp_path, "el_un", nproc=4,
                      BIGDL_TEST_CKPT=str(tmp_path / "ckpt_un"), **base)
    pre = _run_cluster(tmp_path, "el_pre", nproc=4, expect_out=False,
                       BIGDL_TEST_CKPT=str(ckpt),
                       BIGDL_FAULTS="preempt@6", **base)
    assert not os.path.exists(pre), "preempted run must not publish params"
    assert any(f.startswith("model.6") for f in os.listdir(ckpt)), \
        sorted(os.listdir(ckpt))
    tele = tmp_path / "tele_el"
    resumed = _run_cluster(tmp_path, "el_res", nproc=2,
                           BIGDL_TEST_CKPT=str(ckpt),
                           BIGDL_TELEMETRY=str(tele), **base)
    _assert_same_params(resumed, un)
    # both width-2 workers restored the width-4 checkpoint and said so
    from bigdl_tpu.telemetry.schema import read_events

    marks = []
    for path in glob.glob(str(tele / "run-*.jsonl")):
        events, _errs = read_events(path)
        marks += [e for e in events if e.get("kind") == "event"
                  and e.get("name") == "cluster/reshard"]
    assert len(marks) == 2, marks
    assert all(e["from_processes"] == 4 and e["to_processes"] == 2
               for e in marks), marks
