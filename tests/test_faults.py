"""Fault-matrix suite (ISSUE 5): every ``FaultPlan`` kind, injected into
a seeded run, must either RECOVER (the run completes, the final loss is
finite, and — for the crash/preempt/kill classes, whose recovery path
replays the exact interrupted trajectory — the final params match the
no-fault run) or HALT WITH EVIDENCE (``HealthError`` + flight dump).
Torn checkpoints must never be partially loaded: restore verifies the
content digests and either loads fully or quarantines and falls back to
the previous good step; ``prune_old`` never deletes the last
verified-good checkpoint."""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import bigdl_tpu.nn as nn
import bigdl_tpu.optim as optim
from bigdl_tpu import faults, telemetry
from bigdl_tpu.dataset.sample import Sample
from bigdl_tpu.nn.module import state_dict
from bigdl_tpu.optim.trigger import Trigger
from bigdl_tpu.telemetry.health import HealthError
from bigdl_tpu.utils.config import set_config
from bigdl_tpu.utils.rng import RNG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def setup_function(_fn):
    faults.reset()


def teardown_function(_fn):
    telemetry.end_run()
    set_config(None)
    faults.reset()


def _instants(sink, name):
    return [e for e in sink.events
            if e.get("kind") == "event" and e.get("name") == name]


def _data(n=64, dim=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    return [Sample(x[i], np.int64(y[i])) for i in range(n)]


def _optimizer(tmp_path, iters=8, ckpt_every=2, backend="btpu", seed=11,
               lr=0.1):
    RNG.set_seed(seed)
    model = nn.Sequential(nn.Linear(4, 16), nn.Tanh(),
                          nn.Linear(16, 2), nn.LogSoftMax())
    o = optim.LocalOptimizer(model, _data(), nn.ClassNLLCriterion(),
                             batch_size=16,
                             end_trigger=Trigger.max_iteration(iters))
    o.set_optim_method(optim.SGD(learning_rate=lr, momentum=0.9))
    if ckpt_every:
        o.set_checkpoint(str(tmp_path), Trigger.several_iteration(ckpt_every),
                         backend=backend)
        o.overwrite_checkpoint()
    return o


def _run(tmp_path, monkeypatch, fault_spec="", sink=None, **env):
    """One seeded training run under a fault plan; returns (optimizer,
    final params dict)."""
    monkeypatch.setenv("BIGDL_RETRY_BACKOFF", "0.05")  # fast matrix
    if fault_spec:
        monkeypatch.setenv("BIGDL_FAULTS", fault_spec)
    else:
        monkeypatch.delenv("BIGDL_FAULTS", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    faults.reset()
    o = _optimizer(tmp_path)
    if sink is not None:
        with telemetry.run(sinks=[sink]):
            trained = o.optimize()
    else:
        trained = o.optimize()
    return o, {k: np.asarray(v) for k, v in state_dict(
        trained, kind="param").items()}


def _assert_params_equal(a, b, tol=1e-6):
    assert set(a) == set(b) and a
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol,
                                   err_msg=f"param {k} diverged")


# -- plan parsing ------------------------------------------------------------
def test_plan_parse_full_syntax():
    plan = faults.FaultPlan.parse(
        "crash@12,nan_grads@30,wedge@45,kill_worker@20:p1,torn_ckpt,"
        "data_err@7", seed=3)
    kinds = [(s.kind, s.step, s.process) for s in plan.specs]
    assert kinds == [("crash", 12, None), ("nan_grads", 30, None),
                     ("wedge", 45, None), ("kill_worker", 20, 1),
                     ("torn_ckpt", None, None), ("data_err", 7, None)]
    assert plan.has("torn_ckpt") and not plan.has("preempt")


def test_plan_rejects_bad_specs():
    for bad in ("explode@3", "crash@", "crash@x", "crash:px", "crash@3:q1"):
        with pytest.raises(ValueError, match="bad fault spec"):
            faults.FaultPlan.parse(bad)


def test_plan_parse_straggle_requires_delay():
    plan = faults.FaultPlan.parse("straggle@4:p1:250")
    s = plan.specs[0]
    assert (s.kind, s.step, s.process, s.ms) == ("straggle", 4, 1, 250)
    with pytest.raises(ValueError, match="straggle needs a delay"):
        faults.FaultPlan.parse("straggle@4:p1")
    with pytest.raises(ValueError, match="only straggle takes"):
        faults.FaultPlan.parse("crash@3:250")


def test_straggle_sleep_persists_and_announces_once():
    """Unlike every other kind, ``straggle`` is NOT exactly-once: a slow
    host stays slow, so every fetch from ``@step`` on is delayed; only
    the ``fault/injected`` announcement fires once."""
    plan = faults.FaultPlan.parse("straggle@3:250")
    sink = telemetry.MemorySink()
    with telemetry.run(sinks=[sink]):
        assert plan.straggle_sleep(1) == 0.0
        assert plan.straggle_sleep(2) == 0.0
        assert plan.straggle_sleep(3) == pytest.approx(0.25)
        assert plan.straggle_sleep(9) == pytest.approx(0.25)
    marks = _instants(sink, "fault/injected")
    assert len(marks) == 1 and marks[0]["fault"] == "straggle"
    # a :pP selector for another process never slows THIS one
    other = faults.FaultPlan.parse("straggle@1:p1:250")
    assert other.straggle_sleep(5) == 0.0
    # overlapping specs: the worst delay wins, not the sum
    both = faults.FaultPlan.parse("straggle@1:100,straggle@2:50")
    assert both.straggle_sleep(2) == pytest.approx(0.1)


def test_straggle_delays_data_iter_in_place():
    """The injection point: ``wrap_data_iter`` sleeps ON the fetching
    thread, so under prefetch the delay lands inside the ``data_wait``
    span that fleet blame attributes (telemetry/fleet.py)."""
    import time as _time

    plan = faults.FaultPlan.parse("straggle@2:60")
    it = plan.wrap_data_iter(iter([1, 2, 3]))
    t0 = _time.perf_counter()
    assert next(it) == 1
    fast = _time.perf_counter() - t0
    t1 = _time.perf_counter()
    assert list(it) == [2, 3]
    slow = _time.perf_counter() - t1
    assert slow >= 0.12 > fast


def test_bad_plan_fails_fast_not_retried(tmp_path, monkeypatch):
    """A typo'd BIGDL_FAULTS is a CONFIG error: optimize() must surface
    it immediately, not burn the retry budget on it."""
    monkeypatch.setenv("BIGDL_FAULTS", "kaboom@3")
    faults.reset()
    o = _optimizer(tmp_path, ckpt_every=0)
    with pytest.raises(ValueError, match="bad fault spec"):
        o.optimize()


def test_fault_fires_exactly_once():
    plan = faults.FaultPlan.parse("nan_grads@3")
    assert plan.grad_scale(2) == 1.0
    assert np.isnan(plan.grad_scale(3))
    assert plan.grad_scale(3) == 1.0  # already fired
    assert plan.grad_scale(4) == 1.0


def test_process_selector_gates_firing(monkeypatch):
    plan = faults.FaultPlan.parse("nan_grads@3:p1")
    # this test process is process_index 0 -> the p1 fault never fires
    assert plan.grad_scale(3) == 1.0
    assert not plan.specs[0].fired


# -- the matrix: recover-or-halt ---------------------------------------------
def test_crash_recovers_and_matches_no_fault_run(tmp_path, monkeypatch):
    """``crash@6``: the retry loop restores model.4, the resume replays
    iterations 5-8 on the SAME batches and step keys, and the final
    params equal the uninterrupted run's — crash-consistent restore is
    trajectory-exact, not merely 'finishes'."""
    _, want = _run(tmp_path / "clean", monkeypatch)
    sink = telemetry.MemorySink()
    o, got = _run(tmp_path / "faulty", monkeypatch, "crash@6", sink=sink)
    assert o.state["neval"] == 8
    assert np.isfinite(o.state["loss"])
    _assert_params_equal(got, want)
    injected = _instants(sink, "fault/injected")
    assert len(injected) == 1 and injected[0]["fault"] == "crash" \
        and injected[0]["step"] == 6
    retries = _instants(sink, "run/retry")
    assert len(retries) == 1 and retries[0]["backoff_s"] >= 0


def test_nan_grads_halts_with_flight_evidence(tmp_path, monkeypatch):
    """``nan_grads@3`` under the halt policy: the in-graph probe sees
    nonfinite GRADS at exactly step 3, the policy halts (HealthError is
    a verdict — never retried), and the flight recorder dumps the
    evidence."""
    tele_dir = tmp_path / "tele"
    o = None
    with pytest.raises(HealthError) as err:
        o, _ = _run(tmp_path, monkeypatch, "nan_grads@3",
                    BIGDL_HEALTH="halt", BIGDL_HEALTH_HALT_AFTER="1",
                    BIGDL_TELEMETRY=str(tele_dir))
    assert err.value.step == 3
    assert err.value.evidence["nonfinite_grads"] > 0
    dumps = [f for f in os.listdir(tele_dir) if f.startswith("flight-")]
    assert len(dumps) == 1
    payload = json.loads((tele_dir / dumps[0]).read_text())
    assert payload["reason"] == "health_halt"
    assert any(e.get("name") == "fault/injected"
               for e in payload["events"])


def test_nan_grads_skip_policy_recovers(tmp_path, monkeypatch):
    """Same poison under ``BIGDL_HEALTH=skip``: the in-graph select
    drops the poisoned update, params stay finite, the run completes."""
    sink = telemetry.MemorySink()
    o, got = _run(tmp_path, monkeypatch, "nan_grads@3", sink=sink,
                  BIGDL_HEALTH="skip")
    assert o.state["neval"] == 8
    assert np.isfinite(o.state["loss"])
    for k, v in got.items():
        assert np.isfinite(v).all(), f"param {k} went nonfinite"
    assert len(_instants(sink, "fault/injected")) == 1
    assert len(_instants(sink, "health/skip")) >= 1


def test_wedge_trips_straggler_watchdog_and_recovers(tmp_path, monkeypatch):
    """``wedge@3``: the iteration stalls inside the straggler-guarded
    region, the watchdog fires at the budget, the retry loop restores
    the step-2 checkpoint, and the run completes with a flight dump for
    the stall."""
    tele_dir = tmp_path / "tele"
    sink = telemetry.MemorySink()
    o, got = _run(tmp_path, monkeypatch, "wedge@3", sink=sink,
                  BIGDL_ITERATION_TIMEOUT="1.5",
                  BIGDL_TELEMETRY=str(tele_dir))
    assert o.state["neval"] == 8
    assert np.isfinite(o.state["loss"])
    assert len(_instants(sink, "fault/injected")) == 1
    assert len(_instants(sink, "straggler/timeout")) == 1
    dumps = [f for f in os.listdir(tele_dir) if f.startswith("flight-")]
    assert len(dumps) == 1  # the straggler firing dumped the lead-in


def test_data_err_relays_through_prefetch_and_recovers(tmp_path,
                                                       monkeypatch):
    """``data_err@5``: the injected fetch failure surfaces on the
    prefetch producer thread, relays to the driver exactly like a
    compute error, and the retry loop restores + completes."""
    sink = telemetry.MemorySink()
    o, _ = _run(tmp_path, monkeypatch, "data_err@5", sink=sink)
    assert o.state["neval"] == 8
    assert np.isfinite(o.state["loss"])
    injected = _instants(sink, "fault/injected")
    assert len(injected) == 1 and injected[0]["point"] == "data"
    assert len(_instants(sink, "run/retry")) == 1


def test_preempt_commits_final_checkpoint_and_resume_matches(tmp_path,
                                                             monkeypatch):
    """``preempt@5``: a REAL SIGTERM is delivered mid-run; the grace
    handler finishes iteration 5, commits a final checkpoint carrying
    the mid-epoch position + RNG state, and optimize() returns cleanly
    with ``preempted=True``.  A FRESH optimizer pointed at the same
    checkpoint dir auto-resumes and lands on the uninterrupted run's
    exact final params."""
    _, want = _run(tmp_path / "clean", monkeypatch)
    sink = telemetry.MemorySink()
    o, _ = _run(tmp_path / "ckpt", monkeypatch, "preempt@5", sink=sink)
    assert o.preempted
    assert o.state["neval"] == 5  # finished the in-flight step, no more
    assert any(f == "model.5" for f in os.listdir(tmp_path / "ckpt"))
    marks = _instants(sink, "run/preempted")
    assert len(marks) == 1 and marks[0]["step"] == 5 \
        and marks[0]["signum"] == signal.SIGTERM
    # fresh process analogue: new optimizer, same ckpt dir, no faults
    sink2 = telemetry.MemorySink()
    o2, got = _run(tmp_path / "ckpt", monkeypatch, sink=sink2)
    assert len(_instants(sink2, "run/resumed")) == 1
    assert o2.state["neval"] == 8
    _assert_params_equal(got, want)


def test_resume_off_disables_auto_resume(tmp_path, monkeypatch):
    o, _ = _run(tmp_path, monkeypatch, "preempt@5")
    assert o.preempted
    monkeypatch.setenv("BIGDL_RESUME", "off")
    o2, _ = _run(tmp_path, monkeypatch)
    # started from scratch: the full 8 iterations, no resumed marker
    assert "_resumed_from" not in o2.state


@pytest.mark.slow
def test_kill_worker_is_ungraceful_and_restart_resumes(tmp_path,
                                                       monkeypatch):
    """``kill_worker@4``: SIGKILL, no handler, no final checkpoint — the
    subprocess dies at the injected step; a restarted process resumes
    from the last TRIGGERED checkpoint and matches the uninterrupted
    run.  (Subprocess test: SIGKILL in-process would take pytest with
    it.)  Synchronous checkpointing pins the last committed step."""
    worker = os.path.join(REPO, "tests", "multihost_worker.py")
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()

    def run_single(tag, **extra):
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "BIGDL_FAULTS")}
        env.update(BIGDL_REPO=REPO, BIGDL_TEST_OUT=str(tmp_path / tag),
                   BIGDL_TEST_ITERS="6", BIGDL_ASYNC_CHECKPOINT="0",
                   **{k: str(v) for k, v in extra.items()})
        return subprocess.run([sys.executable, worker], env=env,
                              capture_output=True, timeout=420)

    r = run_single("clean.npz", BIGDL_TEST_CKPT=str(tmp_path / "ckpt_un"),
                   BIGDL_TEST_CKPT_EVERY=2)
    assert r.returncode == 0, r.stdout[-2000:]

    r = run_single("killed.npz", BIGDL_TEST_CKPT=str(ckpt),
                   BIGDL_TEST_CKPT_EVERY=2, BIGDL_FAULTS="kill_worker@4")
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stdout[-2000:])
    assert not (tmp_path / "killed.npz").exists()
    assert any(f.startswith("model.2") for f in os.listdir(ckpt))

    r = run_single("resumed.npz", BIGDL_TEST_CKPT=str(ckpt),
                   BIGDL_TEST_CKPT_EVERY=2)
    assert r.returncode == 0, r.stdout[-2000:]
    a = np.load(tmp_path / "clean.npz")
    b = np.load(tmp_path / "resumed.npz")
    assert set(a.files) == set(b.files) and len(a.files) > 0
    for k in a.files:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7,
                                   err_msg=f"param {k} diverged")


# -- torn checkpoints: verify, quarantine, fall back -------------------------
def test_torn_sharded_checkpoint_quarantined_and_fallback(tmp_path,
                                                          monkeypatch):
    """``torn_ckpt@4`` + ``crash@5``: the step-4 sharded checkpoint is
    torn AFTER its complete-marker committed (the tear the marker can't
    catch); the crash's restore verifies digests, quarantines sharded.4
    as ``*.corrupt``, falls back to sharded.2, and the run still
    completes — a torn checkpoint is never partially loaded."""
    monkeypatch.setenv("BIGDL_RETRY_BACKOFF", "0.05")
    monkeypatch.setenv("BIGDL_FAULTS", "torn_ckpt@4,crash@5")
    faults.reset()
    sink = telemetry.MemorySink()
    o = _optimizer(tmp_path, backend="sharded")
    with telemetry.run(sinks=[sink]):
        o.optimize()
    assert o.state["neval"] == 8
    names = sorted(os.listdir(tmp_path))
    assert "sharded.4.corrupt" in names, names
    assert "sharded.8" in names  # post-recovery checkpoints kept landing
    q = _instants(sink, "checkpoint/quarantined")
    assert len(q) == 1 and q[0]["path"].endswith("sharded.4")
    assert len(_instants(sink, "fault/injected")) == 2


def test_torn_btpu_checkpoint_quarantined_and_fallback(tmp_path,
                                                       monkeypatch):
    """Same story on the BTPU (gather-and-write) backend: ckptmeta
    digests reject the torn model.4, the pair moves to ``*.corrupt``,
    restore falls back to the step-2 pair, and the final params still
    match the no-fault run (trajectory-exact recovery)."""
    _, want = _run(tmp_path / "clean", monkeypatch)
    sink = telemetry.MemorySink()
    o, got = _run(tmp_path / "faulty", monkeypatch, "torn_ckpt@4,crash@5",
                  sink=sink)
    assert o.state["neval"] == 8
    names = sorted(os.listdir(tmp_path / "faulty"))
    assert "model.4.corrupt" in names, names
    q = _instants(sink, "checkpoint/quarantined")
    assert len(q) == 1 and q[0]["step"] == 4
    _assert_params_equal(got, want)


def test_restore_never_partially_loads_torn_sharded(tmp_path):
    """Direct API check: a bit-flipped shard makes restore_train_step
    raise BEFORE any state is touched — the step keeps its live params
    wholesale."""
    import jax

    from bigdl_tpu.parallel.train_step import TrainStep
    from bigdl_tpu.utils.sharded_ckpt import (CorruptCheckpointError,
                                              restore_train_step,
                                              save_train_step)

    RNG.set_seed(3)
    model = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 2),
                          nn.LogSoftMax())
    step = TrainStep(model, nn.ClassNLLCriterion(),
                     optim.SGD(learning_rate=0.1))
    x = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    step.run(x, np.zeros(8, np.int64), jax.random.key(0))
    d = str(tmp_path / "sharded.1")
    save_train_step(step, d, extra={"neval": 1})
    # flip payload bytes via the plan's own corruptor
    torn = faults.FaultPlan.parse("torn_ckpt")._corrupt_one_file(d)
    assert torn is not None and not torn.endswith(".json")
    before = {k: np.asarray(v) for k, v in step.params.items()}
    with pytest.raises(CorruptCheckpointError, match="digest mismatch"):
        restore_train_step(step, d)
    for k, v in step.params.items():
        np.testing.assert_array_equal(np.asarray(v), before[k])


def test_prune_old_keeps_last_verified_good(tmp_path):
    """Retention must never strand the run: when every checkpoint inside
    the keep window is torn, the newest verified-good one survives
    pruning even though it falls outside keep."""
    import jax

    from bigdl_tpu.parallel.train_step import TrainStep
    from bigdl_tpu.utils.sharded_ckpt import (latest_verified_step_dir,
                                              prune_old, save_train_step)

    RNG.set_seed(3)
    model = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 2),
                          nn.LogSoftMax())
    step = TrainStep(model, nn.ClassNLLCriterion(),
                     optim.SGD(learning_rate=0.1))
    x = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    for n in (2, 4):
        step.run(x, np.zeros(8, np.int64), jax.random.key(n))
        save_train_step(step, str(tmp_path / f"sharded.{n}"),
                        extra={"neval": n})
    faults.FaultPlan.parse("torn_ckpt")._corrupt_one_file(
        str(tmp_path / "sharded.4"))
    pruned = prune_old(str(tmp_path), keep=1)
    assert pruned == []  # sharded.2 is the last verified-good: retained
    assert sorted(os.listdir(tmp_path)) == ["sharded.2", "sharded.4"]
    # discovery falls back past the torn one (quarantining it)
    good = latest_verified_step_dir(str(tmp_path))
    assert good is not None and good.endswith("sharded.2")
    assert "sharded.4.corrupt" in os.listdir(tmp_path)
