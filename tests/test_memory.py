"""Memory observability (telemetry/memory.py, ISSUE 11).

Covers the scheduled-HLO liveness walker (category totals cross-checked
against ``Compiled.memory_analysis()`` within 10% on 2-device lenet AND
transformer steps — the acceptance criterion), the ZeRO-1 per-device
optimizer-state drop, the remat activations-at-peak drop, the per-step
``memory`` event and its knob, the fit-estimator CLI, OOM forensics
(flight dump + ``MemoryExhaustedError`` evidence), the serving
executor's per-bucket memory accounting, the fleet memory-pressure
note, and the diff/bench ``peak_hbm_bytes`` gates."""

import glob
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import bigdl_tpu.nn as nn
import bigdl_tpu.optim as optim
from bigdl_tpu import telemetry
from bigdl_tpu.parallel.mesh import make_mesh
from bigdl_tpu.parallel.train_step import TrainStep
from bigdl_tpu.telemetry import memory as tmem, schema
from bigdl_tpu.utils.config import BigDLConfig, set_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_config():
    set_config(None)
    yield
    set_config(None)


def _registry_step(name, batch, sync="allreduce", devices=2):
    from bigdl_tpu.models import registry

    mesh = make_mesh((devices,), ("data",),
                     devices=jax.devices()[:devices]) \
        if devices > 1 else None
    model = registry.build_model(name)
    spec = registry.input_spec(name, batch)
    criterion, tspec = registry.train_pieces(name, batch)
    step = TrainStep(model, criterion,
                     optim.SGD(learning_rate=0.01, momentum=0.9),
                     mesh=mesh, parameter_sync=sync)
    return step, spec, tspec


# -- acceptance: walker vs XLA's own memory_analysis -------------------------
@pytest.mark.parametrize("name,batch", [("lenet", 8), ("transformer", 2)])
def test_walker_categories_match_memory_analysis(name, batch):
    """The acceptance criterion: on the 2-device sharded lenet and
    transformer train steps, the walker's per-device argument total
    must MATCH XLA's (the ENTRY parameter shapes are post-SPMD), its
    liveness temp peak must land within 10% of XLA's buffer-assignment
    temp, and the donation detection must equal the alias bytes."""
    step, spec, tspec = _registry_step(name, batch)
    out = tmem.attribute_memory_train_step(step, spec, tspec)
    ma = out.get("memory_analysis")
    assert ma, "CPU backend stopped reporting memory_analysis"
    assert out["args_bytes"] == ma["argument_bytes"]
    assert abs(out["temp_peak_bytes"] - ma["temp_bytes"]) \
        / ma["temp_bytes"] < 0.10, (out["temp_peak_bytes"],
                                    ma["temp_bytes"])
    assert out["donated_bytes"] == ma["alias_bytes"]
    # the categories tile the argument total exactly
    cats = out["categories"]
    assert cats["params"] + cats["opt_state"] + cats["buffers"] \
        + cats["batch"] + cats["other"] == out["args_bytes"]
    # activations + workspace tile the live-at-peak temp
    assert cats["activations_at_peak"] + cats["workspace_at_peak"] \
        == out["temp_peak_bytes"]
    # named modules own real bytes and the table renders
    named = [r for r in out["rows"] if r["path"] != "(unattributed)"]
    assert named and sum(r["total_bytes"] for r in named) > 0
    text = tmem.format_memory(out)
    assert "per-device peak" in text and "by module" in text


def test_zero1_drops_per_device_optimizer_state():
    """ZeRO-1 ('sharded') shards the optimizer state over the data
    axis: the walker must show strictly lower PER-DEVICE opt-state
    bytes than the dense replicated layout — the arXiv 2004.13336
    claim made CI-checkable (exactly 1/2 on a 2-device mesh for the
    shardable leaves)."""
    outs = {}
    for sync in ("allreduce", "sharded"):
        step, spec, tspec = _registry_step("lenet", 8, sync=sync)
        outs[sync] = tmem.attribute_memory_train_step(step, spec, tspec)
    dense, zero = outs["allreduce"], outs["sharded"]
    assert zero["categories"]["opt_state"] \
        < dense["categories"]["opt_state"]
    # params stay replicated under ZeRO-1 — only the moments shrink
    assert zero["categories"]["params"] == dense["categories"]["params"]
    # the drop is visible per module too, not just in the totals
    zrows = {r["path"]: r for r in zero["rows"]}
    shrunk = [r for r in dense["rows"]
              if r["path"] in zrows and r["opt_bytes"]
              and zrows[r["path"]]["opt_bytes"] < r["opt_bytes"]]
    assert shrunk, "no module shows the per-device opt-state drop"


def test_remat_lowers_activations_at_peak():
    """A Remat-wrapped transformer block recomputes its forward in the
    backward instead of saving activations: the walker's
    activations-at-peak must drop (the recomputed ops carry the
    transpose() frame, so they read as backward workspace, and the
    saved residuals shrink to the block inputs)."""
    from bigdl_tpu import models

    def peak_acts(remat):
        model = models.build_transformer_lm(
            256, num_layers=2, embed_dim=128, num_heads=4, max_len=256,
            remat=remat)
        crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                           size_average=True)
        step = TrainStep(model, crit,
                         optim.SGD(learning_rate=0.01, momentum=0.9))
        x = jax.ShapeDtypeStruct((2, 256), np.int32)
        y = jax.ShapeDtypeStruct((2, 256), np.int32)
        out = tmem.attribute_memory_train_step(step, x, y)
        return out["categories"]["activations_at_peak"], out

    acts_plain, _ = peak_acts(False)
    acts_remat, out_remat = peak_acts(True)
    assert acts_remat < 0.5 * acts_plain, (acts_remat, acts_plain)
    # and the whole peak shrinks too — remat trades HBM for FLOPs
    assert out_remat["peak_bytes"] > 0


def test_scope_of_drops_bare_remat_frames():
    """jax.checkpoint inserts BARE checkpoint/rematted_computation
    frames; they are transform structure, not module scopes — a
    Remat-wrapped block's ops must fold onto the block's tree path."""
    from bigdl_tpu.telemetry.attribution import scope_of

    path, direction = scope_of(
        "jit(step)/jit(main)/transpose(jvp(2))/checkpoint/"
        "rematted_computation/0/fc1/dot_general")
    assert path == "2.0.fc1" and direction == "bwd"
    path, direction = scope_of(
        "jit(step)/jit(main)/jvp(3)/checkpoint/0/attn/dot_general")
    assert path == "3.0.attn" and direction == "fwd"


# -- the memory event + knob --------------------------------------------------
def _sharded_step_run(sink):
    mesh = make_mesh((2,), ("data",), devices=jax.devices()[:2])
    model = nn.Sequential(nn.Linear(6, 8), nn.Tanh(), nn.Linear(8, 4),
                          nn.LogSoftMax())
    step = TrainStep(model, nn.ClassNLLCriterion(),
                     optim.SGD(learning_rate=0.1), mesh=mesh)
    x = np.ones((8, 6), np.float32)
    y = np.zeros((8,), np.int64)
    with telemetry.run(sinks=[sink]):
        step.run(x, y, jax.random.key(0))


def test_memory_event_auto_on_for_sharded_step():
    sink = telemetry.MemorySink()
    _sharded_step_run(sink)
    events = [e for e in sink.events if e.get("kind") == "memory"]
    assert len(events) == 1
    ev = events[0]
    assert schema.validate_event(ev) == []
    assert ev["peak_bytes"] > 0
    assert ev["program"] == "train_step"
    assert ev["categories"]["params"] > 0
    assert ev["rows"]  # per-module rows travel with the event


def test_memory_event_default_off_single_device_and_off_knob():
    # auto + no mesh: nothing emitted
    sink = telemetry.MemorySink()
    model = nn.Sequential(nn.Linear(6, 4), nn.LogSoftMax())
    step = TrainStep(model, nn.ClassNLLCriterion(),
                     optim.SGD(learning_rate=0.1))
    with telemetry.run(sinks=[sink]):
        step.run(np.ones((4, 6), np.float32), np.zeros((4,), np.int64),
                 jax.random.key(0))
    assert not [e for e in sink.events if e.get("kind") == "memory"]
    # off knob mutes even the sharded step
    set_config(BigDLConfig(telemetry_memory="off"))
    sink2 = telemetry.MemorySink()
    _sharded_step_run(sink2)
    assert not [e for e in sink2.events if e.get("kind") == "memory"]


def test_memory_on_knob_forces_single_device_and_survives_device_off():
    """BIGDL_MEMORY=on must emit on a single-device step and even with
    BIGDL_TELEMETRY_DEVICE=off — the knobs are independent (the comms
    contract, extended)."""
    set_config(BigDLConfig(telemetry_device="off",
                           telemetry_memory="on"))
    sink = telemetry.MemorySink()
    model = nn.Sequential(nn.Linear(6, 4), nn.LogSoftMax())
    step = TrainStep(model, nn.ClassNLLCriterion(),
                     optim.SGD(learning_rate=0.1))
    with telemetry.run(sinks=[sink]):
        step.run(np.ones((4, 6), np.float32), np.zeros((4,), np.int64),
                 jax.random.key(0))
    kinds = [e.get("kind") for e in sink.events]
    assert "memory" in kinds
    assert "device_facts" not in kinds  # the device level still holds


def test_memory_event_rides_aot_scan_and_sees_the_loop_body():
    """aot_scan has the executable in hand — the memory event is a text
    parse, and the walker's while-body recursion must report the peak
    INSIDE the scanned step (far above the tuple shuffle around it)."""
    mesh = make_mesh((2,), ("data",), devices=jax.devices()[:2])
    model = nn.Sequential(nn.Linear(64, 128), nn.Tanh(),
                          nn.Linear(128, 4), nn.LogSoftMax())
    step = TrainStep(model, nn.ClassNLLCriterion(),
                     optim.SGD(learning_rate=0.1), mesh=mesh)
    x = np.ones((8, 64), np.float32)
    y = np.zeros((8,), np.int64)
    sink = telemetry.MemorySink()
    with telemetry.run(sinks=[sink]):
        step.aot_scan(x, y, jax.random.key(0), 3)
    events = [e for e in sink.events if e.get("kind") == "memory"]
    assert len(events) == 1
    ev = events[0]
    assert ev["program"] == "aot_scan"
    # the body's live temp dominates: peak must exceed the args alone
    assert ev["peak_bytes"] > ev["args_bytes"]


# -- OOM forensics ------------------------------------------------------------
def test_oom_forensics_flight_dump_carries_buffer_table(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("BIGDL_TELEMETRY", str(tmp_path))
    model = nn.Sequential(nn.Linear(6, 4), nn.LogSoftMax())
    step = TrainStep(model, nn.ClassNLLCriterion(),
                     optim.SGD(learning_rate=0.1, momentum=0.9))
    x = np.ones((4, 6), np.float32)
    y = np.zeros((4,), np.int64)

    def boom(*args):
        raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory "
                           "allocating 123456789 bytes")

    step._compiled = boom
    with telemetry.run(str(tmp_path)):
        with pytest.raises(tmem.MemoryExhaustedError) as ei:
            step.run_sharded(x, y, jax.random.key(0))
    err = ei.value
    assert err.evidence["categories"]["params"] > 0
    assert err.evidence["largest_buffers"][0]["bytes"] > 0
    assert "RESOURCE_EXHAUSTED" in err.evidence["error"]
    assert isinstance(err.__cause__, RuntimeError)
    dumps = glob.glob(str(tmp_path / "flight-*.json"))
    assert dumps, "OOM must flight-dump before re-raising"
    doc = json.load(open(dumps[0]))
    assert doc["reason"] == "oom"
    assert doc["evidence"]["largest_buffers"]
    assert doc["evidence"]["categories"]["params"] > 0


def test_non_oom_errors_pass_through_unwrapped():
    model = nn.Sequential(nn.Linear(6, 4), nn.LogSoftMax())
    step = TrainStep(model, nn.ClassNLLCriterion(),
                     optim.SGD(learning_rate=0.1))

    def boom(*args):
        raise RuntimeError("something else entirely")

    step._compiled = boom
    with pytest.raises(RuntimeError, match="something else"):
        step.run_sharded(np.ones((4, 6), np.float32),
                         np.zeros((4,), np.int64), jax.random.key(0))


def test_is_oom_spellings():
    assert tmem.is_oom(RuntimeError("RESOURCE_EXHAUSTED: ..."))
    assert tmem.is_oom(RuntimeError("Out of memory while trying to "
                                    "allocate 1 bytes"))
    assert not tmem.is_oom(ValueError("shape mismatch"))


# -- serving executor: per-bucket executable memory ---------------------------
def test_executor_warmup_records_bucket_memory():
    from bigdl_tpu.serving.executor import BucketedExecutor
    from bigdl_tpu.serving.buckets import BucketPolicy

    model = nn.Sequential(nn.Linear(12, 8), nn.Tanh(), nn.Linear(8, 4),
                          nn.LogSoftMax())
    ex = BucketedExecutor(model,
                          policy=BucketPolicy(max_batch=8,
                                              batch_buckets=[4, 8]))
    ex.warmup((12,), np.float32)
    assert set(ex.bucket_memory) == {(4, None), (8, None)}
    summary = ex.memory_summary()
    assert summary["state_bytes"] > 0
    assert summary["resident_bytes"] >= summary["state_bytes"]
    assert set(summary["buckets"]) == {"b4", "b8"}
    # the server's /status carries it (ROADMAP item 2's KV-cache budget
    # subtracts this from the device)
    from bigdl_tpu.serving.server import ModelServer

    server = ModelServer(model, jax.ShapeDtypeStruct((1, 12),
                                                     np.float32),
                         host="127.0.0.1", port=0)
    try:
        server.warmup()
        st = server.status()
        assert st["memory"]["state_bytes"] > 0
        assert st["memory"]["resident_bytes"] \
            >= st["memory"]["state_bytes"]
    finally:
        server.stop(drain=False)


# -- fleet: memory fold + pressure note ---------------------------------------
def _host_events(pidx, data_wait_s, live, limit):
    evs = [{"kind": "run_start", "ts": 0.0,
            "meta": {"process_index": pidx}}]
    t = 1.0
    for i in range(1, 9):
        evs.append({"kind": "span_end", "name": "data_wait",
                    "span": i, "dur": data_wait_s, "ts": t})
        evs.append({"kind": "step", "step": i, "dur": 0.1, "ts": t})
        t += 0.1
    evs.append({"kind": "memory", "ts": t, "peak_bytes": 1 << 30,
                "hbm_limit_bytes": limit,
                "live": [{"device": 0, "peak_bytes_in_use": live,
                          "bytes_limit": limit}]})
    return evs


def test_fleet_folds_memory_and_blame_notes_pressure():
    from bigdl_tpu.telemetry.fleet import fleet_view

    limit = 16 * (1 << 30)
    view = fleet_view([
        ("run-a-p0-1.jsonl", _host_events(0, 0.001, live=limit // 2,
                                          limit=limit)),
        ("run-b-p1-2.jsonl", _host_events(1, 0.06,
                                          live=int(limit * 0.97),
                                          limit=limit)),
    ])
    row = view["hosts"]["p1"]
    assert row["hbm_peak_bytes"] == 1 << 30
    assert row["hbm_live_bytes"] == int(limit * 0.97)
    assert row["memory_pressure"] is True
    assert view["hosts"]["p0"]["memory_pressure"] is False
    verdict = view["blame"]
    assert verdict and verdict["laggard"] == 1
    assert verdict["cause"] == "data_wait"
    assert verdict["memory_pressure"] == ["p1"]
    from bigdl_tpu.telemetry.fleet import format_fleet_view

    text = format_fleet_view(view)
    assert "memory pressure" in text and "hbm" in text


def test_metrics_sink_folds_memory_event():
    from bigdl_tpu.telemetry.metrics_http import MetricsSink

    sink = MetricsSink()
    sink.emit({"kind": "memory", "peak_bytes": 123456,
               "args_bytes": 100000, "temp_peak_bytes": 23456,
               "hbm_limit_bytes": 1 << 30,
               "live": [{"device": 0, "peak_bytes_in_use": 777,
                         "bytes_limit": 1 << 30}]})
    st = sink.status()
    assert st["memory"]["peak_bytes"] == 123456
    assert st["memory"]["live_bytes"] == 777
    assert st["memory"]["limit_bytes"] == 1 << 30
    text = sink.openmetrics()
    assert "bigdl_hbm_peak_bytes" in text
    assert "bigdl_hbm_live_bytes" in text


# -- CLI ----------------------------------------------------------------------
def test_cli_attribute_memory_model_and_json(capsys):
    from bigdl_tpu.telemetry import __main__ as cli

    rc = cli.main(["attribute", "--memory", "--model", "lenet",
                   "--mesh", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "HBM attribution" in out and "by module" in out
    rc = cli.main(["attribute", "--memory", "--model", "lenet",
                   "--mesh", "2", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["peak_bytes"] > 0
    assert doc["categories"]["opt_state"] > 0


def test_cli_attribute_memory_from_run_log(tmp_path, capsys):
    from bigdl_tpu.telemetry import __main__ as cli

    log = tmp_path / "run.jsonl"
    _sharded_step_run(telemetry.JsonlSink(str(log)))
    rc = cli.main(["attribute", "--memory", str(log)])
    out = capsys.readouterr().out
    assert rc == 0 and "per-device peak" in out
    # a log without memory events exits 2 with a hint
    empty = tmp_path / "empty.jsonl"
    with telemetry.run(str(empty)):
        telemetry.instant("epoch", epoch=1)
    assert cli.main(["attribute", "--memory", str(empty)]) == 2


def test_cli_fit_estimator_json_exit_codes(capsys, monkeypatch):
    from bigdl_tpu.telemetry import __main__ as cli

    monkeypatch.setenv("BIGDL_HBM_GB", "1.0")
    rc = cli.main(["memory", "--model", "lenet", "--mesh", "2",
                   "--zero1", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["fits"] is True and doc["headroom_pct"] > 0
    assert doc["mesh"] == {"devices": 2, "sync": "sharded"}
    assert doc["remat_advice"], "advisor rows expected"
    # an absurdly small budget flips the verdict and the exit code
    monkeypatch.setenv("BIGDL_HBM_GB", "0.0001")
    rc = cli.main(["memory", "--model", "lenet", "--no-advice"])
    out = capsys.readouterr().out
    assert rc == 1 and "DOES NOT FIT" in out
    # nothing to estimate exits 2
    assert cli.main(["memory", "--model", "nosuchmodel"]) == 2


def test_fit_estimator_rejects_oversized_mesh():
    with pytest.raises(ValueError, match="xla_force_host_platform"):
        tmem.attribute_memory_model("lenet", devices=99)


def test_remat_advice_ranks_blocks():
    out = tmem.fit_estimate("transformer", batch=2, devices=1)
    advice = out["remat_advice"]
    assert advice
    blocks = [a for a in advice if a["class"] == "TransformerBlock"]
    assert blocks, advice
    assert all(a["act_bytes"] > 0 for a in advice)
    # sorted by payoff: bytes saved per recompute-FLOP, descending
    ratios = [a["bytes_per_mflop"] for a in advice]
    assert ratios == sorted(ratios, reverse=True)


# -- diff / bench gates -------------------------------------------------------
def _memory_log(path, peak):
    with telemetry.run(str(path)):
        tr = telemetry.get()
        for i in range(1, 4):
            tr.emit("step", step=i, dur=0.01, records=8)
        tr.emit("memory", peak_bytes=peak, args_bytes=peak // 2,
                temp_peak_bytes=peak // 2)


def test_diff_flags_peak_hbm_regression(tmp_path, capsys):
    from bigdl_tpu.telemetry import __main__ as cli

    lean, fat = tmp_path / "lean.jsonl", tmp_path / "fat.jsonl"
    _memory_log(lean, 1_000_000)
    _memory_log(fat, 1_500_000)
    rc = cli.main(["diff", str(lean), str(fat)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "peak_hbm_bytes" in out and "REGRESSED" in out
    # less memory is an improvement, not a regression
    assert cli.main(["diff", str(fat), str(lean)]) == 0
    capsys.readouterr()
    # the dedicated threshold: 60% growth passes a 100% budget
    rc = cli.main(["diff", str(lean), str(fat),
                   "--memory-threshold-pct", "100"])
    assert rc == 0
    capsys.readouterr()
    # --json carries the memory threshold for CI archiving
    rc = cli.main(["diff", str(lean), str(fat), "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert doc["memory_threshold_pct"] == 10.0
    assert rc == 1


def test_bench_row_peak_hbm_diffs_by_suffix():
    from bigdl_tpu.telemetry.diff import bench_metrics, diff_metrics

    a = bench_metrics({"configs": {"x": {"images_per_sec": 10.0,
                                         "peak_hbm_bytes": 100.0}}})
    b = bench_metrics({"configs": {"x": {"images_per_sec": 10.0,
                                         "peak_hbm_bytes": 200.0}}})
    rows = {r["name"]: r for r in diff_metrics(a, b)}
    assert rows["x.peak_hbm_bytes"]["regressed"]
    rows = {r["name"]: r
            for r in diff_metrics(a, b, memory_threshold_pct=200.0)}
    assert not rows["x.peak_hbm_bytes"]["regressed"]


@pytest.mark.deadline(60)
def test_bench_memory_budget_exits_4_on_injected_regression(tmp_path):
    """The acceptance gate: bench.py --memory-budget flags a config
    whose peak_hbm_bytes grew past the budget with exit 4 — the same
    contract as --compile-budget."""
    baseline = tmp_path / "base.json"
    baseline.write_text(json.dumps(
        {"configs": {"lenet_mnist": {"peak_hbm_bytes": 1.0}}}))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               BENCH_CONFIGS="lenet_mnist", BENCH_ITERS="2",
               BENCH_INFER="0", BIGDL_SINGLETON_WAIT="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"),
         "--diff-against", str(baseline), "--memory-budget", "10"],
        capture_output=True, text=True, timeout=140, env=env, cwd=REPO)
    assert proc.returncode == 4, proc.stderr[-2000:]
    assert "peak_hbm_bytes" in proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    row = line["configs"]["lenet_mnist"]
    assert row["peak_hbm_bytes"] > 1000
    assert row["hbm_categories"]["params"] > 0


def test_cli_rejects_comms_plus_memory():
    """The two views must not silently shadow each other — and the two
    front-ends must agree (review finding: they resolved the flag pair
    in opposite orders)."""
    from bigdl_tpu.telemetry import __main__ as cli

    with pytest.raises(SystemExit):
        cli.main(["attribute", "--comms", "--memory", "--model",
                  "lenet"])
    from bigdl_tpu.models import cli as mcli

    with pytest.raises(SystemExit):
        mcli.main(["attribute", "--model", "lenet", "--comms",
                   "--memory"])


def test_pressure_judged_against_rows_own_allocator_limit():
    """The allocator's reservation-adjusted bytes_limit is the binding
    constraint — a device at 97% of ITS limit is pressured even when
    the spec-sheet budget says otherwise (review finding: the budget
    used to win and the warning under-fired right before a real OOM)."""
    limit = 10 * (1 << 30)
    live = [{"device": 0, "peak_bytes_in_use": int(limit * 0.97),
             "bytes_limit": limit}]
    # a LARGER configured budget must not mask the allocator ceiling
    hit = tmem.pressured_device(live, budget=16 * (1 << 30))
    assert hit and hit["limit_bytes"] == limit
    # no per-row limit: the budget is the fallback
    bare = [{"device": 0, "peak_bytes_in_use": int(limit * 0.97)}]
    assert tmem.pressured_device(bare, budget=limit)
    assert tmem.pressured_device(bare, budget=None) is None
    # display helper prefers the rows' own limit too
    peak, shown = tmem.live_peak_and_limit(live, 16 * (1 << 30))
    assert peak == int(limit * 0.97) and shown == limit


# -- device table -------------------------------------------------------------
def test_hbm_limit_override_and_table(monkeypatch):
    from bigdl_tpu.telemetry.device import hbm_per_device

    assert hbm_per_device("TPU v4 chip") == 32 * (1 << 30)
    assert hbm_per_device("TPU v5p pod") == 95 * (1 << 30)
    assert hbm_per_device("TPU v5 litepod") == 16 * (1 << 30)
    assert hbm_per_device("cpu") is None
    monkeypatch.setenv("BIGDL_HBM_GB", "2.5")
    assert tmem.hbm_limit_bytes() == int(2.5 * (1 << 30))
    monkeypatch.delenv("BIGDL_HBM_GB")
    # CPU: no table entry, no allocator limit -> None
    assert tmem.hbm_limit_bytes() is None
