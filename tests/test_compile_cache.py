"""Managed persistent compile cache (utils/compile_cache.py,
docs/compile.md): a same-config second process over the same cache dir
must LOAD its executables (cache hits > 0, measurably lower compile
seconds) for both the training aot_scan path and the serving warmup
path; hits/misses land in the run log as schema-valid instants; and
the compile budget (`telemetry diff` / `bench.py --compile-budget`)
flags an injected compile_s regression with a nonzero exit."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: one training process: build a TrainStep, AOT-compile a 3-iteration
#: scan, print the cache monitor snapshot + the run-log path as JSON
_TRAIN_CHILD = """
import json, sys
import numpy as np, jax
from bigdl_tpu import telemetry
import bigdl_tpu.nn as nn, bigdl_tpu.optim as optim
from bigdl_tpu.parallel.train_step import TrainStep
from bigdl_tpu.utils.rng import RNG

with telemetry.run(sys.argv[1]):
    RNG.set_seed(0)
    m = nn.Sequential(nn.Linear(16, 64), nn.Tanh(), nn.Linear(64, 4),
                      nn.LogSoftMax())
    step = TrainStep(m, nn.ClassNLLCriterion(),
                     optim.SGD(learning_rate=0.1))
    x = np.random.RandomState(0).randn(32, 16).astype(np.float32)
    y = np.random.RandomState(0).randint(0, 4, 32)
    step.aot_scan(x, y, jax.random.key(0), 3)
from bigdl_tpu.utils import compile_cache as cc
print(json.dumps({"run_log": telemetry.last_run_path(),
                  **cc.monitor().snapshot()}))
"""

#: one serving process: warm a 2-bucket executor, print the snapshot
_SERVE_CHILD = """
import json, sys
import numpy as np
import bigdl_tpu.nn as nn
from bigdl_tpu.serving.buckets import BucketPolicy
from bigdl_tpu.serving.executor import BucketedExecutor
from bigdl_tpu.utils.rng import RNG

RNG.set_seed(0)
model = nn.Sequential(nn.Linear(6, 32), nn.Tanh(), nn.Linear(32, 3),
                      nn.LogSoftMax()).evaluate()
ex = BucketedExecutor(model, policy=BucketPolicy(batch_buckets=[2, 4]))
warm_s = ex.warmup((6,), np.float32)
out = ex.run(np.ones((3, 6), np.float32))
assert np.asarray(out).shape[0] == 3
from bigdl_tpu.utils import compile_cache as cc
print(json.dumps({"warmup_s": warm_s, "buckets": len(ex.warm_buckets()),
                  **cc.monitor().snapshot()}))
"""


def _run_child(code, cache_dir, tmp_path, *args):
    """Fresh interpreter, single CPU device (the persistent cache's
    supported CPU shape — the tier-1 rig's forced 8-device host
    platform is exactly what the implicit gate keeps away from it),
    explicit cache opt-in."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # single device in the child
    env.update(JAX_PLATFORMS="cpu",
               BIGDL_COMPILE_CACHE=str(cache_dir),
               BIGDL_COMPILE_CACHE_MIN_S="0",
               PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code, *[str(a) for a in args]],
        capture_output=True, text=True, timeout=180, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.deadline(60)
def test_second_process_aot_scan_hits_cache(tmp_path):
    cache = tmp_path / "cache"
    cold = _run_child(_TRAIN_CHILD, cache, tmp_path, tmp_path / "run1")
    warm = _run_child(_TRAIN_CHILD, cache, tmp_path, tmp_path / "run2")
    assert cold["misses"] > 0 and cold["hits"] == 0, cold
    assert warm["hits"] > 0, warm
    assert warm["misses"] == 0, warm
    # the headline contract: a warm restart's compile bill collapses
    assert warm["compile_s"] < cold["compile_s"], (cold, warm)

    # hits/misses are per-run telemetry, schema-valid
    from bigdl_tpu.telemetry import schema

    for snap, name in ((cold, "compile/cache_miss"),
                       (warm, "compile/cache_hit")):
        n, errors = schema.validate_run(snap["run_log"])
        assert errors == [], errors[:3]
        events, _ = schema.read_events(snap["run_log"])
        names = [e.get("name") for e in events if e.get("kind") == "event"]
        assert name in names, (name, names)
        assert "compile/cache" in names, "ingredients not announced"

    # and `telemetry diff` sees the warm run's lower compile_s
    from bigdl_tpu.telemetry import diff

    a = diff.run_log_metrics(cold["run_log"])
    b = diff.run_log_metrics(warm["run_log"])
    assert b["compile_s"] < a["compile_s"]


@pytest.mark.deadline(60)
def test_second_process_serving_warmup_reuses_cache(tmp_path):
    cache = tmp_path / "cache"
    cold = _run_child(_SERVE_CHILD, cache, tmp_path)
    warm = _run_child(_SERVE_CHILD, cache, tmp_path)
    assert cold["buckets"] == warm["buckets"] == 2
    assert cold["misses"] > 0 and cold["hits"] == 0, cold
    assert warm["hits"] > 0 and warm["misses"] == 0, warm
    assert warm["compile_s"] < cold["compile_s"], (cold, warm)


# -- the compile budget ------------------------------------------------------
def _bench_doc(compile_s, images_per_sec=1000.0):
    return {"metric": "x_train_throughput", "value": images_per_sec,
            "configs": {"lenet_mnist": {
                "images_per_sec": images_per_sec,
                "compile_s": compile_s,
                "stages_s": {"compile": compile_s}}}}


def test_diff_flags_injected_compile_regression(tmp_path):
    """Acceptance: `telemetry diff` exits nonzero on a compile_s
    regression beyond the compile budget."""
    from bigdl_tpu.telemetry import diff

    a = tmp_path / "a.json"
    b = tmp_path / "b.json"
    a.write_text(json.dumps(_bench_doc(10.0)))
    b.write_text(json.dumps(_bench_doc(100.0)))  # 10x: the outlier class
    assert diff.main([str(a), str(b)]) == 1
    # within the default 50% budget: no regression
    b.write_text(json.dumps(_bench_doc(12.0)))
    assert diff.main([str(a), str(b)]) == 0
    # a tightened budget flags it
    assert diff.main([str(a), str(b),
                      "--compile-threshold-pct", "10"]) == 1


def test_bench_metrics_reads_banked_stages_fallback():
    """Pre-budget banked artifacts (stages_s only, no compile_s field)
    stay comparable."""
    from bigdl_tpu.telemetry import diff

    doc = {"configs": {"lenet_mnist": {"images_per_sec": 1.0,
                                       "stages_s": {"compile": 445.7}}}}
    m = diff.bench_metrics(doc)
    assert m["lenet_mnist.compile_s"] == pytest.approx(445.7)


def test_diff_metrics_compile_threshold_param():
    from bigdl_tpu.telemetry.diff import diff_metrics

    a = {"compile_s": 10.0}
    b = {"compile_s": 14.0}  # +40%
    rows = diff_metrics(a, b)
    assert not rows[0]["regressed"]  # default 50% budget
    rows = diff_metrics(a, b, compile_threshold_pct=25.0)
    assert rows[0]["regressed"]
    # the runtime threshold does NOT govern compile_s
    rows = diff_metrics(a, b, threshold_pct=1.0)
    assert not rows[0]["regressed"]


def test_metrics_sink_exports_compile_cache_counters():
    """/metrics + /status carry bigdl_compile_cache_hits/misses and
    cumulative compile seconds (the satellite contract)."""
    from bigdl_tpu.telemetry.metrics_http import MetricsSink

    sink = MetricsSink()
    base = {"v": 1, "ts": 0.0, "pid": 1, "tid": 1}
    sink.emit({**base, "kind": "compile", "name": "TrainStep.run",
               "dur": 2.5})
    sink.emit({**base, "kind": "compile", "name": "TrainStep.run",
               "dur": 0.5})
    sink.emit({**base, "kind": "event", "name": "compile/cache_hit"})
    sink.emit({**base, "kind": "event", "name": "compile/cache_miss"})
    sink.emit({**base, "kind": "event", "name": "compile/cache_miss"})
    status = sink.status()
    assert status["compile_s"] == pytest.approx(3.0)
    assert status["compile_cache"] == {"hits": 1, "misses": 2}
    text = sink.openmetrics()
    assert "bigdl_compile_seconds_total" in text
    assert 'bigdl_compile_cache_hits_total{process_index="0"} 1' in text
    assert 'bigdl_compile_cache_misses_total{process_index="0"} 2' in text


def test_cache_key_ingredients_name_the_key():
    from bigdl_tpu.utils.compile_cache import cache_key_ingredients

    ing = cache_key_ingredients()
    assert "jax" in ing and "jaxlib" in ing
    assert "cache_dir" in ing and "min_compile_s" in ing


def test_implicit_enable_stays_off_cpu(monkeypatch, tmp_path):
    """The hot-path spelling must not flip the cache on for plain-CPU
    processes (tier-1's forced 8-device host platform is unsafe to
    serialize on this jaxlib) — only an explicit BIGDL_COMPILE_CACHE
    opts CPU in."""
    import jax

    from bigdl_tpu.utils.engine import enable_compile_cache

    monkeypatch.delenv("BIGDL_COMPILE_CACHE", raising=False)
    if jax.config.jax_compilation_cache_dir:
        pytest.skip("cache already configured process-wide")
    assert enable_compile_cache(implicit=True) == ""
    assert not jax.config.jax_compilation_cache_dir
