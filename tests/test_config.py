"""Typed config object (``utils/config.py``) — the unified BIGDL_* knob
surface (``utils/Engine.scala:113-154`` system-property parity)."""

import pytest

from bigdl_tpu.utils.config import BigDLConfig, get_config, set_config


def test_defaults_without_env(monkeypatch):
    for k in ("BIGDL_FAILURE_RETRY_TIMES", "BIGDL_ITERATION_TIMEOUT",
              "BIGDL_LOCAL_MODE", "BIGDL_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    cfg = get_config()
    assert cfg.failure_retry_times == 5
    assert cfg.failure_retry_interval == 120.0
    assert cfg.iteration_timeout == ""
    assert cfg.coordinator_address is None
    assert not cfg.local_mode


def test_env_resolution(monkeypatch):
    monkeypatch.setenv("BIGDL_FAILURE_RETRY_TIMES", "2")
    monkeypatch.setenv("BIGDL_ITERATION_TIMEOUT", " auto ")
    monkeypatch.setenv("BIGDL_LOCAL_MODE", "true")
    monkeypatch.setenv("BIGDL_COORDINATOR_ADDRESS", "h:1234")
    monkeypatch.setenv("BIGDL_NUM_PROCESSES", "4")
    cfg = get_config()
    assert cfg.failure_retry_times == 2
    assert cfg.iteration_timeout == "auto"  # stripped
    assert cfg.local_mode
    assert cfg.coordinator_address == "h:1234"
    assert cfg.num_processes == 4


def test_env_mutations_visible_per_call(monkeypatch):
    monkeypatch.setenv("BIGDL_PROFILE_ITERS", "7")
    assert get_config().profile_iters == 7
    monkeypatch.setenv("BIGDL_PROFILE_ITERS", "9")
    assert get_config().profile_iters == 9  # re-resolved, not cached


def test_explicit_override_wins(monkeypatch):
    monkeypatch.setenv("BIGDL_FAILURE_RETRY_TIMES", "2")
    try:
        set_config(BigDLConfig(failure_retry_times=11))
        assert get_config().failure_retry_times == 11
    finally:
        set_config(None)
    assert get_config().failure_retry_times == 2


def test_bench_make_step_applies_graph_passes():
    """The shared perf-tool recipe (bench.make_step) must bench the
    graph-OPTIMIZED model — tools drifting onto the unfused model is how
    the round-3 profile/bench mismatch happened."""
    import sys
    sys.path.insert(0, ".")
    import bench
    import bigdl_tpu.nn as nn

    step, x, y = bench.make_step("inception_v1_imagenet", batch=2)
    names = [m.get_name() or "" for m in step.model.modules()]
    assert any("+" in n for n in names), "no merged sibling convs in bench model"
    assert any(n.endswith("/s2d") for n in names), "no s2d conv1 in bench model"
    assert x.shape[0] == 2


@pytest.mark.slow
def test_bench_infer_legs_run_and_account():
    """Both inference legs (bf16, int8-quantized) of the bench's
    int8-vs-bf16 table run end-to-end and report throughput + op
    accounting — guards the quantize()+EvalStep+AOT wiring from rot
    between hardware windows."""
    import sys
    sys.path.insert(0, ".")
    import bench

    for quantized in (False, True):
        row = bench.run_infer_config("vgg16_cifar10", batch=8, iters=1,
                                     quantized=quantized)
        assert row["img_s"] > 0, row
        # cost accounting present (cpu has no peak, so no utilization)
        assert "achieved_tops" in row, row
