"""Production inference serving (bigdl_tpu/serving/, docs/serving.md):
batcher coalescing/deadline invariants, bucket selection with ZERO
steady-state recompiles (retrace detector), AOT warmup, live HTTP e2e
against the batch Predictor's numerics, queue-full backpressure (429),
and graceful SIGTERM drain."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from bigdl_tpu.serving.batcher import ContinuousBatcher, QueueFullError
from bigdl_tpu.serving.buckets import BucketPolicy, pow2_buckets
from bigdl_tpu.serving.executor import BucketedExecutor, executor_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- bucket policy -----------------------------------------------------------
def test_pow2_buckets_and_selection():
    assert pow2_buckets(8) == (1, 2, 4, 8)
    assert pow2_buckets(12) == (1, 2, 4, 8, 12)
    pol = BucketPolicy(max_batch=8)
    assert [pol.batch_bucket(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    with pytest.raises(ValueError):
        pol.batch_bucket(9)
    with pytest.raises(ValueError):
        pol.batch_bucket(0)


def test_seq_bucket_selection_and_padding():
    pol = BucketPolicy(max_batch=4, seq_buckets=[16, 32])
    assert pol.seq_bucket(7) == 16
    assert pol.seq_bucket(17) == 32
    assert pol.seq_bucket(99) == 32  # clamps to the largest
    x = np.arange(2 * 10, dtype=np.int32).reshape(2, 10)
    padded = pol.pad(x, 4, 16)
    assert padded.shape == (4, 16)
    np.testing.assert_array_equal(padded[:2, :10], x)
    assert padded[2:].sum() == 0 and padded[:, 10:].sum() == 0
    # over-long sequences truncate onto the largest bucket
    long = np.ones((1, 40), np.int32)
    assert pol.pad(long, 1, pol.seq_bucket(40)).shape == (1, 32)


# -- continuous batcher (no jax needed: a fake runner) -----------------------
def test_batcher_coalesces_under_deadline():
    calls = []

    def runner(x):
        calls.append(np.asarray(x).shape[0])
        return np.asarray(x)

    b = ContinuousBatcher(runner, max_batch=8, max_wait_ms=250.0)
    try:
        reqs = [b.submit(np.full((1, 3), i, np.float32))
                for i in range(4)]
        for r in reqs:
            assert r.wait(5.0)
        # all four arrived well inside the first request's deadline ->
        # ONE dispatch carried them, each got its own rows back
        assert calls == [4]
        for i, r in enumerate(reqs):
            np.testing.assert_array_equal(
                r.output, np.full((1, 3), i, np.float32))
    finally:
        b.stop(drain=False)


def test_batcher_deadline_fires_without_full_batch():
    b = ContinuousBatcher(lambda x: np.asarray(x), max_batch=64,
                          max_wait_ms=50.0)
    try:
        t0 = time.perf_counter()
        r = b.submit(np.zeros((1, 2), np.float32))
        assert r.wait(5.0)
        # a lone request is dispatched at the deadline, not held for
        # max_batch rows
        assert time.perf_counter() - t0 < 2.0
        assert r.output.shape == (1, 2)
    finally:
        b.stop(drain=False)


def test_batcher_never_exceeds_max_batch_and_keeps_order():
    sizes = []

    def runner(x):
        sizes.append(np.asarray(x).shape[0])
        time.sleep(0.01)
        return np.asarray(x)

    b = ContinuousBatcher(runner, max_batch=4, max_wait_ms=20.0)
    try:
        reqs = [b.submit(np.full((1, 2), i, np.float32))
                for i in range(10)]
        for r in reqs:
            assert r.wait(10.0)
        assert max(sizes) <= 4
        for i, r in enumerate(reqs):  # slicing stayed aligned
            assert float(r.output[0, 0]) == i
    finally:
        b.stop(drain=False)


def test_batcher_queue_full_backpressure():
    release = threading.Event()

    def runner(x):
        release.wait(10.0)
        return np.asarray(x)

    b = ContinuousBatcher(runner, max_batch=1, max_wait_ms=0.0,
                          queue_limit=2)
    try:
        first = b.submit(np.zeros((1, 1), np.float32))
        time.sleep(0.2)  # worker now blocked inside the runner
        b.submit(np.zeros((1, 1), np.float32))
        b.submit(np.zeros((1, 1), np.float32))
        with pytest.raises(QueueFullError):
            b.submit(np.zeros((1, 1), np.float32))
        assert b.rejected == 1
        release.set()
        assert first.wait(5.0)
    finally:
        release.set()
        b.stop(drain=False)


def test_batcher_drain_finishes_queued_requests():
    slow = threading.Event()

    def runner(x):
        slow.wait(0.05)
        return np.asarray(x)

    b = ContinuousBatcher(runner, max_batch=2, max_wait_ms=1.0)
    reqs = [b.submit(np.full((1, 1), i, np.float32)) for i in range(6)]
    assert b.stop(drain=True, timeout=10.0)
    for i, r in enumerate(reqs):
        assert r.done.is_set() and r.error is None
        assert float(r.output[0, 0]) == i
    with pytest.raises(QueueFullError):  # admissions closed
        b.submit(np.zeros((1, 1), np.float32))


def test_batcher_relays_runner_errors():
    def runner(x):
        raise RuntimeError("boom")

    b = ContinuousBatcher(runner, max_batch=4, max_wait_ms=1.0)
    try:
        r = b.submit(np.zeros((1, 1), np.float32))
        assert r.wait(5.0)
        assert isinstance(r.error, RuntimeError)
    finally:
        b.stop(drain=False)


# -- bucketed executor -------------------------------------------------------
def _lenet():
    from bigdl_tpu.models import registry

    return registry.build_model("lenet")


def test_executor_warmup_compiles_every_bucket_then_zero_recompiles():
    from bigdl_tpu import telemetry
    from bigdl_tpu.analysis.retrace import trace_retraces

    model = _lenet()
    ex = BucketedExecutor(
        model, policy=BucketPolicy(max_batch=8, batch_buckets=[1, 2, 4, 8]))
    sink = telemetry.MemorySink()
    with telemetry.run(sinks=[sink]):
        ex.warmup((784,), np.float32)
        assert ex.compile_count == 4
        assert ex.warm_buckets() == [(1, None), (2, None), (4, None),
                                     (8, None)]
        x = np.random.RandomState(0).randn(8, 784).astype(np.float32)
        want = np.asarray(model.evaluate().forward(x))
        # steady state: every arrival size maps onto a warm bucket —
        # the retrace detector must stay CLEAN and the compile count
        # must not move
        with trace_retraces() as mon:
            for n in (1, 3, 2, 8, 5, 1, 4, 7):
                out = ex.run(x[:n])
                assert out.shape == (n, 10)
                np.testing.assert_allclose(out, want[:n], atol=1e-5)
        assert mon.report.diagnostics == []
        assert ex.compile_count == 4
    compiles = [e for e in sink.events if e.get("kind") == "compile"]
    assert len(compiles) == 4
    assert {e["name"] for e in compiles} == {"ServeExecutor.warmup"}


def test_executor_cold_bucket_compiles_in_path_and_is_named():
    from bigdl_tpu import telemetry

    ex = BucketedExecutor(
        _lenet(), policy=BucketPolicy(max_batch=4, batch_buckets=[2, 4]))
    sink = telemetry.MemorySink()
    with telemetry.run(sinks=[sink]):
        out = ex.run(np.zeros((2, 784), np.float32))  # no warmup: cold
        assert out.shape == (2, 10)
    names = [e["name"] for e in sink.events if e.get("kind") == "compile"]
    assert names == ["ServeExecutor.compile"]  # the in-request-path name


def test_executor_refresh_state_keeps_warm_executables():
    model = _lenet()
    ex = BucketedExecutor(model,
                          policy=BucketPolicy(max_batch=2,
                                              batch_buckets=[2]))
    ex.warmup((784,), np.float32)
    x = np.random.RandomState(1).randn(2, 784).astype(np.float32)
    before = ex.run(x)
    # same-shape weight update (training between predicts): executables
    # survive, outputs track the new params
    w = model.get(8).weight  # fc1
    model.get(8).weight = np.asarray(w) * 0.5
    ex.refresh_state()
    after = ex.run(x)
    assert ex.compile_count == 1
    assert not np.allclose(before, after)
    np.testing.assert_allclose(after,
                               np.asarray(model.evaluate().forward(x)),
                               atol=1e-5)


def test_predictor_shares_one_compile_cache_across_predicts():
    model = _lenet()
    from bigdl_tpu.optim.predictor import LocalPredictor

    x = np.random.RandomState(2).randn(10, 784).astype(np.float32)
    pred = LocalPredictor(model, batch_size=4)
    out1 = pred.predict(x)
    ex = executor_for(model, max_batch=4)
    count = ex.compile_count
    assert count >= 1
    # second predict — and a SECOND Predictor over the same model —
    # reuse the same executor: zero new compiles (the old code paid a
    # fresh EvalStep jit per call)
    out2 = pred.predict(x)
    out3 = LocalPredictor(model, batch_size=4).predict(x)
    assert ex.compile_count == count
    np.testing.assert_allclose(out1, out2, atol=1e-6)
    np.testing.assert_allclose(out1, out3, atol=1e-6)
    np.testing.assert_allclose(
        out1, np.asarray(model.evaluate().forward(x)), atol=1e-5)


def test_predictor_on_mesh_uses_mesh_aligned_buckets():
    """Review regression: the default pow2 bucket set starts at 1,
    which cannot shard over a multi-device data mesh — mesh executors
    must default to mesh-aligned buckets, and the mesh Predictor path
    must keep working."""
    from bigdl_tpu.optim.predictor import LocalPredictor
    from bigdl_tpu.parallel.mesh import make_mesh
    from bigdl_tpu.serving.executor import default_policy

    import jax

    mesh = make_mesh((2,), ("data",), devices=jax.devices()[:2])
    pol = default_policy(max_batch=8, mesh=mesh)
    assert all(b % 2 == 0 for b in pol.batch_buckets), pol.batch_buckets
    model = _lenet()
    x = np.random.RandomState(6).randn(7, 784).astype(np.float32)
    out = LocalPredictor(model, batch_size=4, mesh=mesh).predict(x)
    np.testing.assert_allclose(
        out, np.asarray(model.evaluate().forward(x)), atol=1e-5)


def test_executor_seq_buckets_token_model():
    """Token inputs snap onto (batch, seq) buckets; numerics match the
    model's own forward at the same padded shape."""
    import bigdl_tpu.nn as nn
    from bigdl_tpu.analysis.retrace import trace_retraces

    model = nn.Sequential(nn.LookupTable(50, 8), nn.TimeDistributed(
        nn.Linear(8, 4)))
    ex = BucketedExecutor(
        model, policy=BucketPolicy(max_batch=4, batch_buckets=[2, 4],
                                   seq_buckets=[8, 16]), seq_axis=1)
    ex.warmup((16,), np.int32)
    assert ex.compile_count == 4  # {2,4} x {8,16}
    rng = np.random.RandomState(3)
    with trace_retraces() as mon:
        for rows, t in ((1, 5), (2, 8), (3, 12), (4, 16), (2, 3)):
            x = rng.randint(1, 50, (rows, t)).astype(np.int32)
            out = ex.run(x)
            assert out.shape[:2] == (rows, t)
            padded = np.zeros((rows, ex.policy.seq_bucket(t)), np.int32)
            padded[:, :t] = x
            want = np.asarray(model.evaluate().forward(padded))
            np.testing.assert_allclose(out, want[:, :t], atol=1e-6)
    assert mon.report.diagnostics == []
    assert ex.compile_count == 4


def test_http_seq_bucketed_outputs_trim_to_request_length():
    """Review regression: the batcher pads ragged token requests to the
    common seq bucket BEFORE the executor, so the trim back to each
    request's own length must happen per request after slicing —
    a 5-token request gets 5 output steps, not the bucket's 8."""
    import jax

    import bigdl_tpu.nn as nn
    from bigdl_tpu.serving import serve_model

    model = nn.Sequential(nn.LookupTable(50, 8),
                          nn.TimeDistributed(nn.Linear(8, 4)))
    spec = jax.ShapeDtypeStruct((1, 16), np.int32)
    server = serve_model(model, spec, host="127.0.0.1", port=0,
                         max_batch=4, batch_buckets=[2, 4],
                         seq_buckets=[8, 16], max_wait_ms=20.0)
    try:
        rng = np.random.RandomState(9)
        xs = {5: rng.randint(1, 50, (1, 5)), 12: rng.randint(1, 50, (2, 12))}
        results = {}

        def client(t):
            code, resp = _post(server.port,
                               {"inputs": xs[t].astype(int).tolist()})
            results[t] = (code, np.asarray(resp["outputs"]))

        threads = [threading.Thread(target=client, args=(t,)) for t in xs]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30.0)
        for t, (code, out) in results.items():
            assert code == 200
            assert out.shape[:2] == (xs[t].shape[0], t), (t, out.shape)
            # numerics: the model forward at this request's own bucket
            padded = np.zeros((xs[t].shape[0],
                               server.executor.policy.seq_bucket(t)),
                              np.int32)
            padded[:, :t] = xs[t]
            want = np.asarray(model.evaluate().forward(padded))
            np.testing.assert_allclose(out, want[:, :t], atol=1e-5)
    finally:
        server.stop(drain=False)


# -- live HTTP e2e -----------------------------------------------------------
@pytest.fixture
def lenet_server():
    from bigdl_tpu.models import registry
    from bigdl_tpu.serving import serve_model

    model = registry.build_model("lenet")
    server = serve_model(model, registry.input_spec("lenet", 1),
                         name="lenet", host="127.0.0.1", port=0,
                         max_batch=8, batch_buckets=[1, 2, 4, 8],
                         max_wait_ms=2.0)
    try:
        yield model, server
    finally:
        server.stop(drain=False)


def _post(port, payload, timeout=30.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_http_e2e_concurrent_mixed_sizes_match_predictor(lenet_server):
    from bigdl_tpu.optim.predictor import LocalPredictor

    model, server = lenet_server
    rng = np.random.RandomState(4)
    x = rng.randn(24, 784).astype(np.float32)
    want = LocalPredictor(model, batch_size=8).predict(x)

    results = {}
    errors = []
    slices = [(0, 1), (1, 4), (4, 6), (6, 11), (11, 19), (19, 24)]

    def client(lo, hi):
        try:
            code, resp = _post(server.port, {"inputs": x[lo:hi].tolist()})
            assert code == 200
            results[(lo, hi)] = np.asarray(resp["outputs"])
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=s) for s in slices]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert errors == []
    for (lo, hi), out in results.items():
        assert out.shape == (hi - lo, 10)
        np.testing.assert_allclose(out, want[lo:hi], atol=1e-5)
    # a single bare sample gets a single bare output row back
    code, resp = _post(server.port, {"inputs": x[0].tolist()})
    assert code == 200
    np.testing.assert_allclose(np.asarray(resp["outputs"]), want[0],
                               atol=1e-5)
    assert resp["queue_ms"] >= 0.0


def test_http_status_healthz_metrics_and_bad_input(lenet_server):
    _, server = lenet_server
    _post(server.port, {"inputs": np.zeros(784).tolist()})
    st = json.load(urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}/status", timeout=10))
    srv = st["serving"]
    assert srv["model"] == "lenet"
    assert srv["batch_buckets"] == [1, 2, 4, 8]
    assert srv["compiles"] == 4 and srv["warmup_s"] > 0
    assert srv["warm_buckets"][:2] == [[1], [2]]
    assert srv["requests"] >= 1 and srv["p50_ms"] > 0
    hz = urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}/healthz", timeout=10)
    assert json.loads(hz.read())["ok"] is True
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}/metrics", timeout=10
    ).read().decode()
    assert "bigdl_serve_qps" in body and body.rstrip().endswith("# EOF")
    # shape errors are a 400, not a 500 or a hang
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server.port, {"inputs": [[1.0, 2.0]]})
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server.port, {"wrong": 1})
    assert ei.value.code == 400


def test_http_queue_full_returns_429(lenet_server):
    _, server = lenet_server
    release = threading.Event()
    inner = server.batcher.runner

    def slow(xx):
        release.wait(10.0)
        return inner(xx)

    server.batcher.runner = slow
    server.batcher.queue_limit = 2
    server.batcher._q.maxsize = 2
    codes = []
    lock = threading.Lock()

    def client():
        try:
            code, _ = _post(server.port,
                            {"inputs": np.zeros((1, 784)).tolist()})
        except urllib.error.HTTPError as e:
            code = e.code
        with lock:
            codes.append(code)

    threads = [threading.Thread(target=client) for _ in range(6)]
    for t in threads:
        t.start()
        time.sleep(0.05)  # let each submission land before the next
    release.set()
    for t in threads:
        t.join(30.0)
    assert 429 in codes, codes
    assert 200 in codes, codes  # accepted requests still completed


def test_serve_events_are_schema_valid():
    from bigdl_tpu import telemetry
    from bigdl_tpu.models import registry
    from bigdl_tpu.serving import serve_model
    from bigdl_tpu.telemetry import schema

    sink = telemetry.MemorySink()
    with telemetry.run(sinks=[sink]):
        model = registry.build_model("lenet")
        server = serve_model(model, registry.input_spec("lenet", 1),
                             host="127.0.0.1", port=0, max_batch=4,
                             batch_buckets=[4], max_wait_ms=1.0)
        try:
            _post(server.port, {"inputs": np.zeros((2, 784)).tolist()})
        finally:
            server.stop(drain=True)
    kinds = {e.get("kind") for e in sink.events}
    assert "serve" in kinds and "compile" in kinds
    names = {e.get("name") for e in sink.events}
    assert {"serve/started", "serve/drain", "serve/warmup",
            "serve/requests"} <= names
    assert schema.validate_events(sink.events) == []


def test_sigterm_drain_in_process():
    """SIGTERM flips /healthz to 503 and wait() returns; stop(drain)
    finishes queued work.  (The subprocess test below exercises the
    whole CLI path; this one pins the handler semantics.)"""
    from bigdl_tpu.models import registry
    from bigdl_tpu.serving import serve_model

    model = registry.build_model("lenet")
    server = serve_model(model, registry.input_spec("lenet", 1),
                         host="127.0.0.1", port=0, max_batch=4,
                         batch_buckets=[4], max_wait_ms=1.0)
    old_term = signal.getsignal(signal.SIGTERM)
    old_int = signal.getsignal(signal.SIGINT)
    try:
        server.install_signal_handlers()
        r = server.batcher.submit(np.zeros((1, 784), np.float32))
        os.kill(os.getpid(), signal.SIGTERM)
        server.wait()  # returns because the handler set the term event
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/healthz", timeout=10)
        assert ei.value.code == 503
        server.stop(drain=True)
        assert r.done.is_set() and r.error is None
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
        server.stop(drain=False)


@pytest.mark.deadline(60)
def test_cli_serve_live_e2e_with_sigterm_drain():
    """The acceptance path: `models/cli.py serve` on a registry model,
    real HTTP from another process, numerics equal to the in-process
    Predictor, graceful SIGTERM drain, exit 0."""
    from bigdl_tpu.models import registry
    from bigdl_tpu.optim.predictor import LocalPredictor
    from bigdl_tpu.utils.rng import RNG

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "bigdl_tpu.models.cli", "serve",
         "--model", "lenet", "--port", "0", "-b", "8",
         "--buckets", "1,2,4,8", "--max-wait-ms", "2", "--seed", "42"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    try:
        port = None
        deadline = time.time() + 180
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            m = re.search(r"serving lenet on port (\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "no ready line from cli serve"
        RNG.set_seed(42)
        model = registry.build_model("lenet")
        x = np.random.RandomState(5).randn(6, 784).astype(np.float32)
        want = LocalPredictor(model, batch_size=8).predict(x)
        code, resp = _post(port, {"inputs": x.tolist()})
        assert code == 200
        np.testing.assert_allclose(np.asarray(resp["outputs"]), want,
                                   atol=1e-5)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "drained" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
