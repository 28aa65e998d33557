"""The port's HTTP server on the CPU: predict, backpressure, status,
health and drain, with the narrow Inception-v1 of the slice test."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from bigdl_tpu_torch.models.registry import InputSpec
from bigdl_tpu_torch.serving import serve_model
from test_torch_slice import copied_pair, one_thread  # noqa: F401


def _post(port, inputs):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict",
        data=json.dumps({"inputs": inputs}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def server():
    _, tmodel = copied_pair()
    srv = serve_model(tmodel, InputSpec((1, 3, 32, 32), "float32"),
                      host="127.0.0.1", port=0, max_batch=4,
                      batch_buckets=[1, 2, 4], max_wait_ms=1.0, queue_limit=1,
                      device="cpu")
    yield srv
    srv.stop(drain=False)


def test_predict_backpressure_status_and_drain(server):
    x = np.random.RandomState(0).randn(4, 3, 32, 32).astype(np.float32)
    port = server.port
    assert server.executor.warm_buckets() == [1, 2, 4]

    code, body = _post(port, x[0].tolist())            # one sample
    assert code == 200
    np.testing.assert_allclose(body["outputs"], server.executor.run(x[:1])[0],
                               rtol=1e-5, atol=1e-5)
    code, body = _post(port, x[:3].tolist())           # a 3-row micro-batch
    assert code == 200
    np.testing.assert_allclose(body["outputs"], server.executor.run(x[:3]),
                               rtol=1e-5, atol=1e-5)
    assert _post(port, x[:1, :2].tolist())[0] == 400   # wrong sample shape

    # over-queue burst: the worker holds one request in a gated dispatch,
    # the queue (limit 1) holds the next, the third gets a 429
    gate, entered = threading.Event(), threading.Event()
    run = server.batcher.runner

    def gated(rows):
        entered.set()
        assert gate.wait(30)
        return run(rows)

    server.batcher.runner = gated
    results = {}
    first = threading.Thread(target=lambda: results.update(a=_post(port, x[:1].tolist())))
    first.start()
    assert entered.wait(30)
    second = threading.Thread(target=lambda: results.update(b=_post(port, x[1:2].tolist())))
    second.start()
    for _ in range(500):
        if server.batcher.depth() == 1:
            break
        threading.Event().wait(0.01)
    code, body = _post(port, x[2:3].tolist())
    assert code == 429 and "capacity" in body["error"]

    code, health = _get(port, "/healthz")
    assert code == 200 and health["ok"]
    # drain: stop() finishes the queued request before it returns
    stopper = threading.Thread(target=server.stop)
    stopper.start()
    gate.set()
    for t in (first, second, stopper):
        t.join(30)
        assert not t.is_alive()
    assert results["a"][0] == results["b"][0] == 200
    np.testing.assert_allclose(results["b"][1]["outputs"],
                               server.executor.run(x[1:2]), rtol=1e-5,
                               atol=1e-5)
    st = server.status()
    assert (st["requests"], st["rejected"], st["errors"]) == (4, 1, 0)
    assert st["batches"] == 4 and st["rows"] == 6
    assert st["p50_ms"] > 0 and st["p99_ms"] >= st["p50_ms"]
    assert st["kernel_launches"] == {"cross_map_lrn_fwd": 0, "avg_pool_fwd": 0}


def test_status_and_health_endpoints(server):
    code, st = _get(server.port, "/status")
    assert code == 200
    assert st["serving"]["batch_buckets"] == [1, 2, 4]
    assert st["serving"]["device"] == "cpu"
    assert st["serving"]["queue_depth"] == 0
    server.stop(drain=True)
    assert server.draining()
