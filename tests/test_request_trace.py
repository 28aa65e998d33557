"""Request-level tracing for the serving path
(bigdl_tpu/telemetry/request_trace.py, docs/observability.md "Tracing a
request"): trace-id minting + X-Request-Id propagation/echo, span
completeness (every ms of wall time owned by exactly one span, ±5%),
tail-aware retention (the slowest-k survive eviction pressure), the
slow-request blame verdict on crafted slow requests (injected queue
backlog -> queue_wait, injected prefill flood -> prefill_interference),
terminal-span traces for rejected requests, OpenMetrics latency
histograms + SLO burn gauges, chrome request lanes, the offline
`telemetry trace` waterfall, schema validity of `request` events, and
the bench_serving.py --slo-* exit-4 gate in a live subprocess."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from bigdl_tpu.telemetry import request_trace as rt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VOCAB = 50


# -- ids ---------------------------------------------------------------------
def test_mint_and_valid_ids():
    a, b = rt.mint_id(), rt.mint_id()
    assert a != b and rt.valid_id(a) and len(a) == 16
    assert rt.valid_id("client-id_1.A")
    # anything unsafe for a header/log line is replaced, not rejected
    for bad in (None, "", "a b", "x" * 129, "id\nSet-Cookie: h"):
        assert not rt.valid_id(bad)


# -- store: tail-aware retention ---------------------------------------------
def _trace(tid, ms, endpoint="predict", status="ok", reason=None):
    tr = rt.RequestTrace(tid, endpoint, started_at=1000.0)
    tr.add_span("infer", 1000.0, ms, component="compute")
    tr.finish(status, reason, now=1000.0 + ms / 1000.0)
    return tr


def test_store_slowest_k_survives_eviction_pressure():
    store = rt.TraceStore(ring=8, slowest_k=2)
    store.add(_trace("slowest", 500.0))
    store.add(_trace("second", 400.0))
    for i in range(100):  # a flood of healthy requests
        store.add(_trace(f"fast{i}", 1.0))
    # the p99 exemplars were NOT evicted by recency...
    assert store.get("slowest")["ms"] == 500.0
    assert store.get("second")["ms"] == 400.0
    # ...while plain old traces age out of the ring
    assert store.get("fast0") is None
    assert store.get("fast99") is not None
    slow = store.slowest("predict", n=2)
    assert [d["trace_id"] for d in slow] == ["slowest", "second"]
    summary = store.summary()
    assert summary["count"] == 102
    assert summary["by_endpoint"]["predict"] == 102
    assert summary["slowest"]["predict"][0]["trace_id"] == "slowest"
    # bounded: ring + pinned, not one dict per request ever seen
    assert summary["kept"] <= 8 + 2


def test_store_reused_client_id_holds_exactly_one_slot():
    """A client retrying with the same X-Request-Id (the docs encourage
    reuse) must not burn two tail slots or leave a stale doc behind —
    the newest doc wins everywhere."""
    store = rt.TraceStore(ring=8, slowest_k=2)
    store.add(_trace("ticket-1", 300.0))
    store.add(_trace("other", 200.0))
    store.add(_trace("ticket-1", 50.0))  # the retry, faster
    assert store.get("ticket-1")["ms"] == 50.0
    slow = store.slowest("predict", n=4)
    ids = [d["trace_id"] for d in slow]
    assert ids.count("ticket-1") == 1
    # the stale 300ms entry no longer occupies a pinned slot: both
    # distinct requests hold exactly one each
    assert set(ids) == {"other", "ticket-1"}
    assert [d["ms"] for d in slow] == [200.0, 50.0]


def test_slo_and_histograms_survive_trace_off():
    """BIGDL_TRACE=off disables trace RECORDING only: the declared
    budgets keep burning and the bench gate keeps gating — an SLO
    violation must never pass CI because tracing was off."""
    import urllib.request as _url

    from bigdl_tpu.models import registry
    from bigdl_tpu.serving import serve_model
    from bigdl_tpu.utils.config import BigDLConfig, set_config

    set_config(BigDLConfig(trace_requests=False))
    try:
        model = registry.build_model("lenet")
        server = serve_model(model, registry.input_spec("lenet", 1),
                             name="lenet", host="127.0.0.1", port=0,
                             max_batch=4, batch_buckets=[4],
                             max_wait_ms=1.0, slo_p99_ms=0.001)
        try:
            code, body, hdrs = _post(
                server.port, {"inputs": np.zeros((1, 784)).tolist()})
            assert code == 200
            # the id echo stays (propagation is the contract)...
            assert rt.valid_id(hdrs["X-Request-Id"])
            # ...recording is off...
            assert server.traces is None
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(server.port,
                     f"/v1/trace/{hdrs['X-Request-Id']}")
            assert ei.value.code == 404
            # ...but the budgets burned and the histograms filled
            assert server.slo.violations >= 1
            assert server.slo.burn()["p99"]["burn"] > 1.0
            metrics = _url.urlopen(
                f"http://127.0.0.1:{server.port}/metrics",
                timeout=10).read().decode()
            assert 'bigdl_serve_latency_ms_count{model="lenet",' \
                   'endpoint="predict"} 1' in metrics
            assert "bigdl_slo_p99_burn_ratio" in metrics
        finally:
            server.stop(drain=False)
    finally:
        set_config(None)


def test_store_rejected_requests_counted_but_never_pin_tail_slots():
    store = rt.TraceStore(ring=4, slowest_k=1)
    store.add(_trace("rej", 900.0, status="rejected",
                     reason="queue_full"))
    store.add(_trace("slow", 50.0))
    assert store.rejections == {"queue_full": 1}
    # a rejected request is fast by construction: the tail slot belongs
    # to the slowest COMPLETED request even though the rejection's
    # recorded wall was larger
    assert [d["trace_id"] for d in store.slowest()] == ["slow"]


def test_trace_span_cap_keeps_component_accounting_complete():
    from bigdl_tpu.serving.server import ModelServer

    tr = rt.RequestTrace("t", "generate", started_at=1000.0,
                         max_spans=4)
    for i in range(10):
        tr.add_span("decode", 1000.0 + i, 2.0, component="compute")
    assert len(tr.spans) == 4 and tr.spans_dropped == 6
    # spans past the cap still landed in the tally
    assert tr.components["compute"] == pytest.approx(20.0)
    tr.finish(now=1000.025)  # 25ms wall: 20 accounted + 5 residual
    assert tr.to_dict()["spans_dropped"] == 6
    # the host residual is judged against the COMPONENT tally, not the
    # truncated span list — dropped iterations must not be re-counted
    ModelServer._close_books(tr)
    assert tr.components.get("host", 0.0) == pytest.approx(5.0, abs=0.1)
    assert sum(tr.components.values()) == pytest.approx(25.0, abs=0.1)


# -- blame verdict ------------------------------------------------------------
def _warm_baseline(**medians):
    base = rt.ComponentBaseline()
    for _ in range(rt.BASELINE_MIN_SAMPLES):
        base.observe_components(dict(medians))
    return base


def test_blame_needs_a_warmed_baseline():
    base = rt.ComponentBaseline()
    base.observe_components({"compute": 5.0})
    assert rt.blame_verdict({"queue_wait": 500.0}, base) is None


def test_blame_names_the_attributable_excess_not_compute():
    base = _warm_baseline(queue_wait=1.0, compute=10.0)
    # healthy request: no verdict
    assert rt.blame_verdict({"queue_wait": 1.2, "compute": 10.5},
                            base) is None
    # a queue stall is blamed on queue_wait even though compute also
    # drifted a little
    v = rt.blame_verdict({"queue_wait": 250.0, "compute": 11.0}, base)
    assert v["cause"] == "queue_wait"
    assert v["excess_ms"] == pytest.approx(249.0)
    assert v["baseline_ms"] == pytest.approx(1.0)
    # compute is the residual verdict: blamed only when nothing
    # attributable explains the excess
    v = rt.blame_verdict({"queue_wait": 1.0, "compute": 80.0}, base)
    assert v["cause"] == "compute"
    # sub-floor blips are not verdicts (2ms excess on a tiny request)
    assert rt.blame_verdict({"queue_wait": 3.0, "compute": 10.0},
                            base) is None


# -- histograms + SLO ---------------------------------------------------------
def test_latency_histogram_openmetrics_cumulative():
    h = rt.LatencyHistogram()
    for ms in (0.5, 3.0, 3.0, 40.0, 99999.0):
        h.observe(ms)
    h.observe(float("nan"))  # dropped, not corrupting
    lines = h.openmetrics("bigdl_serve_latency_ms",
                          'model="m",endpoint="predict"')
    assert lines[0] == "# TYPE bigdl_serve_latency_ms histogram"
    by_le = {}
    for ln in lines:
        if "_bucket" in ln:
            le = ln.split('le="')[1].split('"')[0]
            by_le[le] = int(ln.rsplit(" ", 1)[1])
    assert by_le["1"] == 1       # 0.5
    assert by_le["5"] == 3       # + the two 3.0s
    assert by_le["50"] == 4      # + 40.0
    assert by_le["10000"] == 4   # 99999 is over every bound
    assert by_le["+Inf"] == 5
    assert lines[-1].endswith(" 5")  # _count
    # cumulative counts never decrease (the OpenMetrics contract)
    seq = [by_le[f"{b:g}"] for b in rt.LATENCY_BUCKETS_MS]
    assert seq == sorted(seq)


def test_slo_tracker_burn_rates_and_violation_ledger():
    slo = rt.SLOTracker(p99_ms=10.0, ttft_ms=5.0)
    assert slo.active()
    for i in range(20):
        slo.observe(2.0, f"ok{i}", ttft_ms=1.0)
    assert slo.observe(50.0, "bad", ttft_ms=20.0) == ["p99", "ttft"]
    burn = slo.burn()
    assert burn["p99"]["burn"] == pytest.approx(5.0)   # 50 / 10
    assert burn["ttft"]["burn"] == pytest.approx(4.0)  # 20 / 5
    st = slo.status()
    assert st["violations"] == 1
    assert st["violating"][0]["trace_id"] == "bad"
    assert st["violating"][0]["violated"] == ["p99", "ttft"]
    assert not rt.SLOTracker().active()  # no budgets -> no gate


# -- offline: chrome lanes, waterfall text, summary ---------------------------
def _request_event(tid="abc123", endpoint="predict"):
    tr = rt.RequestTrace(tid, endpoint, started_at=1000.0)
    tr.add_span("queue_wait", 1000.0, 3.0, component="queue_wait")
    tr.add_span("infer", 1000.003, 7.0, component="compute")
    tr.note_token(1000.004)
    tr.finish(now=1000.010)
    doc = tr.to_dict()
    doc.update(kind="request", ts=1000.0, pid=0)
    return doc


def test_chrome_trace_renders_request_lanes():
    from bigdl_tpu.telemetry.chrome_trace import chrome_trace

    evs = [_request_event("req-a"), _request_event("req-b", "generate")]
    out = chrome_trace(evs)["traceEvents"]
    names = [e for e in out if e.get("ph") == "M"
             and e.get("name") == "thread_name"]
    labels = {e["args"]["name"] for e in names}
    assert "req req-a [predict]" in labels
    assert "req req-b [generate]" in labels
    # each request gets its OWN lane (distinct tid), spans ride it as
    # complete events, token emits as instants
    lanes = {e["args"]["name"]: e["tid"] for e in names}
    assert lanes["req req-a [predict]"] != lanes["req req-b [generate]"]
    spans = [e for e in out if e.get("ph") == "X"
             and e.get("cat") == "request"]
    assert {e["name"] for e in spans} == {"queue_wait", "infer"}
    assert all(e["args"]["trace_id"] in ("req-a", "req-b")
               for e in spans)
    toks = [e for e in out if e.get("ph") == "i"
            and e.get("cat") == "request"]
    assert len(toks) == 2


def test_format_trace_and_summarize_requests():
    doc = _request_event()
    doc["blame"] = {"cause": "queue_wait", "excess_ms": 2.0,
                    "baseline_ms": 1.0, "floor_ms": 5.0}
    text = rt.format_trace(doc)
    assert "abc123" in text and "blame=queue_wait" in text
    assert "queue_wait" in text and "infer" in text
    rej = {"kind": "request", "trace_id": "r1", "endpoint": "predict",
           "ms": 0.2, "status": "rejected", "reason": "queue_full",
           "ts": 1.0}
    summary = rt.summarize_requests([doc, rej])
    assert summary["requests"] == 2
    assert summary["rejections"] == {"queue_full": 1}
    ep = summary["endpoints"]["predict"]
    assert ep["count"] == 2 and ep["completed"] == 1
    assert ep["slowest"][0]["trace_id"] == "abc123"
    assert ep["slowest"][0]["blame"] == "queue_wait"


# -- live HTTP: predict -------------------------------------------------------
@pytest.fixture(scope="module")
def lenet_server():
    from bigdl_tpu.models import registry
    from bigdl_tpu.serving import serve_model

    model = registry.build_model("lenet")
    server = serve_model(model, registry.input_spec("lenet", 1),
                         name="lenet", host="127.0.0.1", port=0,
                         max_batch=8, batch_buckets=[1, 2, 4, 8],
                         max_wait_ms=2.0, slo_p99_ms=10_000.0)
    try:
        yield server
    finally:
        server.stop(drain=False)


def _post(port, payload, headers=None, path="/v1/predict",
          timeout=30.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read()), dict(r.headers)


def _get(port, path, timeout=10.0):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def test_header_propagation_minting_and_echo(lenet_server):
    server = lenet_server
    x = {"inputs": np.zeros((1, 784)).tolist()}
    # a valid client id is propagated and echoed...
    code, body, hdrs = _post(server.port, x,
                             headers={"X-Request-Id": "ticket-4711"})
    assert code == 200
    assert hdrs["X-Request-Id"] == "ticket-4711"
    assert body["trace_id"] == "ticket-4711"
    # ...and names the retained trace
    doc = _get(server.port, "/v1/trace/ticket-4711")
    assert doc["trace_id"] == "ticket-4711"
    assert doc["endpoint"] == "predict" and doc["status"] == "ok"
    # no header -> a minted id, still echoed
    code, body, hdrs = _post(server.port, x)
    assert rt.valid_id(hdrs["X-Request-Id"])
    assert body["trace_id"] == hdrs["X-Request-Id"]
    # an unsafe header value is REPLACED by a minted id, not propagated
    code, body, hdrs = _post(
        server.port, x, headers={"X-Request-Id": "x" * 200})
    assert hdrs["X-Request-Id"] != "x" * 200
    assert rt.valid_id(hdrs["X-Request-Id"])
    # unknown ids 404 with the retention window named
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server.port, "/v1/trace/never-seen")
    assert ei.value.code == 404


def test_predict_span_completeness_and_status_traces(lenet_server):
    server = lenet_server
    code, body, _ = _post(server.port,
                          {"inputs": np.zeros((3, 784)).tolist()})
    assert code == 200
    doc = _get(server.port, f"/v1/trace/{body['trace_id']}")
    # every millisecond of wall time is owned by exactly one span: the
    # span sum equals the recorded wall within 5% (the residual becomes
    # an explicit `host` span, never a silent gap)
    span_sum = sum(s["ms"] for s in doc["spans"])
    assert span_sum == pytest.approx(doc["ms"], rel=0.05)
    names = [s["name"] for s in doc["spans"]]
    assert "parse" in names and "queue_wait" in names
    assert "infer" in names
    comp = doc["components"]
    assert comp["compute"] > 0 and "queue_wait" in comp
    # /status.traces: the evidence index
    st = _get(server.port, "/status")
    traces = st["serving"]["traces"]
    assert traces["count"] >= 1
    assert traces["by_endpoint"]["predict"] >= 1
    assert traces["slowest"]["predict"][0]["trace_id"]
    # declared budget -> /status.slo + burn gauges on /metrics
    assert st["serving"]["slo"]["budgets"]["p99_ms"] == 10_000.0
    metrics = urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}/metrics",
        timeout=10).read().decode()
    assert "bigdl_serve_latency_ms_bucket" in metrics
    assert 'le="+Inf"' in metrics
    assert "bigdl_slo_p99_burn_ratio" in metrics
    # the ring-buffer gauges tpu_watch.sh keys on stayed
    assert "bigdl_serve_p99_ms" in metrics


def test_rejected_requests_leave_terminal_traces(lenet_server):
    server = lenet_server
    release = threading.Event()
    inner = server.batcher.runner
    old_limit, old_timeout = (server.batcher.queue_limit,
                              server.request_timeout_s)

    def slow(xx, **kw):
        release.wait(10.0)
        return inner(xx, **kw)

    server.batcher.runner = slow
    server.batcher.queue_limit = 1
    server.batcher._q.maxsize = 1
    codes, lock = {}, threading.Lock()

    def client(i):
        try:
            code, _, _ = _post(server.port,
                               {"inputs": np.zeros((1, 784)).tolist()},
                               headers={"X-Request-Id": f"rej-{i}"})
        except urllib.error.HTTPError as e:
            code = e.code
        with lock:
            codes[i] = code

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(5)]
        for t in threads:
            t.start()
            time.sleep(0.05)
        release.set()
        for t in threads:
            t.join(30.0)
    finally:
        release.set()
        server.batcher.runner = inner
        server.batcher.queue_limit = old_limit
        server.batcher._q.maxsize = old_limit
        server.request_timeout_s = old_timeout
    rejected = [i for i, c in codes.items() if c == 429]
    assert rejected, codes
    # a 429 leaves a terminal-span trace with the rejection reason —
    # rejection spikes stay diagnosable post-hoc
    doc = _get(server.port, f"/v1/trace/rej-{rejected[0]}")
    assert doc["status"] == "rejected"
    assert doc["reason"] == "queue_full"
    assert doc["spans"][-1]["name"] == "rejected"
    assert sum(s["ms"] for s in doc["spans"]) == \
        pytest.approx(doc["ms"], rel=0.05)
    # counted per reason in the store and on /metrics
    st = _get(server.port, "/status")
    assert st["serving"]["traces"]["rejections"]["queue_full"] >= 1
    metrics = urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}/metrics",
        timeout=10).read().decode()
    assert 'bigdl_serve_rejected_by_reason_total' in metrics
    assert 'reason="queue_full"' in metrics


def test_dispatch_failure_keeps_the_id_contract(lenet_server):
    """A worker exception (500) still echoes X-Request-Id and lands a
    terminal error trace — server-side failures are the requests most
    in need of post-hoc evidence."""
    server = lenet_server
    inner = server.batcher.runner

    def boom(xx, **kw):
        server.batcher.runner = inner
        raise RuntimeError("injected dispatch failure")

    server.batcher.runner = boom
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server.port, {"inputs": np.zeros((1, 784)).tolist()},
                  headers={"X-Request-Id": "boom-1"})
    finally:
        server.batcher.runner = inner
    assert ei.value.code == 500
    assert ei.value.headers["X-Request-Id"] == "boom-1"
    doc = _get(server.port, "/v1/trace/boom-1")
    assert doc["status"] == "error"
    assert "injected dispatch failure" in doc["reason"]


def test_draining_rejection_leaves_a_trace(lenet_server):
    server = lenet_server
    server._term.set()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server.port, {"inputs": np.zeros((1, 784)).tolist()},
                  headers={"X-Request-Id": "drained-1"})
        assert ei.value.code == 503
        assert ei.value.headers["X-Request-Id"] == "drained-1"
    finally:
        server._term.clear()
    doc = _get(server.port, "/v1/trace/drained-1")
    assert doc["status"] == "rejected" and doc["reason"] == "draining"


def test_predict_dispatch_timeout_burns_the_slo_budget(lenet_server):
    """A 504's wall is real waiting the client did: it must enter the
    SLO burn, the violation ledger, and the latency histogram — an
    overloaded server timing out its requests must not pass the SLO
    gate on the strength of the requests it managed to answer."""
    server = lenet_server
    release = threading.Event()
    inner = server.batcher.runner

    def wedge(xx, **kw):
        release.wait(10.0)
        return inner(xx, **kw)

    old_timeout = server.request_timeout_s
    old_budget = server.slo.p99_ms
    hist_before = server._hist["predict"]._count
    server.batcher.runner = wedge
    server.request_timeout_s = 0.2
    server.slo.p99_ms = 50.0  # the ~200ms timeout wall must violate
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server.port, {"inputs": np.zeros((1, 784)).tolist()},
                  headers={"X-Request-Id": "slow-504"})
        assert ei.value.code == 504
        assert ei.value.headers["X-Request-Id"] == "slow-504"
    finally:
        release.set()
        server.batcher.runner = inner
        server.request_timeout_s = old_timeout
        server.slo.p99_ms = old_budget
    doc = _get(server.port, "/v1/trace/slow-504")
    assert doc["status"] == "rejected"
    assert doc["reason"] == "dispatch_timeout"
    assert "p99" in doc.get("slo_violated", [])
    ledger = server.slo.status()["violating"]
    assert any(v["trace_id"] == "slow-504" for v in ledger), ledger
    assert server._hist["predict"]._count == hist_before + 1


def test_slo_ledger_keeps_the_worst_violators_not_the_newest():
    """Under a sustained burn the ledger is bounded at VIOLATING_KEEP
    — and keeps the WORST violators by budget overshoot, worst-first,
    so a long burn cannot evict its own catastrophic evidence with a
    tail of mild ones."""
    slo = rt.SLOTracker(p99_ms=10.0)
    # one catastrophic early violator, then a long tail of mild ones
    slo.observe(500.0, "catastrophe")
    for i in range(rt.VIOLATING_KEEP + 8):
        slo.observe(11.0 + i * 0.01, f"mild-{i}")
    st = slo.status()
    assert slo.violations == rt.VIOLATING_KEEP + 9
    assert len(st["violating"]) == rt.VIOLATING_KEEP
    assert st["violating"][0]["trace_id"] == "catastrophe"
    assert st["violating"][0]["severity"] == pytest.approx(50.0)
    kept = {v["trace_id"] for v in st["violating"]}
    assert "mild-0" not in kept  # the mildest fell off, not the worst


def test_slo_tracker_rejects_a_zero_budget_loudly():
    """`--slo-p99-ms 0` must not silently DISABLE the gate (0 is falsy
    — the old check dropped the budget and the bench exited 0 with no
    burn accounting at all)."""
    with pytest.raises(ValueError, match="must be > 0"):
        rt.SLOTracker(p99_ms=0.0)
    with pytest.raises(ValueError, match="must be > 0"):
        rt.SLOTracker(p99_ms=10.0, ttft_ms=0)
    assert rt.SLOTracker(p99_ms=None).active() is False  # None still ok


def test_diff_run_log_counts_rejected_504_violations(tmp_path):
    """`telemetry diff` run-log metrics: a rejected-504 that blew the
    budget counts in slo_violations (the zero-slack gate must see it)
    and its wall enters the request percentiles, while an instant 429
    stays out of the latency set."""
    from bigdl_tpu.telemetry.diff import run_log_metrics

    log = tmp_path / "run.jsonl"
    base = {"v": 1, "kind": "request", "ts": 1000.0}
    rows = [
        dict(base, trace_id="ok1", endpoint="predict", ms=10.0,
             status="ok"),
        dict(base, trace_id="t504", endpoint="predict", ms=30000.0,
             status="rejected", reason="dispatch_timeout",
             slo_violated=["p99"]),
        dict(base, trace_id="t429", endpoint="predict", ms=0.1,
             status="rejected", reason="queue_full"),
    ]
    log.write_text("".join(json.dumps(r) + "\n" for r in rows))
    m = run_log_metrics(str(log))
    assert m["slo_violations"] == 1
    # the 504's wall dominates the p99; the 429's 0.1ms is excluded
    assert m["request_p99_ms"] > 10_000.0
    assert m["request_p50_ms"] >= 10.0


def test_untraced_generate_timeout_burns_the_real_wall(gen_server):
    """With BIGDL_TRACE=off a token-less generate 504 must observe the
    enqueue-to-retire wall (stats()['dur_s'] reads 0.0 with no tokens
    — a window of zeros would read as a healthy burn)."""
    server = gen_server
    old_traces, old_timeout = server.traces, server.request_timeout_s
    old_budget = server.slo.p99_ms
    server.traces = None  # recording off; budgets must keep burning
    server.request_timeout_s = 0.02
    server.slo.p99_ms = 5.0
    lat_before = len(server.slo._lat)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _generate(server.port,
                      {"prompt": [1, 2, 3], "max_new_tokens": 60,
                       "stream": False})
        assert ei.value.code == 504
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline \
                and len(server.slo._lat) == lat_before:
            time.sleep(0.02)
    finally:
        server.traces = old_traces
        server.request_timeout_s = old_timeout
        server.slo.p99_ms = old_budget
    assert len(server.slo._lat) > lat_before
    assert server.slo._lat[-1] >= 15.0  # the ~20ms wall, not dur_s=0


def test_request_fold_counts_rejected_violations_in_both_tallies():
    """The shared RequestFold: a 504 dispatch timeout is BOTH a
    per-reason rejection and (its full wall observed) an SLO violation
    — and the MetricsSink and fleet HostState fold through the one
    implementation."""
    from bigdl_tpu.telemetry.fleet import HostState
    from bigdl_tpu.telemetry.metrics_http import MetricsSink

    fold = rt.RequestFold()
    fold.fold({"kind": "request", "trace_id": "t1", "endpoint":
               "predict", "ms": 30000.0, "status": "rejected",
               "reason": "dispatch_timeout", "slo_violated": ["p99"]})
    assert fold.rejections == {"dispatch_timeout": 1}
    assert fold.slo_violations == 1
    # rejected requests never become the slowest-completed exemplar
    assert fold.slowest == {}
    assert isinstance(MetricsSink().requests, rt.RequestFold)
    assert isinstance(HostState("p0.jsonl").requests, rt.RequestFold)


def test_each_frontend_status_reports_itself(lenet_server, gen_server):
    """With several live servers in one process, each port's /status
    must carry ITS OWN serving block — the observer merge used to
    overwrite it with whichever server registered serving.get() last."""
    st_l = _get(lenet_server.port, "/status")
    st_g = _get(gen_server.port, "/status")
    assert st_l["serving"]["model"] == "lenet"
    assert st_g["serving"]["model"] == "tlm"


# -- the acceptance e2e: injected queue stall -> queue_wait blame -------------
@pytest.mark.deadline(60)
def test_queue_stall_is_blamed_on_queue_wait_not_the_cobatch(
        lenet_server, tmp_path):
    """Mixed load with one injected ~250ms queue stall: the stalled
    request's waterfall sums to its wall time within 5%, the blame
    verdict names queue_wait, a healthy co-batched request is NOT
    blamed, and `telemetry trace --slowest` reproduces the waterfall
    offline from the run log."""
    from bigdl_tpu import telemetry

    server = lenet_server
    x = {"inputs": np.zeros((1, 784)).tolist()}
    log = str(tmp_path / "run.jsonl")
    with telemetry.run(log):
        # warm the endpoint baseline: blame verdicts need
        # BASELINE_MIN_SAMPLES healthy requests to judge against
        for _ in range(rt.BASELINE_MIN_SAMPLES + 4):
            _post(server.port, x)
        # inject the stall: the worker blocks ~250ms inside a dispatch
        # while the victim sits in the queue behind it
        inner = server.batcher.runner
        stalled, release = threading.Event(), threading.Event()

        def stall_once(xx, **kw):
            server.batcher.runner = inner
            stalled.set()
            release.wait(10.0)
            return inner(xx, **kw)

        results = {}

        def client(name, headers):
            code, body, _ = _post(server.port, x, headers=headers)
            results[name] = (code, body)

        server.batcher.runner = stall_once
        t_blocker = threading.Thread(
            target=client, args=("blocker", {}))
        t_blocker.start()
        assert stalled.wait(10.0)
        t0 = time.perf_counter()
        t_victim = threading.Thread(
            target=client,
            args=("victim", {"X-Request-Id": "victim-1"}))
        t_victim.start()
        time.sleep(0.25)  # the victim's injected queue wait
        # the rider lands in the queue JUST before the stall lifts, so
        # it co-batches with the victim but waited almost nothing
        t_rider = threading.Thread(
            target=client, args=("rider", {"X-Request-Id": "rider-1"}))
        t_rider.start()
        deadline = time.time() + 10.0
        while server.batcher._q.qsize() < 2 and time.time() < deadline:
            time.sleep(0.001)
        release.set()
        for t in (t_blocker, t_victim, t_rider):
            t.join(30.0)
        victim_wall_ms = (time.perf_counter() - t0) * 1000.0
    assert all(code == 200 for code, _ in results.values()), results

    doc = _get(server.port, "/v1/trace/victim-1")
    # complete waterfall: spans sum to the observed wall within 5%
    span_sum = sum(s["ms"] for s in doc["spans"])
    assert span_sum == pytest.approx(doc["ms"], rel=0.05)
    assert doc["ms"] <= victim_wall_ms * 1.05
    # the verdict names the stall...
    assert doc["components"]["queue_wait"] > 200.0
    assert doc["blame"]["cause"] == "queue_wait"
    assert doc["blame"]["excess_ms"] > 150.0
    # ...and does NOT blame the healthy co-batched request that rode
    # the same dispatch (its own queue wait was a few ms)
    rider = _get(server.port, "/v1/trace/rider-1")
    assert rider["components"].get("queue_wait", 0.0) < 100.0
    assert (rider.get("blame") or {}).get("cause") != "queue_wait"
    # the victim is now the retained tail exemplar
    st = _get(server.port, "/status")
    slowest = st["serving"]["traces"]["slowest"]["predict"]
    assert "victim-1" in [r["trace_id"] for r in slowest]

    # offline twin: `telemetry trace run.jsonl --slowest 3` reproduces
    # the same waterfall from the run log's `request` events
    out = subprocess.run(
        [sys.executable, "-m", "bigdl_tpu.telemetry", "trace", log,
         "--slowest", "3"],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "victim-1" in out.stdout
    assert "blame=queue_wait" in out.stdout
    assert "queue_wait" in out.stdout and "infer" in out.stdout
    # --id renders exactly the victim; --chrome exports request lanes
    chrome = str(tmp_path / "req.json")
    out = subprocess.run(
        [sys.executable, "-m", "bigdl_tpu.telemetry", "trace", log,
         "--id", "victim-1", "--chrome", chrome],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=120)
    assert out.returncode == 0, out.stderr
    lanes = json.load(open(chrome))["traceEvents"]
    assert any(e.get("args", {}).get("name") ==
               "req victim-1 [predict]" for e in lanes)


# -- live HTTP: generate ------------------------------------------------------
@pytest.fixture(scope="module")
def gen_server():
    import jax

    from bigdl_tpu.models.transformer import build_transformer_lm
    from bigdl_tpu.serving import serve_model
    from bigdl_tpu.utils.rng import RNG

    RNG.set_seed(7)
    model = build_transformer_lm(vocab_size=VOCAB, num_layers=2,
                                 embed_dim=32, num_heads=2, max_len=64,
                                 scan=False).evaluate()
    spec = jax.ShapeDtypeStruct((1, 16), np.int32)
    server = serve_model(model, spec, name="tlm", host="127.0.0.1",
                         port=0, max_batch=2, batch_buckets=[1, 2],
                         seq_buckets=[16], max_wait_ms=1.0,
                         generate=True, decode_buckets=[1, 2],
                         cache_buckets=[64])
    try:
        yield server
    finally:
        server.stop(drain=False)


def _generate(port, payload, headers=None, timeout=60.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return (r.status, [json.loads(l) for l in r if l.strip()],
                dict(r.headers))


def test_generate_trace_decomposes_ttft_and_inter_token(gen_server):
    server = gen_server
    code, lines, hdrs = _generate(
        server.port, {"prompt": [1, 2, 3], "max_new_tokens": 5},
        headers={"X-Request-Id": "gen-1"})
    assert code == 200
    assert hdrs["X-Request-Id"] == "gen-1"
    done = lines[-1]
    assert done["done"] is True and done["trace_id"] == "gen-1"
    doc = _get(server.port, "/v1/trace/gen-1")
    assert doc["endpoint"] == "generate" and doc["status"] == "ok"
    names = [s["name"] for s in doc["spans"]]
    # TTFT decomposes: parse -> queue_wait -> prefill; inter-token time
    # decomposes into the decode iterations the request actually rode
    assert names.index("queue_wait") < names.index("prefill")
    decodes = [s for s in doc["spans"] if s["name"] == "decode"]
    assert len(decodes) == 4  # 5 tokens: 1 off the prefill + 4 decodes
    assert all("co_batch" in s for s in decodes)
    assert len(doc["token_ts"]) == 5
    assert doc["ttft_ms"] > 0 and doc["n_tokens"] == 5
    # span completeness holds on the generate path too
    span_sum = sum(s["ms"] for s in doc["spans"])
    assert span_sum == pytest.approx(doc["ms"], rel=0.05)
    metrics = urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}/metrics",
        timeout=10).read().decode()
    assert 'bigdl_serve_latency_ms_bucket{model="tlm",' \
           'endpoint="generate"' in metrics
    assert "bigdl_serve_ttft_ms_bucket" in metrics
    # exactly ONE TYPE line per metric family even with both endpoint
    # label sets present — a duplicate makes strict scrapers drop the
    # whole scrape
    assert metrics.count("# TYPE bigdl_serve_latency_ms histogram") == 1


@pytest.mark.deadline(60)
def test_prefill_flood_is_blamed_on_interference(gen_server):
    """A healthy decode stream that stalls because the worker keeps
    prefilling OTHER requests is blamed on prefill_interference — not
    on its own compute."""
    server = gen_server
    rng = np.random.default_rng(3)
    # warm the generate baseline with sequential healthy requests
    for _ in range(rt.BASELINE_MIN_SAMPLES + 2):
        code, _, _ = _generate(server.port,
                               {"prompt": rng.integers(
                                   1, VOCAB, 3).tolist(),
                                "max_new_tokens": 3})
        assert code == 200
    results, errors = {}, []

    def client(name, prompt, n):
        try:
            hdr = {"X-Request-Id": name}
            results[name] = _generate(
                server.port, {"prompt": prompt, "max_new_tokens": n},
                headers=hdr)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append((name, e))

    # the victim decodes many tokens; the flood keeps forcing prefill
    # dispatches into the worker loop while the victim is active
    victim = threading.Thread(
        target=client,
        args=("flood-victim", rng.integers(1, VOCAB, 4).tolist(), 55))
    victim.start()
    time.sleep(0.01)
    flood = [threading.Thread(
        target=client,
        args=(f"flood-{i}", rng.integers(1, VOCAB, 12).tolist(), 2))
        for i in range(8)]
    for t in flood:
        t.start()
        time.sleep(0.005)
    victim.join(120.0)
    for t in flood:
        t.join(120.0)
    assert errors == []
    doc = _get(server.port, "/v1/trace/flood-victim")
    assert doc["components"].get("prefill_interference", 0.0) > 0.0
    assert any(s["name"] == "prefill_interference"
               for s in doc["spans"])
    assert doc["blame"]["cause"] == "prefill_interference", doc["blame"]


@pytest.mark.deadline(60)
def test_generate_dispatch_timeout_is_a_counted_rejection(gen_server):
    """A non-streamed /v1/generate 504 leaves a dispatch_timeout
    REJECTION record (per-reason counters, /status.traces.rejections)
    exactly like the predict path — not an anonymous cancellation."""
    server = gen_server
    old_timeout = server.request_timeout_s
    server.request_timeout_s = 0.02  # 60 tokens cannot finish in 20ms
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _generate(server.port,
                      {"prompt": [1, 2, 3], "max_new_tokens": 60,
                       "stream": False},
                      headers={"X-Request-Id": "gen-504"})
        assert ei.value.code == 504
        assert ei.value.headers["X-Request-Id"] == "gen-504"
    finally:
        server.request_timeout_s = old_timeout
    # the retire hook lands the trace asynchronously after the cancel
    deadline = time.monotonic() + 30.0
    doc = None
    while time.monotonic() < deadline:
        try:
            doc = _get(server.port, "/v1/trace/gen-504")
            if doc.get("status") == "rejected":
                break
        except urllib.error.HTTPError:
            pass
        time.sleep(0.05)
    assert doc is not None and doc["status"] == "rejected", doc
    assert doc["reason"] == "dispatch_timeout"
    st = _get(server.port, "/status")
    assert st["serving"]["traces"]["rejections"][
        "dispatch_timeout"] >= 1


# -- schema -------------------------------------------------------------------
def test_request_events_are_schema_valid():
    from bigdl_tpu import telemetry
    from bigdl_tpu.models import registry
    from bigdl_tpu.serving import serve_model
    from bigdl_tpu.telemetry import schema

    sink = telemetry.MemorySink()
    with telemetry.run(sinks=[sink]):
        model = registry.build_model("lenet")
        server = serve_model(model, registry.input_spec("lenet", 1),
                             host="127.0.0.1", port=0, max_batch=4,
                             batch_buckets=[4], max_wait_ms=1.0,
                             slo_p99_ms=10_000.0)
        try:
            _post(server.port, {"inputs": np.zeros((2, 784)).tolist()})
        finally:
            server.stop(drain=True)
    reqs = [e for e in sink.events if e.get("kind") == "request"]
    assert len(reqs) == 1
    ev = reqs[0]
    assert ev["endpoint"] == "predict" and ev["status"] == "ok"
    assert rt.valid_id(ev["trace_id"]) and ev["ms"] > 0
    assert ev["spans"] and ev["components"]
    assert ev["slo_p99_ms"] == 10_000.0
    assert schema.validate_events(sink.events) == []
    # the serve batch event now carries the min/mean queue waits beside
    # the worst-case anchor, so aggregates stop overstating the typical
    serves = [e for e in sink.events if e.get("kind") == "serve"]
    assert serves
    batch = serves[0]
    assert {"queue_ms", "queue_ms_min", "queue_ms_mean"} <= set(batch)
    assert batch["queue_ms_min"] <= batch["queue_ms_mean"] \
        <= batch["queue_ms"]


def test_metrics_sink_and_fleet_fold_request_events():
    from bigdl_tpu.telemetry.fleet import HostState
    from bigdl_tpu.telemetry.metrics_http import MetricsSink

    events = [
        _request_event("fast-1"),
        dict(_request_event("slow-1"), ms=777.0,
             blame={"cause": "queue_wait"}, slo_violated=["p99"]),
        {"kind": "request", "trace_id": "r", "endpoint": "predict",
         "ms": 0.1, "status": "rejected", "reason": "queue_full",
         "ts": 2.0},
        {"kind": "gauge", "name": "serve/slo_p99_burn", "value": 0.8,
         "ts": 3.0},
        {"kind": "gauge", "name": "serve/slo_ttft_burn", "value": 0.3,
         "ts": 3.0},
    ]
    sink = MetricsSink()
    for ev in events:
        sink.emit(ev)
    snap = sink.status()["requests"]
    assert snap["count"] == 3
    assert snap["rejections"] == {"queue_full": 1}
    assert snap["slo_violations"] == 1
    assert snap["slowest"]["trace_id"] == "slow-1"
    assert snap["slowest"]["blame"] == "queue_wait"
    body = sink.openmetrics()
    assert "bigdl_request_traces_total" in body
    assert "bigdl_request_slo_violations_total" in body
    # the fleet view folds the same events into per-replica SLO columns
    host = HostState("p0.jsonl")
    host.fold(events)
    row = host.row(now=4.0)
    assert row["slo_p99_burn"] == pytest.approx(0.8)
    assert row["slo_ttft_burn"] == pytest.approx(0.3)
    assert row["slo_violations"] == 1
    assert row["slowest_request"]["trace_id"] == "slow-1"


# -- bench_serving SLO gate (live subprocess) ---------------------------------
@pytest.mark.deadline(60)
def test_bench_serving_slo_gate_exits_4_with_trace_evidence(tmp_path):
    """An impossible p99 budget must burn: exit 4 (the --diff-against
    regression code), the bench JSON row carrying the violating
    requests' trace ids — the failing artifact names its own
    evidence."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "bench_serving.py", "--model", "lenet",
         "--qps", "40", "--duration", "2", "-b", "8",
         "--buckets", "4,8", "--max-wait-ms", "2",
         "--slo-p99-ms", "0.001"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=220)
    assert out.returncode == 4, (out.returncode, out.stderr[-2000:])
    assert "SLO VIOLATED" in out.stderr
    line = [l for l in out.stdout.splitlines() if l.startswith("{")][-1]
    row = json.loads(line)["configs"]["serve_lenet"]
    assert row["slo_violations"] > 0
    slo = row["slo"]
    assert slo["burn"]["p99"]["burn"] > 1.0
    violating = slo["violating"]
    assert violating and all(rt.valid_id(v["trace_id"])
                             for v in violating)
