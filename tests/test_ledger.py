"""Goodput ledger (bigdl_tpu/telemetry/ledger.py, ISSUE 18): run-level
wall-time accounting.

The contract under test is *conservation*: compute plus every badput
category must sum to the wall time the run held the hardware, within
the pinned tolerance — per incarnation, and across a supervised
restart chain where the inter-incarnation gaps are classified
(supervisor backoff vs restart overhead) without counting any second
twice.  Plus the consumption surfaces: the per-run ``goodput`` event,
the ``telemetry goodput`` CLI, the report section, the diff/bench
gates, and the chrome-trace badput lanes.
"""

import json
import os
import signal
import sys
import time

import pytest

from bigdl_tpu.telemetry import ledger

TOL = ledger.DEFAULT_TOLERANCE_PCT


def _ev(kind, ts, pid=100, **fields):
    d = {"v": 1, "ts": ts, "pid": pid, "tid": 1, "kind": kind}
    d.update(fields)
    return d


def _single_incarnation():
    """10s wall: 2s compile, 4s of steps (0.5s of it input-stalled),
    2s checkpoint, 2s unexplained."""
    return [
        _ev("run_start", 0.0, meta={"process_index": 0, "incarnation": 0}),
        _ev("compile", 2.0, name="train_step", dur=2.0),
        _ev("step", 4.0, step=0, dur=2.0),
        _ev("span_end", 4.0, name="data_wait", span=1, dur=0.5),
        _ev("step", 6.0, step=1, dur=2.0),
        _ev("span_end", 8.5, name="checkpoint", span=2, dur=2.0),
        _ev("run_end", 10.0, dur=10.0),
    ]


def _incarnation_chain():
    """p0 dies at t=10 (SIGKILL), supervisor books 3s backoff at t=12,
    incarnation 1 restarts at t=15: a 5s gap = 3s backoff + 2s restart
    overhead."""
    inc0 = [
        _ev("run_start", 0.0, 100,
            meta={"process_index": 0, "incarnation": 0}),
        _ev("compile", 2.0, 100, name="train_step", dur=2.0),
        _ev("step", 4.0, 100, step=0, dur=2.0),
        _ev("step", 6.0, 100, step=1, dur=2.0),
        _ev("step", 8.0, 100, step=2, dur=2.0),
        _ev("step", 10.0, 100, step=3, dur=2.0),
    ]
    sup = [
        _ev("run_start", 0.0, 50, meta={"cmd": "supervise",
                                        "role": "supervisor",
                                        "declared_n": 1}),
        _ev("event", 12.0, 50, name="cluster/restart", incarnation=0,
            restart=1, budget=5, width=1, declared_n=1, exits=[-9],
            backoff_s=3.0),
        _ev("run_end", 30.0, 50, dur=30.0),
    ]
    inc1 = [
        _ev("run_start", 15.0, 200,
            meta={"process_index": 0, "incarnation": 1}),
        _ev("stage", 15.5, 200, name="checkpoint/restore", dur=0.5,
            source="ckpt"),
        _ev("stage", 16.0, 200, name="resume/fast_forward", dur=0.5,
            records=128),
        _ev("step", 18.0, 200, step=4, dur=2.0),
        _ev("step", 20.0, 200, step=5, dur=2.0),
        _ev("step", 22.0, 200, step=6, dur=2.0),
        _ev("step", 24.0, 200, step=7, dur=2.0),
        _ev("run_end", 25.0, 200, dur=10.0),
    ]
    return [("inc0.jsonl", inc0), ("sup.jsonl", sup),
            ("inc1.jsonl", inc1)]


def _assert_conserves(report, tol=TOL):
    total = report["compute_s"] + sum(report["badput"].values())
    assert abs(total - report["wall_s"]) <= report["wall_s"] * tol / 100
    assert report["conservation_err_pct"] <= tol


# -- conservation ------------------------------------------------------------
def test_single_run_categories_sum_to_wall():
    r = ledger.goodput_from_events(_single_incarnation())
    assert r["wall_s"] == pytest.approx(10.0)
    _assert_conserves(r)
    # every instrument landed in its category, unexplained time in idle
    assert r["badput"]["compile"] == pytest.approx(2.0)
    assert r["badput"]["data_wait"] == pytest.approx(0.5)
    assert r["badput"]["checkpoint"] == pytest.approx(2.0)
    assert r["badput"]["idle"] == pytest.approx(4.0)
    assert r["compute_s"] == pytest.approx(1.5)
    assert r["goodput_pct"] == pytest.approx(15.0)
    assert r["blame"]["cause"] == "idle"


def test_in_step_carve_never_exceeds_step_time():
    """A mis-scaled instrument (comms seconds > the whole step) must
    not push in-step badput past the time the steps took."""
    events = [
        _ev("run_start", 0.0, meta={"process_index": 0}),
        _ev("step", 1.0, step=0, dur=1.0),
        _ev("comms", 1.0, measured_s=50.0),
        _ev("run_end", 2.0, dur=2.0),
    ]
    r = ledger.goodput_from_events(events)
    assert r["badput"]["comms"] <= 1.0
    _assert_conserves(r)


def test_retry_backoff_killed_mid_sleep_is_trimmed_to_wall():
    """``run/retry`` fires BEFORE its sleep: a process killed mid-backoff
    (the supervised peer-kill shape — found live by the verify drive)
    charged badput past its own wall and broke conservation; the
    unelapsed tail must be trimmed, while fully-slept retries keep
    their face value."""
    events = [
        _ev("run_start", 0.0, meta={"process_index": 0}),
        _ev("step", 1.0, step=0, dur=1.0),
        # slept in full: the next event is past ts + backoff_s
        _ev("event", 2.0, name="run/retry", attempt=1, backoff_s=1.0),
        _ev("step", 4.0, step=1, dur=1.0),
        # killed 0.5s into a 5s backoff — the log simply ends
        _ev("event", 4.5, name="run/retry", attempt=2, backoff_s=5.0),
        _ev("event", 5.0, name="straggler/timeout", budget_s=0.0),
    ]
    r = ledger.goodput_from_events(events)
    assert r["wall_s"] == pytest.approx(5.0)
    # 1.0 fully slept + only the 0.5 of the second backoff the wall saw
    assert r["badput"]["retry_backoff"] == pytest.approx(1.5)
    _assert_conserves(r)


def test_staleness_barrier_wait_charged_to_straggler_badput():
    """A fast host holding the local-SGD door open for a laggard
    (``sync/staleness`` ``waited_s`` — parallel/local_sync.py) lands in
    the SAME ``straggler`` blame column as a straggler-guard trip, and
    the in-step carve still caps it at the time the steps took."""
    events = [
        _ev("run_start", 0.0, meta={"process_index": 0}),
        _ev("step", 1.0, step=0, dur=1.0),
        _ev("step", 2.0, step=1, dur=1.0),
        # the survivor waited 0.7s of those steps at the barrier; a
        # zero-wait round must NOT count as a straggler incident
        _ev("event", 2.0, name="sync/staleness", round=1, waited_s=0.7,
            lag=1, stale=2, step=2),
        _ev("event", 2.0, name="sync/staleness", round=2, waited_s=0.0,
            lag=0, stale=2, step=4),
        _ev("run_end", 3.0, dur=3.0),
    ]
    r = ledger.goodput_from_events(events)
    assert r["badput"]["straggler"] == pytest.approx(0.7)
    assert r["counts"]["stragglers"] == 1
    _assert_conserves(r)
    # mis-scaled waits can never push the carve past the step time
    huge = list(events)
    huge[3] = _ev("event", 2.0, name="sync/staleness", round=1,
                  waited_s=99.0, lag=3, stale=2, step=2)
    r2 = ledger.goodput_from_events(huge)
    assert r2["badput"]["straggler"] <= 2.0
    _assert_conserves(r2)


def test_chain_stitches_gap_into_backoff_plus_restart():
    r = ledger.ledger_from_events(_incarnation_chain())
    assert r["conservation"]["ok"]
    chain = r["chains"][0]
    assert chain["process_index"] == 0
    assert chain["incarnations"] == 2
    # wall = 10s (inc0) + 5s gap + 10s (inc1): every second once,
    # none twice across the restart boundary
    assert chain["wall_s"] == pytest.approx(25.0)
    assert r["badput"]["backoff"] == pytest.approx(3.0)
    assert r["badput"]["restart"] == pytest.approx(2.0)
    assert r["badput"]["replay"] == pytest.approx(0.5)
    assert r["counts"]["restarts"] == 1
    assert r["counts"]["incarnations"] == 2
    _assert_conserves(r)
    _assert_conserves(chain)
    # the supervisor log classified the gap but contributed no wall
    assert r["n_supervisor_runs"] == 1
    assert "sup.jsonl" not in chain["paths"]


def test_streaming_fold_matches_offline_fold():
    events = _single_incarnation()
    fold = ledger.LedgerFold()
    for ev in events:
        fold.emit(ev)  # the sink protocol path the runtime uses
    live = fold.event_fields()
    offline = ledger.goodput_from_events(events)
    assert live == offline


def test_blame_names_dominant_category_with_evidence():
    r = ledger.ledger_from_events(_incarnation_chain())
    blame = r["blame"]
    assert blame["cause"] in ("backoff", "restart")
    assert blame["seconds"] > 0
    assert blame["evidence"]
    # negligible badput -> no blame
    quiet = ledger.goodput_from_events([
        _ev("run_start", 0.0, meta={}),
        _ev("step", 10.0, step=0, dur=10.0),
        _ev("run_end", 10.0, dur=10.0),
    ])
    assert quiet["blame"]["cause"] == "none"


# -- runtime wiring ----------------------------------------------------------
def test_end_run_writes_goodput_event(tmp_path):
    from bigdl_tpu import telemetry
    from bigdl_tpu.telemetry import schema

    with telemetry.run(str(tmp_path), meta={"cmd": "test"}):
        with telemetry.span("data_wait"):
            time.sleep(0.02)
        telemetry.emit("step", step=0, dur=0.05)
        time.sleep(0.05)
        telemetry.emit("step", step=1, dur=0.05)
        live = telemetry.goodput()
        assert live is not None and live["wall_s"] > 0
    assert telemetry.goodput() is None  # detached with the run
    events, errors = schema.read_events(telemetry.last_run_path())
    assert errors == []
    gp = [e for e in events if e["kind"] == "goodput"]
    assert len(gp) == 1
    assert gp[0]["goodput_pct"] == pytest.approx(live["goodput_pct"],
                                                 abs=5.0)
    assert gp[0]["blame"]["cause"] in ("none",) + \
        tuple(ledger.BADPUT_CATEGORIES)
    _assert_conserves(gp[0])


def test_report_includes_goodput_section(tmp_path):
    from bigdl_tpu.telemetry import report

    summary = report.summarize(_single_incarnation())
    assert summary["goodput"]["goodput_pct"] == pytest.approx(15.0)
    text = report.format_summary(summary)
    assert "-- goodput --" in text
    assert "blame" in text


# -- CLI ---------------------------------------------------------------------
def _write_log(path, events):
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")


def test_goodput_cli_folds_chain(tmp_path, capsys):
    for name, events in _incarnation_chain():
        _write_log(tmp_path / name, events)
    rc = ledger.goodput_main([str(tmp_path / n) for n, _ in
                              _incarnation_chain()] + ["--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["conservation"]["ok"]
    assert out["badput"]["restart"] > 0
    # text renderer names the chain and the blame
    rc = ledger.goodput_main([str(tmp_path / n) for n, _ in
                              _incarnation_chain()])
    text = capsys.readouterr().out
    assert rc == 0
    assert "chain p0: 2 incarnation(s)" in text
    assert "blame:" in text


def test_goodput_cli_exit_codes(tmp_path, capsys):
    assert ledger.goodput_main([]) == 2  # nothing to read
    # instruments summing way past wall -> conservation violation -> 1
    bad = [
        _ev("run_start", 0.0, meta={"process_index": 0}),
        _ev("span_end", 5.0, name="checkpoint", span=1, dur=20.0),
        _ev("run_end", 10.0, dur=10.0),
    ]
    _write_log(tmp_path / "bad.jsonl", bad)
    assert ledger.goodput_main([str(tmp_path / "bad.jsonl")]) == 1
    capsys.readouterr()


def test_supervise_dir_discovers_logs(tmp_path, capsys):
    sub = tmp_path / "telemetry"
    sub.mkdir()
    for name, events in _incarnation_chain():
        _write_log(sub / f"run-{name}", events)
    rc = ledger.goodput_main(["--supervise-dir", str(tmp_path),
                              "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["n_runs"] == 3


# -- diff / bench gates ------------------------------------------------------
def test_diff_gates_goodput_regression(tmp_path, capsys):
    from bigdl_tpu.telemetry import diff as tdiff

    base = {"metric": "m", "value": 100.0, "goodput_pct": 90.0,
            "badput_s": 10.0}
    cand = {"metric": "m", "value": 100.0, "goodput_pct": 70.0,
            "badput_s": 30.0}
    a = tmp_path / "base.json"
    b = tmp_path / "cand.json"
    a.write_text(json.dumps(base))
    b.write_text(json.dumps(cand))
    rc = tdiff.main([str(a), str(b), "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1  # 90 -> 70 goodput is way past the 5% threshold
    assert out["goodput_threshold_pct"] == \
        tdiff.DEFAULT_GOODPUT_THRESHOLD_PCT
    regressed = {r["name"] for r in out["rows"] if r["regressed"]}
    assert "goodput_pct" in regressed
    # within threshold -> no gate
    cand2 = dict(base, goodput_pct=89.0, badput_s=10.2)
    b.write_text(json.dumps(cand2))
    assert tdiff.main([str(a), str(b)]) == 0
    capsys.readouterr()


def test_run_log_metrics_carries_goodput(tmp_path):
    from bigdl_tpu.telemetry import diff as tdiff

    _write_log(tmp_path / "run.jsonl", _single_incarnation())
    m = tdiff.run_log_metrics(str(tmp_path / "run.jsonl"))
    assert m["goodput_pct"] == pytest.approx(15.0)
    assert m["badput_s"] == pytest.approx(8.5)


def test_bench_metrics_carries_goodput():
    from bigdl_tpu.telemetry import diff as tdiff

    doc = {"metric": "m", "value": 1.0, "goodput_pct": 88.5,
           "badput_s": 12.25,
           "configs": {"lenet": {"images_per_sec": 10.0,
                                 "goodput_pct": 88.5}}}
    m = tdiff.bench_metrics(doc)
    assert m["goodput_pct"] == 88.5
    assert m["badput_s"] == 12.25


# -- chrome trace ------------------------------------------------------------
def test_chrome_trace_renders_badput_lanes():
    from bigdl_tpu.telemetry import chrome_trace

    merged = [ev for _, events in _incarnation_chain() for ev in events]
    trace = chrome_trace.chrome_trace(merged)["traceEvents"]
    lanes = {e["args"]["name"] for e in trace
             if e.get("ph") == "M" and
             str(e["args"].get("name", "")).startswith("badput:")}
    assert {"badput:compile", "badput:checkpoint",
            "badput:replay"} <= lanes
    # the incarnation gap is stitched into restart + backoff slices
    slices = {e["name"]: e for e in trace
              if e.get("cat") == "badput" and e.get("ph") == "X"}
    assert slices["backoff"]["dur"] == pytest.approx(3.0 * 1e6)
    assert slices["restart"]["dur"] == pytest.approx(2.0 * 1e6)
    # the supervisor's own lane contributes no restart slice: the gap
    # belongs to the reborn worker pid
    assert slices["restart"]["pid"] == 200


# -- live e2e: supervised run with an injected kill --------------------------
@pytest.mark.deadline(60)
def test_supervised_kill_shows_restart_badput(tmp_path, monkeypatch):
    """End to end: a 2-process supervised run whose p0 SIGKILLs itself
    in incarnation 0.  Folding the telemetry dir (supervisor log +
    every incarnation's worker logs) must show nonzero restart/backoff
    badput, blame it, and still conserve."""
    from bigdl_tpu import telemetry
    from bigdl_tpu.parallel import cluster

    monkeypatch.setenv("BIGDL_RETRY_BACKOFF", "0.05")
    tdir = tmp_path / "telemetry"
    tdir.mkdir()
    body = (
        "import os, signal, time\n"
        "from bigdl_tpu import telemetry\n"
        "pidx = int(os.environ['BIGDL_PROCESS_ID'])\n"
        "inc = int(os.environ['BIGDL_SUPERVISOR_INCARNATION'])\n"
        f"tr = telemetry.start_run({str(tdir)!r},\n"
        "                          meta={'process_index': pidx})\n"
        "for i in range(3):\n"
        "    t0 = time.perf_counter()\n"
        "    time.sleep(0.05)\n"
        "    telemetry.emit('step', step=inc * 3 + i,\n"
        "                   dur=time.perf_counter() - t0)\n"
        "    for s in tr._sinks:\n"
        "        s.flush()\n"
        "if inc == 0 and pidx == 0:\n"
        "    os.kill(os.getpid(), signal.SIGKILL)\n"
        "telemetry.end_run()\n")
    sup = cluster.Supervisor(2, [sys.executable, "-c", body],
                             max_restarts=3,
                             cluster_dir=str(tmp_path / "cl"),
                             settle_grace=5.0, env=dict(os.environ))
    with telemetry.run(str(tdir), meta={"cmd": "supervise",
                                        "role": "supervisor",
                                        "declared_n": 2}):
        rc = sup.run()
    assert rc == 0
    assert sup.restarts >= 1

    paths = ledger.discover_logs(str(tmp_path))
    assert len(paths) >= 4  # supervisor + >= 3 worker incarnation logs
    from bigdl_tpu.telemetry import schema
    runs = [(p, schema.read_events(p)[0]) for p in paths]
    report = ledger.ledger_from_events(runs)
    assert report["conservation"]["ok"], report["conservation"]
    assert report["n_supervisor_runs"] >= 1
    # the killed chain carries the restart: gap time classified, not
    # dropped and not double-counted
    killed = [c for c in report["chains"] if c["incarnations"] >= 2]
    assert killed, report["chains"]
    gap = report["badput"]["restart"] + report["badput"]["backoff"]
    assert gap > 0
    assert report["badput"]["backoff"] > 0  # supervisor booked its sleep
    assert report["counts"]["restarts"] >= 1
    # with steps covering nearly all in-run time, the respawn gap
    # dominates: blame must point at the restart machinery
    assert report["blame"]["cause"] in ("restart", "backoff")
    assert "restart" in report["blame"]["evidence"] \
        or "backoff" in report["blame"]["evidence"]
