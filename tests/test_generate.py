"""The LLM decode subsystem (bigdl_tpu/serving/generate/,
docs/serving.md "Autoregressive generation"): cache-length buckets and
the stacked KV store, the q_len=1 attention routing rule, the
cache-correctness contract (KV-cached greedy decode == full-context
forward argmax, token for token), sampled-decode determinism keyed on
(seed, request), warm-executable + live-cache survival across a
same-shape weight rollout, and the live streamed-HTTP e2e with the
retrace detector armed and a graceful drain."""

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

from bigdl_tpu.serving.batcher import QueueFullError
from bigdl_tpu.serving.generate.kv_cache import (StackedKVCache,
                                                 cache_buckets)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VOCAB = 50


def _model(seed=7):
    from bigdl_tpu.models.transformer import build_transformer_lm
    from bigdl_tpu.utils.rng import RNG

    RNG.set_seed(seed)
    return build_transformer_lm(vocab_size=VOCAB, num_layers=2,
                                embed_dim=32, num_heads=2, max_len=64,
                                scan=False).evaluate()


def _executor(model):
    from bigdl_tpu.serving.buckets import BucketPolicy
    from bigdl_tpu.serving.generate.decode import GenerateExecutor

    pol = BucketPolicy(max_batch=2, batch_buckets=[1, 2],
                       seq_buckets=[16])
    ex = GenerateExecutor(model, policy=pol, decode_buckets=[1, 2],
                          cache_buckets=[32])
    ex.warmup((16,), np.int32)
    return ex


@pytest.fixture(scope="module")
def gen_executor():
    model = _model()
    return model, _executor(model)


def _full_forward_greedy(model, prompt, n):
    """Reference: re-run the FULL context each step, argmax the last
    position — the numerics the KV cache must reproduce."""
    seq = list(np.asarray(prompt).reshape(-1))
    out_tokens = []
    for _ in range(n):
        out = np.asarray(model.forward(np.asarray([seq], np.int32)))
        tok = int(np.argmax(out[0, len(seq) - 1]))
        out_tokens.append(tok)
        seq.append(tok)
    return out_tokens


# -- cache buckets + stacked store -------------------------------------------
def test_cache_buckets_closed_doubling_set():
    assert cache_buckets(256, smallest=32) == (32, 64, 128, 256)
    assert cache_buckets(96, smallest=32) == (32, 64, 96)
    assert cache_buckets(16, smallest=64) == (16,)
    with pytest.raises(ValueError):
        cache_buckets(0)


def test_stacked_kv_cache_stack_pad_and_row_reuse():
    import jax.numpy as jnp

    # two layers, [B=2, H=1, C=4, D=2] source
    src = [(jnp.arange(16, dtype=jnp.float32).reshape(2, 1, 4, 2),
            jnp.arange(16, 32, dtype=jnp.float32).reshape(2, 1, 4, 2))
           for _ in range(2)]
    stack = StackedKVCache.stack([(src, 0, 3), (src, 1, 2)],
                                 bucket=8, batch=2)
    assert stack.lengths == [3, 2] and stack.bucket == 8
    k0 = np.asarray(stack.layers[0][0])
    assert k0.shape == (2, 1, 8, 2)
    np.testing.assert_array_equal(k0[0, :, :4], np.asarray(src[0][0][0]))
    assert k0[:, :, 4:].sum() == 0  # padded cells
    assert 0.0 < stack.occupancy() < 1.0
    # dropping row 0 and re-stacking reuses row 1's cells verbatim
    survivors = stack.row_sources([1])
    small = StackedKVCache.stack(survivors, bucket=8, batch=1)
    assert small.lengths == [2]
    np.testing.assert_array_equal(np.asarray(small.layers[0][0])[0],
                                  k0[1])
    with pytest.raises(ValueError):
        StackedKVCache.stack(survivors, bucket=8, batch=0)


# -- the routing table (satellite: q_len=1 never routes to flash) ------------
def test_attention_routing_table_decode_row(monkeypatch):
    from bigdl_tpu.ops.attention import select_attention_backend

    monkeypatch.delenv("BIGDL_KERNELS", raising=False)
    monkeypatch.delenv("BIGDL_FLASH_MIN_SEQ", raising=False)
    on_tpu = False
    try:
        from bigdl_tpu.ops.attention import is_tpu_device

        on_tpu = is_tpu_device()
    except Exception:  # noqa: BLE001 - no backend at all
        pass
    # (sq, sk, masked, env) -> expected backend; None = either reason
    rows = [
        # decode: q_len=1 NEVER flash, regardless of kv length or mode
        (1, 8192, False, None, "dense"),
        (1, 128, False, None, "dense"),
        (1, 8192, False, "pallas", "dense"),
        (1, 8192, True, None, "dense"),
        # the kill switch still forces dense everywhere
        (4096, 4096, False, "xla", "dense"),
        # dense masks always route dense
        (4096, 4096, True, None, "dense"),
        # forced pallas with a real q extent routes flash
        (512, 512, False, "pallas", "flash"),
        # auto off-TPU is dense; on TPU long seqs go flash
        (4096, 4096, False, None, "flash" if on_tpu else "dense"),
        (64, 64, False, None, "dense"),
    ]
    for sq, sk, masked, env, want in rows:
        if env is None:
            monkeypatch.delenv("BIGDL_KERNELS", raising=False)
        else:
            monkeypatch.setenv("BIGDL_KERNELS", env)
        got, reason = select_attention_backend(sq, sk, masked)
        assert got == want, (sq, sk, masked, env, got, reason)
    # the decode row carries its own reason so dispatch attribution
    # can see the choice was deliberate
    monkeypatch.delenv("BIGDL_KERNELS", raising=False)
    assert select_attention_backend(1, 4096)[1] == "decode:q_len=1"


# -- sampling ----------------------------------------------------------------
def test_sample_token_greedy_and_seeded_topk():
    from bigdl_tpu.serving.generate.batcher import sample_token

    logits = np.log(np.asarray([0.1, 0.6, 0.2, 0.1]))
    assert sample_token(logits, temperature=0.0) == 1
    with pytest.raises(ValueError):
        # a negative top_k would silently sample near the FULL vocab
        # (np.partition from the wrong end) — rejected instead
        sample_token(logits, 0.7, -3,
                     np.random.Generator(np.random.Philox(5)))
    r1 = np.random.Generator(np.random.Philox(5))
    r2 = np.random.Generator(np.random.Philox(5))
    seq1 = [sample_token(logits, 0.7, 2, r1) for _ in range(20)]
    seq2 = [sample_token(logits, 0.7, 2, r2) for _ in range(20)]
    assert seq1 == seq2          # same seed -> same stream
    assert set(seq1) <= {1, 2}   # top_k=2 keeps only the two best
    with pytest.raises(ValueError):
        sample_token(logits, temperature=0.5)  # sampled needs an rng


# -- the cache-correctness contract ------------------------------------------
@pytest.mark.slow
def test_greedy_decode_matches_full_forward_argmax(gen_executor):
    model, ex = gen_executor
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, VOCAB, size=(1, 6)).astype(np.int32)
    logits, caches = ex.prefill(prompt, [6])
    toks = [int(np.argmax(logits[0]))]
    stack = StackedKVCache.stack([(caches, 0, 6)], 32, 1)
    for _ in range(7):
        lg = ex.decode(stack, [toks[-1]])
        stack.lengths[0] += 1
        toks.append(int(np.argmax(lg[0])))
    assert toks == _full_forward_greedy(model, prompt, 8)


@pytest.mark.slow
def test_batched_decode_rows_are_independent(gen_executor):
    """Two sequences decoding TOGETHER produce exactly what each
    produces alone — the per-row length mask isolates cache rows."""
    model, ex = gen_executor
    rng = np.random.default_rng(3)
    p1 = rng.integers(1, VOCAB, 4).astype(np.int32)
    p2 = rng.integers(1, VOCAB, 9).astype(np.int32)
    tokens = np.zeros((2, 9), np.int32)
    tokens[0, :4], tokens[1, :] = p1, p2
    logits, caches = ex.prefill(tokens, [4, 9])
    toks = [[int(np.argmax(logits[0]))], [int(np.argmax(logits[1]))]]
    stack = StackedKVCache.stack([(caches, 0, 4), (caches, 1, 9)], 32, 2)
    for _ in range(5):
        lg = ex.decode(stack, [toks[0][-1], toks[1][-1]])
        for r in range(2):
            stack.lengths[r] += 1
            toks[r].append(int(np.argmax(lg[r])))
    assert toks[0] == _full_forward_greedy(model, p1, 6)
    assert toks[1] == _full_forward_greedy(model, p2, 6)


# -- the generation batcher ---------------------------------------------------
def test_generation_batcher_greedy_and_slot_reuse(gen_executor):
    from bigdl_tpu.serving.generate.batcher import GenerationBatcher

    model, ex = gen_executor
    warm = ex.compile_count
    gb = GenerationBatcher(ex, max_wait_ms=1.0)
    try:
        rng = np.random.default_rng(1)
        prompts = [rng.integers(1, VOCAB, n).astype(np.int32)
                   for n in (3, 7, 5, 11)]  # > max_active: slots reuse
        reqs = [gb.submit(p, max_new_tokens=4) for p in prompts]
        for r in reqs:
            assert r.wait(60.0) and r.error is None
        for p, r in zip(prompts, reqs):
            assert r.tokens == _full_forward_greedy(model, p, 4)
            assert r.finish_reason == "length"
            assert r.ttft_ms() > 0
        assert ex.compile_count == warm  # zero steady-state compiles
        st = gb.stats()
        assert st["completed"] == 4 and st["gen_tokens"] == 16
        assert st["ttft_p50_ms"] > 0 and st["active_seqs"] == 0
    finally:
        gb.stop(drain=False)


def test_burst_larger_than_prefill_bucket_admits_over_rounds():
    """More waiting prompts than ``policy.max_batch`` while decode
    slots are free: admission is capped per round at the prefill
    batch-bucket ceiling, so the burst admits over successive rounds
    instead of handing ``BucketPolicy.pad`` an oversized prefill (which
    failed every newcomer in the burst)."""
    from bigdl_tpu.serving.buckets import BucketPolicy
    from bigdl_tpu.serving.generate.batcher import GenerationBatcher
    from bigdl_tpu.serving.generate.decode import GenerateExecutor

    model = _model()
    pol = BucketPolicy(max_batch=2, batch_buckets=[1, 2],
                       seq_buckets=[16])
    ex = GenerateExecutor(model, policy=pol, decode_buckets=[1, 2, 4],
                          cache_buckets=[32])
    ex.warmup((16,), np.int32)
    assert ex.max_active > pol.max_batch  # the seeded mismatch
    gb = GenerationBatcher(ex, max_wait_ms=1.0)
    try:
        rng = np.random.default_rng(8)
        prompts = [rng.integers(1, VOCAB, n).astype(np.int32)
                   for n in (3, 6, 4, 7)]
        reqs = [gb.submit(p, max_new_tokens=3) for p in prompts]
        for p, r in zip(prompts, reqs):
            assert r.wait(60.0) and r.error is None
            assert r.tokens == _full_forward_greedy(model, p, 3)
    finally:
        gb.stop(drain=False)


def test_submit_rejects_negative_top_k_and_bad_temperature(gen_executor):
    from bigdl_tpu.serving.generate.batcher import GenerationBatcher

    _, ex = gen_executor
    gb = GenerationBatcher(ex, max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError, match="top_k"):
            gb.submit(np.asarray([1, 2], np.int32), top_k=-3)
        for t in (float("nan"), float("inf"), -0.5):
            with pytest.raises(ValueError, match="temperature"):
                gb.submit(np.asarray([1, 2], np.int32), temperature=t)
    finally:
        gb.stop(drain=False)


def test_tiny_temperature_degrades_to_greedy_not_nan():
    """A subnormal temperature overflows ``logits / t`` to inf; the
    shift-before-scale ordering keeps the distribution valid (it
    collapses onto the argmax) instead of raising on NaN probs."""
    from bigdl_tpu.serving.generate.batcher import sample_token

    logits = np.log(np.asarray([0.1, 0.6, 0.2, 0.1]))
    rng = np.random.Generator(np.random.Philox(0))
    assert sample_token(logits, 1e-300, 0, rng) == 1


def test_one_bad_sampler_does_not_kill_the_batch(gen_executor,
                                                 monkeypatch):
    """A host-side sampling failure on ONE request fails that request
    alone — its co-admitted and co-decoding neighbours keep streaming
    (and nobody is left in neither queue nor active to hang)."""
    import bigdl_tpu.serving.generate.batcher as gbm

    model, ex = gen_executor
    orig = gbm.sample_token
    calls = {"n": 0}

    def boom(logits, temperature=0.0, top_k=0, rng=None):
        if temperature == 0.123:       # fails at the TTFT draw (_admit)
            raise RuntimeError("poisoned at admit")
        if temperature == 0.456:       # fails on a decode draw (_step)
            calls["n"] += 1
            if calls["n"] > 1:
                raise RuntimeError("poisoned at step")
        return orig(logits, 0.0, 0, None)  # greedy underneath

    monkeypatch.setattr(gbm, "sample_token", boom)
    gb = gbm.GenerationBatcher(ex, max_wait_ms=1.0)
    try:
        good = gb.submit(np.asarray([1, 2, 3], np.int32),
                         max_new_tokens=6)
        bad_admit = gb.submit(np.asarray([4, 5], np.int32),
                              max_new_tokens=6, temperature=0.123,
                              seed=1)
        bad_step = gb.submit(np.asarray([6, 7], np.int32),
                             max_new_tokens=6, temperature=0.456,
                             seed=1)
        assert good.wait(60.0) and good.error is None
        assert good.tokens == _full_forward_greedy(model, [1, 2, 3], 6)
        assert bad_admit.wait(60.0) and "poisoned" in bad_admit.error
        assert bad_step.wait(60.0) and "poisoned" in bad_step.error
        assert bad_step.tokens  # it DID stream before the failure
        # the batcher survives: a fresh request still completes
        again = gb.submit(np.asarray([8, 9], np.int32),
                          max_new_tokens=2)
        assert again.wait(60.0) and again.error is None
        st = gb.stats()
        assert st["errors"] == 2 and st["completed"] == 2
    finally:
        gb.stop(drain=False)


def test_cache_full_uses_the_last_cache_cell(gen_executor):
    """A cache bucket of C buys exactly C positions of context: a
    16-token prompt against cache_buckets=[32] yields the TTFT token
    plus 16 decode tokens (the last k/v written at index 31) before
    finishing cache_full — not one fewer."""
    from bigdl_tpu.serving.generate.batcher import GenerationBatcher

    _, ex = gen_executor
    gb = GenerationBatcher(ex, max_wait_ms=1.0)
    try:
        r = gb.submit(np.arange(1, 17, dtype=np.int32),
                      max_new_tokens=40)
        assert r.wait(120.0) and r.error is None
        assert r.finish_reason == "cache_full"
        assert len(r.tokens) == 17  # 1 TTFT + (32 - 16) decode steps
    finally:
        gb.stop(drain=False)


def test_idle_batcher_gauges_read_zero(gen_executor):
    """Normal completion of the last active row must reset the
    serve/active_seqs and serve/cache_occupancy gauges — a consumer of
    the gauge stream would otherwise see a permanently busy replica."""
    from bigdl_tpu import telemetry
    from bigdl_tpu.serving.generate.batcher import GenerationBatcher

    _, ex = gen_executor
    sink = telemetry.MemorySink()
    with telemetry.run(sinks=[sink]):
        gb = GenerationBatcher(ex, max_wait_ms=1.0)
        try:
            r = gb.submit(np.asarray([1, 2, 3], np.int32),
                          max_new_tokens=3)
            assert r.wait(60.0) and r.error is None
        finally:
            gb.stop(drain=True)
    for name in ("serve/active_seqs", "serve/cache_occupancy"):
        vals = [e for e in sink.events if e.get("name") == name]
        assert vals and vals[-1]["value"] == 0, name


def test_decode_donates_cache_operands(gen_executor):
    """The decode executable updates the KV stack in place (donated
    operands) instead of copying every layer's [B,H,C,D] per token —
    the pre-call buffers must be deleted after the step."""
    _, ex = gen_executor
    logits, caches = ex.prefill(np.asarray([[1, 2, 3]], np.int32), [3])
    stack = StackedKVCache.stack([(caches, 0, 3)], 32, 1)
    old_k = stack.layers[0][0]
    ex.decode(stack, [int(np.argmax(logits[0]))])
    assert old_k.is_deleted()
    assert stack.layers[0][0] is not old_k


def test_generation_model_and_default_seq_buckets():
    """The front-end special case (unrolled transformer build + the
    halving seq-bucket default) lives ONCE in serving.generate."""
    import jax

    from bigdl_tpu.nn.layers.scan import ScanLayers
    from bigdl_tpu.serving.generate import (default_seq_buckets,
                                            generation_model)

    m = generation_model("transformer", 50)
    assert not any(isinstance(x, ScanLayers) for x in m.modules())
    with pytest.raises(ValueError, match="unknown model"):
        generation_model("no_such_model")
    spec = jax.ShapeDtypeStruct((1, 128), np.int32)
    assert default_seq_buckets(spec) == [32, 64, 128]
    spec = jax.ShapeDtypeStruct((1, 16), np.int32)
    assert default_seq_buckets(spec) == [16]


def test_sampled_decode_deterministic_on_seed(gen_executor):
    from bigdl_tpu.serving.generate.batcher import GenerationBatcher

    _, ex = gen_executor
    gb = GenerationBatcher(ex, max_wait_ms=1.0)
    try:
        prompt = np.asarray([5, 9, 2], np.int32)
        runs = []
        for _ in range(2):  # same (seed, request) twice -> identical
            r = gb.submit(prompt, max_new_tokens=6, temperature=0.9,
                          top_k=10, seed=1234)
            assert r.wait(60.0) and r.error is None
            runs.append(r.tokens)
        assert runs[0] == runs[1]
        other = gb.submit(prompt, max_new_tokens=6, temperature=0.9,
                          top_k=10, seed=99)
        assert other.wait(60.0)
        # a different seed is allowed to (and here does) diverge
        assert other.tokens != runs[0]
    finally:
        gb.stop(drain=False)


def test_generation_batcher_rejects_oversize_and_draining(gen_executor):
    from bigdl_tpu.serving.generate.batcher import GenerationBatcher

    _, ex = gen_executor
    gb = GenerationBatcher(ex, max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError):
            gb.submit(np.ones(32, np.int32))  # no room in largest bucket
        r = gb.submit(np.asarray([1, 2], np.int32), max_new_tokens=2)
        assert gb.stop(drain=True)
        assert r.done.is_set() and r.error is None  # drained, answered
        with pytest.raises(QueueFullError):
            gb.submit(np.asarray([1], np.int32))
    finally:
        gb.stop(drain=False)


@pytest.mark.slow
def test_refresh_state_keeps_decode_executables_and_live_caches():
    """The rollout contract: a same-shape weight swap mid-generation
    keeps every warm prefill/decode executable AND the in-flight KV
    caches — the generation completes with zero new compiles."""
    import jax.numpy as jnp

    from bigdl_tpu.nn.module import load_state_dict, state_dict
    from bigdl_tpu.serving.generate.batcher import GenerationBatcher

    model = _model()
    ex = _executor(model)
    warm = ex.compile_count
    gb = GenerationBatcher(ex, max_wait_ms=1.0)
    try:
        prompt = np.asarray([4, 8, 15, 16], np.int32)
        want = _full_forward_greedy(model, prompt, 20)
        r = gb.submit(prompt, max_new_tokens=20)
        # same VALUES, fresh arrays: identity check misses, the sig
        # check hits — executables survive, outputs stay comparable
        sd = state_dict(model)
        load_state_dict(model, {k: jnp.asarray(np.array(v))
                                for k, v in sd.items()})
        ex.refresh_state()
        assert r.wait(120.0) and r.error is None
        assert r.tokens == want
        assert ex.compile_count == warm
    finally:
        gb.stop(drain=False)


def test_refresh_state_shape_change_drops_executables():
    model = _model()
    ex = _executor(model)
    assert ex.warm_buckets() != []
    with ex._lock:
        ex._state_sig = dict(ex._state_sig,
                             **{next(iter(ex._state_sig)): ((9,), "?")})
        ex._place_state(dict(ex._state_src))
    # re-placing against a changed signature drops every executable
    # (prefill, decode, and plain predict alike) — the documented
    # full-redeploy path
    assert ex.warm_buckets() == []


# -- live HTTP e2e ------------------------------------------------------------
@pytest.fixture(scope="module")
def gen_server():
    import jax

    from bigdl_tpu.serving import serve_model

    model = _model()
    spec = jax.ShapeDtypeStruct((1, 16), np.int32)
    server = serve_model(model, spec, name="tlm", host="127.0.0.1",
                         port=0, max_batch=2, batch_buckets=[1, 2],
                         seq_buckets=[16], max_wait_ms=1.0,
                         generate=True, decode_buckets=[1, 2],
                         cache_buckets=[32])
    try:
        yield model, server
    finally:
        server.stop(drain=False)


def _generate(port, payload, timeout=60.0):
    """POST /v1/generate, collecting the streamed JSON lines."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, [json.loads(l) for l in r if l.strip()]


def test_http_streamed_generations_concurrent_mixed_prompts(gen_server):
    from bigdl_tpu.analysis.retrace import trace_retraces

    model, server = gen_server
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, VOCAB, n).tolist() for n in (3, 8, 13, 5)]
    warm = server.executor.compile_count
    results, errors = {}, []

    def client(i):
        try:
            code, lines = _generate(server.port,
                                    {"prompt": prompts[i],
                                     "max_new_tokens": 5})
            assert code == 200
            results[i] = lines
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    with trace_retraces() as mon:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
    assert errors == []
    for i, lines in results.items():
        toks = [ev["token"] for ev in lines if "token" in ev]
        done = lines[-1]
        assert done["done"] is True and done["tokens"] == toks
        assert done["ttft_ms"] > 0 and done["n_tokens"] == 5
        # the acceptance contract: streamed greedy == full-forward
        # argmax per token, under concurrency and mixed prompt lengths
        assert toks == _full_forward_greedy(model, prompts[i], 5)
    # zero steady-state compiles with the retrace detector armed
    assert server.executor.compile_count == warm
    assert len(mon.report.diagnostics) == 0


def test_http_generate_nonstream_status_metrics_and_errors(gen_server):
    _, server = gen_server
    code, lines = _generate(server.port,
                            {"prompt": [1, 2, 3], "max_new_tokens": 3,
                             "stream": False})
    assert code == 200 and len(lines) == 1
    assert len(lines[0]["tokens"]) == 3
    st = json.load(urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}/status", timeout=10))
    gen = st["serving"]["generate"]
    assert gen["completed"] >= 1 and gen["gen_tokens"] >= 3
    assert gen["decode_buckets"] == [1, 2]
    assert gen["cache_buckets"] == [32]
    assert "active_seqs" in gen and "cache_occupancy" in gen
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}/metrics", timeout=10
    ).read().decode()
    assert "bigdl_gen_tokens_total" in body
    for bad in ({"prompt": []}, {"prompt": "text"}, {"wrong": 1},
                {"prompt": [1], "max_new_tokens": 0},
                {"prompt": [1, 2], "top_k": -3},  # rejected up front
                {"prompt": list(range(40))}):  # over the cache bucket
        with pytest.raises(urllib.error.HTTPError) as ei:
            _generate(server.port, bad)
        assert ei.value.code == 400, bad


def test_stream_is_http11_chunked(gen_server):
    """Chunked transfer encoding is undefined for HTTP/1.0 — the
    response must be HTTP/1.1 or strict clients/proxies deliver raw
    chunk framing to the user."""
    import http.client

    _, server = gen_server
    conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                      timeout=60)
    try:
        conn.request("POST", "/v1/generate",
                     body=json.dumps({"prompt": [1, 2, 3],
                                      "max_new_tokens": 2}),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.version == 11
        assert r.getheader("Transfer-Encoding") == "chunked"
        lines = [json.loads(l) for l in r.read().splitlines() if l]
        assert lines[-1].get("done") is True
    finally:
        conn.close()


def test_generate_events_are_schema_valid():
    from bigdl_tpu import telemetry
    from bigdl_tpu.serving.generate.batcher import GenerationBatcher
    from bigdl_tpu.telemetry import schema

    sink = telemetry.MemorySink()
    model = _model()
    with telemetry.run(sinks=[sink]):
        ex = _executor(model)
        gb = GenerationBatcher(ex, max_wait_ms=1.0)
        try:
            r = gb.submit(np.asarray([3, 1, 4], np.int32),
                          max_new_tokens=3)
            assert r.wait(60.0)
        finally:
            gb.stop(drain=True)
    kinds = {e.get("kind") for e in sink.events}
    assert "generate" in kinds and "compile" in kinds
    names = {e.get("name") for e in sink.events}
    assert {"serve/generate", "serve/active_seqs",
            "serve/cache_occupancy"} <= names
    assert schema.validate_events(sink.events) == []
    gen = [e for e in sink.events if e.get("kind") == "generate"]
    assert gen and gen[0]["tokens"] == 3 and gen[0]["ttft_ms"] > 0


def test_metrics_sink_and_fleet_fold_generation_events():
    from bigdl_tpu.telemetry.fleet import HostState
    from bigdl_tpu.telemetry.metrics_http import MetricsSink

    ev = {"v": 1, "ts": time.time(), "pid": 1, "tid": 1,
          "kind": "generate", "tokens": 12, "dur": 0.5,
          "ttft_ms": 41.0, "itl_p99_ms": 9.0, "finish": "length"}
    sink = MetricsSink()
    sink.emit(ev)
    st = sink.status()
    assert st["gen_tokens"] == 12 and st["gen_requests"] == 1
    assert st["last_gen"]["ttft_ms"] == 41.0
    om = sink.openmetrics()
    assert "bigdl_gen_tokens_total" in om
    assert "bigdl_gen_itl_p99_ms" in om
    host = HostState("run.jsonl")
    host.fold([ev])
    row = host.row()
    assert row["gen_tokens"] == 12 and row["gen_ttft_ms"] == 41.0
    assert row["gen_tokens_s"] > 0


@pytest.mark.deadline(240)
@pytest.mark.slow
def test_cli_serve_generate_live_e2e_with_sigterm_drain():
    """The acceptance path: `cli serve --generate`, real streamed HTTP
    from another process with mixed prompt lengths, KV-cached greedy
    equal to the full-forward argmax, SIGTERM drain finishing the
    in-flight generation, exit 0."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("BIGDL_SCAN_LAYERS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "bigdl_tpu.models.cli", "serve",
         "--model", "transformer", "--generate", "--num-classes",
         str(VOCAB), "--port", "0", "-b", "2", "--buckets", "1,2",
         "--seq-buckets", "16", "--decode-buckets", "1,2",
         "--cache-buckets", "32", "--max-wait-ms", "1", "--seed", "7"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    try:
        port = None
        deadline = time.time() + 180
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            m = re.search(r"serving transformer on port (\d+)", line)
            if m:
                assert "generate decode=[1, 2] cache=[32]" in line
                port = int(m.group(1))
                break
        assert port, "no ready line from cli serve --generate"
        # the CLI seeds RNG with --seed 7 then builds the registry-
        # default transformer (4 layers, 256 embed) unrolled — rebuild
        # the identical reference here
        from bigdl_tpu.models.transformer import build_transformer_lm
        from bigdl_tpu.utils.rng import RNG

        RNG.set_seed(7)
        model = build_transformer_lm(vocab_size=VOCAB,
                                     scan=False).evaluate()
        rng = np.random.default_rng(6)
        prompts = [rng.integers(1, VOCAB, n).tolist() for n in (4, 9)]
        results = {}

        def client(i):
            code, lines = _generate(port, {"prompt": prompts[i],
                                           "max_new_tokens": 4})
            results[i] = (code, lines)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        for i, (code, lines) in results.items():
            assert code == 200
            toks = [ev["token"] for ev in lines if "token" in ev]
            assert toks == _full_forward_greedy(model, prompts[i], 4)
        # SIGTERM mid-generation: the in-flight stream finishes before
        # the process exits 0
        slow = [None]

        def long_client():
            slow[0] = _generate(port, {"prompt": prompts[0],
                                       "max_new_tokens": 12})

        t = threading.Thread(target=long_client)
        t.start()
        time.sleep(0.15)  # let the generation get in flight
        proc.send_signal(signal.SIGTERM)
        t.join(60.0)
        assert slow[0] is not None
        code, lines = slow[0]
        assert code == 200 and lines[-1].get("done") is True
        assert len([ev for ev in lines if "token" in ev]) == 12
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "drained" in out
    finally:
        if proc.poll() is None:
            proc.kill()
