#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one
NVIDIA GPU.  Run from the root of a checkout:

    python3 chip_smoke.py

It builds what it needs from the checkout's sources and prints one JSON
line per phase; any failure ends it with a non-zero exit and no result:

1. build   -- compiles ``bigdl_tpu_torch/csrc/*.cu`` for sm_90a (one
              nvcc per source, started together) and prints ptxas's
              register and spill report.
2. kernels -- each kernel at the serving shapes of batch 8, in f32 and
              bf16, held against its plain PyTorch version on the card
              (f32 at rtol 1e-5 / atol 1e-6, bf16 at 2e-2), and timed
              beside its plain version, a one-call PyTorch yardstick that
              the port never calls, and its bound.
3. serve   -- full-width Inception-v1 (1000 classes, seeded weights)
              served by the port's ModelServer with bf16 weights and f32
              compute, buckets 1,2,4,8, max-wait 2 ms; concurrent
              requests of 1 and 3 rows are checked against the same rows
              run through the plain-version forward on the card (1e-4),
              and the kernel wrappers' launch counts show the served
              forwards went through the kernels.

Then the kernel summary line, the card's name and power limit, and the
last line ``{"ok": true, "device": {...}}``.  It exits non-zero when
CUDA is unavailable, and in a directory that holds nothing of the repo.

Kernel times are device times: each timed op runs as a CUDA graph of
many launches over rotating copies of its input that together exceed
the 50 MB L2 cache, timed with CUDA events.  Bounds use the H100 SXM
data-sheet peaks: 3.35 TB/s of HBM and 67 TFLOP/s of f32 outside the
tensor cores (both kernels compute in f32).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
L2_BYTES = 50e6
SEED = 1
BATCH = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def graph_ms(torch, fn, inputs, launches: int, replays: int = 5) -> float:
    """Mean device milliseconds of one ``fn`` call: ``launches`` calls
    over the rotating ``inputs`` captured as one CUDA graph, replayed."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for x in inputs[:3]:  # warm: builds, lazy module loads, caches
            fn(x)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fn(inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def rotating_copies(x, torch):
    """Enough copies of ``x`` that a pass over them exceeds twice the L2
    cache, so each timed launch reads its input from HBM."""
    n = min(64, max(2, math.ceil(2 * L2_BYTES / (x.numel() * x.element_size()))))
    return [x.clone() for _ in range(n)]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    import torch

    from bigdl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    info = _build.build()
    seconds = time.perf_counter() - t0
    for name, i in info.items():
        if i["ptxas"]:
            print(f"# ptxas {name}:\n" + "\n".join(
                "#   " + line for line in i["ptxas"].splitlines()), flush=True)
    card = card_line()
    emit({"phase": "build", "ok": True, "seconds": seconds,
          "per_source_s": {n: i["seconds"] for n, i in info.items()},
          "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return card


def _lrn_cases(torch):
    from bigdl_tpu_torch.ops import lrn

    size, alpha, beta, k = 5, 1e-4, 0.75, 1.0  # inception.py:64,69

    def kernel(x):
        return lrn.cross_map_lrn_forward(x, size, alpha, beta, k)

    def plain(x):
        return lrn.cross_map_lrn_plain(x, size, alpha, beta, k)[0]

    def library(x):
        return torch.nn.functional.local_response_norm(x, size, alpha, beta, k)

    def bound(x):
        nbytes = 2 * x.numel() * x.element_size()
        flops = x.numel() * (2 * size + 5)
        return nbytes, flops

    return [dict(name="cross_map_lrn_fwd", site=site, shape=shape,
                 kernel=kernel, plain=plain, library=library, bound=bound)
            for site, shape in (("pool1/norm1", (BATCH, 64, 56, 56)),
                                ("conv2/norm2", (BATCH, 192, 56, 56)))]


def _pool_cases(torch):
    from bigdl_tpu_torch.nn.layers.pooling import SpatialAveragePooling
    from bigdl_tpu_torch.ops import pool

    shape = (BATCH, 1024, 7, 7)
    layer = SpatialAveragePooling(7, 7, 1, 1)  # inception.py:88
    probe = torch.empty(shape, device="meta")
    dims, strides, pads, declared = layer._window(probe)
    inv = pool._np_inv_counts(shape, dims, strides, pads, declared, True)
    inv_dev = {}

    def kernel(x):
        return pool.avg_pool_forward(x, dims, strides, pads, declared, True)

    def plain(x):
        if x.device not in inv_dev:
            inv_dev[x.device] = torch.as_tensor(inv, dtype=torch.float32,
                                                device=x.device)
        return pool.avg_pool_plain(x, dims, strides, pads, inv_dev[x.device])

    def library(x):
        return torch.nn.functional.avg_pool2d(x, 7, 1)

    def bound(x):
        out = x.numel() // 49
        nbytes = (x.numel() + out) * x.element_size()
        flops = out * (49 + 1)
        return nbytes, flops

    return [dict(name="avg_pool_fwd", site="head 7x7 s1", shape=shape,
                 kernel=kernel, plain=plain, library=library, bound=bound)]


def phase_kernels(torch):
    """Accuracy and timing of every kernel at the serving shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for case in _lrn_cases(torch) + _pool_cases(torch):
        for dtype, tol in ((torch.float32, dict(rtol=1e-5, atol=1e-6)),
                           (torch.bfloat16, dict(rtol=2e-2, atol=2e-2))):
            x = torch.randn(case["shape"], generator=gen, device="cuda").to(dtype)
            got = case["kernel"](x)
            want = case["plain"](x)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **tol)
            err = (got.float() - want.float()).abs().max().item()
            copies = rotating_copies(x, torch)
            launches = max(len(copies), 20)
            nbytes, flops = case["bound"](x)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOPS_PER_S * 1e3
            row = {"name": case["name"], "site": case["site"],
                   "shape": list(case["shape"]), "dtype": str(dtype)[6:],
                   "max_abs_err": err, "tolerance": tol,
                   "ms": graph_ms(torch, case["kernel"], copies, launches),
                   "plain_ms": graph_ms(torch, case["plain"], copies, launches),
                   "library_ms": graph_ms(torch, case["library"], copies,
                                          launches),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": nbytes, "flops": flops}
            emit({"phase": "kernels", **row})
            rows.append(row)
            del copies
    return rows


@contextlib.contextmanager
def plain_versions():
    """Route the layers of the serving path to the plain versions of
    their kernels (the reference forward on the card).  Lives here and
    nowhere in the package: the package never swaps a kernel out."""
    from bigdl_tpu_torch.nn.layers import normalization, pooling
    from bigdl_tpu_torch.ops import lrn, pool

    def lrn_plain(x, size, alpha, beta, k, want_den=False):
        return lrn.cross_map_lrn_plain(x, size, alpha, beta, k)[0]

    def avg_plain(x, dims, strides, pads, declared, cip):
        inv = pool._np_inv_counts(tuple(x.shape), tuple(dims), tuple(strides),
                                  tuple(pads), tuple(declared), cip)
        return pool.avg_pool_plain(x, dims, strides, pads, inv)

    saved = normalization.cross_map_lrn_forward, pooling.avg_pool_forward
    normalization.cross_map_lrn_forward, pooling.avg_pool_forward = \
        lrn_plain, avg_plain
    try:
        yield
    finally:
        normalization.cross_map_lrn_forward, pooling.avg_pool_forward = saved


def _post(port, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict",
                                 data=body,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, doc = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, doc = e.code, json.loads(e.read())
    return code, doc, (time.perf_counter() - t0) * 1000.0


def phase_serve(torch, card: str):
    from bigdl_tpu_torch.models import registry
    from bigdl_tpu_torch.ops import lrn, pool
    from bigdl_tpu_torch.serving import serve_model

    t0 = time.perf_counter()
    model = registry.build_model(
        "inception_v1", generator=torch.Generator().manual_seed(SEED))
    server = serve_model(model, registry.input_spec("inception_v1", 1),
                         name="inception_v1", host="127.0.0.1", port=0,
                         max_batch=BATCH, batch_buckets=[1, 2, 4, 8],
                         max_wait_ms=2.0, compute_dtype=torch.bfloat16,
                         device="cuda")
    try:
        startup_s = time.perf_counter() - t0
        rng = np.random.RandomState(SEED)
        # inputs at 4 decimals keep each JSON body short; the rows the
        # server parses are exactly the float32 rows checked below
        xs64 = [np.round(rng.randn(1 + 2 * (i % 2), 3, 224, 224), 4)
                for i in range(32)]
        xs = [x.astype(np.float32) for x in xs64]
        bodies = [json.dumps({"inputs": x.tolist()}).encode() for x in xs64]
        results = [None] * len(xs)

        def client(i):
            results[i] = _post(server.port, bodies[i])

        # the main path: counts at 0 just before, read just after
        lrn.cross_map_lrn_forward.launches = 0
        pool.avg_pool_forward.launches = 0
        t_burst = time.perf_counter()
        for wave in (range(0, 16), range(16, 32)):  # 16 concurrent each
            threads = [threading.Thread(target=client, args=(i,)) for i in wave]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
                if t.is_alive():
                    raise RuntimeError("a request did not return in 600 s")
        burst_s = time.perf_counter() - t_burst
        launches = {"cross_map_lrn_fwd": lrn.cross_map_lrn_forward.launches,
                    "avg_pool_fwd": pool.avg_pool_forward.launches}
        st = server.status()

        health = urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/healthz", timeout=30).status
        if health != 200:
            raise RuntimeError(f"/healthz answered {health}")
        max_err = 0.0
        with plain_versions():
            for x, (code, doc, _) in zip(xs, results):
                if code != 200:
                    raise RuntimeError(f"predict answered {code}: {doc}")
                out = np.asarray(doc["outputs"], np.float32)
                if out.shape != (len(x), 1000) or not np.isfinite(out).all():
                    raise RuntimeError(f"bad outputs of shape {out.shape}")
                np.testing.assert_allclose(np.exp(out).sum(1), 1.0, atol=1e-3)
                ref = server.executor.forward(
                    torch.from_numpy(x).cuda()).cpu().numpy()
                np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
                max_err = max(max_err, float(np.abs(out - ref).max()))
        if (lrn.cross_map_lrn_forward.launches,
                pool.avg_pool_forward.launches) != tuple(launches.values()):
            raise RuntimeError("the plain-version reference reached a kernel")
        batches = st["batches"]
        if launches["cross_map_lrn_fwd"] < 2 * batches \
                or launches["avg_pool_fwd"] < batches or batches < 1:
            raise RuntimeError(f"kernel launches {launches} for {batches} "
                               f"batches: the served forward missed a kernel")
    finally:
        parked = server.stop(drain=True)
    if not parked:
        raise RuntimeError("the batcher did not drain")
    breakdown = serve_breakdown(torch, server, bodies)
    lat = sorted(r[2] for r in results)
    rows = sum(len(x) for x in xs)
    row = {"phase": "serve", "ok": True, "model": "inception_v1",
           "classes": 1000, "weights": "bf16", "compute": "f32",
           "buckets": [1, 2, 4, 8], "max_wait_ms": 2.0,
           "startup_s": startup_s, "warmup_s": server.executor.warmup_s,
           "requests": len(xs), "rows": rows, "batches": batches,
           "batch_fill": st["batch_fill"], "kernel_launches": launches,
           "max_abs_err_vs_plain": max_err,
           "server_p50_ms": st["p50_ms"], "server_p99_ms": st["p99_ms"],
           "client_p50_ms": lat[len(lat) // 2],
           "client_p99_ms": lat[min(len(lat) - 1, round(0.99 * (len(lat) - 1)))],
           "img_per_s": rows / burst_s, "burst_s": burst_s,
           "breakdown": breakdown, "card": card}
    emit(row)
    return launches


def serve_breakdown(torch, server, bodies, reps: int = 10):
    """Where a request's time goes, after the drain: median host-clock
    milliseconds of the forward alone (synchronised) and of the
    executor's whole run (copies in and out) per bucket, and of parsing
    a 1-row and a 3-row JSON body."""
    ex = server.executor

    def median_ms(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1000.0)
        return sorted(times)[reps // 2]

    out = {"forward_ms": {}, "run_ms": {}}
    for b in ex.policy.batch_buckets:
        x = torch.zeros((b,) + server.sample_shape, device="cuda")
        xn = np.zeros((b,) + server.sample_shape, np.float32)
        out["forward_ms"][b] = median_ms(lambda: ex.forward(x))
        out["run_ms"][b] = median_ms(lambda: ex.run(xn))
    for rows, body in (("1_row", bodies[0]), ("3_rows", bodies[1])):
        out[f"parse_ms_{rows}"] = median_ms(
            lambda: server.parse_inputs(json.loads(body)))
    return out


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    import bigdl_tpu_torch  # noqa: F401 - fails outside a checkout

    card = phase_build()
    rows = phase_kernels(torch)
    launches = phase_serve(torch, card)

    summary = []
    meta = {"cross_map_lrn_fwd": ("bigdl_tpu_torch/csrc/lrn_fwd.cu",
                                  "bigdl_tpu/ops/lrn_pallas.py:103"),
            "avg_pool_fwd": ("bigdl_tpu_torch/csrc/avg_pool_fwd.cu",
                             "bigdl_tpu/ops/pool_pallas.py:175")}
    for name, (source, replaces) in meta.items():
        mine = [r for r in rows if r["name"] == name]
        f32 = [r for r in mine if r["dtype"] == "float32"]
        t_bytes = sum(r["bytes"] for r in f32) / HBM_BYTES_PER_S * 1e3
        t_ops = sum(r["flops"] for r in f32) / F32_FLOPS_PER_S * 1e3
        # per served forward at batch 8, f32: the sum over its call sites
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in f32),
            "plain_ms": sum(r["plain_ms"] for r in f32),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in f32),
            "per": "one served forward at batch 8, f32: "
                   + ", ".join(f"{r['site']} {r['shape']}" for r in f32)})
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
