#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one
NVIDIA GPU.  Run from the root of a checkout:

    python3 chip_smoke.py

It builds what it needs from the checkout's sources and prints one JSON
line per phase; any failure ends it with a non-zero exit and no result:

1. build   -- compiles ``bigdl_tpu_torch/csrc/*.cu`` for sm_90a (one
              nvcc per source, started together) and prints ptxas's
              register and spill report.
2. kernels -- each kernel held against its plain PyTorch version on the
              card (f32 at rtol 1e-5 / atol 1e-6, bf16 at 2e-2) and
              timed beside its plain version, a one-call PyTorch
              yardstick that the port never calls, and its bound, in f32
              and bf16: the forward kernels at the serving shapes of
              batch 8, and every kernel at the training shapes of batch
              256, where the LRN forward also writes ``den`` (checked
              too) for its backward.
3. serve   -- full-width Inception-v1 (1000 classes, seeded weights)
              served by the port's ModelServer with bf16 weights and f32
              compute, buckets 1,2,4,8, max-wait 2 ms; concurrent
              requests of 1 and 3 rows are checked against the same rows
              run through the plain-version forward on the card (1e-4),
              and the kernel wrappers' launch counts show the served
              forwards went through the kernels.
4. train   -- (a) one f32 SGD step of full-width Inception-v1 (no
              dropout, batch 8, TF32 off, deterministic cuDNN) through
              the kernels, against the same step through the plain
              versions: losses to 1e-5 relative, parameters to 1e-4.
              (b) the main path: ``python -m bigdl_tpu_torch.models.cli
              perf --model inception_v1 -b 256 --warmup 3 -i 10`` (bf16,
              dropout on) in a subprocess; every loss finite, the last
              three below the first three on the fixed batch, and the
              launches per step 2/2/1/1 (LRN forward and backward,
              average-pool forward and backward).  (c) where a step's
              time goes at batch 256: forward, backward and optimizer.
5. train_lm -- the transformer LM ``transformer_lm`` (32000 vocab, 6
              layers, embed 512, 8 heads, seq 512).  (a) one f32 SGD
              step of a 2-layer model at full width, batch 2, through the
              flash kernels against the same step through their plain
              versions: loss to 1e-5 relative, parameters to 1e-4.  (b)
              the main path: ``bench_configs.make_step("transformer_lm")``,
              batch 32, bf16, 3 warm-up and 10 timed steps synchronised
              only at the window's ends; every loss finite, the last three
              below the first three, and exactly 6/6/6 launches per step
              of the flash forward, dq and dkv kernels.  (c) forward,
              backward and optimizer ms.  (d) the same step with dense
              attention, records/s, for re-picking ``flash_min_seq``.

The kernels phase also holds the three flash-attention kernels against
their plain versions in f32 and bf16 at the training shape
[32, 8, 512, 64] causal (checked and timed) and at edge shapes (checked
only): non-causal, sq 128 / sk 384 and sq 384 / sk 128 causal (rows
that see no key: ``out`` and ``dq`` 0), ragged S 500, head dims 32 and
128.  Their f32 tolerance is rtol 1e-5 with atol 1e-6 times the largest
magnitude of the output: the kernels sum up to 512 products in another
order than the plain version's matmuls.

Then the card's name and power limit, the kernel summary line, and the
last line ``{"ok": true, "device": {...}}``.  It exits non-zero when
CUDA is unavailable, and in a directory that holds nothing of the repo.

Kernel times are device times: each timed op runs as a CUDA graph of
many launches over rotating copies of its input that together exceed
the 50 MB L2 cache, timed with CUDA events (the backward of
``F.local_response_norm``, an autograd graph, and
``F.scaled_dot_product_attention`` forward and backward are timed with
events around plain calls).  Bounds use the H100 SXM
data-sheet peaks: 3.35 TB/s of HBM and 67 TFLOP/s of f32 outside the
tensor cores (every kernel computes in f32), except the flash-attention
rows in bf16, whose operations are held to the tensor cores' 989 TFLOP/s
so that a redesign on them is judged by what the card can do.
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
BF16_TENSOR_FLOPS_PER_S = 989e12
L2_BYTES = 50e6
SEED = 1
BATCH = 8
TRAIN_BATCH = 256
#: kernel launches of one Inception-v1 train step, by kernel
PER_STEP = {"cross_map_lrn_fwd": 2, "cross_map_lrn_bwd": 2,
            "avg_pool_fwd": 1, "avg_pool_bwd": 1}
LM_BATCH = 32
LM_LAYERS = 6
#: kernel launches of one transformer_lm train step: one per layer each
LM_PER_STEP = {"flash_fwd": LM_LAYERS, "flash_dq": LM_LAYERS,
               "flash_dkv": LM_LAYERS}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def expect_launches(launches, per_step, steps: int, what: str) -> None:
    """Every kernel launched exactly ``per_step * steps`` times, and the
    kernels ``per_step`` does not name not at all."""
    want = {k: per_step.get(k, 0) * steps for k in launches}
    if launches != want:
        raise RuntimeError(f"{what} launched {launches}, expected {want}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def graph_ms(torch, fn, inputs, launches: int, replays: int = 5) -> float:
    """Mean device milliseconds of one ``fn(*args)`` call: ``launches``
    calls over the rotating argument tuples ``inputs`` captured as one
    CUDA graph, replayed."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for args in inputs[:3]:  # warm: builds, lazy module loads, caches
            fn(*args)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * launches)


def event_ms(torch, fn, inputs, calls: int = 10) -> float:
    """Mean device milliseconds of one ``fn(*args)`` call, eagerly
    launched over the rotating ``inputs`` between two CUDA events (for
    calls of milliseconds, which a graph cannot capture)."""
    for args in inputs[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def rotating_copies(args, torch):
    """Enough copies of the argument tuple ``args`` that a pass over
    them exceeds twice the L2 cache, so each timed launch reads its
    inputs from HBM."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    n = min(64, max(2, math.ceil(2 * L2_BYTES / nbytes)))
    return [tuple(a.clone() for a in args) for _ in range(n)]


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


LRN_HYPER = (5, 1e-4, 0.75, 1.0)  # size, alpha, beta, k: inception.py:64,69
LRN_SITES = (("pool1/norm1", 64), ("conv2/norm2", 192))  # channels at 56x56


def _lrn_cases(torch, path, batch):
    """The LRN forward as ``path`` calls it: serving wants y alone, the
    train step y and ``den``, which its backward reads."""
    from bigdl_tpu_torch.ops import lrn

    size, alpha, beta, k = LRN_HYPER
    want_den = path == "train"

    def make(gen, shape, dtype):
        return (torch.randn(shape, generator=gen, device="cuda").to(dtype),)

    def kernel(x):
        return lrn.cross_map_lrn_forward(x, size, alpha, beta, k,
                                         want_den=want_den)

    def plain(x):
        y, den = lrn.cross_map_lrn_plain(x, size, alpha, beta, k)
        return (y, den) if want_den else y

    def library(x):
        return torch.nn.functional.local_response_norm(x, size, alpha, beta, k)

    def bound(x):
        # x in; y, and den where it is written, out
        nbytes = (3 if want_den else 2) * x.numel() * x.element_size()
        flops = x.numel() * (2 * size + 5)
        return nbytes, flops

    return [dict(name="cross_map_lrn_fwd", path=path, site=site,
                 shape=(batch, c, 56, 56), make=make, kernel=kernel,
                 plain=plain, library=library, bound=bound)
            for site, c in LRN_SITES]


def _lrn_bwd_cases(torch):
    from bigdl_tpu_torch.ops import lrn

    size, alpha, beta, k = LRN_HYPER
    F = torch.nn.functional

    def make(gen, shape, dtype):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        den = lrn.cross_map_lrn_plain(x, size, alpha, beta, k)[1]
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        return x, den, g

    def kernel(x, den, g):
        return lrn.cross_map_lrn_backward(x, den, g, size, alpha, beta)

    def plain(x, den, g):
        return lrn.cross_map_lrn_backward_plain(x, den, g, size, alpha, beta)

    def library_inputs(x, den, g):
        # the graph of F.local_response_norm is built here, outside the
        # timed region; the timed call is its backward alone
        xr = x.detach().clone().requires_grad_()
        return F.local_response_norm(xr, size, alpha, beta, k), xr, g

    def library(y, xr, g):
        return torch.autograd.grad(y, xr, g, retain_graph=True)[0]

    def bound(x, den, g):
        nbytes = 4 * x.numel() * x.element_size()  # x, den, g in; dx out
        flops = x.numel() * (size + 11)
        return nbytes, flops

    return [dict(name="cross_map_lrn_bwd", path="train", site=site,
                 shape=(TRAIN_BATCH, c, 56, 56), make=make, kernel=kernel,
                 plain=plain, library=library, library_inputs=library_inputs,
                 bound=bound)
            for site, c in LRN_SITES]


def _head_geometry(torch, shape):
    from bigdl_tpu_torch.nn.layers.pooling import SpatialAveragePooling

    layer = SpatialAveragePooling(7, 7, 1, 1)  # inception.py:88
    return layer._window(torch.empty(shape, device="meta"))


def _pool_cases(torch, path, batch):
    from bigdl_tpu_torch.ops import pool

    shape = (batch, 1024, 7, 7)
    dims, strides, pads, declared = _head_geometry(torch, shape)
    inv = pool._np_inv_counts(shape, dims, strides, pads, declared, True)
    inv_dev = torch.as_tensor(inv, dtype=torch.float32, device="cuda")

    def make(gen, shape, dtype):
        return (torch.randn(shape, generator=gen, device="cuda").to(dtype),)

    def kernel(x):
        return pool.avg_pool_forward(x, dims, strides, pads, declared, True)

    def plain(x):
        return pool.avg_pool_plain(x, dims, strides, pads, inv_dev)

    def library(x):
        return torch.nn.functional.avg_pool2d(x, 7, 1)

    def bound(x):
        out = x.numel() // 49
        nbytes = (x.numel() + out) * x.element_size()
        flops = out * (49 + 1)
        return nbytes, flops

    return [dict(name="avg_pool_fwd", path=path, site="head 7x7 s1",
                 shape=shape, make=make, kernel=kernel, plain=plain,
                 library=library, bound=bound)]


def _pool_bwd_cases(torch):
    from bigdl_tpu_torch.ops import pool

    shape = (TRAIN_BATCH, 1024, 7, 7)
    dims, strides, pads, declared = _head_geometry(torch, shape)
    out_shape = (TRAIN_BATCH, 1024, 1, 1)

    def make(gen, _shape, dtype):
        wgt = torch.randn(out_shape, generator=gen, device="cuda").to(dtype)
        x = torch.empty(shape, dtype=dtype, device="cuda")  # library only
        return wgt, x

    def kernel(wgt, x):
        return pool.avg_pool_backward(wgt, shape, dims, strides, pads,
                                      wgt.dtype)

    def plain(wgt, x):
        return pool.avg_pool_backward_plain(wgt, shape, dims, strides, pads,
                                            wgt.dtype)

    def library(wgt, x):
        # the same gradient from gy = 49 * wgt: aten divides by the count
        return torch.ops.aten.avg_pool2d_backward(
            wgt, x, [7, 7], [1, 1], [0, 0], False, True, None)

    def bound(wgt, x):
        nbytes = (wgt.numel() + x.numel()) * wgt.element_size()
        flops = x.numel()  # one window holds each position
        return nbytes, flops

    return [dict(name="avg_pool_bwd", path="train", site="head 7x7 s1",
                 shape=shape, make=make, kernel=kernel, plain=plain,
                 library=library, bound=bound)]


def phase_kernels(torch):
    """Accuracy and timing of every kernel at the shapes of each main
    path that launches it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    cases = (_lrn_cases(torch, "serve", BATCH)
             + _pool_cases(torch, "serve", BATCH)
             + _lrn_cases(torch, "train", TRAIN_BATCH)
             + _pool_cases(torch, "train", TRAIN_BATCH)
             + _lrn_bwd_cases(torch) + _pool_bwd_cases(torch))
    for case in cases:
        for dtype, tol in ((torch.float32, dict(rtol=1e-5, atol=1e-6)),
                           (torch.bfloat16, dict(rtol=2e-2, atol=2e-2))):
            args = case["make"](gen, case["shape"], dtype)
            got = case["kernel"](*args)
            want = case["plain"](*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **tol)
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
            del got, want
            copies = rotating_copies(args, torch)
            launches = max(len(copies), 20)
            nbytes, flops = case["bound"](*args)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOPS_PER_S * 1e3
            ms = graph_ms(torch, case["kernel"], copies, launches)
            plain_ms = graph_ms(torch, case["plain"], copies, launches)
            if "library_inputs" in case:
                lib_args = [case["library_inputs"](*a) for a in copies]
                library_ms = event_ms(torch, case["library"], lib_args)
                del lib_args
            else:
                library_ms = graph_ms(torch, case["library"], copies,
                                      launches)
            row = {"name": case["name"], "path": case["path"],
                   "site": case["site"],
                   "shape": list(case["shape"]), "dtype": str(dtype)[6:],
                   "max_abs_err": err, "tolerance": tol, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": nbytes, "flops": flops,
                   "peak_flops": F32_FLOPS_PER_S}
            emit({"phase": "kernels", **row})
            rows.append(row)
            del copies, args
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

#: (b, h, sq, sk, d, causal): the training shape, checked and timed
FLASH_TRAIN = (LM_BATCH, 8, 512, 512, 64, True)
#: edge shapes, checked only
FLASH_EDGES = ((2, 8, 512, 512, 64, False), (2, 8, 128, 384, 64, True),
               (2, 8, 384, 128, 64, True), (2, 8, 500, 500, 64, True),
               (2, 8, 512, 512, 32, True), (2, 8, 512, 512, 128, True))


def _flash_tol(torch, want, dtype):
    """bf16: 2e-2, as for the other kernels.  f32: rtol 1e-5 and atol
    1e-6 scaled by the output's largest magnitude, since the kernels sum
    up to 512 products in another order than the plain matmuls."""
    if dtype == torch.bfloat16:
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=1e-5,
                atol=1e-6 * max(1.0, want.float().abs().max().item()))


def live_pairs(sq: int, sk: int, causal: bool) -> int:
    """(q, k) pairs a causal mask leaves visible: row r sees the keys up
    to r + sk - sq."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, r + sk - sq + 1)) for r in range(sq))


def _flash_check(torch, gen, shape, dtype):
    """Every output of the three kernels against the plain versions on
    the same inputs (the backward fed the plain forward's lse and
    delta); returns the inputs and each output's max abs error."""
    from bigdl_tpu_torch.ops import attention as A

    b, h, sq, sk, d, causal = shape
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .to(dtype) for s in (sq, sk, sk, sq))
    scale = d ** -0.5
    out, lse = A.flash_fwd(q, k, v, scale, causal)
    p_out, p_lse = A.flash_fwd_plain(q, k, v, scale, causal)
    delta = (do.float() * p_out.float()).sum(-1)
    dq = A.flash_dq(q, k, v, do, p_lse, delta, scale, causal)
    dk, dv = A.flash_dkv(q, k, v, do, p_lse, delta, scale, causal)
    p_dq, p_dk, p_dv = A.flash_bwd_plain(q, k, v, p_out, p_lse, do, delta,
                                         scale, causal)
    torch.cuda.synchronize()
    errs = {}
    # a row that sees no key has lse -1e30 in both: compare above -1e4
    for name, got, want in (("out", out, p_out),
                            ("lse", lse.clamp(min=-1e4), p_lse.clamp(min=-1e4)),
                            ("dq", dq, p_dq), ("dk", dk, p_dk),
                            ("dv", dv, p_dv)):
        torch.testing.assert_close(got, want, **_flash_tol(torch, want, dtype),
                                   msg=lambda m: f"{name} {shape}: {m}")
        errs[name] = (got.float() - want.float()).abs().max().item()
    blind = max(0, sq - sk) if causal else 0  # rows that see no key
    if blind and (out[:, :, :blind].abs().max().item() != 0.0
                  or dq[:, :, :blind].abs().max().item() != 0.0
                  or lse[:, :, :blind].max().item() > -1e29):
        raise RuntimeError(f"rows that see no key are not 0 at {shape}")
    return (q, k, v, do, p_lse, delta), errs


def _flash_rows(torch, dtype, inputs, errs):
    """Device times of the three kernels at the training shape, beside
    their plain versions, ``F.scaled_dot_product_attention`` (forward;
    its autograd backward for the dq/dkv pair, which computes dq, dk and
    dv in one call) and their bounds."""
    from bigdl_tpu_torch.ops import attention as A

    F = torch.nn.functional
    b, h, sq, sk, d, causal = FLASH_TRAIN
    scale = d ** -0.5
    peak = BF16_TENSOR_FLOPS_PER_S if dtype == torch.bfloat16 \
        else F32_FLOPS_PER_S
    esize = inputs[0].element_size()
    pairs = b * h * live_pairs(sq, sk, causal)
    q_elems, kv_elems, rows = b * h * sq * d, b * h * sk * d, b * h * sq

    def sdpa_bwd_inputs(q, k, v, do, lse, delta):
        # the graph is built here, outside the timed region; the timed
        # call is its backward alone
        xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        return F.scaled_dot_product_attention(*xs, is_causal=True), xs, do

    def sdpa_bwd(out, xs, do):
        return torch.autograd.grad(out, xs, do, retain_graph=True)

    specs = [
        ("flash_fwd", lambda q, k, v, *_: A.flash_fwd(q, k, v, scale, causal),
         lambda q, k, v, *_: A.flash_fwd_plain(q, k, v, scale, causal),
         (lambda q, k, v, *_: (q, k, v)),
         lambda q, k, v: F.scaled_dot_product_attention(q, k, v,
                                                        is_causal=True),
         # q, k, v in, out out; lse out in f32
         (2 * q_elems + 2 * kv_elems) * esize + 4 * rows, 4 * d * pairs,
         ("out", "lse")),
        ("flash_dq",
         lambda q, k, v, do, lse, delta: A.flash_dq(q, k, v, do, lse, delta,
                                                    scale, causal),
         lambda q, k, v, do, lse, delta: A._dq_plain(q, k, v, lse, do, delta,
                                                     scale, causal),
         sdpa_bwd_inputs, sdpa_bwd,
         # q, k, v, do in, dq out; lse and delta in f32
         (3 * q_elems + 2 * kv_elems) * esize + 8 * rows, 6 * d * pairs,
         ("dq",)),
        ("flash_dkv",
         lambda q, k, v, do, lse, delta: A.flash_dkv(q, k, v, do, lse, delta,
                                                     scale, causal),
         lambda q, k, v, do, lse, delta: A._dkv_plain(q, k, v, lse, do,
                                                      delta, scale, causal),
         sdpa_bwd_inputs, sdpa_bwd,
         # q, k, v, do in, dk, dv out; lse and delta in f32
         (2 * q_elems + 4 * kv_elems) * esize + 8 * rows, 8 * d * pairs,
         ("dk", "dv")),
    ]
    copies = rotating_copies(inputs, torch)
    launches = max(len(copies), 20)
    out = []
    for name, kernel, plain, lib_inputs, library, nbytes, flops, outs in specs:
        ms = graph_ms(torch, kernel, copies, launches)
        plain_ms = graph_ms(torch, plain, copies, launches)
        lib_args = [lib_inputs(*a) for a in copies]
        library_ms = event_ms(torch, library, lib_args)
        del lib_args
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        row = {"name": name, "path": "train_lm", "site": "attention",
               "shape": list(FLASH_TRAIN[:5]), "causal": causal,
               "dtype": str(dtype)[6:],
               "max_abs_err": max(errs[o] for o in outs),
               "errors": {o: errs[o] for o in outs},
               "tolerance": "2e-2" if dtype == torch.bfloat16
               else "rtol 1e-5, atol 1e-6 x max|plain|",
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "flops": flops, "peak_flops": peak,
               "live_pairs": pairs}
        emit({"phase": "kernels", **row})
        out.append(row)
        torch.cuda.empty_cache()
    return out


def phase_flash_kernels(torch):
    """The flash-attention kernels against their plain versions at the
    training shape (then timed) and at the edge shapes, f32 and bf16."""
    from bigdl_tpu_torch.device import strict_f32

    strict_f32()  # the plain versions' f32 matmuls stay f32
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FLASH_EDGES:
            _, errs = _flash_check(torch, gen, shape, dtype)
            emit({"phase": "kernels", "name": "flash", "checked_only": True,
                  "shape": list(shape[:5]), "causal": shape[5],
                  "dtype": str(dtype)[6:], "errors": errs})
        inputs, errs = _flash_check(torch, gen, FLASH_TRAIN, dtype)
        rows += _flash_rows(torch, dtype, inputs, errs)
        del inputs
        torch.cuda.empty_cache()
    return rows


def _plain_lrn(torch):
    """Cross-map LRN through its plain versions, forward and backward."""
    from bigdl_tpu_torch.ops import lrn

    class PlainLRN(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, size, alpha, beta, k):
            y, den = lrn.cross_map_lrn_plain(x, size, alpha, beta, k)
            ctx.save_for_backward(x, den)
            ctx.hyper = (size, alpha, beta)
            return y

        @staticmethod
        def backward(ctx, g):
            x, den = ctx.saved_tensors
            dx = lrn.cross_map_lrn_backward_plain(x, den, g.contiguous(),
                                                  *ctx.hyper)
            return dx, None, None, None, None

    return PlainLRN.apply


def _plain_avg_pool(torch):
    """Average pooling through its plain versions, forward and backward."""
    from bigdl_tpu_torch.ops import pool

    class PlainAvgPool(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dims, strides, pads, declared, cip):
            ctx.key = (tuple(x.shape), tuple(dims), tuple(strides),
                       tuple(pads), tuple(declared), cip)
            ctx.x_dtype = x.dtype
            inv = pool._np_inv_counts(*ctx.key)
            return pool.avg_pool_plain(x, dims, strides, pads, inv)

        @staticmethod
        def backward(ctx, gy):
            inv = torch.as_tensor(pool._np_inv_counts(*ctx.key),
                                  dtype=gy.dtype, device=gy.device)
            dx = pool.avg_pool_backward_plain(gy * inv, *ctx.key[:4],
                                              ctx.x_dtype)
            return dx, None, None, None, None, None

    return PlainAvgPool.apply


def _plain_flash(torch):
    """Flash attention through its plain versions, forward and backward."""
    from bigdl_tpu_torch.ops import attention as A

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, scale, causal):
            out, lse = A.flash_fwd_plain(q, k, v, scale, causal)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.scale, ctx.causal = scale, causal
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            do = do.contiguous()
            delta = (do.float() * out.float()).sum(-1)
            dq, dk, dv = A.flash_bwd_plain(q, k, v, out, lse, do, delta,
                                           ctx.scale, ctx.causal)
            return dq, dk, dv, None, None

    def flash_attention(q, k, v, causal=False, scale=None):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        return PlainFlash.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), scale, causal)

    return flash_attention


@contextlib.contextmanager
def plain_versions(torch):
    """Route the layers to the plain versions of their kernels, forward
    and backward (the reference model on the card).  Lives here and
    nowhere in the package: the package never swaps a kernel out."""
    from bigdl_tpu_torch.nn.layers import normalization, pooling
    from bigdl_tpu_torch.ops import attention

    saved = (normalization.cross_map_lrn, pooling.avg_pool,
             attention.flash_attention)
    normalization.cross_map_lrn = _plain_lrn(torch)
    pooling.avg_pool = _plain_avg_pool(torch)
    attention.flash_attention = _plain_flash(torch)
    try:
        yield
    finally:
        (normalization.cross_map_lrn, pooling.avg_pool,
         attention.flash_attention) = saved


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
    from bigdl_tpu_torch.ops import kernel_launches, reset_kernel_launches
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

        # the serving path: counts at 0 just before, read just after
        reset_kernel_launches()
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
        launches = kernel_launches()
        st = server.status()

        health = urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/healthz", timeout=30).status
        if health != 200:
            raise RuntimeError(f"/healthz answered {health}")
        max_err = 0.0
        with plain_versions(torch):
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
        if kernel_launches() != launches:
            raise RuntimeError("the plain-version reference reached a kernel")
        batches = st["batches"]
        if launches["cross_map_lrn_fwd"] < 2 * batches \
                or launches["avg_pool_fwd"] < batches or batches < 1 \
                or launches["cross_map_lrn_bwd"] or launches["avg_pool_bwd"] \
                or any(launches[k] for k in LM_PER_STEP):
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


def _train_parity(torch):
    """(a) One f32 SGD step of full-width Inception-v1 through the
    kernels against the same step through their plain versions."""
    import copy

    from bigdl_tpu_torch.models.inception import build_inception_v1
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import TrainStep

    torch.backends.cudnn.deterministic = True
    model = build_inception_v1(
        1000, has_dropout=False, generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.normal(size=(BATCH, 3, 224, 224))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, BATCH)).cuda()

    def step(m):
        return TrainStep(m, ClassNLLCriterion(),
                         SGD(learning_rate=0.01, momentum=0.9),
                         device="cuda")

    ref = step(copy.deepcopy(model))
    run = step(model)
    reset_kernel_launches()
    loss = run.run(x, y)
    launches = kernel_launches()
    expect_launches(launches, PER_STEP, 1, "one train step")
    with plain_versions(torch):
        want = ref.run(x, y)
    if kernel_launches() != launches:
        raise RuntimeError("the plain-version step reached a kernel")
    torch.backends.cudnn.deterministic = False
    if not (math.isfinite(loss) and abs(loss - want) <= 1e-5 * abs(want)):
        raise RuntimeError(f"step loss {loss} against plain {want}")
    max_err = 0.0
    for k, p in run.params.items():
        torch.testing.assert_close(p, ref.params[k], rtol=1e-4, atol=1e-6)
        max_err = max(max_err, (p - ref.params[k]).abs().max().item())
    return {"batch": BATCH, "dtype": "float32", "loss": loss,
            "loss_plain": want, "param_max_abs_err": max_err,
            "launches": launches}


def _train_main_path(root: str):
    """(b) ``cli perf`` at batch 256 in a subprocess: its JSON report and
    its records/sec line."""
    warmup, iters = 3, 10
    cmd = [sys.executable, "-m", "bigdl_tpu_torch.models.cli", "perf",
           "--model", "inception_v1", "-b", str(TRAIN_BATCH),
           "--warmup", str(warmup), "-i", str(iters)]
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[1:])} exited {out.returncode}:\n"
                           f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    lines = out.stdout.strip().splitlines()
    report = json.loads(lines[-2])
    last = lines[-1]
    if not last.startswith("inception_v1: ") or "records/sec" not in last:
        raise RuntimeError(f"unexpected last line {last!r}")
    losses = report["losses"]
    steps = warmup + iters
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"losses {losses}")
    first, tail = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not tail < first:
        raise RuntimeError(f"the loss did not fall on the fixed batch: "
                           f"{losses}")
    expect_launches(report["launches"], PER_STEP, steps, f"{steps} steps")
    report["records_per_s"] = float(last.split()[1])
    report["last_line"] = last
    return report


def _train_breakdown(torch, steps: int = 5):
    """(c) Median host-clock milliseconds (synchronised) of the forward
    with the loss, the backward, and the optimizer update of one bf16
    step at batch 256, dropout on, as ``cli perf`` builds it."""
    from bigdl_tpu_torch.models import registry
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import TrainStep

    model = registry.build_model("inception_v1", 1000,
                                 generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(TRAIN_BATCH, 3, 224, 224))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, TRAIN_BATCH)).cuda()
    step = TrainStep(model, ClassNLLCriterion(),
                     SGD(learning_rate=0.01, momentum=0.9),
                     compute_dtype=torch.bfloat16, device="cuda")
    times = {"forward_ms": [], "backward_ms": [], "optimizer_ms": [],
             "step_ms": []}
    for i in range(steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step.loss(x, y, torch.Generator("cuda").manual_seed(i))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = step.grads(loss)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        step.update(grads)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i >= 2:  # the first two build caches and pick algorithms
            for k, v in (("forward_ms", t1 - t0), ("backward_ms", t2 - t1),
                         ("optimizer_ms", t3 - t2), ("step_ms", t3 - t0)):
                times[k].append(v * 1e3)
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def phase_train(torch, card: str, root: str):
    parity = _train_parity(torch)
    torch.cuda.empty_cache()
    report = _train_main_path(root)
    breakdown = _train_breakdown(torch)
    torch.cuda.empty_cache()
    row = {"phase": "train", "ok": True, "model": "inception_v1",
           "parity": parity, "batch": TRAIN_BATCH, "compute": "bf16",
           "losses": report["losses"], "launches": report["launches"],
           "launches_per_step": PER_STEP,
           "records_per_s": report["records_per_s"],
           "step_ms": report["step_ms"],
           "max_memory_allocated": report["max_memory_allocated"],
           "breakdown_ms": breakdown, "last_line": report["last_line"],
           "card": card}
    emit(row)
    return report["launches"]


def _lm_parity(torch):
    """(a) One f32 SGD step of a 2-layer transformer LM at full width
    (vocab 32000, embed 512, 8 heads, seq 512), batch 2, through the
    flash kernels against the same step through their plain versions."""
    import copy

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.transformer import build_transformer_lm
    from bigdl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import TrainStep

    layers, batch = 2, 2
    model = build_transformer_lm(32000, num_layers=layers, embed_dim=512,
                                 num_heads=8, max_len=512,
                                 generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.integers(0, 32000, (batch, 512),
                                      dtype=np.int32)).cuda()
    y = torch.from_numpy(rng.integers(0, 32000, (batch, 512))).cuda()

    def step(m):
        return TrainStep(m, nn.TimeDistributedCriterion(
            nn.ClassNLLCriterion(), size_average=True),
            SGD(learning_rate=0.01, momentum=0.9), device="cuda")

    ref = step(copy.deepcopy(model))
    run = step(model)
    reset_kernel_launches()
    loss = run.run(x, y)
    launches = kernel_launches()
    expect_launches(launches, {k: layers for k in LM_PER_STEP}, 1,
                    f"one {layers}-layer LM step")
    with plain_versions(torch):
        want = ref.run(x, y)
    if kernel_launches() != launches:
        raise RuntimeError("the plain-version step reached a kernel")
    if not (math.isfinite(loss) and abs(loss - want) <= 1e-5 * abs(want)):
        raise RuntimeError(f"LM step loss {loss} against plain {want}")
    max_err = 0.0
    for k, p in run.params.items():
        torch.testing.assert_close(p, ref.params[k], rtol=1e-4, atol=1e-6)
        max_err = max(max_err, (p - ref.params[k]).abs().max().item())
    return {"layers": layers, "batch": batch, "dtype": "float32",
            "loss": loss, "loss_plain": want, "param_max_abs_err": max_err,
            "launches": launches}


def _lm_timed(torch, step, x, y, warmup: int = 3, iters: int = 10):
    """``warmup`` then ``iters`` timed steps, the clock read after a
    synchronise at the window's two ends only; the losses stay on the
    card until then."""
    def train():
        loss = step.loss(x, y)
        step.update(step.grads(loss))
        return loss.detach()

    losses = [train() for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [train() for _ in range(iters)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [float(v) for v in losses], wall


def _lm_breakdown(torch, step, x, y, steps: int = 5):
    """(c) Median host-clock milliseconds (synchronised) of the forward
    with the loss, the backward and the optimizer update."""
    times = {"forward_ms": [], "backward_ms": [], "optimizer_ms": [],
             "step_ms": []}
    for i in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step.loss(x, y)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = step.grads(loss)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        step.update(grads)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i >= 1:
            for k, v in (("forward_ms", t1 - t0), ("backward_ms", t2 - t1),
                         ("optimizer_ms", t3 - t2), ("step_ms", t3 - t0)):
                times[k].append(v * 1e3)
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def phase_train_lm(torch, card: str):
    from bigdl_tpu_torch.bench_configs import make_step
    from bigdl_tpu_torch.nn import MultiHeadAttention
    from bigdl_tpu_torch.ops import kernel_launches, reset_kernel_launches

    parity = _lm_parity(torch)
    torch.cuda.empty_cache()

    # (b) the main path: counts at 0 just before, read just after
    warmup, iters = 3, 10
    step, x, y = make_step("transformer_lm")
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    losses, wall = _lm_timed(torch, step, x, y, warmup, iters)
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    steps = warmup + iters
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"transformer_lm losses {losses}")
    if not sum(losses[-3:]) < sum(losses[:3]):
        raise RuntimeError(f"the LM loss did not fall on the fixed batch: "
                           f"{losses}")
    expect_launches(launches, LM_PER_STEP, steps, f"{steps} LM steps")
    records_per_s = LM_BATCH * iters / wall

    breakdown = _lm_breakdown(torch, step, x, y)

    # (d) the same step with dense attention (records/s only)
    attns = [m for m in step.model.modules()
             if isinstance(m, MultiHeadAttention)]
    for m in attns:
        m.backend = "dense"
    reset_kernel_launches()
    dense_losses, dense_wall = _lm_timed(torch, step, x, y, warmup, iters)
    if any(kernel_launches().values()):
        raise RuntimeError("the dense step launched a kernel")
    if not all(math.isfinite(v) for v in dense_losses):
        raise RuntimeError(f"dense-attention losses {dense_losses}")
    for m in attns:
        m.backend = "auto"
    del step, x, y
    torch.cuda.empty_cache()
    row = {"phase": "train_lm", "ok": True, "model": "transformer_lm",
           "config": {"vocab": 32000, "layers": LM_LAYERS, "embed": 512,
                      "heads": 8, "seq": 512},
           "parity": parity, "batch": LM_BATCH, "compute": "bf16",
           "losses": losses, "launches": launches,
           "launches_per_step": LM_PER_STEP,
           "records_per_s": records_per_s,
           "tokens_per_s": records_per_s * 512,
           "step_ms": wall / iters * 1e3, "max_memory_allocated": peak,
           "breakdown_ms": breakdown,
           "dense_attention": {"records_per_s": LM_BATCH * iters / dense_wall,
                               "step_ms": dense_wall / iters * 1e3,
                               "losses": dense_losses},
           "card": card}
    emit(row)
    return launches


def path_summary(rows, dtype: str, launches: int, per: str) -> dict:
    """One kernel on one path: its launches there, and the sum over the
    path's call sites of the times and the bound in the path's dtype
    (the error is the worst over both dtypes)."""
    sites = [r for r in rows if r["dtype"] == dtype]
    t_bytes = sum(r["bytes"] for r in sites) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(r["flops"] / r["peak_flops"] for r in sites) * 1e3
    return {"launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in sites),
            "plain_ms": sum(r["plain_ms"] for r in sites),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in sites),
            "per": f"{per}, {dtype}: " + ", ".join(
                f"{r['site']} {r['shape']}" for r in sites)}


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    import bigdl_tpu_torch  # noqa: F401 - fails outside a checkout

    root = os.path.dirname(os.path.abspath(__file__))
    card = phase_build()
    rows = phase_kernels(torch) + phase_flash_kernels(torch)
    serve_launches = phase_serve(torch, card)
    launches = phase_train(torch, card, root)
    lm_launches = phase_train_lm(torch, card)

    # each path's numbers come from its own shapes and dtype: serving
    # runs the forwards in f32 at batch 8, training every Inception-v1
    # kernel in bf16 at batch 256 and every flash kernel in bf16 at batch
    # 32; each row leads with its kernel's training path
    paths = {"train": (launches, "bfloat16",
                       f"one train step at batch {TRAIN_BATCH}"),
             "train_lm": (lm_launches, "bfloat16",
                          f"one transformer_lm train step at batch "
                          f"{LM_BATCH}"),
             "serve": (serve_launches, "float32",
                       f"one served forward at batch {BATCH}")}
    meta = {"cross_map_lrn_fwd": ("bigdl_tpu_torch/csrc/lrn_fwd.cu",
                                  "bigdl_tpu/ops/lrn_pallas.py:103"),
            "avg_pool_fwd": ("bigdl_tpu_torch/csrc/avg_pool_fwd.cu",
                             "bigdl_tpu/ops/pool_pallas.py:175"),
            "cross_map_lrn_bwd": ("bigdl_tpu_torch/csrc/lrn_bwd.cu",
                                  "bigdl_tpu/ops/lrn_pallas.py:115"),
            "avg_pool_bwd": ("bigdl_tpu_torch/csrc/avg_pool_bwd.cu",
                             "bigdl_tpu/ops/pool_pallas.py:183"),
            "flash_fwd": ("bigdl_tpu_torch/csrc/flash_fwd.cu",
                          "bigdl_tpu/ops/attention.py:212"),
            "flash_dq": ("bigdl_tpu_torch/csrc/flash_dq.cu",
                         "bigdl_tpu/ops/attention.py:266"),
            "flash_dkv": ("bigdl_tpu_torch/csrc/flash_dkv.cu",
                          "bigdl_tpu/ops/attention.py:312")}
    summary = []
    for name, (source, replaces) in meta.items():
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces}
        for path, (counts, dtype, per) in paths.items():
            mine = [r for r in rows if r["name"] == name and r["path"] == path]
            if not mine:
                continue
            entry_path = path_summary(mine, dtype, counts[name], per)
            if "launches" not in entry:
                entry.update(entry_path)
            else:
                entry[path] = entry_path
        summary.append(entry)
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
