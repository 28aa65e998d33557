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
              (e) six ``Adam`` steps of the same step: finite losses
              that fall, 6/6/6 flash launches each, and their
              breakdown.
6. train_pool -- the Inception-v1 step with its 13 max pools in each
              kernel mode.  (a) one full-width step (no dropout, batch 8,
              deterministic cuDNN) through the kernels against the same
              step through the plain versions: tie-split in f32, argmax
              in bf16 (its gate takes 16-bit input only), both to loss
              1e-5 relative and parameters rtol 1e-4 / atol 1e-6 (every
              kernel is bit-equal to its plain version, so nothing but
              the order of cuDNN's sums could tell the two apart, and
              that is fixed).  (b) batch 256, bf16, dropout on, 3 warm-up
              and 10 timed steps: tie-split built here with
              ``split_ties()`` on every max pool, argmax through ``cli
              perf ... --pool-kernel on`` in a subprocess; finite losses,
              the last three below the first three, and exactly 13 + 13
              max-pool launches per step (``maxpool_fwd`` with
              ``maxpool_tie_bwd`` or ``maxpool_argmax_bwd``) beside
              2/2/1/1 of the LRN and average-pool kernels; records/s,
              step ms and peak memory beside the default step's.
7. train_v2 -- Inception-v2 (BN-Inception, 1000 classes, 3x224x224;
              run between train_pool and train_lm).  (a) both
              average-pool kernels bit-equal to their plain versions at
              its eight geometries (3x3 s1 p1 ceil at 28x28, 14x14 and
              7x7, and the 7x7 head; batch 16, f32 and bf16, normal and
              special inputs).  (b) one f32 SGD step at batch 8 through
              the kernels against the same step through the plain
              versions: loss to 1e-5 relative, parameters and batch-norm
              buffers to 1e-4.  (c) the main path: ``python -m
              bigdl_tpu_torch.models.cli perf --model inception_v2 -b
              256`` in a subprocess: finite losses that fall, exactly 8
              average-pool forward and 8 backward launches a step and no
              other kernel, records/s, step ms and peak memory.  (d)
              forward, backward and optimizer ms at batch 256, then
              three steps under ``torch.profiler``: device ms a step,
              the device's idle share, and device ms by class of
              kernel (convolution, the average-pool kernels, the
              default max pool, the elementwise and reduction work of
              batch norm and the rest).
8. train_resnet -- (after train_v2) the ResNet family.  (a) both
              average-pool kernels bit-equal to their plain versions at
              ResNet-20's head (8x8 on [128, 64, 8, 8]) and ResNet-50's
              (7x7 on [128, 2048, 7, 7]), f32 and bf16, normal and
              special inputs; the kernels phase times them.  (b) one f32
              SGD step of ResNet-20 at batch 8 through the kernels
              against the same step through the plain versions: loss to
              1e-5 relative, parameters and batch-norm buffers to 1e-4.
              (c) the main path, in subprocesses: ``python -m
              bigdl_tpu_torch.models.cli train --model resnet -b 128
              --max-epoch 2 --checkpoint <tmp> -f <tmp>`` through the
              ``LocalOptimizer`` on CIFAR-10 files written here (the
              loader's synthetic images, both splits from one set of
              class patterns): finite losses whose epoch-2 mean is below
              epoch 1's, Top1 above 10% at the last validation,
              ``model.N``, ``optimMethod.N`` and ``ckptmeta.N.json`` at
              both epochs with digests that verify, exactly one
              average-pool forward a step and a validation batch, one
              backward a step and no other kernel; ``cli test`` on the
              checkpoint prints the Top1 of the last validation; a
              1-epoch run resumed to 2 epochs in another directory
              starts at iteration 9 of epoch 2 and ends at the same
              ``neval``, with the largest parameter difference from the
              straight run; records/s of the loop and the share of its
              wall time outside the train step's calls.  (d) ``cli perf
              --model resnet50 -b 128`` (bf16, 3 warm-up and 10 timed
              steps): finite losses that fall, 1 + 1 average-pool
              launches a step and no other kernel, records/s, step ms,
              peak memory; forward, backward and optimizer ms; three
              steps under ``torch.profiler``: device ms, idle share and
              device ms by class of kernel (convolution, batch norm's
              kernels found under its forward and backward ops, the
              default max pool, the average-pool kernels, the rest).
9. step_options -- (after train_lm) the train step's options on a small
              batch-norm model: ``Adam``, bf16 compute, a per-layer
              scale and regularizer, bf16 gradient compression,
              clipping, ``max_norm``, the health probe and
              ``skip_nonfinite``, every step under CUDA's sync debug mode
              set to raise on a host synchronisation; five finite steps
              whose loss falls, then a NaN input that leaves parameters,
              optimizer state and batch-norm buffers bit-equal.
10. norm   -- the within-channel LRN and the subtractive, divisive and
              contrastive normalizations, none of which a registered
              model uses, where the JAX package's kernel bench puts them
              (bench_kernels.py:48-52): ``SpatialWithinChannelLRN(5,
              1e-4, 0.75)`` at Inception-v1's LRN sites [256, 64, 56, 56]
              and [256, 192, 56, 56], and the three smoothing layers
              (9x9 Gaussian, threshold and thresval 1e-4) on the
              headline input [256, 3, 224, 224].  Each layer runs one
              forward and backward through autograd in bf16, then f32:
              exactly 1 + 1 within-channel LRN launches, or 3, 3 and 6
              smoothing launches (two forward, one transposed per
              subtractive or divisive layer), and no other kernel; the
              output and input gradient against the same pass through
              the plain versions on the card (f32 at rtol 1e-5 / atol
              1e-6, bf16 at 2e-2); ms per forward + backward beside the
              plain versions' and peak memory.

The kernels phase also holds the three max-pool kernels to their plain
versions bit for bit: the forward without an index (tie-split) in f32
and bf16, with the int8 index (argmax) in bf16 and f16, the tie-split
backward in f32 and bf16 and the argmax backward in bf16 and f16, at
the training shapes of pool1, the inception_3b pool branch and pool4
(post-ReLU inputs, so windows of zeros tie; checked and timed), and at
the edge geometries of the JAX package's pooling tests (ceil overflow,
anisotropic windows, stride 1, global 7x7, the bottom-row residue
shortfall) and at geometries that reach each tile of the backward
kernels (groups of whole planes with a short last group, spans off 16
bytes, row bands with halo rows at stride 1 and 2 and a 64-tap window),
the forward with and without the index and both backwards, each in
f32, bf16 and f16, with tie-heavy inputs, all -inf windows, NaN, -0.0
beside +0.0 and an inf gradient (checked only); and the forward alone
on rows too wide for its staged tiles, which take its
one-thread-per-output kernel (``MAXPOOL_FWD_EDGES``).

It holds the average-pool forward and backward to their plain versions
bit for bit too: at Inception-v2's eight sites at batch 256 in bf16
(checked and timed beside ``F.avg_pool2d`` and
``aten.avg_pool2d_backward``), and in f32 and bf16 at the head shapes
(checked and timed) and at edge geometries (checked only, normal and
special inputs): the
aux heads' 5x5 s3 ceil on [8, 512, 14, 14], the 3x3 s1 p1 branch pool
with and without ``count_include_pad``, the 8x8 head, a plane count
that is no multiple of the staged kernels' plane group, an input (x, or
the backward's wgt) that starts off a 16-byte boundary (a contiguous
slice of a larger buffer), and a plane too large to stage, which takes
the one-thread-an-element kernels.  The cross-map LRN backward is held
bit for bit at its two training sites (checked and timed) and at
``LRN_BWD_EDGES`` (checked only, normal and special inputs, three
(alpha, beta, k)): fewer channels than the band, channel counts no
multiple of a chunk, bands 1, 3, 7 and 15, 7x7 and 1x1 pixel counts
and inputs 1 element off 16 bytes (the element-wise kernel).

The kernels phase also holds the within-channel LRN forward (y and
scale) and backward at the norm phase's two sites, and the smoothing
kernel at its three call shapes (the [1, 224, 224] edge-coverage mass,
the mean map of the [256, 224, 224] stack and its transpose), bit for
bit against their plain versions in f32 and bf16, and times them; the
smoothing's yardstick is ``F.conv2d`` with the kernel as a [1, 1, 9, 9]
weight (TF32 off), the within-channel LRN has none.  The smoothing is
also held bit for bit at ``SMOOTH_EDGES`` in both directions, f32 and
bf16 (checked only): the 9x9 window on planes of widths that are no
multiple of 4, smaller than the window and alone in the stack, and
random-weight 8x8, 3x11 and 32x32 windows on the run-time path.  The
within-channel LRN forward and backward are held bit for bit at
``WCL_EDGES`` (checked only), f32 and bf16, normal inputs and inputs
rounded to integers, at alpha 1e-4 and 1 and beta 0.75 and 0.5 (the
rsqrt branch): the compiled-in 5x5 on planes of widths that are no
multiple of 4, smaller than the window, alone in the stack and starting
off 16 bytes, and 4x4, 2x2 (asymmetric pads), 1x1 and 32x32 windows on
the run-time path.

The kernels phase also holds the three flash-attention kernels against
their plain versions in f32 and bf16 at the training shape
[32, 8, 512, 64] causal (checked and timed) and at edge shapes (checked
only): non-causal, sq 128 / sk 384 and sq 384 / sk 128 causal (rows
that see no key: ``out`` and ``dq`` 0), ragged S 500, head dims 32 and
128, and 40 and 20 (padded inside the bf16 tensor-core kernels: 16-byte
copies, then element loads).  In bf16 all three kernels run on the
tensor cores (mma.sync, their rows say ``"design": "mma.sync bf16"``),
in f32 on the CUDA cores (``"fma f32"``).
Their f32 tolerance is rtol 1e-5 with atol 1e-6 times the largest
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
tensor cores (the kernels that compute in f32), except the
flash-attention rows in bf16, whose operations are held to the tensor
cores' 989 TFLOP/s, where the three bf16 flash kernels run.
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
#: kernel launches of one Inception-v1 train step in each max-pool mode:
#: the 13 max pools launch the forward and the mode's backward once each
POOL_PER_STEP = {
    "tie": {**PER_STEP, "maxpool_fwd": 13, "maxpool_tie_bwd": 13},
    "argmax": {**PER_STEP, "maxpool_fwd": 13, "maxpool_argmax_bwd": 13}}
#: Inception-v2's eight average pools (``inception.py:186-199``): (site,
#: channels, extent, ``SpatialAveragePooling`` arguments); 3x3 s1 p1 ceil
#: in the blocks 3a-5a, then the 7x7 head
_V2_BRANCH_POOL = dict(kw=3, kh=3, dw=1, dh=1, pad_w=1, pad_h=1,
                       ceil_mode=True)
V2_AVG_POOLS = (
    ("inception_3a pool", 192, 28, _V2_BRANCH_POOL),
    ("inception_3b pool", 256, 28, _V2_BRANCH_POOL),
    ("inception_4a pool", 576, 14, _V2_BRANCH_POOL),
    ("inception_4b pool", 576, 14, _V2_BRANCH_POOL),
    ("inception_4c pool", 576, 14, _V2_BRANCH_POOL),
    ("inception_4d pool", 576, 14, _V2_BRANCH_POOL),
    ("inception_5a pool", 1024, 7, _V2_BRANCH_POOL),
    ("head", 1024, 7, dict(kw=7, kh=7, dw=1, dh=1)))
V2_BATCH = 256
#: kernel launches of one Inception-v2 train step: each average pool's
#: forward and backward once (its max pools take the default path)
V2_PER_STEP = {"avg_pool_fwd": len(V2_AVG_POOLS),
               "avg_pool_bwd": len(V2_AVG_POOLS)}
#: ResNet's average-pool heads (``resnet.py``): ResNet-20's 8x8 window
#: on [128, 64, 8, 8] (f32 through ``cli train``) and ResNet-50's 7x7 on
#: [128, 2048, 7, 7] (bf16 through ``cli perf``): (path, site, shape,
#: ``SpatialAveragePooling`` arguments)
RESNET_BATCH = 128
RESNET_HEADS = (
    ("train_resnet", "ResNet-20 head 8x8 s1", (RESNET_BATCH, 64, 8, 8),
     dict(kw=8, kh=8, dw=1, dh=1)),
    ("train_resnet50", "ResNet-50 head 7x7 s1", (RESNET_BATCH, 2048, 7, 7),
     dict(kw=7, kh=7, dw=1, dh=1)))
#: kernel launches of one ResNet train step (its one average pool; the
#: ImageNet stem's max pool takes the default path)
RESNET_PER_STEP = {"avg_pool_fwd": 1, "avg_pool_bwd": 1}
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
                 bound=bound, exact=True)
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
                 library=library, bound=bound, exact=True)]


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
                 library=library, bound=bound, exact=True)]


def _avg_pool_cases(torch, sites, dtypes):
    """Both average-pool kernels at ``sites`` ((path, site, shape,
    ``SpatialAveragePooling`` arguments)) in ``dtypes``, checked bit for
    bit and timed beside ``F.avg_pool2d`` and
    ``aten.avg_pool2d_backward``."""
    from bigdl_tpu_torch.nn.layers.pooling import SpatialAveragePooling
    from bigdl_tpu_torch.ops import pool

    cases = []
    for path, site, shape, layer_args in sites:
        layer = SpatialAveragePooling(**layer_args)
        k, s, pad = layer.kw, layer.dw, layer.pad_w
        dims, strides, pads, declared = layer._window(
            torch.empty(shape, device="meta"))
        inv = torch.as_tensor(pool._np_inv_counts(
            shape, dims, strides, pads, declared, True),
            dtype=torch.float32, device="cuda")
        out_shape = tuple(pool._out_sizes(shape, dims, strides, pads))
        ceil = layer.ceil_mode

        def fwd_make(gen, shape, dtype):
            return (torch.randn(shape, generator=gen, device="cuda")
                    .to(dtype),)

        def fwd_bound(x, out=math.prod(out_shape), k=k):
            return (x.numel() + out) * x.element_size(), out * (k * k + 1)

        def bwd_make(gen, shape, dtype, out_shape=out_shape):
            wgt = torch.randn(out_shape, generator=gen, device="cuda") \
                .to(dtype)
            return wgt, torch.empty(shape, dtype=dtype, device="cuda")

        def bwd_bound(wgt, x, k=k):
            return ((wgt.numel() + x.numel()) * wgt.element_size(),
                    wgt.numel() * k * k)

        geom = (dims, strides, pads)
        common = dict(path=path, site=site, shape=shape, exact=True,
                      dtypes=dtypes)
        cases.append(dict(
            name="avg_pool_fwd", make=fwd_make, bound=fwd_bound,
            kernel=lambda x, g=geom, d=declared: pool.avg_pool_forward(
                x, *g, d, True),
            plain=lambda x, g=geom, inv=inv: pool.avg_pool_plain(
                x, *g, inv),
            library=lambda x, k=k, s=s, pad=pad, ceil=ceil:
                torch.nn.functional.avg_pool2d(x, k, s, pad, ceil_mode=ceil,
                                               count_include_pad=True),
            **common))
        cases.append(dict(
            name="avg_pool_bwd", make=bwd_make, bound=bwd_bound,
            kernel=lambda wgt, x, g=geom: pool.avg_pool_backward(
                wgt, x.shape, *g, wgt.dtype),
            plain=lambda wgt, x, g=geom: pool.avg_pool_backward_plain(
                wgt, x.shape, *g, wgt.dtype),
            # the same map from gy = count * wgt: aten divides by it
            library=lambda wgt, x, k=k, s=s, pad=pad, ceil=ceil:
                torch.ops.aten.avg_pool2d_backward(
                    wgt, x, [k, k], [s, s], [pad, pad], ceil, True, None),
            **common))
    return cases


def _v2_pool_cases(torch):
    """Both average-pool kernels at Inception-v2's eight sites, batch
    ``V2_BATCH``, bf16 (the path's dtype)."""
    return _avg_pool_cases(
        torch, [("train_v2", f"{site} {a['kw']}x{a['kw']} s{a['dw']} "
                             f"p{a.get('pad_w', 0)}", (V2_BATCH, c, e, e), a)
                for site, c, e, a in V2_AVG_POOLS],
        (torch.bfloat16,))


def _resnet_pool_cases(torch):
    """Both average-pool kernels at ResNet's two heads, f32 and bf16."""
    return _avg_pool_cases(torch, RESNET_HEADS,
                           (torch.float32, torch.bfloat16))


#: the max pools' training sites timed at batch 256: (site, channels,
#: extent, stride, pad) of pool1, the inception_3b pool branch and pool4
MAXPOOL_SITES = (("pool1", 64, 112, 2, 0), ("inception_3b pool", 256, 28, 1, 1),
                 ("pool4", 832, 14, 2, 0))


def _maxpool_geometry(torch, shape, k, s, pad):
    """(dims, strides, pads) of ``SpatialMaxPooling(k, k, s, s, pad,
    pad).ceil()`` on ``shape``, as inception.py builds every max pool."""
    from bigdl_tpu_torch.nn.layers.pooling import SpatialMaxPooling

    layer = SpatialMaxPooling(k, k, s, s, pad, pad).ceil()
    return layer._window(torch.empty(shape, device="meta"))[:3]


def _maxpool_cases(torch):
    """The three max-pool kernels at the training sites: the forward
    without an index (the tie-split path) and with it (the argmax path),
    and both backwards.  Inputs are post-ReLU, as the model feeds the
    pools, so windows of zeros tie."""
    from bigdl_tpu_torch.ops import pool, pooling

    F = torch.nn.functional
    inf = float("inf")
    cases = []
    for site, c, n, s, pad in MAXPOOL_SITES:
        shape = (TRAIN_BATCH, c, n, n)
        dims, strides, pads = _maxpool_geometry(torch, shape, 3, s, pad)
        flat = [pads[3][0], pads[3][1], pads[2][0], pads[2][1]]
        k2, s2 = list(dims[2:]), list(strides[2:])
        taps = dims[2] * dims[3]
        outs = math.prod(pool._out_sizes(shape, dims, strides, pads))
        per_input = math.ceil(dims[2] / strides[2]) \
            * math.ceil(dims[3] / strides[3])

        def make_x(gen, shape, dtype):
            return (torch.randn(shape, generator=gen, device="cuda")
                    .relu().to(dtype),)

        def make_tie(gen, shape, dtype, dims=dims, strides=strides,
                     pads=pads):
            x = make_x(gen, shape, dtype)[0]
            y = pool.maxpool_forward_plain(x, dims, strides, pads)
            return x, y, torch.randn(y.shape, generator=gen,
                                     device="cuda").to(dtype)

        def make_argmax(gen, shape, dtype, dims=dims, strides=strides,
                        pads=pads):
            x = make_x(gen, shape, dtype)[0]
            y, idx = pool.maxpool_forward_plain(x, dims, strides, pads, True)
            gy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
            return gy, idx, x

        def padded(x, flat=flat):
            return (F.pad(x, flat, value=-inf),)

        def argmax_library_inputs(gy, idx, x, flat=flat, k2=k2, s2=s2):
            # the int64 indices F.max_pool2d saves, made outside the
            # timed region
            xp = F.pad(x, flat, value=-inf)
            return gy, xp, F.max_pool2d(xp, k2, s2, return_indices=True)[1]

        geo = dict(dims=dims, strides=strides, pads=pads)
        common = dict(shape=shape, site=site, exact=True,
                      library_graph=True)
        cases += [
            dict(name="maxpool_fwd", path="train_tie", make=make_x,
                 dtypes=(torch.float32, torch.bfloat16),
                 kernel=lambda x, g=geo: pool.maxpool_forward(x, **g),
                 plain=lambda x, g=geo: pool.maxpool_forward_plain(x, **g),
                 library_inputs=padded,
                 library=lambda xp, k2=k2, s2=s2: F.max_pool2d(xp, k2, s2),
                 # x in, y out
                 bound=lambda x, taps=taps, outs=outs: (
                     (x.numel() + outs) * x.element_size(), outs * taps),
                 **common),
            dict(name="maxpool_fwd", path="train_argmax", make=make_x,
                 dtypes=(torch.bfloat16, torch.float16),
                 kernel=lambda x, g=geo: pool.maxpool_forward(
                     x, want_index=True, **g),
                 plain=lambda x, g=geo: pool.maxpool_forward_plain(
                     x, want_index=True, **g),
                 library_inputs=padded,
                 library=lambda xp, k2=k2, s2=s2: F.max_pool2d(
                     xp, k2, s2, return_indices=True),
                 # x in; y and the int8 idx out
                 bound=lambda x, taps=taps, outs=outs: (
                     (x.numel() + outs) * x.element_size() + outs,
                     outs * taps),
                 **common),
            dict(name="maxpool_tie_bwd", path="train_tie", make=make_tie,
                 dtypes=(torch.float32, torch.bfloat16),
                 kernel=lambda x, y, gy, g=geo:
                     pool.maxpool_tie_split_backward(x, y, gy, **g),
                 plain=lambda x, y, gy, g=geo:
                     pool.maxpool_tie_split_backward_plain(x, y, gy, **g),
                 library=None,   # no PyTorch call splits ties
                 # x, y, gy in; dx out; per output taps compares and a
                 # division, per input its windows' compares and adds
                 bound=lambda x, y, gy, taps=taps, pi=per_input: (
                     (2 * x.numel() + 2 * y.numel()) * x.element_size(),
                     y.numel() * (taps + 1) + x.numel() * pi * 2),
                 **common),
            dict(name="maxpool_argmax_bwd", path="train_argmax",
                 make=make_argmax, dtypes=(torch.bfloat16, torch.float16),
                 kernel=lambda gy, idx, x, g=geo:
                     pooling.maxpool_argmax_backward(gy, idx, x.shape, **g),
                 plain=lambda gy, idx, x, g=geo:
                     pooling.maxpool_argmax_backward_plain(gy, idx, x.shape,
                                                           **g),
                 library_inputs=argmax_library_inputs,
                 library=lambda gy, xp, ind, k2=k2, s2=s2:
                     torch.ops.aten.max_pool2d_with_indices_backward(
                         gy, xp, k2, s2, [0, 0], [1, 1], False, ind),
                 # gy and the int8 idx in; dx out
                 bound=lambda gy, idx, x, pi=per_input: (
                     gy.numel() * (gy.element_size() + 1)
                     + x.numel() * x.element_size(), x.numel() * pi * 2),
                 **common)]
    return cases


#: SpatialWithinChannelLRN(5, 1e-4, 0.75) (bench_kernels.py:77-78) at
#: Inception-v1's two LRN sites, and the smoothing layers' defaults
#: (9x9 Gaussian, threshold and thresval 1e-4) on its input planes
WCL_HYPER = (5, 1e-4, 0.75)
NORM_SHAPE = (TRAIN_BATCH, 3, 224, 224)
#: kernel launches of one forward + backward of each normalization layer
NORM_PER_PASS = {
    "within_channel": {"within_channel_lrn_fwd": 1,
                       "within_channel_lrn_bwd": 1},
    "subtractive": {"smooth2d": 3}, "divisive": {"smooth2d": 3},
    "contrastive": {"smooth2d": 6}}


def _wcl_cases(torch):
    """The within-channel LRN forward and backward at the norm path's
    two sites, bit for bit; no single PyTorch call computes either."""
    from bigdl_tpu_torch.ops import lrn

    size, alpha, beta = WCL_HYPER
    taps = size * size

    def make_x(gen, shape, dtype):
        return (torch.randn(shape, generator=gen, device="cuda").to(dtype),)

    def make_bwd(gen, shape, dtype):
        x = make_x(gen, shape, dtype)[0]
        scale = lrn.within_channel_lrn_plain(x, size, alpha, beta)[1]
        return x, scale, torch.randn(shape, generator=gen,
                                     device="cuda").to(dtype)

    cases = []
    for site, c in LRN_SITES:
        common = dict(path="norm", site=site, shape=(TRAIN_BATCH, c, 56, 56),
                      library=None, exact=True)
        cases += [
            dict(name="within_channel_lrn_fwd", make=make_x,
                 kernel=lambda x: lrn.within_channel_lrn_forward(
                     x, size, alpha, beta),
                 plain=lambda x: lrn.within_channel_lrn_plain(
                     x, size, alpha, beta),
                 # x in; y and scale out; a square, the taps' adds, the
                 # scale, its power and y per element
                 bound=lambda x: (3 * x.numel() * x.element_size(),
                                  x.numel() * (taps + 7)), **common),
            dict(name="within_channel_lrn_bwd", make=make_bwd,
                 kernel=lambda x, s, g: lrn.within_channel_lrn_backward(
                     x, s, g, size, alpha, beta),
                 plain=lambda x, s, g: lrn.within_channel_lrn_backward_plain(
                     x, s, g, size, alpha, beta),
                 # x, scale, g in; dx out; t and g*scale^-beta (two
                 # powers), the taps' adds and dx per element
                 bound=lambda x, s, g: (4 * x.numel() * x.element_size(),
                                        x.numel() * (taps + 12)), **common)]
    return cases


def _smooth_cases(torch):
    """The smoothing kernel as the normalizations call it on the
    headline input: the mean map forward and its transpose on the
    [256, 224, 224] stack, and the [1, 224, 224] edge-coverage mass.
    The yardstick is ``F.conv2d`` of [B, 1, H, W] with the [1, 1, kh,
    kw] kernel, the JAX XLA leg's own formulation, in full f32."""
    from bigdl_tpu_torch.nn.layers.normalization import _gaussian_kernel
    from bigdl_tpu_torch.ops import norm

    F = torch.nn.functional
    kernel = torch.from_numpy(_gaussian_kernel(9)).cuda()
    kh, kw = kernel.shape

    def make(gen, shape, dtype, ones=False):
        if ones:
            return (torch.ones(shape, dtype=dtype, device="cuda"),)
        return (torch.randn(shape, generator=gen, device="cuda").to(dtype),)

    def conv_inputs(v, flip):
        w = kernel.flip(0, 1) if flip else kernel
        return v[:, None], w.to(v.dtype)[None, None]

    def conv(v4, w4):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv2d(v4, w4, padding=(kh // 2, kw // 2))[:, 0]

    cases = []
    for site, flip, shape, ones in (
            ("coef [1,224,224]", False, (1, 224, 224), True),
            ("mean map", False, NORM_SHAPE[:1] + NORM_SHAPE[2:], False),
            ("transpose", True, NORM_SHAPE[:1] + NORM_SHAPE[2:], False)):
        pads = (norm._transpose_pads if flip else norm._fwd_pads)(kh, kw)
        cases.append(dict(
            name="smooth2d", path="norm", site=site, shape=shape,
            make=lambda gen, shape, dtype, ones=ones: make(gen, shape, dtype,
                                                          ones),
            kernel=lambda v, p=pads, f=flip: norm.smooth2d(v, kernel, p, f),
            plain=lambda v, p=pads, f=flip: norm.smooth2d_plain(v, kernel, p,
                                                                f),
            library_inputs=lambda v, f=flip: conv_inputs(v, f),
            library=conv, exact=True,
            # the stack in, the smoothed stack out; a multiply and an add
            # per tap
            bound=lambda v: (2 * v.numel() * v.element_size() + 4 * kh * kw,
                             v.numel() * 2 * kh * kw)))
    return cases


def bit_equal(torch, got, want, what: str) -> None:
    """Raise unless every output of ``got`` has the bits of ``want``'s."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    ints = {2: torch.int16, 4: torch.int32}
    for a, b in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise RuntimeError(f"{what}: {a.dtype} {tuple(a.shape)} against "
                               f"{b.dtype} {tuple(b.shape)}")
        if a.is_floating_point():
            a, b = (t.view(ints[t.element_size()]) for t in (a, b))
        if not torch.equal(a, b):
            raise RuntimeError(f"{what}: the kernel's bits differ from the "
                               f"plain version's at {(a != b).sum().item()} "
                               f"elements")


def phase_kernels(torch):
    """Accuracy and timing of every kernel at the shapes of each main
    path that launches it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    cases = (_lrn_cases(torch, "serve", BATCH)
             + _pool_cases(torch, "serve", BATCH)
             + _lrn_cases(torch, "train", TRAIN_BATCH)
             + _pool_cases(torch, "train", TRAIN_BATCH)
             + _lrn_bwd_cases(torch) + _pool_bwd_cases(torch)
             + _maxpool_cases(torch) + _wcl_cases(torch)
             + _smooth_cases(torch) + _v2_pool_cases(torch)
             + _resnet_pool_cases(torch))
    tols = {torch.float32: dict(rtol=1e-5, atol=1e-6),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
    for case in cases:
        for dtype in case.get("dtypes", (torch.float32, torch.bfloat16)):
            tol = "bit-equal" if case.get("exact") else tols[dtype]
            args = case["make"](gen, case["shape"], dtype)
            got = case["kernel"](*args)
            want = case["plain"](*args)
            torch.cuda.synchronize()
            if case.get("exact"):
                bit_equal(torch, got, want, f"{case['name']} {case['site']} "
                                            f"{str(dtype)[6:]}")
            else:
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
            if case["library"] is None:
                library_ms = None
            elif "library_inputs" in case:
                lib_args = [case["library_inputs"](*a) for a in copies]
                if case.get("library_graph"):
                    library_ms = graph_ms(torch, case["library"], lib_args,
                                          launches)
                else:
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


#: edge geometries (shape, k, s, pads): ``CASES`` of
#: tests/test_pooling_pallas.py, then ``POOL_CASES`` of
#: tests/test_kernels.py, then the tiles of the backward kernels
MAXPOOL_EDGES = (
    ((2, 8, 12, 12), (3, 3), (2, 2), ((0, 1), (0, 1))),   # ceil-mode 3x3/s2
    ((2, 8, 13, 13), (3, 3), (2, 2), ((1, 1), (1, 1))),   # padded odd extent
    ((2, 4, 14, 14), (2, 2), (2, 2), ((0, 0), (0, 0))),   # even 2x2/s2
    ((1, 8, 9, 9), (3, 3), (1, 1), ((0, 0), (0, 0))),     # stride-1 overlap
    ((2, 4, 7, 7), (7, 7), (7, 7), ((0, 0), (0, 0))),     # global 7x7
    ((1, 8, 10, 8), (3, 2), (2, 3), ((1, 0), (0, 1))),    # anisotropic
    ((1, 8, 11, 11), (2, 2), (2, 2), ((0, 0), (0, 0))),   # residue shortfall
    ((2, 3, 9, 9), (3, 3), (2, 2), ((1, 1), (1, 1))),
    ((2, 3, 9, 9), (3, 3), (2, 2), ((1, 2), (1, 2))),     # ceil overflow
    ((1, 2, 7, 8), (3, 2), (2, 3), ((1, 0), (0, 1))),     # anisotropic
    ((1, 1, 6, 6), (3, 3), (1, 1), ((0, 0), (0, 0))),     # stride-1 overlap
    ((1, 2, 11, 11), (2, 2), (2, 2), ((0, 1), (0, 1))),   # residue shortfall
    # the backward kernels' tiles: groups of whole 7x7 planes (5a, 5b)
    ((2, 37, 7, 7), (3, 3), (1, 1), ((1, 1), (1, 1))),
    # 12289 planes, 2 a CTA: the last group holds one
    ((1, 12289, 7, 7), (3, 3), (1, 1), ((1, 1), (1, 1))),
    # one plane a CTA, spans starting off 16 bytes
    ((3, 5, 57, 57), (3, 3), (2, 2), ((0, 0), (0, 0))),
    # pool1's plane: row bands in f32 (tie split) and bf16 (both)
    ((1, 3, 112, 112), (3, 3), (2, 2), ((0, 1), (0, 1))),
    # row bands in every dtype: stride 1 with halo rows on both sides,
    # stride 2 on odd-width rows with a ceil overflow window, and the
    # largest window (64 taps, seven halo rows)
    ((1, 2, 224, 224), (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((1, 2, 226, 226), (3, 3), (2, 2), ((0, 1), (0, 1))),
    ((1, 1, 160, 160), (8, 8), (1, 1), ((0, 0), (0, 0))),
)


#: a forward-only edge geometry: rows too wide for a one-row band of
#: the staged forward to fit a CTA's shared memory, which take its
#: one-thread-per-output kernel (the backwards refuse such rows)
MAXPOOL_FWD_EDGES = (
    ((1, 2, 3, 40000), (3, 3), (1, 1), ((0, 0), (0, 0))),
)


def _edge_inputs(torch, gen, shape):
    """Normal, tie-heavy (quantized to halves) and special inputs: the
    tie-heavy values with a 3x3 block of -inf in the first plane (its
    corner windows are all -inf, padding included), a NaN in the second,
    and -0.0 before +0.0 in the third."""
    x = torch.randn(shape, generator=gen, device="cuda")
    ties = torch.round(x * 2) / 2
    special = ties.clone()
    planes = special.view(-1, shape[2], shape[3])
    planes[0, :3, :3] = float("-inf")
    planes[1 % len(planes), shape[2] // 2, shape[3] // 2] = float("nan")
    planes[2 % len(planes), :2, :2] = 0.0
    planes[2 % len(planes), 0, 0] = -0.0
    return {"normal": x, "tie_heavy": ties, "special": special}


def phase_maxpool_edges(torch):
    """Every max-pool kernel bit-equal to its plain version at the edge
    geometries, the forward with and without the index and both
    backwards, each in f32, bf16 and f16 (checked only)."""
    from bigdl_tpu_torch.ops import pool, pooling

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = 0
    for shape, k, s, p in MAXPOOL_EDGES + MAXPOOL_FWD_EDGES:
        geo = dict(dims=(1, 1) + k, strides=(1, 1) + s,
                   pads=((0, 0), (0, 0)) + p)
        for kind, x32 in _edge_inputs(torch, gen, shape).items():
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                x = x32.to(dtype)
                what = f"{shape} k{k} s{s} p{p} {kind} {str(dtype)[6:]}"
                y, idx = pool.maxpool_forward_plain(x, want_index=True, **geo)
                gy = torch.randn(y.shape, generator=gen,
                                 device="cuda").to(dtype)
                # the forward in every dtype, with and without the index
                bit_equal(torch, pool.maxpool_forward(x, **geo), y,
                          f"maxpool_fwd {what}")
                bit_equal(torch, pool.maxpool_forward(
                    x, want_index=True, **geo), (y, idx),
                    f"maxpool_fwd (index) {what}")
                checks += 2
                if (shape, k, s, p) in MAXPOOL_FWD_EDGES:
                    continue
                bit_equal(torch, pool.maxpool_tie_split_backward(
                    x, y, gy, **geo), pool.maxpool_tie_split_backward_plain(
                    x, y, gy, **geo), f"maxpool_tie_bwd {what}")
                gy.view(-1)[0] = float("inf")
                bit_equal(torch, pooling.maxpool_argmax_backward(
                    gy, idx, shape, **geo),
                    pooling.maxpool_argmax_backward_plain(
                        gy, idx, shape, **geo),
                    f"maxpool_argmax_bwd {what}")
                checks += 2
    torch.cuda.synchronize()
    emit({"phase": "kernels", "name": "maxpool", "checked_only": True,
          "geometries": len(MAXPOOL_EDGES) + len(MAXPOOL_FWD_EDGES),
          "checks": checks,
          "tolerance": "bit-equal",
          "inputs": "normal, tie-heavy, special (-inf block, NaN, -0.0)"})


#: smoothing edge cases (stack shape, window), checked only: the
#: normalizations' 9x9 Gaussian (the compiled-in window) on planes
#: whose width is no multiple of a unit's 4 outputs, on planes smaller
#: than the window and on one plane (tiles shrink to fill the card),
#: then random weights on the run-time path: an even window (asymmetric
#: pads, mirrored in the transpose), a non-square one and the largest
SMOOTH_EDGES = (
    ((3, 37, 53), (9, 9)),
    ((2, 5, 7), (9, 9)),
    ((1, 100, 77), (9, 9)),
    ((2, 40, 40), (8, 8)),
    ((2, 30, 50), (3, 11)),
    ((2, 48, 48), (32, 32)),
)


def phase_smooth_edges(torch):
    """The smoothing kernel bit-equal to its plain version at
    ``SMOOTH_EDGES``, forward and transpose (flipped weights, mirrored
    pads, as the normalizations' backwards call it), in f32 and bf16, on
    normal inputs and on inputs rounded to integers (zeros of both
    signs; checked only)."""
    from bigdl_tpu_torch.nn.layers.normalization import _gaussian_kernel
    from bigdl_tpu_torch.ops import norm

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = 0
    for shape, (kh, kw) in SMOOTH_EDGES:
        kernel = (torch.from_numpy(_gaussian_kernel(9)).cuda()
                  if (kh, kw) == (9, 9)
                  else torch.randn((kh, kw), generator=gen, device="cuda"))
        x = torch.randn(shape, generator=gen, device="cuda")
        for kind, v32 in (("normal", x), ("rounded", torch.round(x))):
            for flip in (False, True):
                pads = (norm._transpose_pads if flip
                        else norm._fwd_pads)(kh, kw)
                for dtype in (torch.float32, torch.bfloat16):
                    v = v32.to(dtype)
                    bit_equal(torch, norm.smooth2d(v, kernel, pads, flip),
                              norm.smooth2d_plain(v, kernel, pads, flip),
                              f"smooth2d {shape} {kh}x{kw} flip={flip} "
                              f"{kind} {str(dtype)[6:]}")
                    checks += 1
    torch.cuda.synchronize()
    emit({"phase": "kernels", "name": "smooth2d", "checked_only": True,
          "geometries": [f"{list(shape)} {kh}x{kw}"
                         for shape, (kh, kw) in SMOOTH_EDGES],
          "checks": checks, "tolerance": "bit-equal",
          "inputs": "normal, rounded to integers (+0.0 and -0.0)"})


#: within-channel LRN edge cases (name, shape, window, offset of x in
#: elements from a 16-byte boundary), checked only: the compiled-in 5x5
#: on planes whose width is no multiple of a unit's 4 outputs, smaller
#: than the window and alone in the stack (tiles shrink to fill the
#: card), then the run-time path: even windows (asymmetric pads,
#: swapped in the backward), size 1 and the largest window; and the
#: 5x5 on an input that starts off 16 bytes (element loads)
WCL_EDGES = (
    ("5x5, width off 4", (2, 3, 37, 53), 5, 0),
    ("5x5, planes under the window", (2, 2, 3, 4), 5, 0),
    ("5x5, one plane", (1, 1, 100, 77), 5, 0),
    ("4x4", (2, 3, 40, 40), 4, 0),
    ("2x2", (2, 3, 33, 31), 2, 0),
    ("1x1", (2, 3, 20, 21), 1, 0),
    ("32x32", (1, 2, 48, 48), 32, 0),
    ("5x5, x 3 elements off 16 bytes", (2, 3, 56, 56), 5, 3),
)
#: (alpha, beta) of the edge checks: the norm path's, and alpha 1 so
#: that the window sums move the scale's low bits, at beta 0.5 (the
#: rsqrt branch) and 0.75
WCL_EDGE_HYPERS = ((1e-4, 0.75), (1.0, 0.5), (1.0, 0.75))


def phase_wcl_edges(torch):
    """The within-channel LRN forward (y and scale) and backward
    bit-equal to their plain versions at ``WCL_EDGES`` and
    ``WCL_EDGE_HYPERS``, in f32 and bf16, on normal inputs and on inputs
    rounded to integers (zeros of both signs; checked only)."""
    from bigdl_tpu_torch.ops import lrn

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = 0
    for name, shape, size, offset in WCL_EDGES:
        x = torch.randn(shape, generator=gen, device="cuda")
        g = torch.randn(shape, generator=gen, device="cuda")
        for kind, x32, g32 in (("normal", x, g),
                               ("rounded", torch.round(x), torch.round(g))):
            for dtype in (torch.float32, torch.bfloat16):
                buf = torch.empty(offset + math.prod(shape), dtype=dtype,
                                  device="cuda")
                xd = buf[offset:].view(shape)
                xd.copy_(x32)
                gd = g32.to(dtype)
                for alpha, beta in WCL_EDGE_HYPERS:
                    what = (f"{name} {list(shape)} alpha={alpha} beta={beta} "
                            f"{kind} {str(dtype)[6:]}")
                    want = lrn.within_channel_lrn_plain(xd, size, alpha, beta)
                    bit_equal(torch, lrn.within_channel_lrn_forward(
                        xd, size, alpha, beta), want,
                        f"within_channel_lrn_fwd {what}")
                    scale = want[1]
                    bit_equal(torch, lrn.within_channel_lrn_backward(
                        xd, scale, gd, size, alpha, beta),
                        lrn.within_channel_lrn_backward_plain(
                            xd, scale, gd, size, alpha, beta),
                        f"within_channel_lrn_bwd {what}")
                    checks += 2
    torch.cuda.synchronize()
    emit({"phase": "kernels", "name": "within_channel_lrn",
          "checked_only": True,
          "geometries": [f"{name} {list(shape)}"
                         for name, shape, _, _ in WCL_EDGES],
          "hyper": [list(h) for h in WCL_EDGE_HYPERS],
          "checks": checks, "tolerance": "bit-equal",
          "inputs": "normal, rounded to integers (+0.0 and -0.0)"})


#: cross-map LRN backward edge cases (name, shape, band, offset of x,
#: den and g in elements from a 16-byte boundary), checked only: fewer
#: channels than the band and than any chunk, channel counts no multiple
#: of a chunk, the bands whose rings the vector kernel holds for fewer
#: pixels (7, 15) and the narrowest (1, 3), pixel counts no multiple of
#: a vector (7x7) and a single pixel, and inputs that start 1 element
#: off 16 bytes (the last three take the element-wise kernel)
LRN_BWD_EDGES = (
    ("c 1", (2, 1, 28, 28), 5, 0),
    ("c 3, under the band", (2, 3, 28, 28), 5, 0),
    ("c 17", (2, 17, 28, 28), 5, 0),
    ("c 50", (2, 50, 28, 28), 5, 0),
    ("band 1", (2, 20, 16, 16), 1, 0),
    ("band 3", (2, 33, 16, 16), 3, 0),
    ("band 7", (2, 40, 24, 24), 7, 0),
    ("band 15", (2, 70, 16, 16), 15, 0),
    ("7x7 pixels", (2, 64, 7, 7), 5, 0),
    ("1x1 pixel", (4, 96, 1, 1), 5, 0),
    ("1 element off 16 bytes", (2, 64, 56, 56), 5, 1),
)
#: (alpha, beta, k) of the edge checks: the training path's, then alpha
#: 1 so that the band sums move den's low bits, at beta 0.5 (the rsqrt
#: branch of g * den^-beta) and 1.5
LRN_BWD_EDGE_HYPERS = ((1e-4, 0.75, 1.0), (1.0, 0.5, 1.0), (1.0, 1.5, 2.0))


def phase_lrn_bwd_edges(torch):
    """The cross-map LRN backward bit-equal to its plain version at
    ``LRN_BWD_EDGES`` and ``LRN_BWD_EDGE_HYPERS``, in f32 and bf16, on
    normal inputs and on ``_edge_inputs``' special ones (a -inf block, a
    NaN and -0.0 beside +0.0 in x; den, from the plain forward, is inf
    or NaN around them; checked only).  NaNs are held bit for bit too:
    the card's arithmetic gives one NaN pattern, in the kernel as in the
    plain version."""
    from bigdl_tpu_torch.ops import lrn

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = 0
    for name, shape, size, offset in LRN_BWD_EDGES:
        inputs = _edge_inputs(torch, gen, shape)
        g32 = torch.randn(shape, generator=gen, device="cuda")
        for kind in ("normal", "special"):
            for dtype in (torch.float32, torch.bfloat16):
                x, den, g = (torch.empty(offset + math.prod(shape),
                                         dtype=dtype, device="cuda")
                             [offset:].view(shape) for _ in range(3))
                x.copy_(inputs[kind])
                g.copy_(g32)
                for alpha, beta, k in LRN_BWD_EDGE_HYPERS:
                    den.copy_(lrn.cross_map_lrn_plain(x, size, alpha, beta,
                                                      k)[1])
                    bit_equal(torch, lrn.cross_map_lrn_backward(
                        x, den, g, size, alpha, beta),
                        lrn.cross_map_lrn_backward_plain(
                            x, den, g, size, alpha, beta),
                        f"cross_map_lrn_bwd {name} {list(shape)} "
                        f"size={size} alpha={alpha} beta={beta} {kind} "
                        f"{str(dtype)[6:]}")
                    checks += 1
    torch.cuda.synchronize()
    emit({"phase": "kernels", "name": "cross_map_lrn_bwd",
          "checked_only": True,
          "geometries": [f"{name} {list(shape)} size {size}"
                         for name, shape, size, _ in LRN_BWD_EDGES],
          "hyper": [list(h) for h in LRN_BWD_EDGE_HYPERS],
          "checks": checks, "tolerance": "bit-equal",
          "inputs": "normal, special (-inf block, NaN, -0.0)"})


#: average-pool edge geometries (name, shape, SpatialAveragePooling
#: arguments, slice offset in elements), checked only
AVG_POOL_EDGES = (
    ("aux head 5x5 s3 ceil", (8, 512, 14, 14),  # inception.py:115
     dict(kw=5, kh=5, dw=3, dh=3, ceil_mode=True), 0),
    ("3x3 s1 p1 branch pool", (8, 256, 28, 28),  # inception.py:167
     dict(kw=3, kh=3, dw=1, dh=1, pad_w=1, pad_h=1, ceil_mode=True), 0),
    ("3x3 s1 p1, count_include_pad off", (8, 256, 28, 28),
     dict(kw=3, kh=3, dw=1, dh=1, pad_w=1, pad_h=1, ceil_mode=True,
          count_include_pad=False), 0),
    ("8x8 head", (8, 2048, 8, 8), dict(kw=8, kh=8, dw=1, dh=1), 0),  # resnet.py:130
    # 4099 planes: no multiple of the staged kernel's plane group
    ("7x7 head, 4099 planes", (1, 4099, 7, 7), dict(kw=7, kh=7, dw=1, dh=1), 0),
    # starts 3 elements past the buffer's 16-byte aligned start
    ("7x7 head, unaligned", (8, 1024, 7, 7), dict(kw=7, kh=7, dw=1, dh=1), 3),
    # a plane too large to stage: the one-thread-per-output kernel
    ("3x3 s1 p1 on 112x112", (2, 8, 112, 112),
     dict(kw=3, kh=3, dw=1, dh=1, pad_w=1, pad_h=1), 0),
)


#: Inception-v2's eight average-pool geometries at batch 16, in the form
#: of ``AVG_POOL_EDGES``
V2_AVG_POOL_GEOMETRIES = tuple((site, (16, c, e, e), layer_args, 0)
                               for site, c, e, layer_args in V2_AVG_POOLS)


def avg_pool_checks(torch, geometries) -> int:
    """The average-pool forward and backward bit-equal to their plain
    versions at ``geometries`` (``AVG_POOL_EDGES`` form), in f32 and
    bf16, on normal and special inputs (the backward's wgt made as the
    forward's x, at the output's shape and the same offset); returns
    the number of checks."""
    from bigdl_tpu_torch.nn.layers.pooling import SpatialAveragePooling
    from bigdl_tpu_torch.ops import pool

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = 0
    for name, shape, layer_args, offset in geometries:
        layer = SpatialAveragePooling(**layer_args)
        dims, strides, pads, declared = layer._window(
            torch.empty(shape, device="meta"))
        cip = layer.count_include_pad
        inv = pool._np_inv_counts(shape, dims, strides, pads, declared, cip)
        inv_dev = torch.as_tensor(inv, dtype=torch.float32, device="cuda")
        inputs = _edge_inputs(torch, gen, shape)
        out_shape = tuple(pool._out_sizes(shape, dims, strides, pads))
        grads = _edge_inputs(torch, gen, out_shape)
        for kind in ("normal", "special"):
            for dtype in (torch.float32, torch.bfloat16):
                what = f"{name} {shape} {kind} {str(dtype)[6:]}"
                buf = torch.empty(offset + math.prod(shape), dtype=dtype,
                                  device="cuda")
                x = buf[offset:].view(shape)
                x.copy_(inputs[kind])
                bit_equal(torch, pool.avg_pool_forward(
                    x, dims, strides, pads, declared, cip),
                    pool.avg_pool_plain(x, dims, strides, pads, inv_dev),
                    f"avg_pool_fwd {what}")
                buf = torch.empty(offset + math.prod(out_shape), dtype=dtype,
                                  device="cuda")
                wgt = buf[offset:].view(out_shape)
                wgt.copy_(grads[kind])
                bit_equal(torch, pool.avg_pool_backward(
                    wgt, shape, dims, strides, pads, dtype),
                    pool.avg_pool_backward_plain(
                        wgt, shape, dims, strides, pads, dtype),
                    f"avg_pool_bwd {what}")
                checks += 2
    torch.cuda.synchronize()
    return checks


def phase_avg_pool_edges(torch):
    """The average-pool kernels bit-equal at ``AVG_POOL_EDGES``
    (checked only)."""
    checks = avg_pool_checks(torch, AVG_POOL_EDGES)
    emit({"phase": "kernels", "name": "avg_pool", "checked_only": True,
          "covers": ["avg_pool_fwd", "avg_pool_bwd"],
          "geometries": [name for name, *_ in AVG_POOL_EDGES],
          "checks": checks, "tolerance": "bit-equal",
          "inputs": "normal, special (-inf block, NaN, -0.0)"})


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

#: (b, h, sq, sk, d, causal): the training shape, checked and timed
FLASH_TRAIN = (LM_BATCH, 8, 512, 512, 64, True)
#: edge shapes, checked only
FLASH_EDGES = ((2, 8, 512, 512, 64, False), (2, 8, 128, 384, 64, True),
               (2, 8, 384, 128, 64, True), (2, 8, 500, 500, 64, True),
               (2, 8, 512, 512, 32, True), (2, 8, 512, 512, 128, True),
               # head dims padded in the bf16 kernels: a multiple of 8
               # (16-byte copies) and not (element loads)
               (2, 8, 512, 512, 40, True), (2, 8, 256, 256, 20, True))
#: the design behind each flash kernel, by dtype
FLASH_DESIGN = {("flash_fwd", "bfloat16"): "mma.sync bf16",
                ("flash_dq", "bfloat16"): "mma.sync bf16",
                ("flash_dkv", "bfloat16"): "mma.sync bf16"}


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
               "design": FLASH_DESIGN.get((name, str(dtype)[6:]), "fma f32"),
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


def _plain_max_pools(torch):
    """Tie-split and argmax max pooling through their plain versions,
    forward and backward."""
    from bigdl_tpu_torch.ops import pool, pooling

    class PlainTieSplit(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dims, strides, pads):
            y = pool.maxpool_forward_plain(x, dims, strides, pads)
            ctx.save_for_backward(x, y)
            ctx.geom = (dims, strides, pads)
            return y

        @staticmethod
        def backward(ctx, gy):
            x, y = ctx.saved_tensors
            dx = pool.maxpool_tie_split_backward_plain(x, y, gy.contiguous(),
                                                       *ctx.geom)
            return dx, None, None, None

    class PlainArgmax(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dims, strides, pads):
            y, idx = pool.maxpool_forward_plain(x, dims, strides, pads, True)
            ctx.save_for_backward(idx)
            ctx.x_shape, ctx.geom = tuple(x.shape), (dims, strides, pads)
            return y

        @staticmethod
        def backward(ctx, gy):
            (idx,) = ctx.saved_tensors
            dx = pooling.maxpool_argmax_backward_plain(
                gy.contiguous(), idx, ctx.x_shape, *ctx.geom)
            return dx, None, None, None

    return PlainTieSplit.apply, PlainArgmax.apply


def _plain_within_channel_lrn(torch):
    """Within-channel LRN through its plain versions, forward and
    backward."""
    from bigdl_tpu_torch.ops import lrn

    class PlainWithinChannelLRN(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, size, alpha, beta):
            y, scale = lrn.within_channel_lrn_plain(x, size, alpha, beta)
            ctx.save_for_backward(x, scale)
            ctx.hyper = (size, alpha, beta)
            return y

        @staticmethod
        def backward(ctx, g):
            x, scale = ctx.saved_tensors
            dx = lrn.within_channel_lrn_backward_plain(
                x, scale, g.contiguous(), *ctx.hyper)
            return dx, None, None, None

    return PlainWithinChannelLRN.apply


@contextlib.contextmanager
def plain_versions(torch):
    """Route the layers to the plain versions of their kernels, forward
    and backward (the reference model on the card).  Lives here and
    nowhere in the package: the package never swaps a kernel out."""
    from bigdl_tpu_torch.nn.layers import normalization, pooling
    from bigdl_tpu_torch.ops import attention, norm

    saved = (normalization.cross_map_lrn, pooling.avg_pool,
             pooling.maxpool_tie_split, pooling.maxpool_argmax,
             attention.flash_attention, normalization.within_channel_lrn,
             norm.smooth2d)
    normalization.cross_map_lrn = _plain_lrn(torch)
    pooling.avg_pool = _plain_avg_pool(torch)
    pooling.maxpool_tie_split, pooling.maxpool_argmax = \
        _plain_max_pools(torch)
    attention.flash_attention = _plain_flash(torch)
    normalization.within_channel_lrn = _plain_within_channel_lrn(torch)
    norm.smooth2d = norm.smooth2d_plain
    try:
        yield
    finally:
        (normalization.cross_map_lrn, pooling.avg_pool,
         pooling.maxpool_tie_split, pooling.maxpool_argmax,
         attention.flash_attention, normalization.within_channel_lrn,
         norm.smooth2d) = saved


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
                or any(launches[k] for k in LM_PER_STEP) \
                or any(launches[k] for k in ("maxpool_fwd", "maxpool_tie_bwd",
                                             "maxpool_argmax_bwd")):
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


def set_pool_mode(model, mode):
    """Put every max pool of ``model`` in ``mode``: None (the default),
    "tie" (``split_ties()``) or "argmax" (``use_argmax_index()``)."""
    from bigdl_tpu_torch.nn.layers.pooling import (SpatialAveragePooling,
                                                   SpatialMaxPooling)

    pools = [m for m in model.modules() if isinstance(m, SpatialMaxPooling)
             and not isinstance(m, SpatialAveragePooling)]
    for m in pools:
        if mode == "tie":
            m.split_ties()
        m.use_argmax_index(mode == "argmax")
    return pools


def _train_parity(torch, mode=None, compute_dtype=None,
                  model_name="inception_v1"):
    """(a) One SGD step of full-width Inception-v1 (no dropout) with its
    max pools in ``mode``, or of Inception-v2, through the kernels
    against the same step through their plain versions (parameters and
    batch-norm buffers compared)."""
    import copy

    from bigdl_tpu_torch.models.inception import (build_inception_v1,
                                                  build_inception_v2)
    from bigdl_tpu_torch.models.resnet import build_resnet_cifar
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import TrainStep

    torch.backends.cudnn.deterministic = True
    gen = torch.Generator().manual_seed(SEED)
    side, classes = 224, 1000
    if model_name == "inception_v2":
        model = build_inception_v2(1000, generator=gen)
        per_step = V2_PER_STEP
    elif model_name == "resnet":
        model = build_resnet_cifar(20, 10, generator=gen)
        per_step, side, classes = RESNET_PER_STEP, 32, 10
    else:
        model = build_inception_v1(1000, has_dropout=False, generator=gen)
        per_step = POOL_PER_STEP[mode] if mode else PER_STEP
    set_pool_mode(model, mode)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.normal(size=(BATCH, 3, side, side))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, classes, BATCH)).cuda()

    def step(m):
        return TrainStep(m, ClassNLLCriterion(),
                         SGD(learning_rate=0.01, momentum=0.9),
                         compute_dtype=compute_dtype, device="cuda")

    ref = step(copy.deepcopy(model))
    run = step(model)
    reset_kernel_launches()
    loss = run.run(x, y)
    launches = kernel_launches()
    expect_launches(launches, per_step, 1,
                    f"one {model_name} train step ({mode or 'default'} "
                    f"max pools)")
    with plain_versions(torch):
        want = ref.run(x, y)
    if kernel_launches() != launches:
        raise RuntimeError("the plain-version step reached a kernel")
    torch.backends.cudnn.deterministic = False
    if not (math.isfinite(loss) and abs(loss - want) <= 1e-5 * abs(want)):
        raise RuntimeError(f"step loss {loss} against plain {want}")
    max_err = 0.0
    for k, p in {**run.params, **run.buffers}.items():
        want_p = {**ref.params, **ref.buffers}[k]
        torch.testing.assert_close(p, want_p, rtol=1e-4, atol=1e-6)
        max_err = max(max_err, (p - want_p).abs().max().item())
    return {"model": model_name, "batch": BATCH,
            "dtype": str(compute_dtype or torch.float32)[6:],
            "pool_mode": mode or "default", "loss": loss,
            "loss_plain": want, "param_max_abs_err": max_err,
            "launches": launches}


def _train_main_path(root: str, pool_kernel: str = "off",
                     model_name: str = "inception_v1",
                     batch: int = TRAIN_BATCH, per_step=None):
    """(b) ``cli perf`` at ``batch`` in a subprocess: its JSON report and
    its records/sec line, the launches checked against ``per_step`` (by
    default Inception-v1's in the ``pool_kernel`` mode)."""
    warmup, iters = 3, 10
    cmd = [sys.executable, "-m", "bigdl_tpu_torch.models.cli", "perf",
           "--model", model_name, "-b", str(batch),
           "--warmup", str(warmup), "-i", str(iters),
           "--pool-kernel", pool_kernel]
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[1:])} exited {out.returncode}:\n"
                           f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    lines = out.stdout.strip().splitlines()
    report = json.loads(lines[-2])
    last = lines[-1]
    if not last.startswith(f"{model_name}: ") or "records/sec" not in last:
        raise RuntimeError(f"unexpected last line {last!r}")
    losses = report["losses"]
    steps = warmup + iters
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"losses {losses}")
    first, tail = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not tail < first:
        raise RuntimeError(f"the loss did not fall on the fixed batch: "
                           f"{losses}")
    if per_step is None:
        per_step = POOL_PER_STEP["argmax"] if pool_kernel == "on" \
            else PER_STEP
    expect_launches(report["launches"], per_step, steps,
                    f"{steps} {model_name} steps (--pool-kernel "
                    f"{pool_kernel})")
    report["records_per_s"] = float(last.split()[1])
    report["last_line"] = last
    return report


#: kernel-name fragments of the classes of device work in a profiled
#: step, matched in order; every other kernel is elementwise work,
#: reductions or copies (batch norm, ReLU, concatenation, casts, the
#: optimizer)
DEVICE_CLASSES = (
    ("convolution", ("cudnn", "xmma", "cutlass", "gemm", "conv")),
    ("average-pool kernels", ("avg_pool_",)),
    ("default max pool", ("max_pool",)))


def device_split(torch, train, steps: int = 3, by_op: bool = False) -> dict:
    """The wall ms a ``train()`` call over ``steps`` calls (synchronised
    at the window's ends, no profiler), then the device ms a call
    (kernel time summed) over ``steps`` more under ``torch.profiler``,
    the device's idle share of the wall time, and the device ms a call
    by ``DEVICE_CLASSES``.  With ``by_op`` the same trace records CPU
    activity too, and the kernels that no class names and that an op
    inside ``_BatchNormTrain`` or ``_BatchNormTrainBackward`` launched
    move to a batch-norm class (``linked_ms``: the kernel time that the
    trace linked to an op)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        train()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3

    acts = [torch.profiler.ProfilerActivity.CUDA]
    if by_op:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            train()
        torch.cuda.synchronize()

    def classify(name):
        return next((cls for cls, frags in DEVICE_CLASSES
                     if any(f in name for f in frags)), None)

    rest = "elementwise, reductions, copies"
    split = {name: 0.0 for name, _ in DEVICE_CLASSES}
    split[rest] = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            split[classify(e.key) or rest] += \
                e.device_time_total / 1e3 / steps
    device = sum(split.values())
    out = {"wall_ms": wall, "device_ms": device,
           "idle_share": 1.0 - device / wall, "device_ms_by_class": split}
    if not by_op:
        return out
    bn = linked = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        anc, in_bn = e, False
        while anc is not None and not in_bn:
            in_bn = anc.name.startswith("_BatchNormTrain")
            anc = anc.cpu_parent
        for k in e.kernels:
            ms = k.duration / 1e3 / steps
            linked += ms
            if in_bn and classify(k.name) is None:
                bn += ms
    split["batch norm (elementwise, reductions)"] = bn
    split[rest] -= bn
    out["linked_ms"] = linked
    return out


def _train_breakdown(torch, steps: int = 5,
                     model_name: str = "inception_v1",
                     batch: int = TRAIN_BATCH, profiled: int = 0,
                     by_op: bool = False, compute_dtype="bf16",
                     health_probe: bool = False):
    """(c) Median host-clock milliseconds (synchronised) of the forward
    with the loss, the backward, and the optimizer update of one step
    (bf16 unless ``compute_dtype`` is ``"f32"``) at ``batch``, dropout
    on, with the model's own number of classes, as ``cli perf`` builds
    it, or with the health probe on as the ``Optimizer`` builds it
    (``health_probe``); with ``profiled`` steps, also their
    :func:`device_split` (``device``)."""
    from bigdl_tpu_torch.models import registry
    from bigdl_tpu_torch.nn import Linear
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import TrainStep

    model = registry.build_model(model_name,
                                 generator=torch.Generator().manual_seed(0))
    classes = [m for m in model.modules()
               if isinstance(m, Linear)][-1].output_size
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=registry.input_spec(
        model_name, batch).shape).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, classes, batch)).cuda()
    step = TrainStep(model, ClassNLLCriterion(),
                     SGD(learning_rate=0.01, momentum=0.9),
                     compute_dtype=torch.bfloat16 if compute_dtype == "bf16"
                     else None, device="cuda", health_probe=health_probe)
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
    out = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    if profiled:
        out["device"] = device_split(
            torch, lambda: step.update(step.grads(step.loss(x, y))),
            profiled, by_op)
    return out


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
    return report


def _tie_split_main_path(torch, warmup: int = 3, iters: int = 10):
    """(b) The ``cli perf`` step at batch 256 (bf16, dropout on, the same
    seeds and batch) with ``split_ties()`` on every max pool, built here:
    the JAX package reaches this mode through the layer method alone."""
    from bigdl_tpu_torch.models import registry
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import TrainStep

    model = registry.build_model("inception_v1", 1000,
                                 generator=torch.Generator().manual_seed(0))
    if len(set_pool_mode(model, "tie")) != 13:
        raise RuntimeError("Inception-v1 does not hold 13 max pools")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(TRAIN_BATCH, 3, 224, 224))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, TRAIN_BATCH)).cuda()
    step = TrainStep(model, ClassNLLCriterion(),
                     SGD(learning_rate=0.01, momentum=0.9),
                     compute_dtype=torch.bfloat16, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    # the tie-split path: counts at 0 just before, read just after
    reset_kernel_launches()
    losses, wall = _timed_steps(torch, step, x, y, warmup, iters)
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    steps = warmup + iters
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"tie-split losses {losses}")
    if not sum(losses[-3:]) < sum(losses[:3]):
        raise RuntimeError(f"the tie-split loss did not fall on the fixed "
                           f"batch: {losses}")
    expect_launches(launches, POOL_PER_STEP["tie"], steps,
                    f"{steps} tie-split steps")
    return {"losses": losses, "launches": launches,
            "records_per_s": TRAIN_BATCH * iters / wall,
            "step_ms": wall / iters * 1e3, "max_memory_allocated": peak}


def phase_train_pool(torch, card: str, root: str, default: dict):
    """The Inception-v1 step in each max-pool kernel mode, beside the
    default step's numbers from ``phase_train``."""
    parity = {"tie": _train_parity(torch, "tie"),
              "argmax": _train_parity(torch, "argmax", torch.bfloat16)}
    torch.cuda.empty_cache()
    tie = _tie_split_main_path(torch)
    torch.cuda.empty_cache()
    argmax = _train_main_path(root, pool_kernel="on")
    keys = ("records_per_s", "step_ms", "max_memory_allocated")
    row = {"phase": "train_pool", "ok": True, "model": "inception_v1",
           "batch": TRAIN_BATCH, "compute": "bf16", "parity": parity,
           "tie_split": {**{k: tie[k] for k in keys},
                         "losses": tie["losses"],
                         "launches": tie["launches"],
                         "launches_per_step": POOL_PER_STEP["tie"]},
           "argmax": {**{k: argmax[k] for k in keys},
                      "losses": argmax["losses"],
                      "launches": argmax["launches"],
                      "launches_per_step": POOL_PER_STEP["argmax"],
                      "last_line": argmax["last_line"]},
           "default": {k: default[k] for k in keys}, "card": card}
    emit(row)
    return tie["launches"], argmax["launches"]


def phase_train_v2(torch, card: str, root: str):
    """Inception-v2 (batch norm): the average-pool kernels bit-equal at
    its eight geometries, one f32 step against the plain versions, the
    ``cli perf`` main path at batch ``V2_BATCH`` and its breakdown."""
    checks = avg_pool_checks(torch, V2_AVG_POOL_GEOMETRIES)
    parity = _train_parity(torch, model_name="inception_v2")
    torch.cuda.empty_cache()
    report = _train_main_path(root, model_name="inception_v2",
                              batch=V2_BATCH, per_step=V2_PER_STEP)
    breakdown = _train_breakdown(torch, model_name="inception_v2",
                                 batch=V2_BATCH, profiled=3)
    torch.cuda.empty_cache()
    emit({"phase": "train_v2", "ok": True, "model": "inception_v2",
          "avg_pool_checks": {"geometries": [g[0] for g in
                                             V2_AVG_POOL_GEOMETRIES],
                              "checks": checks, "tolerance": "bit-equal",
                              "inputs": "normal, special (-inf block, "
                                        "NaN, -0.0)"},
          "parity": parity, "batch": V2_BATCH, "compute": "bf16",
          "losses": report["losses"], "launches": report["launches"],
          "launches_per_step": V2_PER_STEP,
          "records_per_s": report["records_per_s"],
          "step_ms": report["step_ms"],
          "max_memory_allocated": report["max_memory_allocated"],
          "breakdown_ms": breakdown, "last_line": report["last_line"],
          "card": card})
    return report


def _write_cifar(folder: str, n: int = 1024) -> None:
    """CIFAR-10's python batches (``data_batch_1..5``, ``test_batch``)
    of the loader's synthetic images, train and test drawn from ONE set
    of class patterns (2n images from the train split's seed; the first
    n train, the rest test).  The loader's own no-folder fallback draws
    the test split's patterns from another seed, so on it no model can
    beat chance."""
    import pickle

    from bigdl_tpu_torch.dataset.datasets import _synthetic_images

    imgs, labels = _synthetic_images(2 * n, 32, 32, 3, 10, seed=2)
    flat = imgs.transpose(0, 3, 1, 2).reshape(2 * n, -1)
    d = os.path.join(folder, "cifar-10-batches-py")
    os.makedirs(d)
    parts = [(f"data_batch_{i + 1}", idx) for i, idx in
             enumerate(np.array_split(np.arange(n), 5))]
    for name, idx in parts + [("test_batch", np.arange(n, 2 * n))]:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": flat[idx],
                         b"labels": labels[idx].tolist()}, f)


def _cli(root: str, args, timeout: int = 600):
    """``python -m bigdl_tpu_torch.models.cli <args>`` in a subprocess;
    its standard output's lines."""
    cmd = [sys.executable, "-m", "bigdl_tpu_torch.models.cli"] + list(args)
    out = subprocess.run(cmd, cwd=root, env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[1:])} exited {out.returncode}:\n"
                           f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    return out.stdout.strip().splitlines()


def _cli_train(root: str, folder: str, ckpt: str, epochs: int):
    """``cli train --model resnet -b 128``: its JSON report and its two
    ``final`` lines."""
    lines = _cli(root, ["train", "--model", "resnet", "-b", str(RESNET_BATCH),
                        "--max-epoch", str(epochs), "--checkpoint", ckpt,
                        "-f", folder])
    if not (lines[-2].startswith("final Top1Accuracy: ")
            and lines[-1].startswith("final Top5Accuracy: ")):
        raise RuntimeError(f"unexpected last lines {lines[-2:]}")
    return json.loads(lines[-3]), lines[-2:]


def _verified_checkpoints(ckpt_dir: str):
    """The checkpoint numbers under ``ckpt_dir``, each pair's digests
    verified against its ``ckptmeta.N.json``."""
    from bigdl_tpu_torch.utils.ckpt_digest import verify_digests

    nums = sorted(int(f.split(".")[1]) for f in os.listdir(ckpt_dir)
                  if f.startswith("model."))
    for n in nums:
        with open(os.path.join(ckpt_dir, f"ckptmeta.{n}.json")) as f:
            meta = json.load(f)
        if sorted(meta["digests"]) != [f"model.{n}", f"optimMethod.{n}"]:
            raise RuntimeError(f"checkpoint {n}: digests of "
                               f"{sorted(meta['digests'])}")
        problems = verify_digests(ckpt_dir, meta["digests"])
        if problems:
            raise RuntimeError(f"checkpoint {n}: {problems}")
    return nums


def _resnet_main_path(root: str):
    """(c) ``cli train --model resnet -b 128 --max-epoch 2`` through the
    ``LocalOptimizer`` on CIFAR-10 files (:func:`_write_cifar`), ``cli
    test`` on its checkpoint, and a 1-epoch run resumed to 2 epochs in
    another directory; each in a subprocess."""
    import tempfile

    import torch

    from bigdl_tpu_torch.utils.serializer import load_module

    tmp = tempfile.mkdtemp(prefix="chip_smoke_resnet_")
    try:
        folder = os.path.join(tmp, "cifar")
        _write_cifar(folder)
        ck = os.path.join(tmp, "straight")
        report, finals = _cli_train(root, folder, ck, 2)
        its = report["iterations"]
        losses = [v for *_, v in its]
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"cli train losses {losses}")
        mean = {e: np.mean([v for _, ep, v in its if ep == e])
                for e in (1, 2)}
        if not mean[2] < mean[1]:
            raise RuntimeError(f"the mean loss did not fall from epoch 1 to "
                               f"epoch 2: {mean}")
        top1 = report["validation"]["Top1Accuracy"]
        acc = top1["value"] / top1["count"]
        if not acc > 0.10:
            raise RuntimeError(f"Top1 {acc} at the last validation is not "
                               f"above chance")
        steps, vals = report["steps"], report["val_batches"]
        want = {"avg_pool_fwd": steps + vals, "avg_pool_bwd": steps}
        got = {k: v for k, v in report["launches"].items() if v}
        if got != want or steps != 16 or vals != 16:
            raise RuntimeError(f"cli train launches {got} against {want} "
                               f"({steps} steps, {vals} validation batches)")
        ckpt_dir = report["checkpoint_dir"]
        nums = _verified_checkpoints(ckpt_dir)
        if nums != [8, 16]:
            raise RuntimeError(f"checkpoints {nums} under {ckpt_dir}")
        tested = _cli(root, ["test", "--model", "resnet", "-b",
                             str(RESNET_BATCH), "--checkpoint", ck,
                             "-f", folder])
        want_line = f"Top1Accuracy: Accuracy(correct: {int(top1['value'])}, "
        if not (tested[-2].startswith(want_line)
                and tested[-2] == finals[0][len("final "):]):
            raise RuntimeError(f"cli test printed {tested[-2:]} where the "
                               f"last validation gave {top1} and train "
                               f"{finals}")
        # resume: one epoch, then the same command to two epochs
        ck2 = os.path.join(tmp, "resumed")
        first, _ = _cli_train(root, folder, ck2, 1)
        resumed, _ = _cli_train(root, folder, ck2, 2)
        if not (first["neval"] == 8 and resumed["resumed_from"]
                and resumed["iterations"][0][0] == 9
                and resumed["iterations"][0][1] == 2
                and resumed["neval"] == report["neval"] == 16):
            raise RuntimeError(f"resume: first run at {first['neval']}, "
                               f"resumed from {resumed['resumed_from']} at "
                               f"{resumed['iterations'][:1]} to "
                               f"{resumed['neval']} against "
                               f"{report['neval']}")
        def max_diff(n, other_dir):
            a = load_module(os.path.join(ckpt_dir, f"model.{n}"))
            b = load_module(os.path.join(other_dir, f"model.{n}"))
            a, b = a.state_dict(), b.state_dict()
            return max((a[k].float() - b[k].float()).abs().max().item()
                       for k in a)

        diff = max_diff(16, resumed["checkpoint_dir"])
        # the same first epoch in two processes, no resume between
        diff1 = max_diff(8, first["checkpoint_dir"])
        st = report["stages"]
        iters = st["iteration time"][0]  # the steady iterations
        return {"losses": losses, "mean_loss_by_epoch": mean,
                "top1": acc, "final_lines": finals, "test_lines": tested[-2:],
                "launches": report["launches"], "steps": steps,
                "val_batches": vals, "checkpoints": nums,
                "records_per_s": report["records_per_s"],
                "step_ms": iters / st["iteration time"][1] * 1e3,
                "share_outside_train_step": 1.0 - st["dispatch time"][0]
                / iters,
                "host_read_share": st["host read time"][0] / iters,
                # the first iteration's wait for the prefetch thread too
                "data_wait_ms_per_iteration": st["data time"][0]
                / st["data time"][1] * 1e3, "stages": st,
                "resume": {"first_neval": first["neval"],
                           "resumed_at": resumed["iterations"][0][:2],
                           "neval": resumed["neval"],
                           "max_param_abs_diff": diff,
                           "epoch1_two_processes_max_param_abs_diff": diff1,
                           "deterministic_cudnn": bool(
                               torch.backends.cudnn.deterministic)}}
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


def phase_train_resnet(torch, card: str, root: str):
    """ResNet: (a) the average-pool kernels bit-equal at both heads, (b)
    one f32 ResNet-20 step against the plain versions, (c) ``cli train``
    / ``cli test`` / resume of ResNet-20, (d) ``cli perf --model
    resnet50 -b 128`` and its breakdown."""
    checks = avg_pool_checks(torch, [(site, shape, args, 0)
                                     for _, site, shape, args in RESNET_HEADS])
    parity = _train_parity(torch, model_name="resnet")
    torch.cuda.empty_cache()
    loop = _resnet_main_path(root)
    perf = _train_main_path(root, model_name="resnet50", batch=RESNET_BATCH,
                            per_step=RESNET_PER_STEP)
    breakdown = _train_breakdown(torch, model_name="resnet50",
                                 batch=RESNET_BATCH, profiled=3, by_op=True)
    torch.cuda.empty_cache()
    # where the f32 ResNet-20 step of the loop spends its time: 10
    # classes and the health probe, as cli train runs it
    loop["breakdown_ms"] = _train_breakdown(
        torch, model_name="resnet", batch=RESNET_BATCH, profiled=3,
        by_op=True, compute_dtype="f32", health_probe=True)
    torch.cuda.empty_cache()
    emit({"phase": "train_resnet", "ok": True,
          "avg_pool_checks": {"geometries": [h[1] for h in RESNET_HEADS],
                              "checks": checks, "tolerance": "bit-equal",
                              "inputs": "normal, special (-inf block, "
                                        "NaN, -0.0)"},
          "parity": parity, "resnet20_cli_train": loop,
          "resnet50_perf": {
              "batch": RESNET_BATCH, "compute": "bf16",
              "losses": perf["losses"], "launches": perf["launches"],
              "launches_per_step": RESNET_PER_STEP,
              "records_per_s": perf["records_per_s"],
              "step_ms": perf["step_ms"],
              "max_memory_allocated": perf["max_memory_allocated"],
              "breakdown_ms": breakdown, "last_line": perf["last_line"]},
          "card": card})
    return loop["launches"], perf["launches"]


def phase_step_options(torch, card: str):
    """The train step's options on the card: ``Adam``, bf16 compute,
    per-layer scale and regularizer, bf16 gradient compression, value
    clipping, ``max_norm``, the health probe and ``skip_nonfinite`` on a
    small batch-norm model, every step run with CUDA's sync debug mode
    set to raise on a host synchronisation.  Finite steps: finite losses
    that fall and a health vector with no non-finite count; then a NaN
    input, which must leave the parameters, the optimizer state (its
    device counters too) and the batch-norm buffers bit-equal."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import Adam, L1L2Regularizer
    from bigdl_tpu_torch.parallel import TrainStep

    gen = torch.Generator().manual_seed(SEED)
    model = nn.Sequential(
        nn.Linear(256, 512, w_regularizer=L1L2Regularizer(1e-5, 1e-4),
                  generator=gen),
        nn.ReLU(), nn.BatchNormalization(512),
        nn.Linear(512, 10, generator=gen).set_scale_w(0.5),
        nn.LogSoftMax())
    step = TrainStep(model, nn.ClassNLLCriterion(), Adam(1e-3),
                     compute_dtype=torch.bfloat16, device="cuda",
                     gradient_compression="bf16",
                     gradient_clipping=(-1.0, 1.0), max_norm=5.0,
                     health_probe=True, skip_nonfinite=True)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32)
                         ).cuda()
    y = torch.from_numpy(rng.integers(0, 10, 64)).cuda()

    def train(inp):
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss = step.loss(inp, y)
            step.update(step.grads(loss))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return loss.detach()

    losses = [train(x) for _ in range(5)]
    losses = [float(v) for v in losses]
    health = step.last_health.tolist()
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
            and health[3] == health[4] == 0.0):
        raise RuntimeError(f"step options: losses {losses}, health {health}")

    def snapshot():
        flat = {f"state.{k}": v for k, v in model.state_dict().items()}
        for k, v in step.opt_state.items():
            if isinstance(v, dict):
                flat.update({f"{k}.{p}": t for p, t in v.items()})
            else:
                flat[k] = v
        return {k: v.clone() for k, v in flat.items()}

    before = snapshot()
    bad = x.clone()
    bad[3, 7] = float("nan")
    nan_loss = float(train(bad))
    after = snapshot()
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    if math.isfinite(nan_loss) or changed \
            or step.last_health[3].item() == 0:
        raise RuntimeError(f"skip_nonfinite: loss {nan_loss}, changed "
                           f"{changed}, health {step.last_health.tolist()}")
    emit({"phase": "step_options", "ok": True,
          "options": ["Adam", "bf16 compute", "scale_w", "L1L2Regularizer",
                      "bf16 compression", "clipping", "max_norm",
                      "health_probe", "skip_nonfinite"],
          # the debug mode is a prototype: it raised on none of the
          # synchronisations it detects
          "sync_debug_mode": "error", "losses": losses,
          "health": health,
          # non-finite values as strings: the line stays strict JSON
          "nan_step": {"loss": str(nan_loss),
                       "health": [v if math.isfinite(v) else str(v)
                                  for v in step.last_health.tolist()],
                       "state_bit_equal": True},
          "card": card})


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


def _timed_steps(torch, step, x, y, warmup: int = 3, iters: int = 10):
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
    losses, wall = _timed_steps(torch, step, x, y, warmup, iters)
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

    # (e) a few Adam steps on the same step (flash attention)
    from bigdl_tpu_torch.optim import Adam, SGD

    step.optim = Adam(learning_rate=1e-4)
    step.opt_state = step.optim.init_state(step.params)
    reset_kernel_launches()
    adam_losses, adam_wall = _timed_steps(torch, step, x, y, 1, 5)
    expect_launches(kernel_launches(), LM_PER_STEP, 6, "6 Adam LM steps")
    if not all(math.isfinite(v) for v in adam_losses) \
            or not adam_losses[-1] < adam_losses[0]:
        raise RuntimeError(f"the Adam LM loss did not fall: {adam_losses}")
    adam = {"losses": adam_losses, "step_ms": adam_wall / 5 * 1e3,
            "breakdown_ms": _lm_breakdown(torch, step, x, y)}
    step.optim = SGD(learning_rate=0.01, momentum=0.9)
    step.opt_state = step.optim.init_state(step.params)

    # (d) the same step with dense attention (records/s only)
    attns = [m for m in step.model.modules()
             if isinstance(m, MultiHeadAttention)]
    for m in attns:
        m.backend = "dense"
    reset_kernel_launches()
    dense_losses, dense_wall = _timed_steps(torch, step, x, y, warmup, iters)
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
           "breakdown_ms": breakdown, "adam": adam,
           "dense_attention": {"records_per_s": LM_BATCH * iters / dense_wall,
                               "step_ms": dense_wall / iters * 1e3,
                               "losses": dense_losses},
           "card": card}
    emit(row)
    return launches


def _norm_layers(torch):
    """(name, kind, layer, input shape) of the norm path: the
    within-channel LRN at both LRN sites, the three smoothing layers on
    the headline input."""
    from bigdl_tpu_torch import nn

    return ([(f"within_channel {site}", "within_channel",
              nn.SpatialWithinChannelLRN(*WCL_HYPER), (TRAIN_BATCH, c, 56, 56))
             for site, c in LRN_SITES]
            + [(kind, kind, cls(3), NORM_SHAPE) for kind, cls in (
                ("subtractive", nn.SpatialSubtractiveNormalization),
                ("divisive", nn.SpatialDivisiveNormalization),
                ("contrastive", nn.SpatialContrastiveNormalization))])


def _forward_backward(torch, layer, x, g):
    xr = x.detach().requires_grad_()
    y = layer(xr)
    (dx,) = torch.autograd.grad(y, xr, g)
    return y.detach(), dx


def phase_norm(torch, card: str):
    """The four normalization layers, each one forward and backward
    through autograd at full width, in bf16 and then f32: exactly the
    launches of ``NORM_PER_PASS`` and no other kernel, the output and
    the input gradient against the same pass through the plain versions
    on the card, then ms per forward + backward (kernels and plain) and
    peak memory.  Returns the bf16 pass's launches summed over the
    layers."""
    from bigdl_tpu_torch.ops import kernel_launches, reset_kernel_launches

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tols = {torch.float32: dict(rtol=1e-5, atol=1e-6),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
    path_launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        total = {}
        for name, kind, layer, shape in _norm_layers(torch):
            layer = layer.cuda()
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_kernel_launches()
            y, dx = _forward_backward(torch, layer, x, g)
            torch.cuda.synchronize()
            launches = kernel_launches()
            peak = torch.cuda.max_memory_allocated()
            expect_launches(launches, NORM_PER_PASS[kind], 1,
                            f"{name} {str(dtype)[6:]}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            with plain_versions(torch):
                want_y, want_dx = _forward_backward(torch, layer, x, g)
                torch.cuda.synchronize()
                plain_ms = event_ms(torch, lambda: _forward_backward(
                    torch, layer, x, g), [()], calls=5)
            if kernel_launches() != launches:
                raise RuntimeError(f"{name}: the plain-version pass reached "
                                   f"a kernel")
            for got, want in ((y, want_y), (dx, want_dx)):
                if got.shape != x.shape or not torch.isfinite(got).all():
                    raise RuntimeError(f"{name}: output not finite or of "
                                       f"shape {tuple(got.shape)}")
                torch.testing.assert_close(got, want, **tols[dtype])
            ms = event_ms(torch, lambda: _forward_backward(torch, layer, x,
                                                           g), [()], calls=5)
            emit({"phase": "norm", "layer": name, "shape": list(shape),
                  "dtype": str(dtype)[6:], "launches": launches,
                  "max_abs_err_y": (y.float() - want_y.float()).abs().max()
                  .item(),
                  "max_abs_err_dx": (dx.float() - want_dx.float()).abs()
                  .max().item(), "tolerance": tols[dtype],
                  "ms_per_forward_backward": ms,
                  "plain_ms_per_forward_backward": plain_ms,
                  "peak_bytes": peak, "card": card})
            del x, g, y, dx, want_y, want_dx
            torch.cuda.empty_cache()
        if dtype == torch.bfloat16:
            path_launches = total
    return path_launches


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
            "library_ms": (None if any(r["library_ms"] is None
                                       for r in sites)
                           else sum(r["library_ms"] for r in sites)),
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
    phase_maxpool_edges(torch)
    phase_avg_pool_edges(torch)
    phase_smooth_edges(torch)
    phase_wcl_edges(torch)
    phase_lrn_bwd_edges(torch)
    serve_launches = phase_serve(torch, card)
    default = phase_train(torch, card, root)
    tie_launches, argmax_launches = phase_train_pool(torch, card, root,
                                                     default)
    v2_launches = phase_train_v2(torch, card, root)["launches"]
    resnet_launches, resnet50_launches = phase_train_resnet(torch, card, root)
    lm_launches = phase_train_lm(torch, card)
    phase_step_options(torch, card)
    norm_launches = phase_norm(torch, card)

    # each path's numbers come from its own shapes and dtype: serving
    # runs the forwards in f32 at batch 8, training every Inception-v1
    # kernel in bf16 at batch 256 and every flash kernel in bf16 at batch
    # 32; each row leads with its kernel's training path (the max-pool
    # forward's with the tie-split one: its sites there and in the
    # argmax step are three of the 13 pools)
    paths = {"train": (default["launches"], "bfloat16",
                       f"one train step at batch {TRAIN_BATCH}"),
             "train_tie": (tie_launches, "bfloat16",
                           f"one tie-split train step at batch "
                           f"{TRAIN_BATCH}"),
             "train_argmax": (argmax_launches, "bfloat16",
                              f"one argmax-index train step at batch "
                              f"{TRAIN_BATCH}"),
             "train_v2": (v2_launches, "bfloat16",
                          f"one Inception-v2 train step at batch "
                          f"{V2_BATCH}"),
             "train_resnet": (resnet_launches, "float32",
                              f"one cli train run of ResNet-20 at batch "
                              f"{RESNET_BATCH} (2 epochs of 8 steps, a "
                              f"validation of 8 batches each)"),
             "train_resnet50": (resnet50_launches, "bfloat16",
                                f"13 ResNet-50 cli perf steps at batch "
                                f"{RESNET_BATCH}"),
             "train_lm": (lm_launches, "bfloat16",
                          f"one transformer_lm train step at batch "
                          f"{LM_BATCH}"),
             "serve": (serve_launches, "float32",
                       f"one served forward at batch {BATCH}"),
             "norm": (norm_launches, "bfloat16",
                      f"one forward + backward of each normalization "
                      f"layer at batch {TRAIN_BATCH}")}
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
                          "bigdl_tpu/ops/attention.py:312"),
            "maxpool_fwd": ("bigdl_tpu_torch/csrc/maxpool_fwd.cu",
                            "bigdl_tpu/ops/pool_pallas.py:125"),
            "maxpool_tie_bwd": ("bigdl_tpu_torch/csrc/maxpool_tie_bwd.cu",
                                "bigdl_tpu/ops/pool_pallas.py:133"),
            "maxpool_argmax_bwd": (
                "bigdl_tpu_torch/csrc/maxpool_argmax_bwd.cu",
                "bigdl_tpu/ops/pooling_pallas.py:212"),
            "within_channel_lrn_fwd": ("bigdl_tpu_torch/csrc/wcl_fwd.cu",
                                       "bigdl_tpu/ops/lrn_pallas.py:293"),
            "within_channel_lrn_bwd": ("bigdl_tpu_torch/csrc/wcl_bwd.cu",
                                       "bigdl_tpu/ops/lrn_pallas.py:307"),
            "smooth2d": ("bigdl_tpu_torch/csrc/smooth2d.cu",
                         "bigdl_tpu/ops/norm_pallas.py:82")}
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
