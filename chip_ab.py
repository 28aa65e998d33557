#!/usr/bin/env python3
"""Times the bf16 flash-attention kernels, the average-pool forward and
the ``transformer_lm`` train step of several checkouts on one NVIDIA
GPU, each in a process of its own, in the order given (e.g. parent,
change, change, parent):

    python3 chip_ab.py OLD_ROOT NEW_ROOT NEW_ROOT OLD_ROOT

Each process imports ``bigdl_tpu_torch`` and ``chip_smoke`` from its own
root (so each builds its own kernels there), holds the three flash
kernels against their plain versions at the training shape
[32, 8, 512, 64] causal in bf16 and times them with ``chip_smoke``'s
``_flash_rows`` (a CUDA graph over copies of the inputs that exceed the
L2 cache), holds the average-pool forward bit for bit against its plain
version at the Inception-v1 head's training shape [256, 1024, 7, 7] in
bf16 and its serving shape [8, 1024, 7, 7] in f32 (``chip_smoke``'s
``_pool_cases``) and times it the same way beside ``F.avg_pool2d``,
then runs ``make_step("transformer_lm")`` (batch 32, bf16)
for 3 warm-up steps and five windows of 10 timed steps, each window
synchronised at its ends only: finite losses that fall over the first
13 steps, 6/6/6 flash launches per step, and the median window's ms a
step (one slow window, a hiccup of the host, does not move it).  One
JSON line per process, then the card's name and power limit, then a
JSON summary by root (means over that root's processes).  Exits
non-zero without a GPU or when a process fails.

    python3 chip_ab.py --maxpool OLD_ROOT NEW_ROOT NEW_ROOT OLD_ROOT

times the max pools instead, at all 13 of Inception-v1's max-pool sites
at batch 256 (geometries from ``SpatialMaxPooling(3, 3, s, s, p,
p).ceil()``, as ``chip_smoke._maxpool_geometry`` builds them): each
process runs ``chip_smoke._maxpool_cases`` over the 13 sites, holding
the forward without the index (f32, bf16) and with it (bf16, f16), the
tie-split backward (f32, bf16) and the argmax backward (bf16, f16) bit
for bit against their plain versions and timing each as ``chip_smoke``
does, with the sum of
each over the 13 sites beside its summed bound; then it times the
Inception-v1 step (bf16, batch 256, ``cli perf``'s model, seeds and
batch) with ``split_ties()`` and with the argmax index on every max
pool: 3 warm-up steps and five windows of 10 steps, finite losses that
fall, 13 + 13 max-pool launches a step, the median window's ms.

    python3 chip_ab.py --norm OLD_ROOT NEW_ROOT NEW_ROOT OLD_ROOT

times the normalization path instead: each process holds the smoothing
kernel bit for bit against its plain version at ``chip_smoke.
_smooth_cases``' three cases (the [1, 224, 224] edge-coverage mass, the
mean map of the [256, 224, 224] stack and its transpose) in f32 and
bf16 and times each as ``chip_smoke`` does, with the sum over the three
launches of one subtractive or divisive pass (twice that is a
contrastive pass); holds the within-channel LRN forward and backward
bit for bit at ``chip_smoke._wcl_cases``' two sites and times them
beside it; then runs
one forward and backward of each of the four normalization layers of
``chip_smoke._norm_layers`` (``NORM_SHAPE`` for the smoothing layers) in
bf16 and f32, exactly ``NORM_PER_PASS`` launches checked and finite
outputs, and reports each pass's ms (median of three means of 10
passes between CUDA events).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from statistics import fmean

STEPS = {"flash_fwd": 6, "flash_dq": 6, "flash_dkv": 6}
#: Inception-v1's 13 max pools at batch 256: (site, channels, extent,
#: stride, pad), in the order of the forward
MAXPOOL_SITES = (
    ("pool1", 64, 112, 2, 0), ("pool2", 192, 56, 2, 0),
    ("inception_3a pool", 192, 28, 1, 1), ("inception_3b pool", 256, 28, 1, 1),
    ("pool3", 480, 28, 2, 0), ("inception_4a pool", 480, 14, 1, 1),
    ("inception_4b pool", 512, 14, 1, 1), ("inception_4c pool", 512, 14, 1, 1),
    ("inception_4d pool", 512, 14, 1, 1), ("inception_4e pool", 528, 14, 1, 1),
    ("pool4", 832, 14, 2, 0), ("inception_5a pool", 832, 7, 1, 1),
    ("inception_5b pool", 832, 7, 1, 1))


def avg_pool_rows(torch, c) -> dict:
    """The average-pool forward at the train head (bf16) and the serve
    head (f32): bit-equal to its plain version, then its device ms beside
    ``F.avg_pool2d``'s and its byte bound."""
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    out = {}
    for path, batch, dtype in (("train", c.TRAIN_BATCH, torch.bfloat16),
                               ("serve", c.BATCH, torch.float32)):
        (case,) = c._pool_cases(torch, path, batch)
        args = case["make"](gen, case["shape"], dtype)
        c.bit_equal(torch, case["kernel"](*args), case["plain"](*args),
                    f"avg_pool_fwd {path}")
        copies = c.rotating_copies(args, torch)
        launches = max(len(copies), 20)
        nbytes, _ = case["bound"](*args)
        out[path] = {"shape": list(case["shape"]), "dtype": str(dtype)[6:],
                     "ms": c.graph_ms(torch, case["kernel"], copies,
                                      launches),
                     "library_ms": c.graph_ms(torch, case["library"], copies,
                                              launches),
                     "bound_ms": nbytes / c.HBM_BYTES_PER_S * 1e3}
        del copies, args
        torch.cuda.empty_cache()
    return out


def maxpool_rows(torch, c) -> dict:
    """The max-pool kernels at the 13 sites: each bit-equal to its plain
    version, its device ms and bound, and each kernel's sums over the
    sites."""
    c.MAXPOOL_SITES = MAXPOOL_SITES
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    rows, sums = [], {}
    for case in c._maxpool_cases(torch):
        for dtype in case["dtypes"]:
            dt = str(dtype)[6:]
            args = case["make"](gen, case["shape"], dtype)
            c.bit_equal(torch, case["kernel"](*args), case["plain"](*args),
                        f"{case['name']} {case['path']} {case['site']} {dt}")
            copies = c.rotating_copies(args, torch)
            nbytes, flops = case["bound"](*args)
            bound = max(nbytes / c.HBM_BYTES_PER_S,
                        flops / c.F32_FLOPS_PER_S) * 1e3
            ms = c.graph_ms(torch, case["kernel"], copies,
                            max(len(copies), 20))
            rows.append({"name": case["name"], "path": case["path"],
                         "site": case["site"], "dtype": dt, "ms": ms,
                         "bound_ms": bound})
            key = f"{case['name']} {case['path']} {dt}"
            total = sums.setdefault(key, {"sites": 0, "ms": 0.0,
                                          "bound_ms": 0.0})
            total["sites"] += 1
            total["ms"] += ms
            total["bound_ms"] += bound
            del copies, args
            torch.cuda.empty_cache()
    return {"rows": rows, "sums": sums}


def norm_rows(torch, c) -> dict:
    """The smoothing and within-channel LRN kernels at their norm-path
    shapes: each held to its plain version bit for bit, its device ms
    and bound; and the smoothing's sum over one subtractive or divisive
    pass's three launches."""
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    rows = []
    for case in c._smooth_cases(torch) + c._wcl_cases(torch):
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            args = case["make"](gen, case["shape"], dtype)
            what = f"{case['name']} {case['site']} {dt}"
            c.bit_equal(torch, case["kernel"](*args), case["plain"](*args),
                        what)
            copies = c.rotating_copies(args, torch)
            nbytes, flops = case["bound"](*args)
            rows.append({"name": case["name"], "site": case["site"],
                         "dtype": dt,
                         "ms": c.graph_ms(torch, case["kernel"], copies,
                                          max(len(copies), 20)),
                         "bound_ms": max(nbytes / c.HBM_BYTES_PER_S,
                                         flops / c.F32_FLOPS_PER_S) * 1e3})
            del copies, args
            torch.cuda.empty_cache()
    sums = {}
    for dt in ("float32", "bfloat16"):
        mine = [r for r in rows if r["name"] == "smooth2d"
                and r["dtype"] == dt]
        sums[f"smooth2d one subtractive or divisive pass {dt}"] = {
            "launches": len(mine), "ms": sum(r["ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine)}
    return {"rows": rows, "sums": sums}


def norm_passes(torch, c, windows=3, calls=10) -> dict:
    """One forward and backward of each normalization layer through
    autograd, in bf16 and f32: exactly ``NORM_PER_PASS`` launches,
    finite outputs, and the median over ``windows`` of the mean ms of
    ``calls`` passes."""
    from bigdl_tpu_torch.ops import kernel_launches, reset_kernel_launches

    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, kind, layer, shape in c._norm_layers(torch):
            layer = layer.cuda()
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            torch.cuda.synchronize()
            reset_kernel_launches()
            y, dx = c._forward_backward(torch, layer, x, g)
            torch.cuda.synchronize()
            c.expect_launches(kernel_launches(), c.NORM_PER_PASS[kind], 1,
                              f"{name} {str(dtype)[6:]}")
            if not (torch.isfinite(y).all() and torch.isfinite(dx).all()):
                raise RuntimeError(f"{name}: output not finite")
            ms = sorted(c.event_ms(torch, lambda: c._forward_backward(
                torch, layer, x, g), [()], calls=calls)
                for _ in range(windows))
            out[f"{name} {str(dtype)[6:]}"] = ms[len(ms) // 2]
            del x, g, y, dx
            torch.cuda.empty_cache()
    return out


def pool_step(torch, c, mode: str, warmup=3, iters=10, windows=5) -> dict:
    """The bf16 batch-256 Inception-v1 step with every max pool in
    ``mode`` ("tie" or "argmax"): median ms of ``windows`` windows."""
    import numpy as np

    from bigdl_tpu_torch.models import registry
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import TrainStep

    model = registry.build_model("inception_v1", 1000,
                                 generator=torch.Generator().manual_seed(0))
    if len(c.set_pool_mode(model, mode)) != 13:
        raise RuntimeError("Inception-v1 does not hold 13 max pools")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(c.TRAIN_BATCH, 3, 224, 224))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, c.TRAIN_BATCH)).cuda()
    step = TrainStep(model, ClassNLLCriterion(),
                     SGD(learning_rate=0.01, momentum=0.9),
                     compute_dtype=torch.bfloat16, device="cuda")
    reset_kernel_launches()
    losses, wall = c._timed_steps(torch, step, x, y, warmup, iters)
    step_ms = [wall / iters * 1e3]
    for _ in range(windows - 1):
        more, wall = c._timed_steps(torch, step, x, y, 0, iters)
        losses += more
        step_ms.append(wall / iters * 1e3)
    if not all(math.isfinite(v) for v in losses) \
            or not sum(losses[-3:]) < sum(losses[:3]):
        raise RuntimeError(f"{mode} losses {losses}")
    c.expect_launches(kernel_launches(), c.POOL_PER_STEP[mode],
                      warmup + windows * iters, f"{mode} steps")
    median = sorted(step_ms)[len(step_ms) // 2]
    del step, model
    torch.cuda.empty_cache()
    return {"step_ms": median, "records_per_s": c.TRAIN_BATCH / median * 1e3,
            "window_step_ms": step_ms, "losses": losses}


def _checked_imports(root: str):
    """torch and this root's ``chip_smoke``, with the port imported from
    the same root."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as c
    import bigdl_tpu_torch

    for mod in (c, bigdl_tpu_torch):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, "
                               f"not from {root}")
    return root, torch, c


def one_maxpool(root: str) -> dict:
    """The max-pool measurements of one checkout, in this process."""
    root, torch, c = _checked_imports(root)
    from bigdl_tpu_torch.device import strict_f32

    strict_f32()
    kernels = maxpool_rows(torch, c)
    return {"root": root, "maxpool": kernels,
            "steps": {mode: pool_step(torch, c, mode)
                      for mode in ("tie", "argmax")}}


def one_norm(root: str) -> dict:
    """The normalization-path measurements of one checkout, in this
    process."""
    root, torch, c = _checked_imports(root)
    from bigdl_tpu_torch.device import strict_f32

    strict_f32()
    return {"root": root, "norm": norm_rows(torch, c),
            "passes": norm_passes(torch, c)}


def one(root: str) -> dict:
    """The measurements of one checkout, in this process."""
    root, torch, c = _checked_imports(root)
    from bigdl_tpu_torch.bench_configs import make_step
    from bigdl_tpu_torch.device import strict_f32
    from bigdl_tpu_torch.ops import kernel_launches, reset_kernel_launches

    strict_f32()
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    inputs, errs = c._flash_check(torch, gen, c.FLASH_TRAIN, torch.bfloat16)
    rows = c._flash_rows(torch, torch.bfloat16, inputs, errs)
    del inputs
    torch.cuda.empty_cache()
    avg_pool = avg_pool_rows(torch, c)

    warmup, iters, windows = 3, 10, 5
    step, x, y = make_step("transformer_lm")
    reset_kernel_launches()
    losses, wall = c._timed_steps(torch, step, x, y, warmup, iters)
    if not all(math.isfinite(v) for v in losses) \
            or not sum(losses[-3:]) < sum(losses[:3]):
        raise RuntimeError(f"transformer_lm losses {losses}")
    step_ms = [wall / iters * 1e3]
    for _ in range(windows - 1):
        more, wall = c._timed_steps(torch, step, x, y, 0, iters)
        if not all(math.isfinite(v) for v in more):
            raise RuntimeError(f"transformer_lm losses {more}")
        step_ms.append(wall / iters * 1e3)
    c.expect_launches(kernel_launches(), STEPS, warmup + windows * iters,
                      "transformer_lm")
    median = sorted(step_ms)[len(step_ms) // 2]
    return {"root": root,
            "kernels": {r["name"]: {k: r.get(k) for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err", "design")} for r in rows},
            "avg_pool_fwd": avg_pool,
            "lm_step_ms": median,
            "lm_records_per_s": c.LM_BATCH / median * 1e3,
            "lm_window_step_ms": step_ms,
            "lm_losses": losses}


def _summary(mine, mode: str) -> dict:
    """Means over one root's processes."""
    if mode == "norm":
        first = mine[0]["norm"]
        return {"processes": len(mine),
                **{f"{r['name']} {r['site']} {r['dtype']} ms": fmean(
                    m["norm"]["rows"][i]["ms"] for m in mine)
                   for i, r in enumerate(first["rows"])},
                **{f"{key} ms": fmean(m["norm"]["sums"][key]["ms"]
                                      for m in mine)
                   for key in first["sums"]},
                **{f"{key} pass ms": fmean(m["passes"][key] for m in mine)
                   for key in mine[0]["passes"]}}
    if mode == "maxpool":
        sums = mine[0]["maxpool"]["sums"]
        return {"processes": len(mine),
                **{f"{mode}_step_ms": fmean(r["steps"][mode]["step_ms"]
                                            for r in mine)
                   for mode in ("tie", "argmax")},
                **{f"{key} sum_ms": fmean(r["maxpool"]["sums"][key]["ms"]
                                          for r in mine) for key in sums},
                **{f"{key} sum_bound_ms": sums[key]["bound_ms"]
                   for key in sums}}
    return {"processes": len(mine),
            "lm_step_ms": fmean(r["lm_step_ms"] for r in mine),
            **{f"{name}_ms": fmean(r["kernels"][name]["ms"] for r in mine)
               for name in STEPS},
            **{f"avg_pool_fwd_{path}_ms": fmean(
                r["avg_pool_fwd"][path]["ms"] for r in mine)
               for path in ("train", "serve")}}


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        run = {"maxpool": one_maxpool, "norm": one_norm}.get(argv[1], one)
        print(json.dumps(run(argv[2])), flush=True)
        return 0
    mode = argv[0][2:] if argv and argv[0] in ("--maxpool", "--norm") \
        else "default"
    roots = argv if mode == "default" else argv[1:]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available", file=sys.stderr)
        return 2
    runs = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", mode, root], capture_output=True,
                              text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"chip_ab: {root} exited {proc.returncode}", file=sys.stderr)
            return 1
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("{")][-1]
        runs.append(json.loads(line))
        print(json.dumps({k: v for k, v in runs[-1].items()
                          if k != "lm_losses"}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    summary = {}
    for root in dict.fromkeys(r["root"] for r in runs):
        summary[root] = _summary([r for r in runs if r["root"] == root],
                                 mode)
    print(card, flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
