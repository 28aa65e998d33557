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
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from statistics import fmean

STEPS = {"flash_fwd": 6, "flash_dq": 6, "flash_dkv": 6}


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


def one(root: str) -> dict:
    """The measurements of one checkout, in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as c
    from bigdl_tpu_torch.bench_configs import make_step
    from bigdl_tpu_torch.device import strict_f32
    from bigdl_tpu_torch.ops import kernel_launches, reset_kernel_launches

    for mod in (c, sys.modules["bigdl_tpu_torch"]):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, "
                               f"not from {root}")
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


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available", file=sys.stderr)
        return 2
    runs = []
    for root in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True, text=True)
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
        mine = [r for r in runs if r["root"] == root]
        summary[root] = {
            "processes": len(mine),
            "lm_step_ms": fmean(r["lm_step_ms"] for r in mine),
            **{f"{name}_ms": fmean(r["kernels"][name]["ms"] for r in mine)
               for name in STEPS},
            **{f"avg_pool_fwd_{path}_ms": fmean(
                r["avg_pool_fwd"][path]["ms"] for r in mine)
               for path in ("train", "serve")}}
    print(card, flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
