"""Command-line entry point of the port (ported from
``bigdl_tpu/models/cli.py``; ``perf`` and ``serve`` so far).

    python -m bigdl_tpu_torch.models.cli perf --model inception_v1 -b 256
    python -m bigdl_tpu_torch.models.cli perf --model transformer -b 32
    python -m bigdl_tpu_torch.models.cli serve --model inception_v1 \\
        --port 0 -b 8 --buckets 1,2,4,8 --max-wait-ms 2 --bf16

``perf`` trains on one fixed synthetic batch (warm-up steps, then timed
steps) and ends with ``<model>: X records/sec (batch B, I iters, S s)``.
``serve`` prints its ready line after every bucket is warm; SIGTERM
drains gracefully and prints ``drained: ...``.  Both run on ``cuda``
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

__all__ = ["main", "cmd_perf", "cmd_serve"]


def cmd_perf(args) -> None:
    """The LocalOptimizerPerf protocol (``cmd_perf`` of the JAX
    package): synthetic data from ``np.random.default_rng(0)``, SGD(0.01,
    momentum 0.9), bf16 compute unless ``--no-bf16``, warm-up steps, then
    timed steps.  Image models train on normal pixels and class labels
    with ``ClassNLLCriterion``; the transformer LM on [b, 128] tokens and
    next-token targets below ``num_classes`` (its vocab, 256 by default)
    with ``TimeDistributedCriterion(ClassNLLCriterion(),
    size_average=True)``.  Before the records/sec line it prints one JSON line:
    every step's loss, the kernel launches of all steps, the timed step
    time and the peak device memory.  The timed window synchronises only
    at its two ends."""
    import numpy as np
    import torch

    from bigdl_tpu_torch.device import resolve_device
    from bigdl_tpu_torch.models import registry
    from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                              TimeDistributedCriterion)
    from bigdl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import TrainStep

    device = resolve_device(args.device)
    spec = registry.input_spec(args.model, args.batch_size)
    tokens = spec.dtype.startswith("int")
    num_classes = args.num_classes or (256 if tokens else 1000)
    model = registry.build_model(args.model, num_classes,
                                 generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    criterion = ClassNLLCriterion()
    if tokens:
        # a language model: num_classes doubles as the vocab, and every
        # position has a next-token target
        x = rng.integers(0, num_classes, spec.shape, dtype=np.int32)
        y = rng.integers(0, num_classes, spec.shape)
        criterion = TimeDistributedCriterion(ClassNLLCriterion(),
                                             size_average=True)
    else:
        x = rng.normal(size=spec.shape).astype(np.float32)
        y = rng.integers(0, num_classes, args.batch_size)
    step = TrainStep(model, criterion,
                     SGD(learning_rate=0.01, momentum=0.9),
                     compute_dtype=torch.bfloat16 if args.bf16 else None,
                     device=device)
    x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def gen(seed):
        return torch.Generator(device).manual_seed(seed)

    def train(seed):
        # no host read inside the window: the loss stays on the device
        # until the end, as the JAX loop fetches nothing per step
        loss = step.loss(x, y, gen(seed))
        step.update(step.grads(loss))
        return loss.detach()

    reset_kernel_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses = [train(i) for i in range(args.warmup)]
    sync()
    t0 = time.perf_counter()
    losses += [train(100 + i) for i in range(args.iteration)]
    sync()
    wall = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    rate = args.batch_size * args.iteration / wall
    print(json.dumps({
        "perf": args.model, "batch": args.batch_size, "bf16": args.bf16,
        "warmup": args.warmup, "iters": args.iteration, "losses": losses,
        "launches": kernel_launches(),
        "step_ms": wall / max(args.iteration, 1) * 1e3,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")}), flush=True)
    print(f"{args.model}: {rate:.1f} records/sec "
          f"(batch {args.batch_size}, {args.iteration} iters, "
          f"{wall:.2f}s)", flush=True)


def cmd_serve(args) -> None:
    """HTTP frontend -> bounded queue -> continuous batcher -> bucketed
    executor, warmed before the ready line prints."""
    import torch

    from bigdl_tpu_torch.models import registry
    from bigdl_tpu_torch.serving import serve_model

    gen = torch.Generator().manual_seed(args.seed)
    model = registry.build_model(args.model, args.num_classes, generator=gen)
    spec = registry.input_spec(args.model, 1)
    buckets = [int(b) for b in args.buckets.split(",")] if args.buckets else None
    server = serve_model(
        model, spec, name=args.model, port=args.port,
        max_batch=args.batch_size, max_wait_ms=args.max_wait_ms,
        queue_limit=args.queue_limit, batch_buckets=buckets,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        device=args.device)
    print(f"serving {args.model} on port {server.port} "
          f"(buckets {list(server.executor.policy.batch_buckets)}, "
          f"warmup {server.executor.warmup_s:.1f}s)", flush=True)
    server.install_signal_handlers()
    server.wait()
    server.stop(drain=True)
    st = server.batcher
    print(f"drained: {st.requests} requests, {st.rejected} rejected, "
          f"{st.batches} batches", flush=True)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bigdl_tpu_torch.models.cli")
    sub = p.add_subparsers(dest="cmd", required=True)
    pf = sub.add_parser("perf", help="synthetic-data throughput harness")
    pf.add_argument("--model", default="inception_v1",
                    help="inception_v1 (3x224x224 images) or transformer "
                         "([b, 128] tokens; at 128 tokens its attention "
                         "runs the dense path on the card too, since "
                         "flash starts at 512)")
    pf.add_argument("-b", "--batch-size", type=int, default=64)
    pf.add_argument("-i", "--iteration", type=int, default=10)
    pf.add_argument("--warmup", type=int, default=3)
    pf.add_argument("--bf16", action="store_true", default=True)
    pf.add_argument("--no-bf16", dest="bf16", action="store_false")
    pf.add_argument("--num-classes", type=int, default=0)
    pf.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    pf.set_defaults(fn=cmd_perf)
    s = sub.add_parser("serve", help="serve a model over HTTP")
    s.add_argument("--model", default="inception_v1")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("-b", "--batch-size", type=int, default=32,
                   help="largest batch the batcher assembles")
    s.add_argument("--buckets", default=None,
                   help="comma-separated batch buckets (default: powers of "
                        "two up to -b)")
    s.add_argument("--max-wait-ms", type=float, default=5.0)
    s.add_argument("--queue-limit", type=int, default=256)
    s.add_argument("--bf16", action="store_true",
                   help="hold the weights in bf16; compute stays in the "
                        "input's dtype")
    s.add_argument("--seed", type=int, default=1)
    s.add_argument("--num-classes", type=int, default=0)
    s.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    s.set_defaults(fn=cmd_serve)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = _parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
