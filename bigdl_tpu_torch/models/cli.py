"""Command-line entry point of the port (ported from
``bigdl_tpu/models/cli.py``; ``train``, ``test``, ``perf`` and ``serve``
so far).

    python -m bigdl_tpu_torch.models.cli train --model resnet -b 128 \\
        --max-epoch 2 --checkpoint ./ckpt
    python -m bigdl_tpu_torch.models.cli test --model resnet \\
        --checkpoint ./ckpt
    python -m bigdl_tpu_torch.models.cli perf --model inception_v1 -b 256
    python -m bigdl_tpu_torch.models.cli perf --model inception_v1 -b 256 \\
        --pool-kernel on
    python -m bigdl_tpu_torch.models.cli perf --model inception_v2 -b 256
    python -m bigdl_tpu_torch.models.cli perf --model resnet50 -b 128
    python -m bigdl_tpu_torch.models.cli perf --model transformer -b 32
    python -m bigdl_tpu_torch.models.cli serve --model inception_v1 \\
        --port 0 -b 8 --buckets 1,2,4,8 --max-wait-ms 2 --bf16

``train`` runs the ``LocalOptimizer`` loop (validation every epoch,
checkpoints every epoch under ``--checkpoint``, resume from the newest
verified one there); ``test`` evaluates the newest ``model.N`` under
``--checkpoint`` or a ``--model-snapshot``.  Both read CIFAR-10 (MNIST
for ``lenet``) from ``--folder`` and fall back to synthetic data.
``perf`` trains on one fixed synthetic batch (warm-up steps, then timed
steps) and ends with ``<model>: X records/sec (batch B, I iters, S s)``.
``serve`` prints its ready line after every bucket is warm; SIGTERM
drains gracefully and prints ``drained: ...``.  Every command runs on
``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

from bigdl_tpu_torch.device import resolve_device

__all__ = ["main", "cmd_train", "cmd_test", "cmd_perf", "cmd_serve"]


#: token models: their news20 data path is not ported yet
SEQ_MODELS = ("lstm", "transformer")


def _load_data(model_name: str, folder: Optional[str], split: str,
               num_classes: int = 0):
    """Image data as the JAX ``_load_data`` makes it (``:116-133``):
    MNIST for ``lenet`` / ``autoencoder``, normalized by its mean and
    standard deviation, else CIFAR-10 scaled to [0, 1] and standardized
    per channel over the split, as [N, C, H, W] f32 and int64 labels."""
    import numpy as np

    from bigdl_tpu_torch.dataset import datasets

    if model_name in SEQ_MODELS:
        raise SystemExit(f"train/test of {model_name!r}: the news20 token "
                         f"pipeline is not ported yet")
    if model_name in ("lenet", "autoencoder"):
        imgs, labels = datasets.load_mnist(folder, split)
        x = ((imgs.astype(np.float32) / 255.0) - 0.1307) / 0.3081
        x = x.reshape(-1, 1, 28, 28)
    else:
        imgs, labels = datasets.load_cifar10(folder, split)
        x = imgs.astype(np.float32) / 255.0
        x = (x - x.mean((0, 1, 2))) / (x.std((0, 1, 2)) + 1e-7)
        x = x.transpose(0, 3, 1, 2)
    return x, labels


def _samples(x, y):
    from bigdl_tpu_torch.dataset.sample import Sample

    return [Sample(x[i], y[i]) for i in range(len(x))]


def _build(name: str, num_classes: int, seed: int):
    import torch

    from bigdl_tpu_torch.models import registry

    if name not in registry.MODELS:
        raise SystemExit(f"unknown --model {name!r}; choose from "
                         f"{registry.model_names()}")
    return registry.build_model(name, num_classes,
                                generator=torch.Generator().manual_seed(seed))


def cmd_train(args) -> None:
    """The JAX ``cmd_train`` on one device: ``LocalOptimizer`` over the
    training split with SGD (``--learning-rate``, ``--momentum``,
    ``--weight-decay``), ``ClassNLLCriterion``, ``--max-epoch`` epochs,
    Top1/Top5 validation on the test split every epoch, checkpoints
    every epoch under ``--checkpoint`` (a run resumes from the newest
    verified checkpoint there), then the ``Evaluator``'s final results.
    ``--seed`` seeds the weights, the epoch order and the step seeds.
    Before the final lines it prints one JSON line: every iteration's
    loss, the last validation, the kernel launches of the training and
    validation passes, and the loop's per-stage times."""
    import torch

    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from bigdl_tpu_torch.utils import serializer

    device = resolve_device(args.device)
    x, y = _load_data(args.model, args.folder, "train", args.num_classes)
    xt, yt = _load_data(args.model, args.folder, "test", args.num_classes)
    model = _build(args.model, args.num_classes, args.seed)
    if args.model_snapshot:
        model = serializer.load_module(args.model_snapshot)
    samples, val_samples = _samples(x, y), _samples(xt, yt)
    val_methods = [optim.Top1Accuracy(), optim.Top5Accuracy()]
    method = optim.SGD(learning_rate=args.learning_rate,
                       momentum=args.momentum,
                       weight_decay=args.weight_decay)
    if args.state_snapshot:
        method = serializer.load_optim_method(args.state_snapshot)
    o = optim.LocalOptimizer(
        model, samples, ClassNLLCriterion(), batch_size=args.batch_size,
        end_trigger=optim.Trigger.max_epoch(args.max_epoch), device=device,
        seed=args.seed)
    o.set_optim_method(method)
    o.set_validation(optim.Trigger.every_epoch(), val_samples, val_methods,
                     batch_size=args.batch_size)
    if args.checkpoint:
        o.set_checkpoint(args.checkpoint, optim.Trigger.every_epoch())
    reset_kernel_launches()
    t0 = time.perf_counter()
    trained = o.optimize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    m = o.metrics
    stages = {k: [m.total(k), m.count(k)] for k in m.stages()}
    steady = m.count("iteration time")
    val_batches = -(-len(val_samples) // args.batch_size)
    print(json.dumps({
        "train": args.model, "batch": args.batch_size,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "neval": o.state["neval"], "epoch": o.state["epoch"],
        "resumed_from": o.state.get("_resumed_from"),
        "checkpoint_dir": o._ckpt_dir,
        "iterations": [[n, e, v] for n, e, v in o.history],
        "validation": {str(k): {"value": r.value, "count": r.count}
                       for k, r in o.last_validation},
        "launches": launches, "steps": len(o.history),
        "val_batches": m.count("validation time") * val_batches,
        "records_per_s": (args.batch_size * steady
                          / max(m.total("iteration time"), 1e-9)),
        "stages": stages, "wall_s": wall}), flush=True)
    res = optim.Evaluator(trained, batch_size=args.batch_size,
                          device=device).evaluate(val_samples, val_methods)
    for r, meth in res:
        print(f"final {meth}: {r}", flush=True)


def _newest_model(root: str) -> str:
    import glob
    import re

    cands = [p for p in glob.glob(os.path.join(root, "**", "model.*"),
                                  recursive=True)
             if re.fullmatch(r"model\.\d+", os.path.basename(p))]
    if not cands:
        raise SystemExit(f"no model.* snapshot under {root}")
    return max(cands, key=os.path.getmtime)


def cmd_test(args) -> None:
    """Top1/Top5 of the newest ``model.N`` under ``--checkpoint`` (or of
    ``--model-snapshot``) on the test split, printed as the JAX
    ``cmd_test`` prints them."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.utils import serializer

    device = resolve_device(args.device)
    if args.model_snapshot:
        path = args.model_snapshot
    elif args.checkpoint:
        path = _newest_model(args.checkpoint)
    else:
        raise SystemExit("test needs --model-snapshot or --checkpoint")
    model = serializer.load_module(path)
    x, y = _load_data(args.model, args.folder, "test", args.num_classes)
    res = optim.Evaluator(model, batch_size=args.batch_size,
                          device=device).evaluate(
        _samples(x, y), [optim.Top1Accuracy(), optim.Top5Accuracy()])
    for r, m in res:
        print(f"{m}: {r}", flush=True)


def cmd_perf(args) -> None:
    """The LocalOptimizerPerf protocol (``cmd_perf`` of the JAX
    package): synthetic data from ``np.random.default_rng(0)``, SGD(0.01,
    momentum 0.9), bf16 compute unless ``--no-bf16``, warm-up steps, then
    timed steps.  Image models train on normal pixels and class labels
    with ``ClassNLLCriterion``; the transformer LM on [b, 128] tokens and
    next-token targets below ``num_classes`` (its vocab, 256 by default)
    with ``TimeDistributedCriterion(ClassNLLCriterion(),
    size_average=True)``.  ``--pool-kernel on`` sets ``argmax_index`` on
    every max pool of the model (the JAX ``cmd_perf`` reads
    ``BIGDL_POOL_KERNEL`` from the environment instead).  Before the
    records/sec line it prints one JSON line: every step's loss, the
    kernel launches of all steps, the timed step time and the peak
    device memory.  The timed window synchronises only at its two
    ends."""
    import numpy as np
    import torch

    from bigdl_tpu_torch.models import registry
    from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                              TimeDistributedCriterion)
    from bigdl_tpu_torch.nn.layers.pooling import SpatialMaxPooling
    from bigdl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import TrainStep

    device = resolve_device(args.device)
    spec = registry.input_spec(args.model, args.batch_size)
    tokens = spec.dtype.startswith("int")
    num_classes = args.num_classes or (256 if tokens else 1000)
    model = registry.build_model(args.model, num_classes,
                                 generator=torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, SpatialMaxPooling):
            m.use_argmax_index(args.pool_kernel == "on")
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
        "pool_kernel": args.pool_kernel,
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

    def common(sp, batch: int = 64):
        sp.add_argument("--model", default="resnet",
                        help="a registered model (the JAX default, lenet, "
                             "is not ported yet)")
        sp.add_argument("-f", "--folder", default=None,
                        help="dataset folder (synthetic data when absent)")
        sp.add_argument("-b", "--batch-size", type=int, default=batch)
        sp.add_argument("--num-classes", type=int, default=0)
        sp.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")

    t = sub.add_parser("train", help="train a zoo model")
    common(t)
    t.add_argument("--learning-rate", type=float, default=0.05)
    t.add_argument("--momentum", type=float, default=0.9)
    t.add_argument("--weight-decay", type=float, default=0.0)
    t.add_argument("--max-epoch", type=int, default=2)
    t.add_argument("--checkpoint", default=None)
    t.add_argument("--model-snapshot", default=None,
                   help="resume model from snapshot")
    t.add_argument("--state-snapshot", default=None,
                   help="resume optim method from snapshot")
    t.add_argument("--seed", type=int, default=42)
    t.set_defaults(fn=cmd_train)
    te = sub.add_parser("test", help="evaluate a checkpointed model")
    common(te)
    te.add_argument("--checkpoint", default=None)
    te.add_argument("--model-snapshot", default=None)
    te.set_defaults(fn=cmd_test)
    pf = sub.add_parser("perf", help="synthetic-data throughput harness")
    pf.add_argument("--model", default="inception_v1",
                    help="inception_v1, inception_v2 or resnet50 "
                         "(3x224x224 images; v2 is BN-Inception, whose "
                         "eight average pools run the average-pool "
                         "kernels, as ResNet-50's head does), resnet "
                         "(ResNet-20, 3x32x32) or transformer "
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
    pf.add_argument("--pool-kernel", choices=("off", "on"), default="off",
                    help="on: every max pool takes the argmax-index path "
                         "(first-maximum gradient from a saved int8 index, "
                         "CUDA kernels; bf16 or f16 input only, f32 keeps "
                         "the default path). The JAX cmd_perf reads this "
                         "switch from BIGDL_POOL_KERNEL instead, whose "
                         "default auto means off")
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
