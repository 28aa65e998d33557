"""Command-line entry point of the port (ported from
``bigdl_tpu/models/cli.py``; only ``serve`` so far).

    python -m bigdl_tpu_torch.models.cli serve --model inception_v1 \\
        --port 0 -b 8 --buckets 1,2,4,8 --max-wait-ms 2 --bf16

The ready line prints after every bucket is warm; SIGTERM drains
gracefully and prints ``drained: ...``.  Runs on ``cuda`` unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

__all__ = ["main", "cmd_serve"]


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
