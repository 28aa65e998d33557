"""Batch buckets: the fixed set of padded batch shapes a served model
runs at (ported from ``bigdl_tpu/serving/buckets.py``; sequence buckets
for token models are not ported yet).

Every arrival of 1..max_batch rows pads up to the next bucket, powers of
two by default, so the worst-case padding waste is bounded at 50% and
the executor only ever meets shapes it warmed at startup.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["BucketPolicy", "pow2_buckets"]


def pow2_buckets(max_batch: int) -> Tuple[int, ...]:
    """1, 2, 4, ... up to (and including) ``max_batch``."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class BucketPolicy:
    """The closed set of padded batch shapes of one served model.

    ``batch_buckets``: ascending row-count buckets (default: powers of
    two up to ``max_batch``).  Padded rows are zeros, sliced off the
    output."""

    def __init__(self, max_batch: int = 32,
                 batch_buckets: Optional[Sequence[int]] = None):
        buckets = tuple(sorted(set(batch_buckets or pow2_buckets(max_batch))))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"bad batch buckets {buckets}")
        self.batch_buckets = buckets
        self.max_batch = buckets[-1]

    def batch_bucket(self, n: int) -> int:
        """Smallest bucket >= n."""
        if n < 1:
            raise ValueError(f"batch of {n} rows")
        for b in self.batch_buckets:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} rows exceeds the largest bucket "
                         f"{self.max_batch}")

    def pad(self, x: np.ndarray, batch_bucket: int) -> np.ndarray:
        """Pad ``[n, ...]`` rows up to ``[batch_bucket, ...]``."""
        x = np.asarray(x)
        n = x.shape[0]
        if n > batch_bucket:
            raise ValueError(f"{n} rows > bucket {batch_bucket}")
        if n == batch_bucket:
            return x
        out = np.zeros((batch_bucket,) + x.shape[1:], dtype=x.dtype)
        out[:n] = x
        return out

    def __repr__(self):
        return f"BucketPolicy(batch={list(self.batch_buckets)})"
