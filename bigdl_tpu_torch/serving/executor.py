"""Bucketed inference over one model (ported from
``bigdl_tpu/serving/executor.py``).

The JAX executor AOT-compiles one executable per batch bucket.  PyTorch
runs eagerly, so its counterpart of a warm executable is one forward per
bucket at startup (``warmup``): it builds the CUDA kernels, loads the
cuDNN and cuBLAS kernels and sizes the allocator's pools before the
first request, so first-request latency is a dispatch.

``compute_dtype`` mirrors the JAX executor exactly: the STATE is cast to
it (``executor.py:123-127``), and the layers cast each weight back to
the input's dtype, so bf16 serving with f32 input computes in f32 on
bf16-rounded weights; activations stay f32.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device, strict_f32
from bigdl_tpu_torch.nn.module import state_dict
from bigdl_tpu_torch.serving.buckets import BucketPolicy

__all__ = ["BucketedExecutor"]


class BucketedExecutor:
    """Shape-bucketed inference over one model on one device.  The model
    object stays where it is; its state is copied to ``device`` (cast to
    ``compute_dtype``) and bound per call with
    ``torch.func.functional_call``."""

    def __init__(self, model: torch.nn.Module,
                 policy: Optional[BucketPolicy] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            strict_f32()
        self.model = model.eval()
        self.policy = policy or BucketPolicy()
        self.compute_dtype = compute_dtype
        self.warmup_s = 0.0
        self._warm = set()
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self._lock = threading.RLock()

    # -- state -------------------------------------------------------------
    def refresh_state(self) -> None:
        """Copy the model's parameters and buffers onto the device, floats
        cast to ``compute_dtype`` (round to nearest)."""
        cdt = self.compute_dtype
        state = {k: v.to(self.device,
                         cdt if cdt is not None and v.is_floating_point()
                         else v.dtype)
                 for k, v in state_dict(self.model).items()}
        with self._lock:
            self._state = state

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        with self._lock:
            if self._state is None:
                self.refresh_state()
            return self._state

    # -- the forward -------------------------------------------------------
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The served forward on a device tensor ``[bucket, ...]``."""
        with self._lock, torch.inference_mode():
            out = torch.func.functional_call(self.model, self.state, (x,))
        if self.compute_dtype is not None and out.is_floating_point():
            out = out.float()
        return out

    def warmup(self, sample_shape: Tuple[int, ...], dtype) -> float:
        """One forward per bucket for samples of ``sample_shape`` (no
        batch axis), synchronised.  Returns the wall seconds spent in
        all warmups so far; idempotent per bucket."""
        t0 = time.perf_counter()
        tdt = getattr(torch, np.dtype(dtype).name)
        for b in self.policy.batch_buckets:
            if b in self._warm:
                continue
            self.forward(torch.zeros((b,) + tuple(sample_shape), dtype=tdt,
                                     device=self.device))
            self._warm.add(b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmup_s += time.perf_counter() - t0
        return self.warmup_s

    def warm_buckets(self):
        return sorted(self._warm)

    def run(self, x: np.ndarray) -> np.ndarray:
        """Pad ``[n, ...]`` rows onto their bucket, run the forward, slice
        the padding back off.  Returns numpy ``[n, ...]``."""
        x = np.asarray(x)
        n = x.shape[0]
        bucket = self.policy.batch_bucket(n)
        xt = torch.from_numpy(self.policy.pad(x, bucket)).to(self.device)
        out = self.forward(xt).cpu().numpy()
        if bucket == 1 and (out.ndim == 0 or out.shape[0] != 1):
            # Torch-legacy batch-1 ambiguity (executor.py:390-399): a
            # reshape that auto-detects batch mode may drop the batch
            # axis of a [1, ...] input; callers always see [rows, ...]
            out = out[None]
        return out[:n]
