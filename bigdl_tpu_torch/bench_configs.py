"""The benchmark configurations the port can run, and the train step each
one benches (the port of ``bench.py::_configs`` and ``make_step``,
``bench.py:128-219``, for ``inception_v1_imagenet``,
``resnet50_imagenet`` and ``transformer_lm``).

Each configuration is the JAX one: the same model arguments, the same
batch made from ``np.random.default_rng(0)`` (normal pixels and class
labels; uniform tokens with a target per position), the same criterion
and default batch, SGD(0.01, momentum 0.9) and bf16 compute over f32
masters.  Weights come from a ``torch.Generator`` seeded with 0.
``optimize_for_tpu`` is not carried over: the transformer has no
convolution for it to rewrite, and the port keeps the CNNs in NCHW.
Nothing of ``bench.py``'s timing, MFU or result banking is here.

    from bigdl_tpu_torch.bench_configs import make_step
    step, x, y = make_step("transformer_lm")      # batch 32 on cuda
    loss = step.loss(x, y); step.update(step.grads(loss))
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["Config", "configs", "make_step"]


class Config(NamedTuple):
    #: generator -> model
    build_model: Callable[[torch.Generator], torch.nn.Module]
    #: (rng, batch) -> (x, y) as numpy arrays
    build_batch: Callable[[np.random.Generator, int],
                          Tuple[np.ndarray, np.ndarray]]
    #: () -> criterion
    criterion: Callable[[], object]
    default_batch: int


def _img(rng, batch, c, h, w, classes):
    x = rng.normal(size=(batch, c, h, w)).astype(np.float32)
    return x, rng.integers(0, classes, batch)


def _tokens(rng, batch, seq, vocab, classes):
    """Language-model batches: uniform tokens and a target token per
    position (``tokens(..., seq_targets=True)`` of ``bench.py``)."""
    x = rng.integers(0, vocab, (batch, seq), dtype=np.int32)
    return x, rng.integers(0, classes, (batch, seq), dtype=np.int32)


def configs() -> Dict[str, Config]:
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import build_inception_v1, build_resnet
    from bigdl_tpu_torch.models.transformer import build_transformer_lm

    return {
        "inception_v1_imagenet": Config(
            lambda g: build_inception_v1(1000, generator=g),
            lambda rng, b: _img(rng, b, 3, 224, 224, 1000),
            nn.ClassNLLCriterion, 256),
        "resnet50_imagenet": Config(
            lambda g: build_resnet(50, 1000, generator=g),
            lambda rng, b: _img(rng, b, 3, 224, 224, 1000),
            nn.ClassNLLCriterion, 128),
        # decoder-only LM through the flash-attention kernels:
        # [batch, 512] tokens -> per-position next-token NLL
        "transformer_lm": Config(
            lambda g: build_transformer_lm(32000, num_layers=6,
                                           embed_dim=512, num_heads=8,
                                           max_len=512, generator=g),
            lambda rng, b: _tokens(rng, b, 512, 32000, 32000),
            lambda: nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                                size_average=True),
            32),
    }


def make_step(name: str, batch: Optional[int] = None, device=None):
    """The train step a configuration benches and its fixed batch:
    ``(step, x, y)``, ``x`` and ``y`` on the step's device (``cuda``
    unless ``device="cpu"``)."""
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import TrainStep

    table = configs()
    if name not in table:
        raise KeyError(f"unknown config {name!r}; choose from "
                       f"{sorted(table)}")
    cfg = table[name]
    model = cfg.build_model(torch.Generator().manual_seed(0))
    step = TrainStep(model, cfg.criterion(),
                     SGD(learning_rate=0.01, momentum=0.9),
                     compute_dtype=torch.bfloat16, device=device)
    x, y = cfg.build_batch(np.random.default_rng(0),
                           batch or cfg.default_batch)
    return (step, torch.from_numpy(x).to(step.device),
            torch.from_numpy(y).to(step.device))
