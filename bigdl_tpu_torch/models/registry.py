"""Model registry: model names to builders and canonical input specs
(ported from ``bigdl_tpu/models/registry.py``; only the models the port
has so far)."""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

__all__ = ["InputSpec", "ModelEntry", "MODELS", "LM_SEQ_LEN",
           "model_names", "build_model", "input_spec"]

#: the token models' sequence length, as the JAX package's data pipeline
LM_SEQ_LEN = 128


class InputSpec(NamedTuple):
    """A model's batched input: ``shape`` with the batch axis first."""
    shape: Tuple[int, ...]
    dtype: str


class ModelEntry(NamedTuple):
    #: (num_classes, generator) -> model (0 means the builder's default)
    build: Callable[[int, Optional[torch.Generator]], torch.nn.Module]
    #: per-sample feature shape and dtype
    sample: Tuple[int, ...]
    dtype: str


def _inception_v1(num_classes: int = 0,
                  generator: Optional[torch.Generator] = None):
    from bigdl_tpu_torch.models.inception import build_inception_v1

    return build_inception_v1(num_classes or 1000, generator=generator)


def _transformer(num_classes: int = 0,
                 generator: Optional[torch.Generator] = None):
    from bigdl_tpu_torch.models.transformer import build_transformer_lm

    return build_transformer_lm(vocab_size=num_classes or 256,
                                generator=generator)


MODELS: Dict[str, ModelEntry] = {
    "inception_v1": ModelEntry(_inception_v1, (3, 224, 224), "float32"),
    # [batch, 128] int tokens -> per-position log-probs over the vocab
    "transformer": ModelEntry(_transformer, (LM_SEQ_LEN,), "int32"),
}


def model_names():
    return sorted(MODELS)


def _entry(name: str) -> ModelEntry:
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; choose from {model_names()}")
    return MODELS[name]


def build_model(name: str, num_classes: int = 0,
                generator: Optional[torch.Generator] = None):
    return _entry(name).build(num_classes, generator)


def input_spec(name: str, batch: int = 2) -> InputSpec:
    entry = _entry(name)
    return InputSpec((batch,) + entry.sample, entry.dtype)
