"""Core module system, ported from ``bigdl_tpu/nn/module.py``.

``Module`` is a ``torch.nn.Module`` that keeps the BigDL surface the
models are written against: ``set_name``, ``evaluate``/``training_mode``,
and ``Container.add`` registering children under ``"0"``, ``"1"``, ...
so that ``state_dict`` keys equal the JAX package's (``0.0.weight``,
``0.4.bias``) and weights cross by key.  ``backward`` comes from
autograd, as the JAX package derives it from ``jax.vjp``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

__all__ = ["Module", "Container", "Sequential", "state_dict",
           "parameters", "load_state_dict"]


class Module(torch.nn.Module):
    """Base class of every layer and container."""

    def __init__(self):
        super().__init__()
        self._bigdl_name = None

    def set_name(self, name: str) -> "Module":
        self._bigdl_name = name
        return self

    def training_mode(self) -> "Module":
        return self.train(True)

    def evaluate(self) -> "Module":
        return self.train(False)


class Container(Module):
    """Base of composite modules (``nn/Container.scala:40``): children
    are registered under their position, ``"0"``, ``"1"``, ..."""

    def __init__(self, *modules: Module):
        super().__init__()
        for m in modules:
            self.add(m)

    def add(self, module: Module) -> "Container":
        self.add_module(str(len(self._modules)), module)
        return self

    def get(self, i: int) -> Module:
        return list(self._modules.values())[i]


class Sequential(Container):
    """Chain container (``nn/Sequential.scala:30``)."""

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x


def state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` of parameters and buffers, detached."""
    return dict(module.state_dict())


def parameters(module: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    """``{path: parameter}`` of the live parameters, in ``state_dict``
    key order (the JAX package's ``state_dict(model, kind="param")``)."""
    own = dict(module.named_parameters())
    return {k: own[k] for k in module.state_dict(keep_vars=True) if k in own}


def load_state_dict(module: torch.nn.Module, state: Dict[str, Any],
                    strict: bool = True) -> None:
    """Copy ``{path: tensor}`` into the module tree, in place.

    Under ``strict=True`` every missing and every unexpected key is
    reported in ONE ``KeyError`` (``bigdl_tpu/nn/module.py:599-625``);
    a shape mismatch raises ``ValueError`` naming every offending key."""
    own = module.state_dict(keep_vars=True)
    unexpected = sorted(k for k in state if k not in own)
    if strict:
        missing = sorted(set(own) - set(state))
        if missing or unexpected:
            parts = []
            if missing:
                parts.append(f"missing keys in state: {missing}")
            if unexpected:
                parts.append(
                    f"no parameter/buffer in {type(module).__name__} for "
                    f"unexpected keys: {unexpected}")
            raise KeyError("; ".join(parts))
    bad = sorted(f"{k}: {tuple(v.shape)} vs {tuple(own[k].shape)}"
                 for k, v in state.items()
                 if k in own and tuple(v.shape) != tuple(own[k].shape))
    if bad:
        raise ValueError(f"shape mismatch in state: {bad}")
    with torch.no_grad():
        for k, v in state.items():
            if k in own:
                own[k].copy_(torch.as_tensor(v))
