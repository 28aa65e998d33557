"""Core module system, ported from ``bigdl_tpu/nn/module.py``.

``Module`` is a ``torch.nn.Module`` that keeps the BigDL surface the
models are written against: ``set_name``, ``evaluate``/``training_mode``,
and ``Container.add`` registering children under ``"0"``, ``"1"``, ...
so that ``state_dict`` keys equal the JAX package's (``0.0.weight``,
``0.4.bias``) and weights cross by key.  ``backward`` comes from
autograd, as the JAX package derives it from ``jax.vjp``.

``freeze``/``unfreeze`` and the per-module gradient scales ``scale_w``
and ``scale_b`` (``bigdl_tpu/nn/module.py:87-90, 372-391``) are read by
the train step through :func:`param_meta`, with each layer's
``w_regularizer`` / ``b_regularizer``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

__all__ = ["Module", "Container", "Sequential", "Identity", "state_dict",
           "parameters", "load_state_dict", "param_meta"]


class Module(torch.nn.Module):
    """Base class of every layer and container."""

    def __init__(self):
        super().__init__()
        self._bigdl_name = None
        self._frozen = False
        self.scale_w = 1.0
        self.scale_b = 1.0

    def set_name(self, name: str) -> "Module":
        self._bigdl_name = name
        return self

    def training_mode(self) -> "Module":
        return self.train(True)

    def evaluate(self) -> "Module":
        return self.train(False)

    def freeze(self) -> "Module":
        """Freeze this module and every module under it: the train step
        zeroes their gradients and skips their regularizers."""
        for m in self.modules():
            m._frozen = True
        return self

    def unfreeze(self) -> "Module":
        for m in self.modules():
            m._frozen = False
        return self

    def is_frozen(self) -> bool:
        return self._frozen

    def set_scale_w(self, s: float) -> "Module":
        """Multiply this module's weight gradients by ``s`` (the train
        step's scale leg)."""
        self.scale_w = s
        return self

    def set_scale_b(self, s: float) -> "Module":
        self.scale_b = s
        return self


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


class Identity(Module):
    """Pass-through (``nn/Identity.scala``)."""

    def forward(self, x):
        return x


def state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` of parameters and buffers, detached."""
    return dict(module.state_dict())


def parameters(module: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    """``{path: parameter}`` of the live parameters, in ``state_dict``
    key order (the JAX package's ``state_dict(model, kind="param")``)."""
    own = dict(module.named_parameters())
    return {k: own[k] for k in module.state_dict(keep_vars=True) if k in own}


def param_meta(module: torch.nn.Module) -> Dict[str, Tuple[float, bool, Any]]:
    """``{path: (scale, frozen, regularizer)}`` of every parameter, in
    :func:`parameters` order (``_param_meta`` of
    ``bigdl_tpu/parallel/train_step.py:88-100``): a ``bias`` takes its
    module's ``scale_b`` and ``b_regularizer``, every other parameter
    ``scale_w`` and ``w_regularizer``; a disabled regularizer is None.
    Modules from outside the port count as scale 1, unfrozen and
    unregularized."""
    meta = {}
    for path in parameters(module):
        mod_path, _, leaf = path.rpartition(".")
        mod = module.get_submodule(mod_path)
        bias = leaf == "bias"
        scale = getattr(mod, "scale_b" if bias else "scale_w", 1.0)
        reg = getattr(mod, "b_regularizer" if bias else "w_regularizer",
                      None)
        if reg is not None and not getattr(reg, "is_enabled", True):
            reg = None
        meta[path] = (scale, getattr(mod, "_frozen", False), reg)
    return meta


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
