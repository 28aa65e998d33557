"""Weights across packages: the JAX package's ``state_dict`` (as numpy)
into the port's, and the port's back out as numpy.

Both packages name every parameter by the same module path
(``0.0.weight``) and keep the same layouts (OIHW convolution weights,
``[out, in]`` linear weights), so a conversion is a checked copy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["from_jax_state", "to_numpy_state"]


def from_jax_state(state: Dict[str, np.ndarray], device,
                   model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` on ``device`` for ``model`` from a JAX
    ``state_dict``.  The key sets must be equal and every shape must
    match the model's; any mismatch raises ``ValueError`` naming all of
    them at once.  Values keep their dtype."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    shapes = sorted(f"{k}: {tuple(np.shape(state[k]))} vs {tuple(own[k].shape)}"
                    for k in set(own) & set(state)
                    if tuple(np.shape(state[k])) != tuple(own[k].shape))
    if missing or unexpected or shapes:
        raise ValueError(f"JAX state does not fit {type(model).__name__}: "
                         f"missing {missing}, unexpected {unexpected}, "
                         f"shape mismatches {shapes}")
    # np.array copies: JAX arrays are read-only and torch wants writable
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in state.items()}


def to_numpy_state(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """``{path: ndarray}`` of ``model``'s parameters and buffers, on the
    host, in ``state_dict`` order: the reverse of :func:`from_jax_state`,
    in the form the JAX package's ``load_state_dict`` takes."""
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
