"""Module and optim-method persistence, ported from
``bigdl_tpu/utils/serializer.py``: BTPU files (``utils/module_format.py``;
no pickle anywhere) for modules and optim methods, and ``.npz`` files of
bare ``{path: array}`` maps for weights alone.  An ``.npz`` that
:func:`save_state_dict` writes from a port model loads into the JAX
package's model of the same build through its ``load_state_dict_file``,
and back (bf16 tensors are written as f32: numpy has no bf16)."""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from bigdl_tpu_torch.utils import file as File
from bigdl_tpu_torch.utils.module_format import (SerializationError, dumps,
                                                 loads)

__all__ = [
    "save_module", "load_module", "save_optim_method", "load_optim_method",
    "save_state_dict", "load_state_dict_file", "SerializationError",
]


def save_module(module, path: str, overwrite: bool = False):
    File.save(dumps(module, kind="module"), path, overwrite)


def load_module(path: str):
    """The module saved at ``path``, on the CPU."""
    return loads(File.load(path), kind="module")


def save_optim_method(method, path: str, overwrite: bool = False):
    File.save(dumps(method, kind="optim"), path, overwrite)


def load_optim_method(path: str):
    return loads(File.load(path), kind="optim")


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def save_state_dict(state: Dict[str, Any], path: str,
                    overwrite: bool = False):
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)
    np.savez(path, **{k: _numpy(v) for k, v in state.items()})


def load_state_dict_file(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
