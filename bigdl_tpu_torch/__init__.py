"""bigdl_tpu_torch — the PyTorch/CUDA port of ``bigdl_tpu``.

A second package beside the JAX one: the same layer names, the same
``state_dict`` keys (weights cross by key, see ``utils/convert.py``),
and hand-written CUDA kernels for Hopper (``sm_90a``) where the JAX
package runs a Pallas kernel.  Entry points run on ``cuda`` unless the
caller asks for the CPU (``device="cpu"``); on the CPU every kernel
wrapper uses its plain PyTorch version.

This package imports ``torch`` and numpy, never ``jax`` and never a
module of ``bigdl_tpu``.
"""

from bigdl_tpu_torch.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
