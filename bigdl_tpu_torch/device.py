"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
When CUDA is required but absent they raise: nothing carries on on the
CPU silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "strict_f32"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``.  Raises
    RuntimeError for a CUDA device when no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' "
            "(or --device cpu) to run on the CPU")
    return dev


def strict_f32() -> None:
    """Make f32 mean f32 on the card: cuDNN convolutions default to TF32
    (about three decimal digits); matmuls are switched off too."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
