"""The training step on one device, ported from
``bigdl_tpu/parallel/train_step.py`` ``TrainStep`` (``:103-160``, its
``loss_fn`` ``:467-495``).

One step: cast the f32 master parameters and a floating input to
``compute_dtype`` where the JAX ``loss_fn`` casts them, run the model in
training mode (``torch.func.functional_call`` binds the cast
parameters), take the criterion, backpropagate through the casts so the
gradients land on the f32 masters, and let the optimization method
update the masters in place.  Under a 16-bit ``compute_dtype`` the
criterion takes the model's output cast to f32, so the loss is an f32
value where the JAX step returns it rounded to bf16 (within one bf16
step of it); the gradient it sends back is the same bf16 tensor.

Not ported yet: the mesh and ``parameter_sync``, gradient compression
and ``bf16_truncate``, remat, the health probe, ``skip_nonfinite``,
sparse capture and ``run_scan``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from bigdl_tpu_torch.device import resolve_device, strict_f32
from bigdl_tpu_torch.nn.layers.normalization import dropout_generator
from bigdl_tpu_torch.nn.module import parameters

__all__ = ["TrainStep"]


class TrainStep:
    """Forward, loss, backward and update of ``model`` on one device.

    The model moves to ``device`` (``cuda`` unless the caller passes
    ``"cpu"``); its parameters are the f32 masters.  On the card, TF32
    is switched off for convolutions and matmuls, so that f32 means f32.
    Dropout masks come from the step's own ``generator`` (a
    ``torch.Generator`` on the device, seeded with 0) unless :meth:`run`
    is given one."""

    def __init__(self, model: torch.nn.Module, criterion, optim_method,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            strict_f32()
        self.model = model.to(self.device)
        self.criterion = criterion
        self.optim = optim_method
        self.compute_dtype = compute_dtype
        self.params = parameters(self.model)
        self.opt_state = optim_method.init_state(self.params)
        self.generator = torch.Generator(self.device).manual_seed(0)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def loss(self, x, y, generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        """The forward in training mode and the criterion, with the
        graph kept for :meth:`grads`."""
        x, y = self._tensor(x), self._tensor(y)
        cdt = self.compute_dtype
        call = self.params
        if cdt is not None:
            call = {k: p.to(cdt) for k, p in self.params.items()}
            if x.is_floating_point():
                x = x.to(cdt)
        self.model.train()
        with dropout_generator(generator or self.generator):
            out = torch.func.functional_call(self.model, call, (x,))
        if cdt is not None and out.is_floating_point():
            # the criterion reduces in f32, as jnp.mean does inside, but
            # keeps the f32 result: a bf16 loss near ln(1000) moves in
            # steps of 2^-5 and hides a fall smaller than that
            out = out.float()
        return self.criterion.forward(out, y)

    def grads(self, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
        """f32 gradients of the masters, in ``state_dict`` key order."""
        gs = torch.autograd.grad(loss, list(self.params.values()))
        return {k: g.float() for k, g in zip(self.params, gs)}

    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        self.opt_state = self.optim.update(grads, self.params,
                                           self.opt_state)

    def run(self, x, y, generator: Optional[torch.Generator] = None
            ) -> float:
        """One training iteration; returns the loss (of the parameters
        before the update) as a Python float, which waits for the
        step."""
        loss = self.loss(x, y, generator)
        self.update(self.grads(loss))
        return float(loss.detach())
