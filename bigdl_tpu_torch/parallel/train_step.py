"""The training and evaluation steps on one device, ported from
``bigdl_tpu/parallel/train_step.py`` (``TrainStep`` ``:103-160``, its
``loss_fn`` and step ``:467-717``, ``bf16_truncate`` ``:78-85`` and
``EvalStep`` ``:1312-1366``).

One step: cast the f32 master parameters and a floating input to
``compute_dtype`` where the JAX ``loss_fn`` casts them, run the model in
training mode (``torch.func.functional_call`` binds the cast
parameters; batch-norm buffers move in place), take the criterion, add
the regularizers' losses of the masters, backpropagate through the casts
so the gradients land on the f32 masters, run the gradient legs in the
JAX order (frozen -> zero, x scale, bf16 truncation, value clipping,
global L2 ``max_norm``), and let the optimization method update the
masters in place.  Under a 16-bit ``compute_dtype`` the criterion takes
the model's output cast to f32, so the loss is an f32 value where the
JAX step returns it rounded to bf16 (within one bf16 step of it); the
gradient it sends back is the same bf16 tensor.

``health_probe`` and ``skip_nonfinite`` read nothing on the host: the
health vector stays a device tensor, and a non-finite step is undone on
the device by selecting the state saved before it (parameters,
optimizer state with its counters, batch-norm buffers).

Not ported yet: the mesh and ``parameter_sync``, remat, sparse capture,
``grad_fault`` and ``run_scan``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from bigdl_tpu_torch.device import resolve_device, strict_f32
from bigdl_tpu_torch.nn.layers.normalization import dropout_generator
from bigdl_tpu_torch.nn.module import param_meta, parameters

__all__ = ["TrainStep", "EvalStep", "bf16_truncate"]


def bf16_truncate(x: torch.Tensor) -> torch.Tensor:
    """Keep the top 16 bits of each f32 value (bfloat16 rounded toward
    zero, the reference's ``FP16CompressedTensor.scala:272``), as an f32
    tensor; other dtypes pass through.  A mask on the bit pattern:
    ``.to(torch.bfloat16)`` rounds to nearest and is not the same."""
    if x.dtype != torch.float32:
        return x
    return torch.bitwise_and(x.view(torch.int32), -65536).view(torch.float32)


def _clone_state(state):
    """A copy of an optimizer state: tensors cloned, dicts of tensors
    copied, the rest kept."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, dict):
        return {k: _clone_state(v) for k, v in state.items()}
    return state


def _keep(ok: torch.Tensor, new, old):
    """``new`` where ``ok`` else ``old``, over an optimizer state; a
    tensor is overwritten in place, so the state's dicts keep their
    tensors."""
    if isinstance(new, torch.Tensor):
        new.copy_(torch.where(ok, new, old))
        return new
    if isinstance(new, dict):
        return {k: _keep(ok, v, old[k]) for k, v in new.items()}
    return new


class TrainStep:
    """Forward, loss, backward and update of ``model`` on one device.

    The model moves to ``device`` (``cuda`` unless the caller passes
    ``"cpu"``); its parameters are the f32 masters.  On the card, TF32
    is switched off for convolutions and matmuls, so that f32 means f32.
    Dropout masks come from the step's own ``generator`` (a
    ``torch.Generator`` on the device, seeded with 0) unless :meth:`run`
    is given one.

    ``gradient_compression``: None or ``"bf16"`` (:func:`bf16_truncate`
    on every gradient).  ``gradient_clipping``: ``(lo, hi)`` value
    clipping.  ``max_norm``: scale the gradients down to this global L2
    norm.  ``health_probe``: after each update, :attr:`last_health` holds
    the f32 device vector of the JAX probe (``PROBE_FIELDS``): the L2
    norms of the gradients after the legs, of the parameters before the
    update and of the update, then the non-finite counts of the
    gradients and of the new parameters.  ``skip_nonfinite``: a step
    whose gradients, new parameters or loss are not all finite leaves
    the parameters, the optimizer state and the batch-norm buffers as
    they were; the optimizer's counters then live on the device.
    Per-layer ``freeze``, ``scale_w``/``scale_b`` and regularizers are
    read from the model when the step is built."""

    def __init__(self, model: torch.nn.Module, criterion, optim_method,
                 compute_dtype: Optional[torch.dtype] = None, device=None,
                 gradient_compression: Optional[str] = None,
                 gradient_clipping: Optional[Tuple[float, float]] = None,
                 max_norm: Optional[float] = None,
                 health_probe: bool = False, skip_nonfinite: bool = False):
        if gradient_compression not in (None, "bf16"):
            raise ValueError(f"unknown gradient_compression "
                             f"{gradient_compression!r} (None | 'bf16')")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            strict_f32()
        self.model = model.to(self.device)
        self.criterion = criterion
        self.optim = optim_method
        self.compute_dtype = compute_dtype
        self.gradient_compression = gradient_compression
        self.gradient_clipping = gradient_clipping
        self.max_norm = max_norm
        self.health_probe = health_probe
        self.skip_nonfinite = skip_nonfinite
        self.params = parameters(self.model)
        self.buffers = dict(self.model.named_buffers())
        self._meta = param_meta(self.model)
        self.opt_state = optim_method.init_state(self.params)
        if skip_nonfinite:
            # a skipped step holds the counters back without the host
            # learning of it: they live on the device
            for k in ("neval", "epoch"):
                self.opt_state[k] = torch.tensor(
                    self.opt_state[k], dtype=torch.int32, device=self.device)
        self.generator = torch.Generator(self.device).manual_seed(0)
        self.last_health: Optional[torch.Tensor] = None
        self._loss: Optional[torch.Tensor] = None
        self._saved_buffers: Optional[Dict[str, torch.Tensor]] = None

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
        if self.skip_nonfinite:
            # the forward moves the batch-norm buffers in place
            self._saved_buffers = {k: b.clone()
                                   for k, b in self.buffers.items()}
        self.model.train()
        with dropout_generator(generator or self.generator):
            out = torch.func.functional_call(self.model, call, (x,))
        if cdt is not None and out.is_floating_point():
            # the criterion reduces in f32, as jnp.mean does inside, but
            # keeps the f32 result: a bf16 loss near ln(1000) moves in
            # steps of 2^-5 and hides a fall smaller than that
            out = out.float()
        loss = self.criterion.forward(out, y)
        self._loss = loss.detach()
        return loss

    def grads(self, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
        """f32 gradients of the masters, in ``state_dict`` key order, of
        ``loss`` plus the regularizers' losses of the unfrozen masters
        (``loss_fn`` of the JAX step)."""
        total = loss
        for k, (_, frozen, reg) in self._meta.items():
            if reg is not None and not frozen:
                total = total + reg.loss(self.params[k])
        gs = torch.autograd.grad(total, list(self.params.values()))
        return {k: g.float() for k, g in zip(self.params, gs)}

    @torch.no_grad()
    def _legs(self, grads: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """The gradient legs in the JAX order (``:595-637``)."""
        out = {}
        for k, g in grads.items():
            scale, frozen, _ = self._meta[k]
            if frozen:
                g = torch.zeros_like(g)
            elif scale != 1.0:
                g = g * scale
            out[k] = g
        if self.gradient_compression == "bf16":
            out = {k: bf16_truncate(g) for k, g in out.items()}
        gs = list(out.values())
        if self.gradient_clipping is not None:
            lo, hi = self.gradient_clipping
            gs = torch._foreach_clamp_max(torch._foreach_clamp_min(gs, lo),
                                          hi)
        if self.max_norm is not None:
            gn = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(gs)))
            factor = torch.clamp(self.max_norm / (gn + 1e-12), max=1.0)
            gs = torch._foreach_mul(gs, factor)
        return dict(zip(out, gs))

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        """The gradient legs and the optimizer update of the masters (in
        place); with ``health_probe`` or ``skip_nonfinite`` also the
        health vector of this step, and under ``skip_nonfinite`` the
        select that undoes a non-finite step.  The loss it judges is the
        one :meth:`loss` returned last."""
        grads = self._legs(grads)
        if not (self.health_probe or self.skip_nonfinite):
            self.opt_state = self.optim.update(grads, self.params,
                                               self.opt_state)
            return
        ps = list(self.params.values())
        old = [p.clone() for p in ps]
        saved_opt = _clone_state(self.opt_state) \
            if self.skip_nonfinite else None
        self.opt_state = self.optim.update(grads, self.params,
                                           self.opt_state)
        gs = list(grads.values())

        def sq(ts):
            return torch.stack(torch._foreach_norm(ts)).square().sum()

        def bad(ts):
            return torch.stack([(~torch.isfinite(t)).sum() for t in ts]).sum()

        gbad, pbad = bad(gs), bad(ps)
        norms = torch.stack([sq(gs), sq(old),
                             sq(torch._foreach_sub(ps, old))]).sqrt()
        self.last_health = torch.cat(
            [norms, torch.stack([gbad, pbad]).to(torch.float32)])
        if self.skip_nonfinite:
            ok = (gbad == 0) & (pbad == 0) & torch.isfinite(self._loss)
            for p, o in zip(ps, old):
                p.copy_(torch.where(ok, p, o))
            self.opt_state = _keep(ok, self.opt_state, saved_opt)
            for k, b in self.buffers.items():
                b.copy_(torch.where(ok, b, self._saved_buffers[k]))
            self._saved_buffers = None

    def run(self, x, y, generator: Optional[torch.Generator] = None
            ) -> float:
        """One training iteration; returns the loss (of the parameters
        before the update) as a Python float, which waits for the
        step."""
        loss = self.loss(x, y, generator)
        self.update(self.grads(loss))
        return float(loss.detach())


class EvalStep:
    """The evaluation-mode forward of ``model`` on one device
    (``EvalStep`` of the JAX package, ``:1312-1366``): parameters and
    buffers cast to ``compute_dtype`` when it is set (the input keeps
    its dtype, so each layer casts its weights back to the input's), and
    floating outputs returned in f32.  The model's own mode is left as
    it was."""

    def __init__(self, model: torch.nn.Module,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            strict_f32()
        self.model = model.to(self.device)
        self.compute_dtype = compute_dtype

    @torch.no_grad()
    def run(self, x) -> Any:
        cdt = self.compute_dtype
        state = dict(self.model.state_dict())
        if cdt is not None:
            state = {k: v.to(cdt) if v.is_floating_point() else v
                     for k, v in state.items()}
        x = torch.as_tensor(x).to(self.device)
        was_training = self.model.training
        self.model.eval()
        try:
            out = torch.func.functional_call(self.model, state, (x,))
        finally:
            self.model.train(was_training)
        if cdt is not None:
            out = torch.utils._pytree.tree_map(
                lambda a: a.float() if isinstance(a, torch.Tensor)
                and a.is_floating_point() else a, out)
        return out
