"""Optimization methods and learning-rate schedules, ported from
``bigdl_tpu/optim/optim_method.py``: SGD, Adam, Adamax, Adagrad,
Adadelta, RMSprop and LBFGS; the schedules Default, Poly, Step,
MultiStep, EpochDecay, EpochStep, NaturalExp, Exponential, Warmup,
SequentialSchedule, EpochSchedule (with Regime) and Plateau.

The JAX package's functional core ``update(grads, params, state) ->
(new_params, new_state)`` becomes an in-place update of the f32 master
parameters under ``torch.no_grad()`` that returns the new state: the
parameters are not copied, which saves one model's worth of memory.
Each update runs on multi-tensor ``torch._foreach_*`` calls over all
parameters at once, a few launches a term instead of several a tensor,
with each method's arithmetic kept term for term (SGD's last term,
``p - lr * step``, is one fused multiply-add pass where ``lr`` is a
host number: a separate product would allocate a model's worth of
temporaries each step).  The state keeps the
JAX keys (``neval``, ``epoch``, ``velocity``, ``m``, ``v``, ...), its
moments as ``{path: tensor}`` dicts.

The counters ``neval`` and ``epoch`` are Python ints, so a schedule's
rate is computed on the host (in f32, as the JAX step computes it) and
no step waits for the device.  A train step that must keep the counters
on the device (``skip_nonfinite``, which holds them back after a
non-finite step without reading the device) passes them as 0-d device
tensors; the schedules and methods then compute their per-step scalars
there too.  ``LBFGS`` is host-side over a flat vector, as in the JAX
package, and not on the step path.

A method saves and loads as a BTPU file (``save``/``load``, through
``utils/serializer.py``); the ``Optimizer`` keeps its loop state and
the step's optimizer state in the method's ``state`` dict when it
writes a checkpoint.  Not ported yet: the sparse row-wise leg
(``update_mixed``, ``_apply_sparse``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = [
    "OptimMethod", "SGD", "Adam", "Adamax", "Adagrad", "Adadelta", "RMSprop",
    "LBFGS", "LearningRateSchedule", "Default", "Poly", "Step", "MultiStep",
    "EpochDecay", "EpochStep", "NaturalExp", "Exponential", "Plateau",
    "Warmup", "SequentialSchedule", "EpochSchedule", "Regime",
]

Tensors = Dict[str, torch.Tensor]
Scalar = Any  # a Python number or a 0-d tensor


def _count(v) -> torch.Tensor:
    """A counter as a 0-d tensor: a Python int on the CPU, a device
    counter where it lies."""
    return torch.as_tensor(v)


def _f32(v) -> torch.Tensor:
    return _count(v).to(torch.float32)


def _scalar(t: Scalar) -> Scalar:
    """A per-step scalar in the form the foreach calls take: a Python
    float for a value computed on the CPU, the 0-d tensor otherwise
    (reading a device value would wait for the device)."""
    if isinstance(t, torch.Tensor) and t.device.type == "cpu":
        return float(t)
    return t


def _times(ts: List[torch.Tensor], s: Scalar) -> List[torch.Tensor]:
    """``s * t`` for every tensor (the tensors themselves for 1.0)."""
    if isinstance(s, float) and s == 1.0:
        return ts
    return torch._foreach_mul(ts, s)


def _sub_scaled(ps: List[torch.Tensor], ts: List[torch.Tensor],
                s: Scalar) -> None:
    """``p -= s * t`` for every pair, in place: one fused multiply-add
    pass for a host number, the product first for a device scalar."""
    if isinstance(s, torch.Tensor):
        torch._foreach_sub_(ps, torch._foreach_mul(ts, s))
    else:
        torch._foreach_add_(ps, ts, alpha=-s)


def _lists(keys, *dicts) -> List[List[torch.Tensor]]:
    return [[d[k] for k in keys] for d in dicts]


# --------------------------------------------------------------------------
# Learning-rate schedules (optim/SGD.scala:198-534)
# --------------------------------------------------------------------------

class LearningRateSchedule:
    """Maps (base_lr, state) -> lr, in f32."""

    def rate(self, base_lr: float, state: Dict[str, Any]) -> Scalar:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """Torch default: lr / (1 + neval * lrd) (``SGD.scala`` Default)."""

    def __init__(self, learning_rate_decay: float = 0.0):
        self.learning_rate_decay = learning_rate_decay

    def rate(self, base_lr, state):
        return base_lr / (1.0 + _f32(state["neval"])
                          * self.learning_rate_decay)


class Poly(LearningRateSchedule):
    """lr * (1 - iter/max_iter)^power; 0 beyond max_iteration."""

    def __init__(self, power: float, max_iteration: int):
        self.power, self.max_iteration = power, max_iteration

    def rate(self, base_lr, state):
        frac = torch.clamp(1.0 - _f32(state["neval"]) / self.max_iteration,
                           0.0, 1.0)
        return base_lr * torch.pow(frac, self.power)


class Step(LearningRateSchedule):
    """lr * gamma^floor(neval / step_size)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def rate(self, base_lr, state):
        k = torch.div(_count(state["neval"]), self.step_size,
                      rounding_mode="floor").to(torch.float32)
        return base_lr * torch.pow(self.gamma, k)


class MultiStep(LearningRateSchedule):
    """lr * gamma^(number of step sizes reached)."""

    def __init__(self, step_sizes, gamma: float):
        self.step_sizes = tuple(step_sizes)
        self.gamma = gamma

    def rate(self, base_lr, state):
        it = _count(state["neval"])
        k = torch.zeros((), dtype=torch.float32, device=it.device)
        for s in self.step_sizes:
            k = k + (it >= s).to(torch.float32)
        return base_lr * torch.pow(self.gamma, k)


class EpochDecay(LearningRateSchedule):
    """lr * 0.1^decay_fn(epoch); ``decay_fn`` is Python, so it reads the
    epoch on the host (a device counter reads ``static_epoch`` instead,
    as a traced one does in the JAX package)."""

    def __init__(self, decay_fn: Callable[[int], float]):
        self.decay_fn = decay_fn

    def rate(self, base_lr, state):
        ep = _count(state["epoch"])
        ep_val = int(ep) if ep.device.type == "cpu" \
            else int(state.get("static_epoch", 1))
        return base_lr * (0.1 ** self.decay_fn(ep_val))


class EpochStep(LearningRateSchedule):
    """lr * gamma^floor((epoch - 1) / step_size)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def rate(self, base_lr, state):
        k = torch.div(_count(state["epoch"]) - 1, self.step_size,
                      rounding_mode="floor").to(torch.float32)
        return base_lr * torch.pow(self.gamma, k)


class NaturalExp(LearningRateSchedule):
    """lr * exp(-gamma * floor(neval / decay_step))."""

    def __init__(self, decay_step: int, gamma: float):
        self.decay_step, self.gamma = decay_step, gamma

    def rate(self, base_lr, state):
        p = torch.div(_count(state["neval"]), self.decay_step,
                      rounding_mode="floor").to(torch.float32)
        return base_lr * torch.exp(-self.gamma * p)


class Exponential(LearningRateSchedule):
    """lr * decay_rate^(neval / decay_step), floored with
    ``staircase``."""

    def __init__(self, decay_step: int, decay_rate: float,
                 staircase: bool = False):
        self.decay_step, self.decay_rate = decay_step, decay_rate
        self.staircase = staircase

    def rate(self, base_lr, state):
        p = _f32(state["neval"]) / self.decay_step
        if self.staircase:
            p = torch.floor(p)
        return base_lr * torch.pow(self.decay_rate, p)


class Warmup(LearningRateSchedule):
    """Linear ramp by delta for warmup_iteration steps, then the chained
    schedule (SGD.scala Warmup/SequentialSchedule)."""

    def __init__(self, delta: float, warmup_iteration: int,
                 after: Optional[LearningRateSchedule] = None):
        self.delta, self.warmup_iteration = delta, warmup_iteration
        self.after = after

    def rate(self, base_lr, state):
        it = _f32(state["neval"])
        warm = base_lr + self.delta * it
        peak = base_lr + self.delta * self.warmup_iteration
        after = self.after.rate(peak, state) if self.after else peak
        return torch.where(it < self.warmup_iteration, warm,
                           torch.as_tensor(after, dtype=torch.float32,
                                           device=it.device))


class SequentialSchedule(LearningRateSchedule):
    """Chain schedules, each active for a number of iterations; the last
    one also covers the iterations past the total."""

    def __init__(self):
        self.schedules = []  # (schedule, duration)

    def add(self, schedule: LearningRateSchedule, max_iteration: int):
        self.schedules.append((schedule, max_iteration))
        return self

    def rate(self, base_lr, state):
        it = _count(state["neval"])
        offset = 0
        out = None
        for i, (sched, dur) in enumerate(self.schedules):
            shifted = dict(state)
            shifted["neval"] = torch.clamp(it - offset, min=0)
            r = torch.as_tensor(sched.rate(base_lr, shifted),
                                dtype=torch.float32, device=it.device)
            last = i == len(self.schedules) - 1
            sel = (it >= offset) if last \
                else (it >= offset) & (it < offset + dur)
            out = r if out is None else torch.where(sel, r, out)
            offset += dur
        return out


class Regime:
    def __init__(self, start_epoch: int, end_epoch: int,
                 config: Dict[str, Any]):
        self.start_epoch, self.end_epoch = start_epoch, end_epoch
        self.config = config


class EpochSchedule(LearningRateSchedule):
    """Per-epoch-range hyper config (``SGD.scala`` EpochSchedule): the
    last regime holding the epoch sets the rate."""

    def __init__(self, regimes):
        self.regimes = list(regimes)

    def rate(self, base_lr, state):
        ep = _count(state["epoch"])
        out = torch.as_tensor(base_lr, dtype=torch.float32, device=ep.device)
        for r in self.regimes:
            lr = torch.as_tensor(r.config.get("learning_rate", base_lr),
                                 dtype=torch.float32, device=ep.device)
            sel = (ep >= r.start_epoch) & (ep <= r.end_epoch)
            out = torch.where(sel, lr, out)
        return out


class Plateau(LearningRateSchedule):
    """Reduce-on-plateau, driven on the host by validation scores
    (``SGD.scala`` Plateau); the factor may also come from
    ``state['plateau_factor']``."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min",
                 epsilon: float = 1e-4, cooldown: int = 0,
                 min_lr: float = 0.0):
        self.monitor, self.factor, self.patience = monitor, factor, patience
        self.mode, self.epsilon = mode, epsilon
        self.cooldown, self.min_lr = cooldown, min_lr
        self._best = None
        self._wait = 0
        self._cool = 0
        self.current_factor = 1.0

    def on_metric(self, value: float):
        """Host-side hook called after validation."""
        better = (self._best is None
                  or (self.mode == "min" and value < self._best - self.epsilon)
                  or (self.mode == "max" and value > self._best + self.epsilon))
        if better:
            self._best = value
            self._wait = 0
        elif self._cool > 0:
            self._cool -= 1
        else:
            self._wait += 1
            if self._wait >= self.patience:
                self.current_factor *= self.factor
                self._wait = 0
                self._cool = self.cooldown

    def rate(self, base_lr, state):
        factor = state.get("plateau_factor", self.current_factor)
        return torch.clamp(torch.as_tensor(base_lr * factor,
                                           dtype=torch.float32),
                           min=self.min_lr)


# --------------------------------------------------------------------------
# Methods
# --------------------------------------------------------------------------

class OptimMethod:
    """Base (``optim/OptimMethod.scala:38``)."""

    def init_state(self, params: Tensors) -> Dict[str, Any]:
        return {"neval": 0, "epoch": 1}

    def update(self, grads: Tensors, params: Tensors,
               state: Dict[str, Any]) -> Dict[str, Any]:
        """Apply one step to ``params`` in place; return the new state."""
        raise NotImplementedError

    def get_learning_rate(self) -> float:
        return float(getattr(self, "learning_rate", 0.0))

    def save(self, path: str, overwrite: bool = False) -> "OptimMethod":
        from bigdl_tpu_torch.utils.serializer import save_optim_method

        save_optim_method(self, path, overwrite)
        return self

    @staticmethod
    def load(path: str) -> "OptimMethod":
        from bigdl_tpu_torch.utils.serializer import load_optim_method

        return load_optim_method(path)

    @staticmethod
    def _zeros(params: Tensors) -> Tensors:
        return {k: torch.zeros_like(p) for k, p in params.items()}

    @staticmethod
    def _decayed_lr(base_lr: float, decay: float, state) -> Scalar:
        """lr / (1 + neval * decay), the methods' own schedule."""
        return _scalar(base_lr / (1.0 + _f32(state["neval"]) * decay))


class SGD(OptimMethod):
    """SGD with momentum, dampening, Nesterov and weight decay and the
    schedule family (``optim/SGD.scala``)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, weight_decay: float = 0.0,
                 momentum: float = 0.0, dampening: Optional[float] = None,
                 nesterov: bool = False,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = 0.0 if dampening is None else dampening
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError("Nesterov momentum requires momentum > 0 and "
                             "dampening = 0")
        self.schedule = learning_rate_schedule or Default(learning_rate_decay)

    def init_state(self, params):
        st = super().init_state(params)
        if self.momentum > 0:
            st["velocity"] = self._zeros(params)
        return st

    @torch.no_grad()
    def update(self, grads, params, state):
        lr = _scalar(self.schedule.rate(self.learning_rate, state))
        keys = list(params)
        ps, gs = _lists(keys, params, grads)
        if self.weight_decay != 0:
            gs = torch._foreach_add(gs, torch._foreach_mul(
                ps, self.weight_decay))
        new_state = dict(state)
        if self.momentum > 0:
            # v = mu * v + (1 - dampening) * g, except that the first
            # step COPIES the raw gradient into the buffer (``SGD.scala
            # :95``): there v is still zero, and decay 0 with gain 1
            # leaves exactly g
            first = state["neval"] == 0
            if isinstance(first, torch.Tensor):
                decay = torch.where(first, 0.0, self.momentum)
                gain = torch.where(first, 1.0, 1.0 - self.dampening)
            else:
                decay, gain = ((0.0, 1.0) if first
                               else (self.momentum, 1.0 - self.dampening))
            (vs,) = _lists(keys, state["velocity"])
            torch._foreach_mul_(vs, decay)
            torch._foreach_add_(vs, _times(gs, _scalar(gain)))
            step = torch._foreach_add(gs, torch._foreach_mul(
                vs, self.momentum)) if self.nesterov else vs
        else:
            step = gs
        _sub_scaled(ps, step, lr)
        new_state["neval"] = state["neval"] + 1
        return new_state


class Adam(OptimMethod):
    """(``optim/Adam.scala``)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        st = super().init_state(params)
        st["m"] = self._zeros(params)
        st["v"] = self._zeros(params)
        return st

    @torch.no_grad()
    def update(self, grads, params, state):
        t = _f32(state["neval"]) + 1.0
        lr = self._decayed_lr(self.learning_rate, self.learning_rate_decay,
                              state)
        b1, b2 = self.beta1, self.beta2
        keys = list(params)
        ps, gs, ms, vs = _lists(keys, params, grads, state["m"], state["v"])
        # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
        torch._foreach_mul_(vs, b2)
        g2 = torch._foreach_mul(gs, 1 - b2)
        torch._foreach_mul_(g2, gs)
        torch._foreach_add_(vs, g2)
        bc1 = _scalar(1.0 - torch.pow(b1, t))
        bc2 = _scalar(1.0 - torch.pow(b2, t))
        # p -= lr * (m / bc1) / (sqrt(v / bc2) + eps)
        den = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.epsilon)
        upd = torch._foreach_div(ms, bc1)
        torch._foreach_mul_(upd, lr)
        torch._foreach_div_(upd, den)
        torch._foreach_sub_(ps, upd)
        return {**state, "neval": state["neval"] + 1}


class Adamax(OptimMethod):
    """(``optim/Adamax.scala``)."""

    def __init__(self, learning_rate: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38):
        self.learning_rate = learning_rate
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        st = super().init_state(params)
        st["m"] = self._zeros(params)
        st["u"] = self._zeros(params)
        return st

    @torch.no_grad()
    def update(self, grads, params, state):
        t = _f32(state["neval"]) + 1.0
        b1 = self.beta1
        keys = list(params)
        ps, gs, ms, us = _lists(keys, params, grads, state["m"], state["u"])
        # m = b1 m + (1 - b1) g;  u = max(b2 u, |g| + eps)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
        ag = torch._foreach_abs(gs)
        torch._foreach_add_(ag, self.epsilon)
        torch._foreach_mul_(us, self.beta2)
        torch._foreach_maximum_(us, ag)
        # p -= lr_t * m / u,  lr_t = lr / (1 - b1^t)
        lr_t = _scalar(self.learning_rate / (1.0 - torch.pow(b1, t)))
        upd = torch._foreach_mul(ms, lr_t)
        torch._foreach_div_(upd, us)
        torch._foreach_sub_(ps, upd)
        return {**state, "neval": state["neval"] + 1}


class Adagrad(OptimMethod):
    """(``optim/Adagrad.scala``)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay

    def init_state(self, params):
        st = super().init_state(params)
        st["accum"] = self._zeros(params)
        return st

    @torch.no_grad()
    def update(self, grads, params, state):
        lr = self._decayed_lr(self.learning_rate, self.learning_rate_decay,
                              state)
        keys = list(params)
        ps, gs, acc = _lists(keys, params, grads, state["accum"])
        if self.weight_decay != 0:
            gs = torch._foreach_add(gs, torch._foreach_mul(
                ps, self.weight_decay))
        # accum += g g;  p -= lr * g / (sqrt(accum) + 1e-10)
        torch._foreach_add_(acc, torch._foreach_mul(gs, gs))
        den = torch._foreach_sqrt(acc)
        torch._foreach_add_(den, 1e-10)
        upd = torch._foreach_mul(gs, lr)
        torch._foreach_div_(upd, den)
        torch._foreach_sub_(ps, upd)
        return {**state, "neval": state["neval"] + 1}


class Adadelta(OptimMethod):
    """(``optim/Adadelta.scala``)."""

    def __init__(self, decay_rate: float = 0.9, epsilon: float = 1e-10):
        self.decay_rate, self.epsilon = decay_rate, epsilon
        self.learning_rate = 1.0

    def init_state(self, params):
        st = super().init_state(params)
        st["accum"] = self._zeros(params)
        st["delta_accum"] = self._zeros(params)
        return st

    @torch.no_grad()
    def update(self, grads, params, state):
        rho, eps = self.decay_rate, self.epsilon
        keys = list(params)
        ps, gs, acc, dacc = _lists(keys, params, grads, state["accum"],
                                   state["delta_accum"])
        # accum = rho accum + (1 - rho) g g
        torch._foreach_mul_(acc, rho)
        g2 = torch._foreach_mul(gs, 1 - rho)
        torch._foreach_mul_(g2, gs)
        torch._foreach_add_(acc, g2)
        # delta = sqrt(delta_accum + eps) / sqrt(accum + eps) * g
        delta = torch._foreach_add(dacc, eps)
        torch._foreach_sqrt_(delta)
        den = torch._foreach_add(acc, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(delta, den)
        torch._foreach_mul_(delta, gs)
        # delta_accum = rho delta_accum + (1 - rho) delta delta
        torch._foreach_mul_(dacc, rho)
        d2 = torch._foreach_mul(delta, 1 - rho)
        torch._foreach_mul_(d2, delta)
        torch._foreach_add_(dacc, d2)
        torch._foreach_sub_(ps, delta)
        return {**state, "neval": state["neval"] + 1}


class RMSprop(OptimMethod):
    """(``optim/RMSprop.scala``)."""

    def __init__(self, learning_rate: float = 1e-2,
                 learning_rate_decay: float = 0.0, decay_rate: float = 0.99,
                 epsilon: float = 1e-8):
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.decay_rate, self.epsilon = decay_rate, epsilon

    def init_state(self, params):
        st = super().init_state(params)
        st["rms"] = self._zeros(params)
        return st

    @torch.no_grad()
    def update(self, grads, params, state):
        lr = self._decayed_lr(self.learning_rate, self.learning_rate_decay,
                              state)
        rho = self.decay_rate
        keys = list(params)
        ps, gs, rms = _lists(keys, params, grads, state["rms"])
        # rms = rho rms + (1 - rho) g g;  p -= lr * g / (sqrt(rms) + eps)
        torch._foreach_mul_(rms, rho)
        g2 = torch._foreach_mul(gs, 1 - rho)
        torch._foreach_mul_(g2, gs)
        torch._foreach_add_(rms, g2)
        den = torch._foreach_sqrt(rms)
        torch._foreach_add_(den, self.epsilon)
        upd = torch._foreach_mul(gs, lr)
        torch._foreach_div_(upd, den)
        torch._foreach_sub_(ps, upd)
        return {**state, "neval": state["neval"] + 1}


class LBFGS(OptimMethod):
    """Limited-memory BFGS with optional backtracking line search
    (``optim/LBFGS.scala``, ``optim/LineSearch.scala``), on the host over
    a flat parameter vector: the reference uses it for full-batch
    problems, never in the train step.  :meth:`optimize` takes
    ``feval(x) -> (loss, grad)`` and returns ``(x, losses)``."""

    def __init__(self, max_iter: int = 20, max_eval: Optional[float] = None,
                 tol_fun: float = 1e-5, tol_x: float = 1e-9,
                 n_correction: int = 100, learning_rate: float = 1.0,
                 line_search: bool = False):
        self.max_iter, self.tol_fun, self.tol_x = max_iter, tol_fun, tol_x
        self.max_eval = max_eval if max_eval is not None else max_iter * 1.25
        self.n_correction = n_correction
        self.learning_rate = learning_rate
        self.line_search = line_search

    @torch.no_grad()
    def optimize(self, feval, x):
        x = torch.as_tensor(x)
        old_dirs, old_steps = [], []
        loss, g = feval(x)
        losses = [float(loss)]
        d = -g
        h_diag = 1.0
        n_eval = 1
        for _ in range(self.max_iter):
            if torch.max(torch.abs(g)) <= self.tol_fun:
                break
            # two-loop recursion
            if old_dirs:
                q = -g
                al = []
                ro = [1.0 / torch.dot(y, s) for y, s in zip(old_dirs,
                                                            old_steps)]
                for i in range(len(old_dirs) - 1, -1, -1):
                    a = ro[i] * torch.dot(old_steps[i], q)
                    al.append(a)
                    q = q - a * old_dirs[i]
                al.reverse()
                r = q * h_diag
                for i in range(len(old_dirs)):
                    b = ro[i] * torch.dot(old_dirs[i], r)
                    r = r + (al[i] - b) * old_steps[i]
                d = r
            t = self.learning_rate if old_dirs else min(
                1.0, 1.0 / float(torch.sum(torch.abs(g)))) * self.learning_rate
            gtd = torch.dot(g, d)
            if float(gtd) > -self.tol_x:
                break
            if self.line_search:
                f_new, g_new, t, ls_evals = _backtrack(feval, x, t, d, loss,
                                                       gtd)
                n_eval += ls_evals
                x = x + t * d
            else:
                x = x + t * d
                f_new, g_new = feval(x)
                n_eval += 1
            y = g_new - g
            s = t * d
            ys = float(torch.dot(y, s))
            if ys > 1e-10:
                if len(old_dirs) == self.n_correction:
                    old_dirs.pop(0)
                    old_steps.pop(0)
                old_dirs.append(y)
                old_steps.append(s)
                h_diag = ys / float(torch.dot(y, y))
            f_old = loss
            loss, g = f_new, g_new
            losses.append(float(loss))
            if n_eval >= self.max_eval:
                break
            if float(torch.max(torch.abs(t * d))) <= self.tol_x:
                break
            if abs(float(loss - f_old)) < self.tol_fun:
                break
        return x, losses


def _backtrack(feval, x, t, d, f0, gtd, c1: float = 1e-4, max_ls: int = 25):
    """Halve ``t`` until the Armijo condition holds (at most ``max_ls``
    evaluations): ``(f, g, t, evaluations)``."""
    evals = 0
    for _ in range(max_ls):
        f_new, g_new = feval(x + t * d)
        evals += 1
        if float(f_new) <= float(f0) + c1 * t * float(gtd):
            return f_new, g_new, t, evals
        t = t * 0.5
    return f_new, g_new, t, evals
