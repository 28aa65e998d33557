"""Training health, ported from ``bigdl_tpu/telemetry/health.py``: the
probe vocabulary, the host-side loss detector and the policy that turns
a step's findings into warn / skip-step / halt.

The device half is the train step's ``health_probe`` (a 5-vector of
gradient, parameter and update norms and non-finite counts,
``PROBE_FIELDS``) and ``skip_nonfinite``; the ``Optimizer`` reads the
vector with the step's loss and feeds it to :class:`HealthPolicy`.  The
JAX package's ``BIGDL_HEALTH`` / ``BIGDL_HEALTH_HALT_AFTER`` become the
policy given to ``Optimizer.set_health_policy`` (default: halt after 3
consecutive non-finite steps); the telemetry events of the JAX module
are not ported, and the loss detector's tuning (``spike_factor``,
``ewma_alpha``, ``ewma_warmup``, ``plateau_rtol``) is fixed at the JAX
defaults.

Policy: ``on_nonfinite`` escalates warn → skip → halt.  ``skip`` also
makes the step keep the previous parameters, optimizer state and
buffers whenever it was non-finite.  Halting is a predicate over the
policy's running state (``halt_when``)::

    HealthPolicy(on_nonfinite="halt", halt_after=3)
    HealthPolicy(halt_when=Trigger(lambda s: s["consecutive_nonfinite"] >= 3))

The training loop raises :class:`HealthError` with the offending step's
evidence when the predicate fires.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["PROBE_FIELDS", "HealthError", "HealthPolicy", "LossEwma",
           "probe_stats"]

#: order of the scalars in the TrainStep health vector (device layout).
PROBE_FIELDS = ("grad_norm", "param_norm", "update_norm",
                "nonfinite_grads", "nonfinite_params")


def probe_stats(vec, loss: float) -> Dict[str, float]:
    """Decode a fetched health 5-vector (any indexable of floats) into
    the named stats dict the events/policy/exporter share.  NaN norms are
    kept as-is (they ARE the finding); counts are rounded to ints."""
    stats: Dict[str, Any] = {}
    for i, name in enumerate(PROBE_FIELDS):
        v = float(vec[i])
        if name.startswith("nonfinite"):
            stats[name] = int(v) if math.isfinite(v) else -1
        else:
            stats[name] = v
    denom = stats["param_norm"]
    stats["update_ratio"] = (stats["update_norm"] / denom
                             if denom and math.isfinite(denom) else 0.0)
    stats["loss"] = float(loss)
    return stats


def _nonfinite(stats: Dict[str, Any]) -> bool:
    return bool(stats.get("nonfinite_grads") or stats.get("nonfinite_params")
                or not math.isfinite(stats.get("loss", 0.0)))


class HealthError(RuntimeError):
    """Training halted by the health policy.  Carries the offending
    step and the evidence that tripped the halt — the probe stats of the
    final step plus the policy's running counters — so a postmortem
    needs no log spelunking."""

    def __init__(self, step: int, reason: str,
                 evidence: Optional[Dict[str, Any]] = None):
        self.step = step
        self.reason = reason
        self.evidence = dict(evidence or {})
        super().__init__(f"training halted at step {step}: {reason} "
                         f"(evidence: {self.evidence})")


class LossEwma:
    """Host-side loss-spike / plateau detector over the step-loss stream.

    Spike: the loss exceeds the running EWMA by ``spike_factor`` EWMA
    standard deviations AND by ``min_rel`` of the EWMA's magnitude
    (after ``warmup`` finite samples) — the relative floor keeps the
    early, still-converging variance estimate from flagging ordinary
    minibatch noise.  Plateau: the EWMA's relative improvement stays
    below ``plateau_rtol`` for ``plateau_patience`` consecutive steps (0
    disables).  Nonfinite losses are not folded into the EWMA — they are
    the nonfinite detector's finding, and folding them in would blind
    this one.  The constants are the JAX detector's defaults."""

    alpha = 0.1
    spike_factor = 4.0
    warmup = 8
    min_rel = 0.1
    plateau_rtol = 1e-3

    def __init__(self, plateau_patience: int = 0):
        self.plateau_patience = plateau_patience
        self.mean: Optional[float] = None
        self.var = 0.0
        self.samples = 0
        self._flat = 0
        self._plateau_fired = False

    def update(self, step: int, loss: float) -> List[Tuple[str, Dict]]:
        """Feed one step's loss; returns findings as (instant name,
        attrs) pairs."""
        findings: List[Tuple[str, Dict]] = []
        if not math.isfinite(loss):
            return findings
        if self.mean is None:
            self.mean, self.samples = loss, 1
            return findings
        std = math.sqrt(max(self.var, 0.0))
        deviation = loss - self.mean
        if self.samples >= self.warmup \
                and deviation > self.spike_factor * max(std, 1e-12) \
                and deviation > self.min_rel * max(abs(self.mean), 1e-12):
            findings.append(("health/loss_spike", {
                "step": step, "loss": loss, "ewma": self.mean,
                "ewma_std": std, "factor": self.spike_factor}))
        prev = self.mean
        delta = loss - self.mean
        self.mean += self.alpha * delta
        self.var = (1.0 - self.alpha) * (self.var + self.alpha * delta * delta)
        self.samples += 1
        if self.plateau_patience:
            improved = prev - self.mean > self.plateau_rtol * abs(prev)
            self._flat = 0 if improved else self._flat + 1
            if improved:
                self._plateau_fired = False
            if self._flat >= self.plateau_patience \
                    and self.samples > self.warmup \
                    and not self._plateau_fired:
                self._plateau_fired = True  # once per plateau, not per step
                findings.append(("health/plateau", {
                    "step": step, "ewma": self.mean,
                    "flat_steps": self._flat,
                    "rtol": self.plateau_rtol}))
        return findings


class HealthPolicy:
    """Decides what a step's probe stats mean for the run.

    ``on_nonfinite``: ``"off"`` (no probes), ``"warn"`` (log + events
    only), ``"skip"`` (in-graph skip of the poisoned update, then the
    halt predicate still applies), ``"halt"`` (events + halt predicate).
    ``halt_after``: the default halt predicate — ``halt_when`` fires when
    ``consecutive_nonfinite >= halt_after``.  Pass an ``optim.Trigger``
    (or any callable over the state dict) as ``halt_when`` to express a
    different condition; the state dict carries ``step``,
    ``nonfinite_steps`` (total), ``consecutive_nonfinite``,
    ``skipped_steps``, ``spikes``, ``plateaus``, ``grad_explosions``.
    ``max_grad_norm``: warn-level gradient-explosion threshold (None
    disables).
    """

    ACTIONS = ("off", "warn", "skip", "halt")

    def __init__(self, on_nonfinite: str = "halt", halt_after: int = 3,
                 max_grad_norm: Optional[float] = None,
                 plateau_patience: int = 0,
                 halt_when: Optional[Callable[[Dict], bool]] = None):
        if on_nonfinite not in self.ACTIONS:
            raise ValueError(f"unknown on_nonfinite {on_nonfinite!r} "
                             f"({' | '.join(self.ACTIONS)})")
        if halt_after < 1:
            raise ValueError("halt_after must be >= 1")
        # kept for fresh(): a policy is CONFIG + running state; each run
        # attempt needs the config with pristine state
        self._ctor = dict(
            on_nonfinite=on_nonfinite, halt_after=halt_after,
            max_grad_norm=max_grad_norm, plateau_patience=plateau_patience,
            halt_when=halt_when)
        self.on_nonfinite = on_nonfinite
        self.halt_after = halt_after
        self.max_grad_norm = max_grad_norm
        self._halt_when = halt_when
        self.ewma = LossEwma(plateau_patience=plateau_patience)
        self.state: Dict[str, Any] = {
            "step": 0, "nonfinite_steps": 0, "consecutive_nonfinite": 0,
            "skipped_steps": 0, "spikes": 0, "plateaus": 0,
            "grad_explosions": 0}

    def fresh(self) -> "HealthPolicy":
        """Same configuration, pristine running state — one per run
        attempt, so counters/EWMA from before a checkpoint restore (or a
        previous ``optimize()`` call) never leak into the next."""
        return HealthPolicy(**self._ctor)

    @property
    def enabled(self) -> bool:
        return self.on_nonfinite != "off"

    @property
    def skip_nonfinite(self) -> bool:
        return self.on_nonfinite == "skip"

    @property
    def can_halt(self) -> bool:
        """Whether a step's findings may halt the run: the training loop
        then reads each step's probe before it launches the next."""
        return self._halt_when is not None \
            or self.on_nonfinite in ("skip", "halt")

    def _should_halt(self) -> bool:
        if self._halt_when is not None:
            return bool(self._halt_when(self.state))
        if self.on_nonfinite in ("skip", "halt"):
            return self.state["consecutive_nonfinite"] >= self.halt_after
        return False

    def observe(self, step: int,
                stats: Dict[str, Any]) -> Tuple[str, List[Tuple[str, Dict]]]:
        """Fold one step's stats into the running state.  Returns
        ``(action, findings)`` — action is ``"ok"``/``"warn"``/
        ``"skip"``/``"halt"``; findings are (instant name, attrs) pairs
        for the caller to emit.  On ``"halt"`` the caller raises
        :class:`HealthError` with ``self.evidence(step, stats)``."""
        st = self.state
        st["step"] = step
        findings = list(self.ewma.update(step, stats.get("loss", 0.0)))
        for name, _ in findings:
            if name == "health/loss_spike":
                st["spikes"] += 1
            elif name == "health/plateau":
                st["plateaus"] += 1
        action = "ok" if not findings else "warn"
        gn = stats.get("grad_norm", 0.0)
        if self.max_grad_norm is not None and math.isfinite(gn) \
                and gn > self.max_grad_norm:
            st["grad_explosions"] += 1
            findings.append(("health/grad_explosion", {
                "step": step, "grad_norm": gn,
                "max_grad_norm": self.max_grad_norm}))
            action = "warn"
        if _nonfinite(stats):
            st["nonfinite_steps"] += 1
            st["consecutive_nonfinite"] += 1
            findings.append(("health/nonfinite", {
                "step": step, "consecutive": st["consecutive_nonfinite"],
                **{k: stats[k] for k in ("nonfinite_grads",
                                         "nonfinite_params", "loss")}}))
            action = "warn"
            if self.skip_nonfinite:
                st["skipped_steps"] += 1
                findings.append(("health/skip", {
                    "step": step, "skipped": st["skipped_steps"]}))
                action = "skip"
        else:
            st["consecutive_nonfinite"] = 0
        if self._should_halt():
            findings.append(("health/halt", {
                "step": step, "reason": "nonfinite",
                "consecutive": st["consecutive_nonfinite"]}))
            action = "halt"
        return action, findings

    def evidence(self, step: int, stats: Dict[str, Any]) -> Dict[str, Any]:
        """The HealthError payload: the final step's probe stats plus the
        policy's counters."""
        return {**stats, **{k: v for k, v in self.state.items()
                            if k != "step"}, "step": step}
