"""Triggers — composable fire/stop predicates over the training loop's state
(``optim/Trigger.scala:26-127``), ported whole from
``bigdl_tpu/optim/trigger.py``: every_epoch, several_iteration,
max_epoch, max_iteration, max_score, min_loss, and the and/or
combinators.

Each trigger also says which state keys it reads (``reads``; None for a
predicate built by hand, which may read anything): the training loop
reads the loss to the host on the iteration it was made only when a
trigger may read ``"loss"``.
"""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, Optional

__all__ = ["Trigger"]


class Trigger:
    def __init__(self, fn: Callable[[Dict], bool],
                 reads: Optional[FrozenSet[str]] = None):
        self._fn = fn
        self.reads = reads

    def __call__(self, state: Dict) -> bool:
        return self._fn(state)

    @property
    def reads_loss(self) -> bool:
        return self.reads is None or "loss" in self.reads

    # -- factories ---------------------------------------------------------
    @staticmethod
    def every_epoch() -> "Trigger":
        """Fires when the training loop crosses an epoch boundary."""
        holder = {"last": -1}

        def fn(state):
            ep = state.get("epoch", 1)
            if state.get("_epoch_boundary", False) and ep != holder["last"]:
                holder["last"] = ep
                return True
            return False

        return Trigger(fn, frozenset({"epoch", "_epoch_boundary"}))

    @staticmethod
    def several_iteration(interval: int) -> "Trigger":
        return Trigger(lambda s: s.get("neval", 0) % interval == 0
                       and s.get("neval", 0) > 0, frozenset({"neval"}))

    @staticmethod
    def max_epoch(max_: int) -> "Trigger":
        return Trigger(lambda s: s.get("epoch", 1) > max_,
                       frozenset({"epoch"}))

    @staticmethod
    def max_iteration(max_: int) -> "Trigger":
        return Trigger(lambda s: s.get("neval", 0) >= max_,
                       frozenset({"neval"}))

    @staticmethod
    def max_score(max_: float) -> "Trigger":
        return Trigger(lambda s: s.get("score", float("-inf")) > max_,
                       frozenset({"score"}))

    @staticmethod
    def min_loss(min_: float) -> "Trigger":
        return Trigger(lambda s: s.get("loss", float("inf")) < min_,
                       frozenset({"loss"}))

    @staticmethod
    def and_(*triggers: "Trigger") -> "Trigger":
        return Trigger(lambda s: all(t(s) for t in triggers),
                       _union(triggers))

    @staticmethod
    def or_(*triggers: "Trigger") -> "Trigger":
        return Trigger(lambda s: any(t(s) for t in triggers),
                       _union(triggers))


def _union(triggers) -> Optional[FrozenSet[str]]:
    reads = [getattr(t, "reads", None) for t in triggers]
    if any(r is None for r in reads):
        return None
    return frozenset().union(*reads)
