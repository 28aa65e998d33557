"""Per-stage training metrics (``optim/Metrics.scala:31-130``), ported
from ``bigdl_tpu/optim/metrics.py``: a thread-safe accumulator of the
host-observable stages the training loop records (data wait,
host-to-device copies, dispatch, host reads, validation, checkpoint),
reported in pipeline order.  The telemetry forward of the JAX class is
not ported (telemetry is not)."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List

__all__ = ["Metrics"]


class Metrics:
    """``add``/``set``/``timer`` may be called from the training loop, the
    prefetch worker and the checkpoint writer at once; every access
    holds one lock.  ``stages()`` and ``summary()`` list the canonical
    stages first, then the rest in first-recorded order."""

    _STAGE_ORDER = ("data time", "host to device time",
                    "host to device time (overlapped)", "dispatch time",
                    "compile + first iteration time", "computing time",
                    "host read time", "validation time", "checkpoint time",
                    "checkpoint wait time")

    def __init__(self):
        self._lock = threading.Lock()
        self._scalars: Dict[str, List[float]] = {}

    def _ordered(self) -> List[str]:
        known = [n for n in self._STAGE_ORDER if n in self._scalars]
        return known + [n for n in self._scalars
                        if n not in self._STAGE_ORDER]

    def set(self, name: str, value: float):
        with self._lock:
            self._scalars[name] = [float(value)]

    def add(self, name: str, value: float):
        with self._lock:
            self._scalars.setdefault(name, []).append(float(value))

    def get(self, name: str) -> float:
        """Mean of the recorded values (0.0 when empty)."""
        with self._lock:
            vals = self._scalars.get(name, [])
            return sum(vals) / len(vals) if vals else 0.0

    def total(self, name: str) -> float:
        with self._lock:
            return sum(self._scalars.get(name, []))

    def count(self, name: str) -> int:
        with self._lock:
            return len(self._scalars.get(name, []))

    def stages(self) -> List[str]:
        with self._lock:
            return self._ordered()

    @contextmanager
    def timer(self, name: str):
        """Add the wall time of the with-block under ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def reset(self):
        with self._lock:
            self._scalars.clear()

    def summary(self, unit_scale: float = 1.0) -> str:
        """Per-stage mean, total and count (``Metrics.summary``)."""
        with self._lock:
            lines = ["========== Metrics Summary =========="]
            for name in self._ordered():
                vals = self._scalars[name]
                mean = sum(vals) / len(vals) if vals else 0.0
                lines.append(
                    f"{name} : mean {mean * unit_scale:.6f} s "
                    f"(total {sum(vals) * unit_scale:.4f} s, n={len(vals)})")
            lines.append("=====================================")
            return "\n".join(lines)
