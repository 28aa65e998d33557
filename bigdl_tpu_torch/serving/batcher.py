"""Continuous batcher: bounded queue -> coalesced bucketed dispatches
(ported from ``bigdl_tpu/serving/batcher.py``; request traces and
telemetry are not ported yet).

- a dispatch fires as soon as ``max_batch`` rows are assembled, OR
  ``max_wait_ms`` after the OLDEST waiting request arrived;
- while a batch runs, arrivals keep queueing and the worker drains them
  the moment the dispatch returns;
- the queue is bounded: past ``queue_limit`` requests ``submit`` raises
  :class:`QueueFullError`, which the HTTP frontend turns into a 429;
- ``stop(drain=True)`` stops admissions, finishes every queued request,
  then parks the worker.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

__all__ = ["ContinuousBatcher", "QueueFullError", "Request"]


class QueueFullError(RuntimeError):
    """The bounded request queue is at capacity (HTTP 429)."""


class Request:
    """One enqueued request of ``[k, ...feature]`` rows.  ``wait()``
    blocks until the batch that carried it lands; ``output``/``error``
    hold the result.  ``cancel()`` (the frontend's timeout path) tells
    the worker to drop the rows instead of computing them."""

    __slots__ = ("x", "rows", "enqueued_at", "done", "output", "error",
                 "queue_ms", "cancelled")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.rows = int(x.shape[0])
        self.enqueued_at = time.perf_counter()
        self.done = threading.Event()
        self.output: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.queue_ms = 0.0
        self.cancelled = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)

    def cancel(self) -> None:
        self.cancelled = True


class ContinuousBatcher:
    """One worker thread coalescing requests into dispatches of
    ``runner(batch_x) -> batch_out`` (the executor's ``run``, which pads
    onto the bucket)."""

    def __init__(self, runner: Callable[[np.ndarray], np.ndarray],
                 max_batch: int = 32, max_wait_ms: float = 5.0,
                 queue_limit: int = 256,
                 bucket_rows: Optional[Callable[[int], int]] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.runner = runner
        self.max_batch = max_batch
        self.max_wait_s = max(0.0, max_wait_ms) / 1000.0
        self.queue_limit = queue_limit
        # rows -> padded bucket rows, for the padding-waste stat
        self._bucket_rows = bucket_rows or (lambda n: n)
        self._q: "queue.Queue[Request]" = queue.Queue(maxsize=queue_limit)
        self._carry: Optional[Request] = None
        self._stats_lock = threading.Lock()
        self._lat_ms: Deque[Tuple[float, float]] = collections.deque(
            maxlen=4096)  # (wall finish time, e2e latency ms)
        self._queue_ms: Deque[float] = collections.deque(maxlen=4096)
        self.requests = 0
        self.rejected = 0
        self.rows = 0
        self.batches = 0
        self.padded_rows = 0
        self.errors = 0
        self._draining = False
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="bigdl-serve-batcher",
                                        daemon=True)
        self._thread.start()

    # -- admission ---------------------------------------------------------
    def submit(self, x: np.ndarray) -> Request:
        """Enqueue ``[k, ...]`` rows; raises :class:`QueueFullError` at
        capacity or once draining."""
        if self._draining or self._stopped.is_set():
            raise QueueFullError("server is draining")
        req = Request(np.asarray(x))
        try:
            self._q.put_nowait(req)
        except queue.Full:
            with self._stats_lock:
                self.rejected += 1
            raise QueueFullError(
                f"request queue at capacity ({self.queue_limit})") from None
        with self._stats_lock:
            self.requests += 1
        return req

    def depth(self) -> int:
        return self._q.qsize()

    # -- the worker --------------------------------------------------------
    def _gather(self) -> List[Request]:
        """Block for the first request, then coalesce until the batch is
        full or the oldest request's deadline passes.  A request too big
        to ride along is carried, in order, into the next batch."""
        batch: List[Request] = []
        rows = 0
        carry, self._carry = self._carry, None
        if carry is not None:
            if carry.cancelled:
                carry.done.set()
            else:
                batch.append(carry)
                rows = carry.rows
        while not batch:
            if self._stopped.is_set():
                return []
            if self._draining and self._q.empty():
                return []
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if first.cancelled:  # timed-out client: drop, don't compute
                first.done.set()
                continue
            batch.append(first)
            rows = first.rows
        deadline = batch[0].enqueued_at + self.max_wait_s
        while rows < self.max_batch:
            remaining = deadline - time.perf_counter()
            try:
                if self._q.empty() and remaining <= 0:
                    break
                nxt = self._q.get(timeout=max(0.0, remaining)
                                  if self._q.empty() else 0.0)
            except queue.Empty:
                break
            if nxt.cancelled:
                nxt.done.set()
                continue
            if rows + nxt.rows > self.max_batch:
                self._carry = nxt  # rides the next batch, order intact
                break
            batch.append(nxt)
            rows += nxt.rows
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._gather()
            if batch:
                self._execute(batch)
                continue
            if self._stopped.is_set() or (
                    self._draining and self._q.empty()
                    and self._carry is None):
                self._stopped.set()
                return

    def _execute(self, batch: List[Request]) -> None:
        batch = [r for r in batch if not r.cancelled]
        if not batch:
            return
        t0 = time.perf_counter()
        rows = sum(r.rows for r in batch)
        for r in batch:
            r.queue_ms = (t0 - r.enqueued_at) * 1000.0
        try:
            xs = [r.x for r in batch]
            out = self.runner(xs[0] if len(xs) == 1
                              else np.concatenate(xs, axis=0))
            offset = 0
            for r in batch:
                r.output = out[offset:offset + r.rows]
                offset += r.rows
        except Exception as e:  # noqa: BLE001 - relayed to every rider
            with self._stats_lock:
                self.errors += 1
            for r in batch:
                r.error = e
        finally:
            done_at = time.time()
            with self._stats_lock:
                self.batches += 1
                self.rows += rows
                self.padded_rows += max(0, self._bucket_rows(rows) - rows)
                for r in batch:
                    e2e = (time.perf_counter() - r.enqueued_at) * 1000.0
                    self._lat_ms.append((done_at, e2e))
                    self._queue_ms.append(r.queue_ms)
            for r in batch:
                r.done.set()

    # -- stats / lifecycle -------------------------------------------------
    def stats(self, window_s: float = 60.0) -> dict:
        now = time.time()
        with self._stats_lock:
            recent = [(at, lat) for (at, lat) in self._lat_ms
                      if now - at <= window_s]
            lat = sorted(v for _, v in recent)
            out = {"requests": self.requests, "rejected": self.rejected,
                   "rows": self.rows, "batches": self.batches,
                   "errors": self.errors,
                   "queue_depth": self._q.qsize(),
                   "queue_limit": self.queue_limit,
                   "max_batch": self.max_batch,
                   "max_wait_ms": self.max_wait_s * 1000.0,
                   "batch_fill": round(
                       self.rows / (self.batches * self.max_batch), 4)
                   if self.batches else None,
                   "padding_waste": round(
                       self.padded_rows
                       / max(1, self.rows + self.padded_rows), 4),
                   "window_s": window_s,
                   "draining": self._draining}
            qms = sorted(list(self._queue_ms)[-len(lat):]) if lat else []
        if lat:
            # rate over the span the recent window actually covers
            span = min(window_s, max(0.25, now - min(at for at, _ in recent)))
            out["qps"] = round(len(lat) / span, 2)
            out["p50_ms"] = round(_pct(lat, 50.0), 3)
            out["p99_ms"] = round(_pct(lat, 99.0), 3)
            out["queue_p50_ms"] = round(_pct(qms, 50.0), 3)
        return out

    def stop(self, drain: bool = True, timeout: float = 30.0) -> bool:
        """Stop admissions; with ``drain`` finish everything queued
        first.  Returns True when the worker parked in time."""
        self._draining = True
        if not drain:
            self._stopped.set()
        self._thread.join(timeout)
        self._stopped.set()
        parked = not self._thread.is_alive()
        # a submit() that passed the draining check may have enqueued
        # AFTER the worker saw an empty queue and parked: those requests
        # were accepted, so the drain owes them an answer.  The worker is
        # gone here, so running them inline is race-free.
        leftovers: List[Request] = []
        if self._carry is not None:
            leftovers.append(self._carry)
            self._carry = None
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        if drain and parked:
            chunk: List[Request] = []
            rows = 0
            for r in leftovers:
                if rows + r.rows > self.max_batch and chunk:
                    self._execute(chunk)
                    chunk, rows = [], 0
                chunk.append(r)
                rows += r.rows
            if chunk:
                self._execute(chunk)
        else:  # hard stop: fail fast instead of a silent client timeout
            for r in leftovers:
                r.error = QueueFullError("server stopped")
                r.done.set()
        return parked


def _pct(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]
