"""The serving HTTP frontend (ported from ``bigdl_tpu/serving/server.py``):
stdlib ``ThreadingHTTPServer``, a daemon thread per connection, handler
errors never kill the process.

Endpoints:

- ``POST /v1/predict`` — body ``{"inputs": <nested list>}``: one sample
  (the model's feature shape) or a ``[k, ...]`` micro-batch.  The
  response carries ``{"outputs": ..., "ms": total, "queue_ms": wait}``.
  ``429`` when the queue is full, ``503`` while draining, ``400`` on
  shape/JSON errors, ``504`` when no dispatch lands within the request
  timeout;
- ``GET /status`` — ``{"serving": {...}}``: qps, p50/p99 latency, queue
  depth, batches, buckets, and the kernel wrappers' launch counts;
- ``GET /healthz`` — 200 while serving, 503 once draining.

Request traces, SLOs, OpenMetrics, generation, meshes and int8 are not
ported yet.
"""

from __future__ import annotations

import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Tuple

import numpy as np

from bigdl_tpu_torch.ops.lrn import cross_map_lrn_forward
from bigdl_tpu_torch.ops.pool import avg_pool_forward
from bigdl_tpu_torch.serving.batcher import (ContinuousBatcher,
                                             QueueFullError, Request)
from bigdl_tpu_torch.serving.buckets import BucketPolicy
from bigdl_tpu_torch.serving.executor import BucketedExecutor

__all__ = ["ModelServer", "serve_model", "kernel_launches"]


def kernel_launches() -> Dict[str, int]:
    """Launch counts of the kernel wrappers on the serving path."""
    return {"cross_map_lrn_fwd": cross_map_lrn_forward.launches,
            "avg_pool_fwd": avg_pool_forward.launches}


class ModelServer:
    """One served model: executor + batcher + HTTP frontend.

    ``input_spec`` is the model's batched input spec (``.shape`` with a
    leading batch axis, ``.dtype``), as ``models/registry.input_spec``
    returns it."""

    def __init__(self, model, input_spec, name: str = "model",
                 host: str = "0.0.0.0", port: int = 0,
                 max_batch: int = 32, max_wait_ms: float = 5.0,
                 queue_limit: int = 256, batch_buckets=None,
                 compute_dtype=None, request_timeout_s: float = 30.0,
                 device=None):
        self.name = name
        self.sample_shape: Tuple[int, ...] = tuple(input_spec.shape[1:])
        self.dtype = np.dtype(input_spec.dtype)
        self.request_timeout_s = request_timeout_s
        policy = BucketPolicy(max_batch=max_batch, batch_buckets=batch_buckets)
        self.executor = BucketedExecutor(model, policy=policy,
                                         compute_dtype=compute_dtype,
                                         device=device)
        self.batcher = ContinuousBatcher(
            self.executor.run, max_batch=max_batch, max_wait_ms=max_wait_ms,
            queue_limit=queue_limit, bucket_rows=self._bucket_rows)
        self._started_at = time.time()
        self._term = threading.Event()
        self._stopped = False
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.model_server = self  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="bigdl-serve-http",
            kwargs={"poll_interval": 0.2}, daemon=True)
        self._thread.start()

    def warmup(self) -> float:
        """One forward per bucket before taking traffic; returns the wall
        seconds spent."""
        return self.executor.warmup(self.sample_shape, self.dtype)

    def _bucket_rows(self, rows: int) -> int:
        try:
            return self.executor.policy.batch_bucket(rows)
        except ValueError:
            return rows

    # -- request path ------------------------------------------------------
    def parse_inputs(self, payload: Dict[str, Any]) -> Tuple[np.ndarray, bool]:
        """-> ([k, ...] rows, was_single_sample)."""
        if not isinstance(payload, dict) or "inputs" not in payload:
            raise ValueError('body must be {"inputs": <nested list>}')
        arr = np.asarray(payload["inputs"], dtype=self.dtype)
        nd = len(self.sample_shape)
        single = arr.ndim == nd
        if single:
            arr = arr[None]
        elif arr.ndim != nd + 1:
            raise ValueError(
                f"inputs must have {nd} dims (one sample) or {nd + 1} "
                f"(a [k, ...] micro-batch); got {arr.ndim}")
        if arr.shape[0] > self.batcher.max_batch:
            raise ValueError(
                f"micro-batch of {arr.shape[0]} rows exceeds max_batch "
                f"{self.batcher.max_batch}; split the request")
        if arr.shape[1:] != self.sample_shape:
            raise ValueError(f"sample shape {arr.shape[1:]} incompatible "
                             f"with the model's {self.sample_shape}")
        return arr, single

    def predict(self, arr: np.ndarray) -> Request:
        """Submit rows and wait for the carrying batch.  Raises
        QueueFullError / TimeoutError, or the dispatch's own error."""
        req = self.batcher.submit(arr)
        if not req.wait(self.request_timeout_s):
            req.cancel()  # nobody will read the answer: drop the rows
            raise TimeoutError(f"no dispatch within {self.request_timeout_s}s")
        if req.error is not None:
            raise req.error
        return req

    # -- views -------------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        st = self.batcher.stats()
        st.update(
            model=self.name, port=self.port, device=str(self.executor.device),
            uptime_s=round(time.time() - self._started_at, 3),
            sample_shape=list(self.sample_shape), dtype=str(self.dtype),
            batch_buckets=list(self.executor.policy.batch_buckets),
            warm_buckets=self.executor.warm_buckets(),
            warmup_s=round(self.executor.warmup_s, 3),
            kernel_launches=kernel_launches())
        return st

    # -- lifecycle ---------------------------------------------------------
    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> graceful drain (main thread only)."""
        def _on_term(signum, frame):  # noqa: ARG001 - signal contract
            self._term.set()

        signal.signal(signal.SIGTERM, _on_term)
        signal.signal(signal.SIGINT, _on_term)

    def wait(self) -> None:
        """Block until SIGTERM/SIGINT or ``stop()``."""
        while not self._term.is_set():
            self._term.wait(0.5)

    def draining(self) -> bool:
        return self._term.is_set() or self.batcher._draining or self._stopped

    def stop(self, drain: bool = True, timeout: float = 30.0) -> bool:
        """Drain (finish queued requests) then park everything.  Returns
        True when the batcher parked in time."""
        if self._stopped:
            return True
        self._stopped = True
        self._term.set()
        parked = self.batcher.stop(drain=drain, timeout=timeout)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        return parked


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _server(self) -> ModelServer:
        return self.server.model_server  # type: ignore[attr-defined]

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        try:
            if self.path.split("?", 1)[0].rstrip("/") != "/v1/predict":
                self.send_error(404)
                return
            srv = self._server()
            t0 = time.perf_counter()
            if srv.draining():
                self._json(503, {"error": "draining"})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                payload = json.loads(self.rfile.read(length) or b"{}")
                arr, single = srv.parse_inputs(payload)
            except (ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
                return
            try:
                req = srv.predict(arr)
            except QueueFullError as e:
                self._json(503 if srv.draining() else 429, {"error": str(e)})
                return
            except TimeoutError as e:
                self._json(504, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 - worker-relayed
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            outs = req.output[0] if single else req.output
            self._json(200, {"outputs": outs.tolist(),
                             "ms": round((time.perf_counter() - t0) * 1000.0, 3),
                             "queue_ms": round(req.queue_ms, 3)})
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 - the server must survive
            try:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
            except OSError:  # client already gone
                pass

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        try:
            srv = self._server()
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            if path in ("/", "/status"):
                self._json(200, {"serving": srv.status()})
            elif path == "/healthz":
                if srv.draining():
                    self._json(503, {"ok": False, "draining": True})
                else:
                    self._json(200, {"ok": True})
            else:
                self.send_error(404)
        except Exception:  # noqa: BLE001 - the server must survive
            try:
                self.send_error(500)
            except OSError:
                pass

    def _json(self, code: int, obj: Dict[str, Any]) -> None:
        body = (json.dumps(obj) + "\n").encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args) -> None:  # per-request stderr stays quiet
        pass


def serve_model(model, input_spec, warmup: bool = True,
                **kwargs) -> ModelServer:
    """Build a :class:`ModelServer` and (by default) warm every bucket
    before returning — the one-call serving entry point."""
    server = ModelServer(model, input_spec, **kwargs)
    if warmup:
        server.warmup()
    return server
