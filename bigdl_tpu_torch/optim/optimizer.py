"""The Optimizer — the host-side training loop, ported from
``bigdl_tpu/optim/optimizer.py`` (``optim/Optimizer.scala:42``,
``optim/LocalOptimizer.scala``) for one device.

Fluent configuration (optim method, end trigger, validation,
checkpoint, gradient legs, compute dtype, health policy), epoch and
iteration accounting in ``state`` (``epoch``, ``neval``, ``records``),
validation and BTPU checkpoints on their triggers, and resume from the
newest verified checkpoint: the epoch's order is re-entered
(``LocalDataSet.set_position``) and the records already consumed are
skipped, so no batch is replayed or skipped, and the per-step seed
(``key0_seed``) rides in the loop state (``driver_state``), so
stochastic layers replay the same trajectory.

The compute is the ported ``TrainStep`` and ``EvalStep``.  Batches are
made on a host thread and copied to the device ahead of the step that
takes them (``_BatchPrefetcher``).  The loss of an iteration is read to
the host, with the health probe, as soon as it is launched wherever the
JAX loop needs the value before the next step: a health policy that can
halt (the default) or a trigger that reads ``loss``.  Otherwise it is
read after the next iteration has been launched, so the read does not
leave the device idle, and at once before validation and checkpoints.
A validation pass reads its counts once, at its end.

The JAX package's environment switches are arguments here:
``prefetch`` (``BIGDL_PREFETCH``, batches in flight, 0 for the
synchronous path), ``async_checkpoint`` (``BIGDL_ASYNC_CHECKPOINT``:
the files are written on a thread after the host copy of the state)
and :meth:`Optimizer.set_health_policy` (``BIGDL_HEALTH``; the default
halts after 3 consecutive non-finite steps).  A run with a checkpoint
path always resumes from it (``BIGDL_RESUME=auto``).  ``seed`` replaces
the global ``RNG`` of the JAX package: it keys the training set's epoch
order and draws ``key0_seed``.

Not ported yet: ``DistriOptimizer`` and ``set_parameter_sync`` (Queue
4), sharded checkpoints, the topology record, the failure-retry loop,
the straggler and preemption guards and fault injection (Queue 9), and
the telemetry, profiler control and summaries (Queue 10).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet, DataSet
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.optim.evaluator import evaluate_batches
from bigdl_tpu_torch.optim.health import (HealthError, HealthPolicy,
                                          probe_stats)
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import ValidationMethod
from bigdl_tpu_torch.utils import file as File

__all__ = ["Optimizer", "LocalOptimizer", "HealthError", "HealthPolicy"]

log = logging.getLogger("bigdl_tpu_torch.optim")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)


def _method_state(method) -> Dict:
    """The optim method's host-side ``state`` dict (the JAX
    ``OptimMethod.state``), made on first use."""
    if not isinstance(getattr(method, "state", None), dict):
        method.state = {}
    return method.state


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree


class _BatchPrefetcher:
    """A host thread pulls batches through the transformer chain and
    copies them to the device on a side stream while the device runs
    the previous steps; ``depth`` bounds the batches in flight
    (``_BatchPrefetcher`` of the JAX package, ``:152``)."""

    class _Error:
        def __init__(self, exc):
            self.exc = exc

    def __init__(self, data_iter, place, depth: int, metrics: Metrics):
        self._it = data_iter
        self._place = place
        self._metrics = metrics
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker,
                                        name="bigdl-prefetch", daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for batch in self._it:
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                placed = self._place(batch.get_input(), batch.get_target(),
                                     True)
                # producer-side time, overlapped with the device's work;
                # the training loop's stall is "data time"
                self._metrics.add("host to device time (overlapped)",
                                  time.perf_counter() - t0)
                self._put((batch.size(), placed))
            self._put(None)  # exhausted
        except BaseException as e:  # noqa: BLE001 - raised on next()
            self._put(self._Error(e))

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def next(self):
        """(batch size, placed (x, y, ready event)) or None when the
        iterator is exhausted; a producer's exception is raised here."""
        item = self._q.get()
        if isinstance(item, self._Error):
            raise item.exc
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


class Optimizer:
    """The one-device training loop.  ``dataset`` is an
    ``AbstractDataSet`` of MiniBatches, or a list of ``Sample`` with
    ``batch_size``.  ``device`` is ``cuda`` unless the caller passes
    ``"cpu"``."""

    def __init__(self, model, dataset, criterion,
                 batch_size: Optional[int] = None,
                 end_trigger: Optional[Trigger] = None, *,
                 optim_method: Optional[OptimMethod] = None, device=None,
                 seed: int = 0, prefetch: int = 2,
                 async_checkpoint: bool = True):
        if isinstance(dataset, (list, tuple)):
            if batch_size is None:
                raise ValueError("batch_size required when passing raw "
                                 "samples")
            dataset = DataSet.array(list(dataset), seed=seed).transform(
                SampleToMiniBatch(batch_size))
        self.device = resolve_device(device)
        self.model = model
        self.dataset: AbstractDataSet = dataset
        self.criterion = criterion
        self.optim_method: OptimMethod = optim_method or SGD()
        self.end_when: Trigger = end_trigger or Trigger.max_iteration(2 ** 62)
        self.seed = int(seed)
        self.prefetch = int(prefetch)
        self.async_checkpoint = bool(async_checkpoint)
        self.state: Dict = {"epoch": 1, "neval": 0}
        self.metrics = Metrics()
        #: (neval, epoch, loss) of every iteration this object ran
        self.history: List[Tuple[int, int, float]] = []
        #: [(method, result)] of the newest validation
        self.last_validation: List[Tuple[ValidationMethod, object]] = []
        self._val_trigger: Optional[Trigger] = None
        self._val_dataset = None
        self._val_methods: Sequence[ValidationMethod] = ()
        self._ckpt_path: Optional[str] = None
        self._ckpt_trigger: Optional[Trigger] = None
        self._ckpt_overwrite = False
        self._ckpt_dir: Optional[str] = None
        self._ckpt_pool: Optional[ThreadPoolExecutor] = None
        self._ckpt_future = None
        self.gradient_compression: Optional[str] = None
        self.compute_dtype: Optional[torch.dtype] = None
        self._grad_clip: Optional[Tuple[float, float]] = None
        self._grad_clip_norm: Optional[float] = None
        self._health_policy: Optional[HealthPolicy] = HealthPolicy()
        self.last_train_step = None

    # -- fluent configuration (Optimizer.scala:42-265) ----------------------
    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_validation(self, trigger: Trigger, dataset,
                       methods: Sequence[ValidationMethod],
                       batch_size: Optional[int] = None) -> "Optimizer":
        if isinstance(dataset, (list, tuple)):
            dataset = DataSet.array(list(dataset)).transform(
                SampleToMiniBatch(batch_size or 32))
        self._val_trigger = trigger
        self._val_dataset = dataset
        self._val_methods = list(methods)
        return self

    def set_checkpoint(self, path: str, trigger: Trigger) -> "Optimizer":
        """BTPU checkpoints ``model.N`` / ``optimMethod.N`` /
        ``ckptmeta.N.json`` under ``path`` (a time-stamped directory of
        this run unless :meth:`overwrite_checkpoint`) whenever
        ``trigger`` fires.  The JAX package's ``keep`` retention and
        sharded backend are not ported."""
        self._ckpt_path = path
        self._ckpt_trigger = trigger
        return self

    def overwrite_checkpoint(self) -> "Optimizer":
        self._ckpt_overwrite = True
        return self

    def set_model(self, model) -> "Optimizer":
        self.model = model
        return self

    def set_state(self, state: Dict) -> "Optimizer":
        self.state.update(state)
        return self

    def set_gradient_compression(self, mode: Optional[str]) -> "Optimizer":
        """``"bf16"``: the reference's FP16CompressedTensor truncation."""
        self.gradient_compression = mode
        return self

    def set_compute_dtype(self, dtype) -> "Optimizer":
        self.compute_dtype = dtype
        return self

    def set_constant_gradient_clipping(self, lo: float,
                                       hi: float) -> "Optimizer":
        self._grad_clip = (lo, hi)
        return self

    def set_gradient_clipping_by_l2_norm(self,
                                         max_norm: float) -> "Optimizer":
        self._grad_clip_norm = max_norm
        return self

    def set_health_policy(self, policy: Optional[HealthPolicy]
                          ) -> "Optimizer":
        """The training-health policy; None (or ``on_nonfinite="off"``)
        turns the probe off."""
        self._health_policy = policy
        return self

    # -- checkpoints ---------------------------------------------------------
    def _init_checkpoint_dir(self):
        if self._ckpt_path is None:
            return
        if self._ckpt_overwrite:
            self._ckpt_dir = self._ckpt_path
        else:
            stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
            self._ckpt_dir = File.join(self._ckpt_path, stamp)
        File.makedirs(self._ckpt_dir)

    def _join_checkpoint_write(self):
        """Wait for the checkpoint write in flight, if any."""
        fut, self._ckpt_future = self._ckpt_future, None
        if fut is not None:
            with self.metrics.timer("checkpoint wait time"):
                fut.result()

    def _save_checkpoint(self, step):
        """Host copies of the model and of the optim method (its
        ``state`` carrying the loop state and the step's optimizer
        state) are made now; the files, then the meta marker with their
        digests, are written after (on a thread under
        ``async_checkpoint``)."""
        from bigdl_tpu_torch.utils import ckpt_digest
        from bigdl_tpu_torch.utils.module_format import dumps

        n = self.state["neval"]
        mstate = _method_state(self.optim_method)
        mstate["driver_state"] = dict(self.state)
        mstate["func_state"] = step.opt_state
        self._join_checkpoint_write()  # the meta commits stay in order
        d = self._ckpt_dir
        blobs = [(dumps(self.model, kind="module"),
                  File.join(d, f"model.{n}")),
                 (dumps(self.optim_method, kind="optim"),
                  File.join(d, f"optimMethod.{n}"))]
        mstate.pop("func_state")  # device tensors: not kept between saves
        meta = {"neval": n,
                "digests": {os.path.basename(p): ckpt_digest.digest_bytes(b)
                            for b, p in blobs}}

        def write():
            for blob, path in blobs:
                File.save(blob, path, overwrite=True)
            File.save(json.dumps(meta).encode(),
                      File.join(d, f"ckptmeta.{n}.json"), overwrite=True)
            log.info(f"[Checkpoint] saved model.{n} / optimMethod.{n} "
                     f"to {d}")

        if self.async_checkpoint:
            if self._ckpt_pool is None:
                self._ckpt_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="bigdl-ckpt")
            self._ckpt_future = self._ckpt_pool.submit(write)
        else:
            write()

    @staticmethod
    def _numbers(d: str) -> List[int]:
        return sorted({int(m.group(1)) for f in File.listdir(d)
                       if (m := re.match(r"model\.(\d+)$", f))})

    @staticmethod
    def _verify(d: str, n: int) -> Tuple[bool, List[str]]:
        """The ``model.n`` / ``optimMethod.n`` pair against the digests
        of ``ckptmeta.n.json``; a pair without a marker passes when both
        files exist."""
        from bigdl_tpu_torch.utils import ckpt_digest

        try:
            meta = json.loads(File.load(
                File.join(d, f"ckptmeta.{n}.json")).decode())
        except (OSError, ValueError):
            meta = None
        if meta is None:
            both = all(File.exists(File.join(d, f"{p}.{n}"))
                       for p in ("model", "optimMethod"))
            return both, [] if both else [f"incomplete pair at {n}"]
        problems = ckpt_digest.verify_digests(d, meta.get("digests") or {})
        return not problems, problems

    @staticmethod
    def _quarantine(d: str, n: int, problems: List[str]):
        """Move a torn pair aside as ``*.corrupt``: never loaded again,
        kept as evidence."""
        for name in (f"model.{n}", f"optimMethod.{n}", f"ckptmeta.{n}.json"):
            p = File.join(d, name)
            if File.exists(p):
                dest, k = p + ".corrupt", 1
                while File.exists(dest):
                    dest, k = p + f".corrupt.{k}", k + 1
                File.rename(p, dest)
        log.error(f"[Checkpoint] quarantined checkpoint {n}: "
                  f"{'; '.join(problems)}")

    def _restore_from(self, d: str) -> bool:
        """Restore the newest checkpoint under ``d`` whose digests
        verify; a torn one is quarantined and the walk goes on to the one
        before it."""
        from bigdl_tpu_torch.utils.serializer import (load_module,
                                                      load_optim_method)

        for n in reversed(self._numbers(d)):
            ok, problems = self._verify(d, n)
            if ok:
                try:
                    model = load_module(File.join(d, f"model.{n}"))
                    method = load_optim_method(
                        File.join(d, f"optimMethod.{n}"))
                except Exception as e:  # noqa: BLE001 - treated as torn
                    ok, problems = False, [f"load failed: {e}"]
            if not ok:
                self._quarantine(d, n, problems)
                continue
            self.model, self.optim_method = model, method
            self.state.update(_method_state(method).pop("driver_state", {}))
            log.info(f"[Recovery] restored model.{n} and optimMethod.{n} "
                     f"from {d}")
            return True
        return False

    def _resume_sources(self) -> List[str]:
        """The directories a fresh run may resume from, best first: the
        checkpoint directory itself under ``overwrite_checkpoint``, else
        every earlier time-stamped run directory, newest first."""
        if self._ckpt_overwrite:
            return [self._ckpt_dir]
        me = os.path.basename(self._ckpt_dir)
        stamps = sorted((s for s in File.listdir(self._ckpt_path)
                         if re.fullmatch(r"\d{8}_\d{6}", s) and s != me),
                        reverse=True)
        return [File.join(self._ckpt_path, s) for s in stamps
                if any(f.startswith("model.")
                       for f in File.listdir(File.join(self._ckpt_path, s)))]

    def _maybe_resume(self):
        if self._ckpt_path is None or self.state.get("neval", 0) > 0:
            return
        for src in self._resume_sources():
            if self._restore_from(src):
                self.state["_resumed_from"] = src
                log.info(f"[Resume] continuing from {src} at iteration "
                         f"{self.state.get('neval', 0)} (epoch "
                         f"{self.state.get('epoch', 1)}, "
                         f"{self.state.get('records', 0)} records into it)")
                return
            log.warning(f"[Resume] no loadable checkpoint under {src}")

    @staticmethod
    def _fast_forward(data_iter, records: int):
        """Skip the batches a restored position says this epoch already
        consumed (host work only)."""
        skipped = 0
        while skipped < records:
            batch = next(data_iter, None)
            if batch is None:
                break
            skipped += batch.size()
        if skipped != records:
            log.warning(f"[Resume] skipped {skipped} records where the "
                        f"checkpoint recorded {records}: batch size "
                        f"changed between runs?")
        return data_iter

    # -- validation ------------------------------------------------------------
    def _validate(self, eval_step):
        if self._val_dataset is None:
            return
        t0 = time.perf_counter()
        results, count = evaluate_batches(
            eval_step, self._val_dataset.data(train=False),
            self._val_methods)
        if results is None:
            return
        wall = time.perf_counter() - t0
        log.info(f"[Validation] {count} records in {wall:.2f}s, throughput "
                 f"{count / max(wall, 1e-9):.1f} records/s")
        self.last_validation = list(zip(self._val_methods, results))
        for m, r in self.last_validation:
            log.info(f"[Validation] {m} is {r}")
            val, _ = r.result()
            self.state["score"] = val
            sched = getattr(self.optim_method, "schedule", None)
            if sched is not None and hasattr(sched, "on_metric"):
                sched.on_metric(val)

    # -- the loop --------------------------------------------------------------
    def optimize(self):
        """Train until the end trigger fires; returns the model."""
        self._init_checkpoint_dir()
        try:
            self._maybe_resume()
            return self._optimize_once()
        finally:
            self._join_checkpoint_write()
            if self._ckpt_pool is not None:
                self._ckpt_pool.shutdown()
                self._ckpt_pool = None

    def _place(self, x, y, side_stream: bool = False):
        """A batch on the device: (x, y, an event the consumer waits on
        or None).  On the card the prefetch thread copies from pinned
        memory on its own stream."""
        dev = self.device
        x = torch.from_numpy(np.ascontiguousarray(x))
        y = None if y is None else torch.as_tensor(np.asarray(y))
        if dev.type != "cuda":
            return x, y, None
        if not side_stream:
            return x.to(dev), None if y is None else y.to(dev), None
        stream = self._copy_stream
        with torch.cuda.stream(stream):
            xd = x.pin_memory().to(dev, non_blocking=True)
            yd = None if y is None else y.pin_memory().to(dev,
                                                          non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        return xd, yd, ready

    def _take(self, placed):
        x, y, ready = placed
        if ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ready)
            x.record_stream(cur)
            if y is not None:
                y.record_stream(cur)
        return x, y

    def _optimize_once(self):
        from bigdl_tpu_torch.parallel.train_step import EvalStep, TrainStep

        policy = self._health_policy
        health = policy.fresh() if policy is not None and policy.enabled \
            else None
        step = TrainStep(
            self.model, self.criterion, self.optim_method,
            compute_dtype=self.compute_dtype, device=self.device,
            gradient_compression=self.gradient_compression,
            gradient_clipping=self._grad_clip, max_norm=self._grad_clip_norm,
            health_probe=health is not None,
            skip_nonfinite=health is not None and health.skip_nonfinite)
        self.last_train_step = step
        saved = _method_state(self.optim_method).pop("func_state", None)
        if saved is not None:
            opt = _to_device(saved, self.device)
            for k in ("neval", "epoch"):
                v = opt[k]
                opt[k] = torch.as_tensor(v, dtype=torch.int32).to(
                    self.device) if step.skip_nonfinite else int(v)
            step.opt_state = opt
        eval_step = EvalStep(self.model, device=self.device)
        dataset_size = self.dataset.size()
        records_this_epoch = self.state.get("records", 0)
        if hasattr(self.dataset, "set_position"):
            self.dataset.set_position(self.state.get("epoch", 1) - 1)
        data_iter = self.dataset.data(train=True)
        if records_this_epoch > 0:
            data_iter = self._fast_forward(data_iter, records_this_epoch)
        if "key0_seed" not in self.state:
            self.state["key0_seed"] = int(np.random.default_rng(
                self.seed).integers(0, 2 ** 31 - 1))
        key0 = self.state["key0_seed"] << 32
        gen = torch.Generator(self.device)
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
        prefetcher = _BatchPrefetcher(data_iter, self._place, self.prefetch,
                                      self.metrics) \
            if self.prefetch > 0 else None
        triggers = [self.end_when, self._val_trigger, self._ckpt_trigger]
        # the JAX loop reads each step's loss and probe before the next
        # step where a trigger or the health halt needs them
        read_now = any(t is not None and getattr(t, "reads_loss", True)
                       for t in triggers) \
            or (health is not None and health.can_halt)
        epoch_start = time.perf_counter()
        first = True
        pending = None
        log.info(f"[Optimizer] start training on {self.device}")

        def finish(p):
            """The host read of one iteration: its loss (and health
            vector), the log line and the health policy."""
            t0 = time.perf_counter()
            vals = p["loss"].float().reshape(1)
            if p["health"] is not None:
                vals = torch.cat([vals, p["health"].float()])
            vals = vals.tolist()
            self.metrics.add("host read time", time.perf_counter() - t0)
            loss = vals[0]
            self.state["loss"] = loss
            self.history.append((p["neval"], p["epoch"], loss))
            wall = p["t_end"] - p["t_start"]
            log.info(f"[Epoch {p['epoch']} {p['records']}/{dataset_size}]"
                     f"[Iteration {p['neval']}] Trained {p['n']} records in "
                     f"{wall:.4f} seconds. Throughput is "
                     f"{p['n'] / max(wall, 1e-9):.1f} records/second. "
                     f"Loss is {loss:.5f}.")
            if health is not None:
                self._health_observe(health, p["neval"], vals[1:], loss)

        try:
            while not self.end_when(self.state):
                t_start = time.perf_counter()
                if prefetcher is not None:
                    item = prefetcher.next()
                    if item is None:
                        break  # a finite feed ran out
                    batch_n, placed = item
                else:
                    batch = next(data_iter, None)
                    if batch is None:
                        break
                    batch_n = batch.size()
                t_data = time.perf_counter()
                if prefetcher is None:
                    placed = self._place(batch.get_input(),
                                         batch.get_target())
                    self.metrics.add("host to device time",
                                     time.perf_counter() - t_data)
                x, y = self._take(placed)
                t0 = time.perf_counter()
                gen.manual_seed(key0 | self.state["neval"])
                loss = step.loss(x, y, gen)
                step.update(step.grads(loss))
                t_end = time.perf_counter()
                was_first, first = first, False
                self.metrics.add("compile + first iteration time" if was_first
                                 else "dispatch time", t_end - t0)
                if pending is not None:
                    finish(pending)  # overlapped with this step's work
                self.state["neval"] += 1
                records_this_epoch += batch_n
                self.state["records"] = records_this_epoch
                self.metrics.add("data time", t_data - t_start)
                pending = {"neval": self.state["neval"],
                           "epoch": self.state["epoch"],
                           "records": records_this_epoch, "n": batch_n,
                           "t_start": t_start, "t_end": t_end,
                           "loss": loss.detach(), "health": step.last_health}
                if read_now:  # may raise HealthError, as the JAX loop does
                    finish(pending)
                    pending = None
                self.state["_epoch_boundary"] = False
                if records_this_epoch >= dataset_size:
                    self.state["epoch"] += 1
                    ep = self.state["epoch"]
                    step.opt_state = dict(step.opt_state)
                    step.opt_state["epoch"] = torch.tensor(
                        ep, dtype=torch.int32, device=self.device) \
                        if step.skip_nonfinite else ep
                    records_this_epoch = 0
                    self.state["records"] = 0
                    self.state["_epoch_boundary"] = True
                    log.info(f"[Epoch {ep - 1}] finished in "
                             f"{time.perf_counter() - epoch_start:.2f}s")
                    epoch_start = time.perf_counter()
                val = self._val_trigger is not None \
                    and self._val_trigger(self.state)
                ckpt = self._ckpt_trigger is not None \
                    and self._ckpt_trigger(self.state)
                if pending is not None and (val or ckpt):
                    finish(pending)
                    pending = None
                if not was_first:
                    self.metrics.add("iteration time",
                                     time.perf_counter() - t_start)
                if val:
                    with self.metrics.timer("validation time"):
                        self._validate(eval_step)
                if ckpt:
                    with self.metrics.timer("checkpoint time"):
                        self._save_checkpoint(step)
            if pending is not None:
                finish(pending)
        finally:
            if prefetcher is not None:
                prefetcher.close()
        self._join_checkpoint_write()
        log.info(self.metrics.summary())
        return self.model

    def _health_observe(self, policy: HealthPolicy, n: int, vec, loss):
        """Fold one iteration's probe into the policy: log its findings
        and raise :class:`HealthError` when the halt predicate fires."""
        if not vec:
            return
        stats = probe_stats(vec, loss)
        action, findings = policy.observe(n, stats)
        if action == "ok":
            return
        log.warning(f"[Health] step {n}: "
                    f"{', '.join(name for name, _ in findings)} "
                    f"(loss={stats['loss']:.4g}, "
                    f"grad_norm={stats['grad_norm']:.4g}, "
                    f"update_ratio={stats['update_ratio']:.4g})")
        if action == "halt":
            consec = policy.state["consecutive_nonfinite"]
            reason = (f"{consec} consecutive nonfinite step(s)" if consec
                      else "halt_when trigger fired")
            raise HealthError(n, reason, policy.evidence(n, stats))


class LocalOptimizer(Optimizer):
    """Training on one device (``optim/LocalOptimizer.scala``)."""
