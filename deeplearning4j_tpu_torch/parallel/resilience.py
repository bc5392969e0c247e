"""Resilient-training runtime pieces (counterpart of
``deeplearning4j_tpu/parallel/resilience.py``): the supervised step
executor and the asynchronous checkpoint writer, shaped after CheckFreq
(frequent asynchronous checkpoints) and Bamboo/Varuna-style
preemption-tolerant training.

- :class:`TrainingSupervisor` wraps every train-step dispatch: injected
  :class:`~..faults.TransientFault`\\ s are retried with bounded
  exponential backoff (the fault fires BEFORE the step runs, so the
  step's inputs are untouched and the retry replays it bit for bit);
  with the anomaly guard built into the step
  (``_make_step_fn(guard=True)``), a batch whose loss or gradients go
  non-finite is skipped on the device (params, updater state and layer
  state select their previous values), counted, and after K
  CONSECUTIVE anomalies the supervisor rolls the model back to the last
  good host snapshot.
- :class:`AsyncCheckpointWriter` is one background thread that turns a
  host snapshot into a durable checkpoint file. The step loop pays only
  the device-to-host copy (:func:`~..util.serializer.
  snapshot_training_state`); serialization, fsync and the atomic
  rename run off the loop's thread. At most one write is in flight: a
  ``submit`` while the previous write runs waits for it first.

Nothing here runs unless a :class:`~.elastic.FaultTolerantTrainer` in
step mode drives it; a supervisor with no injector adds one ``None``
check a step.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..faults import FaultInjector, TransientFault
from ..profiler import Counter, OpProfiler
from ..util.serializer import _unflatten_like, snapshot_training_state


class TrainingAnomalyError(RuntimeError):
    """Raised when anomalies persist after a rollback exhausted
    ``max_rollbacks`` — the run cannot make progress and continuing
    would only burn device time on NaN batches."""


class TrainingSupervisor:
    """Per-step retry / anomaly / rollback policy for the supervised
    training loop (driven by ``FaultTolerantTrainer._fit_supervised``).

    ``fault_injector``: shared seeded injector (``train_step``,
    ``data_batch`` seams fire here; ``checkpoint_io``/``preempt`` fire
    in the trainer). ``None`` = zero overhead.
    ``anomaly_guard``: the step callable was built with
    ``guard=True`` and returns a trailing ``ok`` flag (a 0-d bool on
    the device).
    ``rollback_after``: K consecutive anomalous batches that trigger a
    rollback to the last good snapshot.
    """

    def __init__(self, fault_injector: Optional[FaultInjector] = None,
                 max_step_retries: int = 3,
                 retry_backoff_ms: float = 5.0,
                 anomaly_guard: bool = False,
                 rollback_after: int = 3,
                 max_rollbacks: int = 3):
        self.injector = fault_injector
        self.max_step_retries = int(max_step_retries)
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.anomaly_guard = bool(anomaly_guard)
        self.rollback_after = max(1, int(rollback_after))
        self.max_rollbacks = int(max_rollbacks)
        # counters are profiler.Counter so they read consistently from
        # listener threads / test asserts while the loop is running
        self.retries = Counter()
        self.anomalies_skipped = Counter()
        self.rollbacks = Counter()
        self.async_checkpoints = Counter()
        self.sync_checkpoints = Counter()
        self.sharded_checkpoints = Counter()   # format-v3 directory writes
        self.preemptions = Counter()
        # coordinated-preemption accounting: broadcasts this worker
        # ORIGINATED (its own SIGTERM / injected preempt) vs notices it
        # RECEIVED over the coordination channel (another worker's)
        self.preempts_broadcast = Counter()
        self.preempts_received = Counter()
        self.checkpoint_stall_s = 0.0   # step-loop time spent in
        self.checkpoint_write_s = 0.0   # snapshot+submit vs background
        self._consecutive = 0
        self._rollbacks_since_good = 0
        self._last_good: Optional[dict] = None
        # out-of-model state capture and restore (a ParallelWrapper's
        # gradient-sharing accumulator), registered by the trainer
        self.extra_state_fn: Optional[Callable[[], Optional[Dict]]] = None
        self.load_extra_fn: Optional[Callable[[Dict], None]] = None
        # observability hooks, attached by the trainer when telemetry
        # was requested; all default None so an unobserved run pays
        # nothing on the cold (retry/anomaly/rollback) branches and
        # NOTHING AT ALL on the happy path
        self.events = None           # EventTimeline
        self.fleet = None            # FleetTelemetry
        self.worker: Optional[int] = None
        self.obs = None              # trainer's retro-span ring

    # -- retry ----------------------------------------------------------
    def _fire_retrying(self, seam: str):
        """Fire ``seam``; retry transient fires with bounded backoff.
        Models re-fetching a batch / re-opening a file handle."""
        inj = self.injector
        if inj is None:
            return
        for attempt in range(self.max_step_retries + 1):
            try:
                inj.fire(seam)
                return
            except TransientFault:
                self.retries.inc()
                if attempt >= self.max_step_retries:
                    raise
                time.sleep(self.retry_backoff_ms * (2 ** attempt) / 1e3)

    # -- the supervised step -------------------------------------------
    def step(self, model, step_fn, x, y, mask, rng):
        """Dispatch one train step under the retry + anomaly policy.
        Returns ``(advanced, loss)``: ``advanced`` is False for a
        skipped anomalous batch (the model state is bit-unchanged and
        the optimizer step counter must not move — Adam's bias
        correction would otherwise skew against a run that never saw
        the bad batch)."""
        self._fire_retrying("data_batch")
        inj = self.injector
        attempt = 0
        while True:
            try:
                if inj is not None:
                    # fires BEFORE the step runs: its inputs are
                    # untouched, so the retry replays bit-exactly
                    inj.fire("train_step")
                out = step_fn(model._params, model._opt_state,
                              model._net_state, model._step,
                              x, y, mask, rng)
                break
            except TransientFault:
                self.retries.inc()
                if attempt >= self.max_step_retries:
                    raise
                t_r = time.perf_counter()
                time.sleep(self.retry_backoff_ms * (2 ** attempt) / 1e3)
                if self.obs is not None:
                    self.obs.append(("retry", t_r, time.perf_counter(),
                                     {"attempt": attempt + 1,
                                      "seam": "train_step"}))
                attempt += 1
        if self.anomaly_guard:
            params, opt, net, loss, ok = out
            ok = bool(ok)          # one scalar host sync per step
        else:
            params, opt, net, loss = out
            ok = True
        # commit even when skipped: the guarded step already selected
        # the original values on the device (bitwise identical)
        model._params = {k: {n: t.requires_grad_(True)
                             for n, t in p.items()}
                         for k, p in params.items()}
        model._opt_state, model._net_state = opt, net
        if ok:
            self._consecutive = 0
            self._rollbacks_since_good = 0
            return True, loss
        self.anomalies_skipped.inc()
        if self.events is not None:
            self.events.record("anomaly_skip", worker=self.worker,
                               step=int(model._step))
        if self.fleet is not None:
            self.fleet.inc(self.worker or 0, "anomaly_skips")
        self._consecutive += 1
        if self._consecutive >= self.rollback_after:
            self._consecutive = 0
            if self._rollbacks_since_good >= self.max_rollbacks:
                raise TrainingAnomalyError(
                    f"still anomalous after {self.max_rollbacks} "
                    "rollbacks — aborting instead of spinning on NaN "
                    "batches")
            self.rollback(model)
        return False, loss

    # -- snapshots / rollback ------------------------------------------
    def capture_good(self, model, cursor: Optional[dict] = None) -> dict:
        """Device→host copy of the full resumable state (the ONLY
        blocking part of an async checkpoint; also the rollback
        source). Includes the registered extra state (a
        ParallelWrapper's gathered residuals and per-worker updater
        moments: a collective on every rank)."""
        extra = self.extra_state_fn() if self.extra_state_fn else None
        with OpProfiler.get_instance().record("resilient.snapshot"):
            snap = snapshot_training_state(model, cursor=cursor,
                                           extra=extra)
        self._last_good = snap
        return snap

    @property
    def last_good(self) -> Optional[dict]:
        return self._last_good

    def rollback(self, model):
        """Restore the last good in-memory snapshot: params, updater
        state, net state, PRNG key, step counter and registered extra
        state — coherently, so optimizer moments and gradient-sharing
        residuals match the params they were captured with. The data
        stream keeps moving forward (rolling the iterator back would
        replay the same poisoned region)."""
        snap = self._last_good
        if snap is None:
            return False
        t0 = time.perf_counter()
        opt = model._opt_state
        model.set_params(_unflatten_like(model._params, snap["params"]))
        if snap.get("opt_state") is not None:
            model.set_updater_state(_unflatten_like(opt,
                                                    snap["opt_state"]))
        if snap.get("net_state"):
            model.set_net_state(_unflatten_like(model._net_state,
                                                snap["net_state"]))
        meta = snap["meta"]
        model._step = meta["step"]
        if meta.get("rng") is not None:
            model._rng = (int(meta["rng"][0]), int(meta["rng"][1]))
        if snap.get("extra") and self.load_extra_fn is not None:
            self.load_extra_fn(snap["extra"])
        self.rollbacks.inc()
        self._rollbacks_since_good += 1
        if self.obs is not None:
            self.obs.append(("rollback", t0, time.perf_counter(),
                             {"to_step": int(meta["step"])}))
        if self.events is not None:
            self.events.record("rollback", worker=self.worker,
                               to_step=int(meta["step"]))
        if self.fleet is not None:
            self.fleet.inc(self.worker or 0, "rollbacks")
        return True

    def snapshot(self) -> Dict:
        """Counters for tests / GET-stats-style reporting / the bench
        training_chaos probe."""
        return {
            "retries": self.retries.value(),
            "anomalies_skipped": self.anomalies_skipped.value(),
            "rollbacks": self.rollbacks.value(),
            "async_checkpoints": self.async_checkpoints.value(),
            "sync_checkpoints": self.sync_checkpoints.value(),
            "sharded_checkpoints": self.sharded_checkpoints.value(),
            "preemptions": self.preemptions.value(),
            "preempts_broadcast": self.preempts_broadcast.value(),
            "preempts_received": self.preempts_received.value(),
            "checkpoint_stall_s": round(self.checkpoint_stall_s, 6),
            "checkpoint_write_s": round(self.checkpoint_write_s, 6),
        }


class AsyncCheckpointWriter:
    """Single background writer turning host snapshots into durable
    checkpoint files (CheckFreq's async phase).

    At most ONE write is in flight: ``submit`` first waits out any
    running write (bounding staleness to one cadence and memory to two
    snapshots), then hands the new one to the worker and returns — the
    step loop never waits for fsync. ``write_fn(snap, path)`` performs
    the actual atomic write (the trainer passes its temp+rename+fsync
    machinery, checkpoint_io seam included)."""

    def __init__(self, write_fn: Callable[[dict, str], None]):
        self._write_fn = write_fn
        self._cv = threading.Condition()
        self._pending = None          # (snap, path) awaiting the worker
        self._busy = False            # worker mid-write
        self._closed = False
        self._error: Optional[BaseException] = None
        self.write_s_total = 0.0
        self.writes = 0
        self._thread = threading.Thread(
            target=self._run, name="elastic-async-ckpt", daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            with self._cv:
                while self._pending is None and not self._closed:
                    self._cv.wait()
                if self._pending is None and self._closed:
                    return
                snap, path = self._pending
                self._pending = None
                self._busy = True
            t0 = time.perf_counter()
            try:
                with OpProfiler.get_instance().record(
                        "resilient.checkpoint_write"):
                    self._write_fn(snap, path)
            except BaseException as e:  # noqa: BLE001 — surfaced on
                self._error = e         # the next submit/wait
            finally:
                # drop the snapshot reference NOW: this loop may idle
                # until close(), and the local would otherwise pin a
                # full model+updater host copy for that whole time
                snap = path = None
                with self._cv:
                    self.write_s_total += time.perf_counter() - t0
                    self.writes += 1
                    self._busy = False
                    self._cv.notify_all()

    def submit(self, snap: dict, path: str):
        """Queue one snapshot for writing; blocks only while a PREVIOUS
        write is still running (backpressure), never for this one."""
        with self._cv:
            if self._closed:
                raise RuntimeError("checkpoint writer is closed")
            while self._busy or self._pending is not None:
                self._cv.wait()
            self._raise_pending_error()
            self._pending = (snap, path)
            self._cv.notify_all()

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        """Block until all submitted writes are durably on disk (fit()
        calls this before returning — an 'async' checkpoint that could
        vanish with the process would not be a checkpoint)."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._cv:
            while self._busy or self._pending is not None:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(timeout=remaining)
            self._raise_pending_error()
        return True

    def _raise_pending_error(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    @property
    def closed(self) -> bool:
        return self._closed

    def snapshot(self) -> Dict:
        """Queue/stall state for the training /metrics plane: completed
        writes, cumulative background write seconds, and whether a
        write is in flight or queued right now."""
        with self._cv:
            return {
                "writes": self.writes,
                "write_s_total": round(self.write_s_total, 6),
                "busy": int(self._busy),
                "pending": int(self._pending is not None),
                "closed": int(self._closed),
            }

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=10)
