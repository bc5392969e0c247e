"""Micro-batching scheduler: coalesce concurrent requests into one
device call (counterpart of ``deeplearning4j_tpu/serving/batcher.py``,
lifted: it touches the device only through the engine).

A bounded request queue feeds a single scheduler thread that waits up
to ``max_latency_ms`` for the batch to fill (or ``max_batch_size``
rows, whichever first), issues ONE padded device call through the
:class:`~.engine.InferenceEngine` (a CUDA graph's replay on the card),
and scatters the rows back to the waiting clients.

Overload semantics are explicit: a full queue SHEDS the request
(:class:`QueueFullError` → HTTP 503) rather than growing without
bound, and every request carries a deadline
(:class:`DeadlineExceededError` → HTTP 504) so a stalled device cannot
strand clients forever.

Admission control: requests carry a priority class — ``interactive``
(default) or ``batch`` — and under pressure batch work is shed FIRST:
batch-class requests only get the front ``batch_queue_fraction`` of
the queue, interactive requests get all of it. Admission is also
deadline-aware and adaptive: the batcher keeps an EWMA of the
device-call time and (a) sheds at submit when the estimated queue wait
alone already blows the request's deadline budget (503 — another,
shorter-queued replica may still make it), and (b) drops a request at
dequeue when its remaining budget cannot cover even one device call
(504) — zero device steps are ever spent on a request that cannot
finish in time. A call that paid a graph capture never feeds the
EWMA.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Optional, Sequence

from ..profiler import OpProfiler
from .engine import (ClientError, InferenceEngine, ServingError,
                     _concat_results, _slice)
from .faults import TransientFault, poll_until_idle


class QueueFullError(ServingError):
    """Load shed: the request queue is at capacity (HTTP 503)."""


class DrainingError(QueueFullError):
    """The server is draining for shutdown: new work is rejected with
    503 + ``Retry-After`` while in-flight requests finish."""


class DeadlineExceededError(ServingError):
    """The request's deadline passed before a result was ready
    (HTTP 504)."""


#: Priority classes, in shed order: under pressure "batch" is shed
#: first so "interactive" p99 holds. Anything else is a ClientError.
PRIORITIES = ("interactive", "batch")


class _Request:
    __slots__ = ("feed", "n", "sig", "deadline", "priority", "event",
                 "result", "error", "t_submit", "abandoned", "_lock",
                 "_timeout_counted", "trace", "qspan")

    def __init__(self, feed, n, sig, deadline, priority="interactive"):
        self.feed = feed
        self.n = n
        self.sig = sig
        self.deadline = deadline
        self.priority = priority
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        self.abandoned = False  # submitter gave up; don't execute/count
        self._lock = threading.Lock()
        self._timeout_counted = False
        self.trace = None   # tracing.Trace when the request is traced
        self.qspan = None   # its open queue-wait span

    def count_timeout_once(self, metrics) -> None:
        """Waiter and scheduler can both observe the deadline expiring
        at the same instant; the counter must move once per request."""
        with self._lock:
            if self._timeout_counted:
                return
            self._timeout_counted = True
        metrics.inc("timeouts")


class MicroBatcher:
    """Thread-based request queue + scheduler over one engine.

    ``submit`` blocks the calling (HTTP handler) thread until its rows
    come back; the scheduler thread owns all device calls, so requests
    admitted while one batch executes pile up and ride the next call —
    that queueing is exactly what produces coalescing under load.
    """

    def __init__(self, engine: InferenceEngine,
                 max_batch_size: Optional[int] = None,
                 max_latency_ms: float = 5.0,
                 max_queue: int = 256,
                 default_timeout_ms: float = 30_000.0,
                 max_retries: int = 3,
                 retry_backoff_ms: float = 1.0,
                 retry_backoff_max_ms: float = 50.0,
                 stall_timeout_s: float = 30.0,
                 batch_queue_fraction: float = 0.5):
        self.engine = engine
        self.max_batch_size = int(max_batch_size or engine.max_batch_size)
        if self.max_batch_size > engine.max_batch_size:
            raise ValueError("batcher max_batch_size exceeds the engine's")
        self.max_latency_ms = float(max_latency_ms)
        self.default_timeout_ms = float(default_timeout_ms)
        # supervision: a TransientFault from the device call is retried
        # up to max_retries times with bounded exponential backoff (the
        # inference path is stateless — no donation — so a retry is
        # always safe); anything else fails the batch as before
        self.max_retries = int(max_retries)
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.retry_backoff_max_ms = float(retry_backoff_max_ms)
        self.stall_timeout_s = float(stall_timeout_s)
        self.metrics = engine.metrics
        self.metrics.queue_max = int(max_queue)
        # priority shedding: batch-class work only gets the front
        # fraction of the queue; interactive gets all of it
        self.batch_queue_fraction = float(batch_queue_fraction)
        self._batch_queue_limit = max(
            1, int(self.batch_queue_fraction * max_queue))
        # adaptive admission: EWMA of one device call, measured — the
        # deadline-budget checks key off it, so the limits track the
        # actual service rate instead of a hand-tuned constant
        self._device_ewma_ms = 0.0
        # total ROWS waiting (in the queue, signature-held, or in a
        # batch being formed): the queue-wait estimate must count
        # rows, not requests — one queued request can carry up to
        # max_batch_size rows
        self._pending_rows = 0
        self._rows_lock = threading.Lock()
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        # submit-wake: an idle scheduler parks on this event instead of
        # polling the queue every 50 ms — set by submit()
        # after each enqueue and by stop() so shutdown is immediate
        self._wake = threading.Event()
        self._held: "deque[_Request]" = deque()  # signature-mismatched
        self._profiler = OpProfiler.get_instance()
        self._running = True
        self._draining = False
        self._beat = time.monotonic()  # scheduler heartbeat (/healthz)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-batcher")
        self._thread.start()

    # -- client side ---------------------------------------------------
    def submit(self, inputs, outputs: Optional[Sequence[str]] = None,
               timeout_ms: Optional[float] = None,
               priority: str = "interactive", trace=None) -> Any:
        """Enqueue one request and block until its result. Raises
        :class:`~.engine.ClientError` on malformed payloads,
        :class:`QueueFullError` when shedding, and
        :class:`DeadlineExceededError` past the deadline. ``priority``
        is ``"interactive"`` (default) or ``"batch"``; batch-class
        work is shed first under pressure. ``trace`` (a
        :class:`~..tracing.Trace`, default ``None`` = untraced) records
        the admission verdict — with the EWMA estimates that drove it —
        plus queue-wait and device spans."""
        if trace is not None:
            return self._submit_traced(inputs, outputs, timeout_ms,
                                       priority, trace)
        return self._submit(inputs, outputs, timeout_ms, priority, None)

    def _submit_traced(self, inputs, outputs, timeout_ms, priority,
                       trace):
        """Wrap :meth:`_submit` so every shed/timeout path lands the
        admission verdict in the trace exactly once."""
        t0 = time.perf_counter()
        try:
            return self._submit(inputs, outputs, timeout_ms, priority,
                                trace)
        except (QueueFullError, DeadlineExceededError) as e:
            trace.span(
                "admission", t_start=t0, verdict="shed",
                error=str(e),
                device_ewma_ms=round(self._device_ewma_ms, 3),
                est_wait_ms=round(
                    self._est_queue_wait_ms(self._pending_rows), 3)
            ).end()
            raise

    def _submit(self, inputs, outputs, timeout_ms, priority,
                trace) -> Any:
        if priority not in PRIORITIES:
            raise ClientError(
                f"unknown priority {priority!r}; expected one of "
                f"{PRIORITIES}")
        if self._draining:
            # checked before _running: a drained replica answers 503 +
            # Retry-After (retry elsewhere), not 500, for its lifetime
            self.metrics.inc("shed")
            raise DrainingError("batcher is draining; retry against "
                                "another replica")
        if not self._running:
            raise ServingError("batcher is stopped")
        feed, n, sig = self.engine.normalize(inputs, outputs)
        if n > self.max_batch_size:
            raise ClientError(
                f"request batch {n} exceeds max_batch_size="
                f"{self.max_batch_size}; split the request")
        timeout = (self.default_timeout_ms if timeout_ms is None
                   else float(timeout_ms)) / 1000.0
        depth = self._queue.qsize()
        if priority == "batch" and depth >= self._batch_queue_limit:
            # shed order: batch first — interactive may still use the
            # remaining queue, so its p99 holds while batch degrades
            self.metrics.inc("shed")
            self.metrics.inc("shed_batch")
            raise QueueFullError(
                f"queue depth {depth} at the batch-priority limit "
                f"({self._batch_queue_limit}/{self.metrics.queue_max});"
                f" shedding batch-class work first")
        est_wait_ms = self._est_queue_wait_ms(self._pending_rows)
        if est_wait_ms + self._device_ewma_ms > timeout * 1e3:
            # deadline-aware early rejection at SUBMIT. Two distinct
            # verdicts: a budget smaller than ONE device call can
            # never be met anywhere (504, same as expiring in queue);
            # a budget eaten by THIS queue's wait is load-local (503 —
            # a shorter-queued replica may still make it)
            self.metrics.inc("shed_deadline")
            if self._device_ewma_ms > timeout * 1e3:
                self.metrics.inc("timeouts")
                raise DeadlineExceededError(
                    f"deadline budget {timeout * 1e3:.0f} ms is below "
                    f"one device call ({self._device_ewma_ms:.0f} ms);"
                    f" rejecting at admission")
            self.metrics.inc("shed")
            raise QueueFullError(
                f"estimated queue wait {est_wait_ms:.0f} ms exceeds "
                f"the {timeout * 1e3:.0f} ms deadline budget; shedding"
                f" at admission")
        req = _Request(feed, n, sig,
                       deadline=time.perf_counter() + timeout,
                       priority=priority)
        if trace is not None:
            # attach BEFORE enqueue: the scheduler may dequeue the
            # request the instant it lands
            req.trace = trace
            trace.span("admission", t_start=req.t_submit,
                       verdict="admitted",
                       est_wait_ms=round(est_wait_ms, 3),
                       device_ewma_ms=round(self._device_ewma_ms, 3),
                       rows=n).end()
            req.qspan = trace.span("queue", rows=n, priority=priority)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self.metrics.inc("shed")
            raise QueueFullError(
                f"queue full ({self.metrics.queue_max}); shedding load")
        with self._rows_lock:
            self._pending_rows += req.n
        self._wake.set()
        if not self._running:
            # raced with stop(): the scheduler may already have drained
            # the queue — fail fast, don't strand the caller on wait()
            req.abandoned = True
            raise ServingError("batcher is stopped")
        self.metrics.inc("requests")
        self.metrics.queue_depth = self._queue.qsize()
        if not req.event.wait(timeout + 1.0):  # grace for the device call
            req.abandoned = True  # scheduler: skip it, don't re-execute
            req.count_timeout_once(self.metrics)
            raise DeadlineExceededError(
                f"no result within {timeout * 1e3:.0f} ms")
        if req.error is not None:
            raise req.error
        self.metrics.inc("responses")
        self.metrics.latency_ms.record(
            (time.perf_counter() - req.t_submit) * 1e3)
        return req.result

    def _est_queue_wait_ms(self, rows: int) -> float:
        """Estimated time for ``rows`` queued ROWS to drain, from the
        measured device-call EWMA. 0.0 until the first call lands (a
        cold batcher admits everything — no data, no shedding)."""
        if not self._device_ewma_ms or rows <= 0:
            return 0.0
        calls = -(-rows // self.max_batch_size)  # ceil division
        return calls * self._device_ewma_ms

    def _rows_done(self, n: int):
        """``n`` rows left the pending set (executed, expired, or
        failed at stop) — keep the queued-rows gauge honest."""
        with self._rows_lock:
            self._pending_rows -= n

    # -- scheduler side ------------------------------------------------
    def _next(self, block_s: Optional[float]):
        if self._held:
            return self._held.popleft()
        try:
            return self._queue.get(timeout=block_s) if block_s else \
                self._queue.get_nowait()
        except queue.Empty:
            return None

    def _next_head(self):
        """Pop the next batch HEAD without idle-polling: the old
        ``_next(0.05)`` woke an idle scheduler 20 times a second just
        to find the queue still empty. Instead, park on the
        submit-wake event (1 s backstop in case a wake is ever lost)
        — idle wakeups drop ~20x and a submit still starts its batch
        immediately. The fill loop keeps its timed ``queue.get``: that
        wait is the deliberate batch-forming window, not a poll."""
        if self._held:
            return self._held.popleft()
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            pass
        # clear-then-recheck closes the lost-wakeup race: a submit
        # landing between the failed pop and clear() re-sets the event
        # and the second pop sees its request
        self._wake.clear()
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            # bounded well under the stall watchdog so an idle
            # batcher's heartbeat never looks wedged to /healthz
            self._wake.wait(
                max(0.05, min(1.0, self.stall_timeout_s / 4.0)))
            return None

    def _expired(self, req) -> bool:
        """Drop a dead request instead of spending device time on rows
        nobody will read. Deadline-BUDGET aware: a request whose
        remaining budget cannot cover even one device call (EWMA) is
        already lost — shed it at dequeue-admission, before it burns a
        device step. The timeout count is a per-request CAS — the
        waiter may be counting the same expiry concurrently."""
        if req.abandoned:
            self._rows_done(req.n)
            return True
        if time.perf_counter() > req.deadline - self._device_ewma_ms / 1e3:
            req.error = DeadlineExceededError(
                "deadline budget exhausted in queue")
            req.count_timeout_once(self.metrics)
            self.metrics.inc("shed_deadline")
            self._rows_done(req.n)
            if req.trace is not None:
                req.qspan.end()
                req.trace.span(
                    "admission", verdict="expired",
                    device_ewma_ms=round(self._device_ewma_ms, 3)).end()
            req.event.set()
            return True
        return False

    def _loop(self):
        while self._running:
            self._beat = time.monotonic()
            head = self._next_head()
            if head is None or self._expired(head):
                continue
            batch = [head]
            rows = head.n
            flush_at = time.perf_counter() + self.max_latency_ms / 1000.0
            skipped = []
            while rows < self.max_batch_size:
                wait = flush_at - time.perf_counter()
                nxt = self._next(wait if wait > 0 else None)
                if nxt is None:
                    break
                if self._expired(nxt):
                    continue
                if nxt.sig != head.sig:
                    skipped.append(nxt)  # rides a later batch; keep
                    continue             # filling this one
                if rows + nxt.n > self.max_batch_size:
                    skipped.append(nxt)
                    break  # same sig but over budget — batch is full
                batch.append(nxt)
                rows += nxt.n
            self._held.extend(skipped)
            # final expiry sweep: members (the head included) can age
            # out DURING the fill wait — dead rows must not ride the
            # device call, and an all-expired batch must skip the call
            # entirely. _expired counts each drop exactly once (CAS
            # against the waiter's own timeout accounting).
            batch = [r for r in batch if not self._expired(r)]
            if batch:
                n_rows = sum(r.n for r in batch)
                self._rows_done(n_rows)
                self._execute(batch, n_rows)
            self.metrics.queue_depth = self._queue.qsize()
        # drain on stop: fail fast rather than strand waiters
        for req in list(self._held):
            self._rows_done(req.n)
            req.error = ServingError("batcher stopped")
            req.event.set()

    def _execute(self, batch, rows):
        feeds = [r.feed for r in batch]
        feed = feeds[0] if len(feeds) == 1 else _concat_results(feeds)
        self.metrics.inc("batches")
        self.metrics.batch_hist.record(rows)
        for r in batch:
            if r.trace is not None:  # queue wait ends as the batch forms
                r.qspan.end(batch_rows=rows)
        # live-occupancy gauge for the /stats summary: rows on the
        # device RIGHT NOW (a fleet router reads it to steer load)
        self.metrics.inflight = rows
        try:
            self._execute_inner(batch, rows, feed)
        finally:
            self.metrics.inflight = 0

    def _captures(self):
        """What moves when a device call pays a capture: the counted
        compiles and the engine's captures, recaptures included."""
        return self.metrics.compiles, self.engine.captures

    def _execute_inner(self, batch, rows, feed):
        backoff = self.retry_backoff_ms / 1e3
        attempt = 0
        while True:
            c0 = self._captures()
            t0 = time.perf_counter()  # device_ms times the call that
            try:                      # succeeded, not the backoffs
                with self._profiler.record("serving.batch"):
                    # rows were normalized in submit(); the sig is
                    # shared by construction — skip re-validating on
                    # the hot path
                    res = self.engine.predict_normalized(feed, rows,
                                                         batch[0].sig)
                break
            except TransientFault as e:
                # raised before the device call touched anything —
                # retry the SAME batch with bounded backoff; give up
                # only after max_retries and fail the batch like any
                # other device error
                attempt += 1
                if attempt > self.max_retries:
                    for r in batch:
                        r.error = e
                        r.event.set()
                    return
                self.metrics.inc("retries")
                time.sleep(backoff)
                backoff = min(backoff * 2.0,
                              self.retry_backoff_max_ms / 1e3)
            except Exception as e:  # noqa: BLE001 — scatter to waiters
                for r in batch:
                    r.error = e
                    r.event.set()
                return
        t1 = time.perf_counter()
        dt_ms = (t1 - t0) * 1e3
        self.metrics.device_ms.record(dt_ms)
        for r in batch:
            if r.trace is not None:
                # retroactive: the device window measured above, not a
                # second clock read per row
                r.trace.span("device", t_start=t0, t_end=t1,
                             batch_rows=rows, retries=attempt)
        # feed the adaptive-admission EWMA (scheduler thread only) —
        # but never from a call that paid a graph capture, the lazy
        # one of a miss or the uncounted one over new weights: one
        # multi-second sample would push the estimate above every
        # deadline budget, and with all traffic then shed at submit
        # no new samples could ever decay it back down
        if self._captures() == c0:
            self._device_ewma_ms = dt_ms if not self._device_ewma_ms \
                else 0.8 * self._device_ewma_ms + 0.2 * dt_ms
        lo = 0
        for r in batch:
            r.result = _slice(res, lo, lo + r.n)
            lo += r.n
            r.event.set()

    @property
    def draining(self) -> bool:
        """True once :meth:`drain` has started (new submits shed with
        503 + Retry-After). Surfaced in the /stats summary so external
        load balancers steer away without parsing error counters."""
        return self._draining

    def alive(self) -> bool:
        """Liveness for ``/healthz``: False only when the scheduler is
        WEDGED — thread dead while it should run, or no heartbeat
        within ``stall_timeout_s`` (the loop beats every iteration,
        bounded by its 50 ms idle poll, so a stale beat means a stuck
        device call). A deliberately stopped/drained batcher is not
        wedged."""
        if not self._running:
            return True
        if not self._thread.is_alive():
            return False
        return (time.monotonic() - self._beat) <= self.stall_timeout_s

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown: reject new submits with 503
        (:class:`DrainingError`), let queued + in-flight requests
        finish, then join the scheduler thread. Returns True when the
        queue fully drained within ``timeout_s`` (leftovers past the
        budget are failed by :meth:`stop`)."""
        first = not self._draining
        self._draining = True
        if first:
            self.metrics.inc("drains")
        clean = poll_until_idle(
            lambda: self._queue.empty() and not self._held, timeout_s)
        # the scheduler finishes its in-flight batch (waiters get their
        # results) before observing _running=False; join covers it
        self.stop()
        return clean

    def stop(self, timeout_s: float = 5.0):
        self._running = False
        self._wake.set()  # unpark an idle scheduler immediately
        self._thread.join(timeout=timeout_s)
        # fail anything still queued
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            self._rows_done(req.n)
            req.error = ServingError("batcher stopped")
            req.event.set()



