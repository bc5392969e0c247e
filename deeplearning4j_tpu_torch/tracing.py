"""Request-scoped tracing for the serving stack (counterpart of
``deeplearning4j_tpu/tracing.py``, lifted: stdlib only, the same
classes, rings and serialised form, so ``tools/trace_report.py`` reads
the port's dumps as it reads the JAX package's).

One trace follows a request through
:class:`~.serving.generation.GenerationEngine`: the ``admission``
verdict and the ``queue`` wait at submit, ``prefix_match``,
``offload_restore`` and one ``prefill`` span per call (per chunk on the
paged backend) at admission, ``recovery`` when the fault ladder
re-admits it, and at its end the ``decode`` (or ``error``),
``step_pipeline``, ``draft`` and ``verify`` spans, rebuilt from what
the engine keeps per request. The HTTP server
(:class:`~.serving.InferenceServer`) mints request ids (its
``X-Request-Id`` is what :func:`new_request_id` mints), opens the
``http`` span, records the micro-batcher's ``admission``, ``queue`` and
``device`` spans on ``/predict`` and serves ``GET /debug/traces``;
stitching a fleet router's hops into the same trace comes with the
fleet (ROADMAP.md queue A, item 9c).

Design rules:

- **Zero cost when disabled.** ``Tracer.begin`` returns ``None`` unless
  tracing was enabled (or the caller forces a one-off trace); every
  instrumentation site guards with a single ``if trace is not None`` on
  an attribute that defaults to ``None``, the pattern the fault
  injector's seams use. The decode hot loop carries NO instrumentation:
  its span is built at request completion from fields the engine
  already keeps (``t_first``/``t_last``/token count), so even enabled
  tracing adds nothing per decode step, and nothing on the device.
- **Hedge-safe.** A hedged request's duplicate dispatches share one
  :class:`Trace`; span ids come from a per-trace counter
  (``itertools.count``, atomic under the GIL, like ``list.append``),
  so concurrent arms record distinct spans without locking.
- **Bounded.** Finished traces are filed into fixed-size rings
  (recent / slow / errored); nothing grows with traffic.

Times are ``time.perf_counter()`` (monotonic). Serialized spans carry
offsets relative to their trace start, so dumps from different
processes can sit side by side in one report even though their
absolute clocks are unrelated.
"""
from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Trace", "Tracer", "new_request_id"]


def new_request_id() -> str:
    """A fresh 16-hex-char request id (minted by whichever HTTP hop
    sees the request first; downstream hops propagate it verbatim)."""
    return uuid.uuid4().hex[:16]


class Span:
    """One timed stage inside a trace. Create via :meth:`Trace.span`;
    close with :meth:`end` or use as a context manager. ``attrs`` is a
    plain dict of JSON-serializable annotations (verdicts, EWMA
    estimates, replica ids, ...)."""

    __slots__ = ("span_id", "parent_id", "kind", "t_start", "t_end",
                 "attrs")

    def __init__(self, span_id: int, parent_id: Optional[int], kind: str,
                 t_start: float, attrs: Dict[str, Any]):
        self.span_id = span_id
        self.parent_id = parent_id
        self.kind = kind
        self.t_start = t_start
        self.t_end: Optional[float] = None
        self.attrs = attrs

    def end(self, **attrs) -> "Span":
        """Close the span (idempotent for timing; attrs always merge)."""
        if self.t_end is None:
            self.t_end = time.perf_counter()
        if attrs:
            self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None and "error" not in self.attrs:
            self.attrs["error"] = repr(exc)
        self.end()

    def to_dict(self, t0: float) -> Dict[str, Any]:
        dur = (None if self.t_end is None
               else round((self.t_end - self.t_start) * 1e3, 4))
        return {"span_id": self.span_id,
                "parent_id": self.parent_id,
                "kind": self.kind,
                "t_offset_ms": round((self.t_start - t0) * 1e3, 4),
                "duration_ms": dur,
                "attrs": dict(self.attrs)}


class Trace:
    """All spans recorded for one request by one component. The
    ``trace_id`` is the propagated request id, so dumps taken from the
    router and from each replica stitch into one logical trace."""

    __slots__ = ("trace_id", "request_id", "t_start", "t_end", "error",
                 "spans", "_ids")

    def __init__(self, request_id: str):
        self.trace_id = request_id
        self.request_id = request_id
        self.t_start = time.perf_counter()
        self.t_end: Optional[float] = None
        self.error = False
        # appends are GIL-atomic: hedge arms add spans concurrently
        self.spans: List[Span] = []
        self._ids = itertools.count(1)

    def span(self, kind: str, parent: Optional[Span] = None,
             t_start: Optional[float] = None,
             t_end: Optional[float] = None, **attrs) -> Span:
        """Open a span. Pass ``t_start``/``t_end`` to record a stage
        retroactively (how the decode span avoids touching the hot
        loop); otherwise the span opens now and closes at ``end()``.
        With no explicit ``parent``, spans after the first attach to
        the trace's root (the component's entry span — ``http`` on a
        replica, ``frontend`` on the router), giving the critical-path
        walk in ``tools/trace_report.py`` a tree to descend."""
        pid = parent.span_id if isinstance(parent, Span) else parent
        if pid is None and self.spans:
            pid = self.spans[0].span_id
        sp = Span(next(self._ids), pid, kind,
                  time.perf_counter() if t_start is None else t_start,
                  attrs)
        if t_end is not None:
            sp.t_end = t_end
        self.spans.append(sp)
        return sp

    def finish(self, error: bool = False) -> "Trace":
        if self.t_end is None:
            self.t_end = time.perf_counter()
        self.error = bool(self.error or error)
        return self

    def duration_ms(self) -> float:
        end = self.t_end if self.t_end is not None else time.perf_counter()
        return (end - self.t_start) * 1e3

    def to_dict(self) -> Dict[str, Any]:
        """Serialize for ``/debug/traces`` / the ``?trace=1`` response
        block. Open spans serialize with ``duration_ms: null``."""
        return {"trace_id": self.trace_id,
                "request_id": self.request_id,
                "duration_ms": round(self.duration_ms(), 4),
                "error": self.error,
                "spans": [s.to_dict(self.t_start) for s in self.spans]}


class Tracer:
    """Factory + bounded retention for traces.

    ``enabled=False`` (the default) makes :meth:`begin` return ``None``
    so instrumented code paths skip all span work; a per-request
    ``force=True`` (the ``?trace=1`` escape hatch) still yields a real
    trace. Finished traces land in three fixed-size rings — every
    finish in ``recent``, finishes slower than ``slow_ms`` in ``slow``,
    errored finishes in ``errored`` — which is what ``GET
    /debug/traces`` serves.
    """

    def __init__(self, enabled: bool = False, ring: int = 256,
                 slow_ms: float = 1000.0, keep: int = 64):
        self.enabled = bool(enabled)
        self.slow_ms = float(slow_ms)
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=max(1, int(ring)))
        self._slow: deque = deque(maxlen=max(1, int(keep)))
        self._errored: deque = deque(maxlen=max(1, int(keep)))
        self._started = 0
        self._finished = 0

    def begin(self, request_id: Optional[str] = None,
              force: bool = False) -> Optional[Trace]:
        """Start a trace, or return ``None`` when tracing is off (and
        not forced) — callers guard every span with that ``None``."""
        if not (self.enabled or force):
            return None
        with self._lock:
            self._started += 1
        return Trace(request_id or new_request_id())

    def finish(self, trace: Optional[Trace], error: bool = False) -> None:
        """File a finished trace into the rings. ``None`` is accepted
        and ignored so call sites need no extra guard."""
        if trace is None:
            return
        trace.finish(error=error)
        with self._lock:
            self._finished += 1
            self._recent.append(trace)
            if trace.duration_ms() >= self.slow_ms:
                self._slow.append(trace)
            if trace.error:
                self._errored.append(trace)

    def dump(self, request_id: Optional[str] = None,
             limit: int = 50) -> List[Dict[str, Any]]:
        """Serialize retained traces, newest first, optionally filtered
        to one request id. Traces retained in several rings appear
        once."""
        with self._lock:
            ordered = (list(self._recent) + list(self._slow)
                       + list(self._errored))
        seen, out = set(), []
        for tr in reversed(ordered):
            if id(tr) in seen:
                continue
            seen.add(id(tr))
            if request_id is not None and tr.request_id != request_id:
                continue
            out.append(tr)
        out.sort(key=lambda t: t.t_start, reverse=True)
        return [t.to_dict() for t in out[:max(0, int(limit))]]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"enabled": self.enabled,
                    "started": self._started,
                    "finished": self._finished,
                    "recent": len(self._recent),
                    "slow": len(self._slow),
                    "errored": len(self._errored)}
