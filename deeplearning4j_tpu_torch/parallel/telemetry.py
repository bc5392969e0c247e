"""Fleet telemetry for resilient and elastic training (counterpart of
``deeplearning4j_tpu/parallel/telemetry.py``, framework-free and lifted
line for line):

- :class:`EventTimeline`: a bounded, thread-safe, structured event log
  (preemption broadcast and received, anomaly skip, rollback,
  checkpoint commit, resume) with a dump API; events are plain dicts.
- :class:`FleetTelemetry`: per-worker step-time EWMAs, preempt,
  rollback and anomaly counters, and a straggler summary (the slowest
  worker's EWMA over the fleet median).

- :func:`compression_stats`: a ``ParallelWrapper``'s gradient-sharing
  effectiveness (achieved sparsity, threshold, the residual norm over
  every worker, wire bytes against dense), with JAX's keys and
  rounding.
"""
from __future__ import annotations

import math
import statistics
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class EventTimeline:
    """Bounded, thread-safe structured event log.

    ``record`` appends a plain-dict event ``{ts, kind, worker, ...}``;
    the deque drops the oldest event past ``capacity`` so a long run
    can never grow the timeline without bound. ``dump`` returns
    JSON-ready copies, oldest first, optionally filtered by kind.
    """

    def __init__(self, capacity: int = 512):
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def record(self, kind: str, worker: Optional[int] = None,
               **attrs: Any) -> None:
        ev = {"ts": time.time(), "kind": kind, "worker": worker}
        ev.update(attrs)
        with self._lock:
            self._events.append(ev)
            self._counts[kind] = self._counts.get(kind, 0) + 1

    def dump(self, limit: Optional[int] = None,
             kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        if limit is not None:
            evs = evs[-int(limit):]
        return [dict(e) for e in evs]

    def counts(self) -> Dict[str, int]:
        """Total events recorded per kind (survives ring eviction)."""
        with self._lock:
            return dict(self._counts)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._counts.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


class FleetTelemetry:
    """Per-worker step-time EWMAs and fault counters.

    One instance is shared by every worker in a fleet; all methods are
    lock-protected and cheap enough to call once per step. The
    straggler summary compares worker EWMAs: ``spread`` is the
    slowest worker's EWMA over the fleet median, so 1.0 means a
    perfectly even fleet and 2.0 means the slowest worker takes twice
    the median step time.
    """

    _COUNTER_KEYS = ("preempts", "rollbacks", "anomaly_skips")

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self._workers: Dict[int, Dict[str, float]] = {}
        self._lock = threading.Lock()

    def _slot(self, worker: int) -> Dict[str, float]:
        w = self._workers.get(worker)
        if w is None:
            w = {"ewma_s": 0.0, "steps": 0,
                 "preempts": 0, "rollbacks": 0, "anomaly_skips": 0}
            self._workers[worker] = w
        return w

    def observe_step(self, worker: int, seconds: float) -> None:
        with self._lock:
            w = self._slot(int(worker))
            if w["steps"] == 0:
                w["ewma_s"] = float(seconds)
            else:
                a = self.alpha
                w["ewma_s"] = (1.0 - a) * w["ewma_s"] + a * float(seconds)
            w["steps"] += 1

    def inc(self, worker: int, key: str, n: int = 1) -> None:
        if key not in self._COUNTER_KEYS:
            raise KeyError(f"unknown fleet counter {key!r}")
        with self._lock:
            self._slot(int(worker))[key] += n

    def straggler(self) -> Dict[str, Any]:
        """Slowest worker, its EWMA, the fleet median, and the spread."""
        with self._lock:
            ewmas = {wid: w["ewma_s"] for wid, w in self._workers.items()
                     if w["steps"] > 0}
        if not ewmas:
            return {"slowest_worker": None, "slowest_ms": 0.0,
                    "median_ms": 0.0, "spread": 0.0}
        slowest = max(ewmas, key=lambda wid: ewmas[wid])
        median = statistics.median(ewmas.values())
        spread = ewmas[slowest] / median if median > 0 else 0.0
        return {"slowest_worker": slowest,
                "slowest_ms": round(ewmas[slowest] * 1e3, 3),
                "median_ms": round(median * 1e3, 3),
                "spread": round(spread, 4)}

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            # string keys: nested-path families in the Prometheus
            # walk (dl4j_..._workers_0_ewma_ms), JSON-safe over HTTP
            workers = {
                str(wid): {"ewma_ms": round(w["ewma_s"] * 1e3, 3),
                           "steps": w["steps"],
                           "preempts": w["preempts"],
                           "rollbacks": w["rollbacks"],
                           "anomaly_skips": w["anomaly_skips"]}
                for wid, w in self._workers.items()}
        return {"workers": workers, "straggler": self.straggler()}


def compression_stats(wrapper) -> Optional[Dict[str, Any]]:
    """Gradient-compression effectiveness of a ParallelWrapper.

    ``None`` until the compressed step has been built (the accumulator
    carries no state before that). The residual norm is over every
    worker's residual: each rank holds its own, so this is a collective
    that every rank of the wrapper's mesh calls, and it reads device
    values: call it at snapshot cadence, never per step."""
    acc = getattr(wrapper, "accumulator", None)
    if acc is None or getattr(acc, "residuals", None) is None:
        return None
    import torch

    leaves = _leaves(acc.residuals)
    # one worker's residual has the params' shapes
    n_params = int(sum(l.numel() for l in leaves))
    per_leaf = wrapper.sum_over_workers(torch.stack(
        [torch.sum(l.double() * l.double()) for l in leaves]))
    sq = 0.0
    for v in per_leaf.tolist():
        sq += v
    residual_norm = math.sqrt(sq)
    sparsity = float(acc.last_sparsity) \
        if getattr(acc, "last_sparsity", None) is not None else 0.0
    threshold = float(acc.threshold) \
        if getattr(acc, "threshold", None) is not None else 0.0
    dense_bytes = n_params * 4  # float32 gradients on the wire
    # sparse encoding ships (int32 index, float32 value) pairs
    wire_bytes = int(round(sparsity * n_params)) * 8
    ratio = dense_bytes / wire_bytes if wire_bytes > 0 else 0.0
    return {"sparsity": round(sparsity, 6),
            "threshold": round(threshold, 8),
            "residual_norm": round(residual_norm, 6),
            "params": n_params,
            "dense_bytes": dense_bytes,
            "wire_bytes": wire_bytes,
            "compression_ratio": round(ratio, 3)}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]
