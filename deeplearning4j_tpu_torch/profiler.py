"""Section timing and serving aggregates (counterpart of the
framework-free parts of ``deeplearning4j_tpu/profiler/__init__.py``):
``OpProfiler.record``/``note`` sections, :class:`Reservoir`,
:class:`RateMeter`, :class:`CountHistogram` and :class:`Counter`. The
NaN/Inf panic checks and the device trace come with the profiler
slice."""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict, deque
from enum import Enum
from typing import Dict, Optional


class ProfilingMode(Enum):
    """The modes that time sections (the panic modes come with the
    profiler slice)."""
    DISABLED = "disabled"
    OPERATIONS = "operations"
    ALL = "all"


class OpProfiler:
    """Named-section timing, off unless the mode is OPERATIONS or ALL.
    A section timed on the host ends when its code returns; the serving
    engine's sections end with a device sync, so they cover the device
    work too."""

    _instance: Optional["OpProfiler"] = None

    def __init__(self):
        self.mode = ProfilingMode.DISABLED
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._rec_lock = threading.Lock()

    @classmethod
    def get_instance(cls) -> "OpProfiler":
        if cls._instance is None:
            cls._instance = OpProfiler()
        return cls._instance

    def set_mode(self, mode: ProfilingMode):
        self.mode = mode

    def _on(self) -> bool:
        return self.mode in (ProfilingMode.OPERATIONS, ProfilingMode.ALL)

    @contextlib.contextmanager
    def record(self, name: str):
        """Time a named section."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._on():
                self.note(name, time.perf_counter() - t0)

    def note(self, name: str, dt_s: float):
        """Record an externally measured duration into a section."""
        if self._on():
            with self._rec_lock:
                self._totals[name] += dt_s
                self._counts[name] += 1

    def timings(self) -> Dict[str, Dict[str, float]]:
        with self._rec_lock:
            items = [(n, self._totals[n], self._counts[n])
                     for n in self._totals]
        return {name: {"total_s": total, "count": count,
                       "mean_s": total / max(1, count)}
                for name, total, count in items}

    def reset(self):
        with self._rec_lock:
            self._totals.clear()
            self._counts.clear()


class Counter:
    """Thread-safe monotonically increasing event counter: the
    resilient-training supervisor bumps these from the step loop (and
    the checkpoint writer's thread) while tests and listeners read them."""

    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._v += int(n)
            return self._v

    def value(self) -> int:
        with self._lock:
            return self._v


#: the exact key set of :meth:`Reservoir.snapshot`
RESERVOIR_SNAPSHOT_KEYS = ("count", "mean", "p50", "p90", "p99", "max")


class Reservoir:
    """Bounded ring of the most recent ``size`` samples with
    nearest-rank percentiles. Thread-safe; record() is O(1)."""

    def __init__(self, size: int = 8192):
        self._size = int(size)
        self._buf = [0.0] * self._size
        self._n = 0
        self._lock = threading.Lock()

    def record(self, value: float):
        with self._lock:
            self._buf[self._n % self._size] = float(value)
            self._n += 1

    def record_many(self, values):
        """Record a batch under one lock acquisition."""
        with self._lock:
            for v in values:
                self._buf[self._n % self._size] = float(v)
                self._n += 1

    def _samples(self):
        with self._lock:
            return sorted(self._buf[:min(self._n, self._size)])

    @staticmethod
    def _nearest_rank(s, p: float) -> float:
        return s[min(len(s) - 1,
                     max(0, int(round(p / 100.0 * (len(s) - 1)))))]

    def snapshot(self) -> Dict[str, float]:
        s = self._samples()
        if not s:
            return dict.fromkeys(RESERVOIR_SNAPSHOT_KEYS, 0.0) | {
                "count": self._n}
        return {"count": self._n,
                "mean": float(sum(s) / len(s)),
                "p50": self._nearest_rank(s, 50),
                "p90": self._nearest_rank(s, 90),
                "p99": self._nearest_rank(s, 99),
                "max": s[-1]}


class RateMeter:
    """Sliding-window event rate (events/s over the last
    ``window_s``). Thread-safe."""

    def __init__(self, window_s: float = 30.0):
        self._window = float(window_s)
        self._events: "deque[tuple]" = deque()
        self._total = 0
        self._lock = threading.Lock()

    def record(self, n: int = 1):
        now = time.perf_counter()
        with self._lock:
            self._events.append((now, int(n)))
            self._total += int(n)
            self._prune(now)

    def _prune(self, now: float):
        cutoff = now - self._window
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def total(self) -> int:
        return self._total

    def rate(self) -> float:
        """Events/s over the retained window (0 with fewer than two
        data points)."""
        now = time.perf_counter()
        with self._lock:
            self._prune(now)
            if len(self._events) < 2:
                return 0.0
            span = now - self._events[0][0]
            if span <= 0:
                return 0.0
            return sum(n for _, n in self._events) / span


class CountHistogram:
    """Exact value -> count histogram for small integer domains.
    Thread-safe."""

    def __init__(self):
        self._counts: Dict[int, int] = defaultdict(int)
        self._lock = threading.Lock()

    def record(self, value: int, weight: int = 1):
        with self._lock:
            self._counts[int(value)] += int(weight)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {str(k): v for k, v in sorted(self._counts.items())}

    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def mean(self) -> float:
        with self._lock:
            n = sum(self._counts.values())
            return (sum(k * v for k, v in self._counts.items()) / n
                    if n else 0.0)
