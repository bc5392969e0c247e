"""Named, versioned multi-model registry (counterpart of
``deeplearning4j_tpu/serving/registry.py``, lifted).

One server process hosts many models, each addressed as
``/v1/models/<name>/predict`` (a :class:`ServedModel`: an
:class:`~.engine.InferenceEngine` and its micro-batcher) or
``/v1/models/<name>/generate`` (a :class:`ServedGenerator`: a
:class:`~.generation.GenerationEngine`), with versions so a new model
can be registered next to the old one and the old one retired
atomically.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

from .batcher import MicroBatcher
from .engine import ClientError, InferenceEngine
from .generation import GenerationEngine
from .metrics import GenerationMetrics, ServingMetrics


class ModelNotFound(ClientError):
    """No such model name/version in the registry (HTTP 404)."""


class ServedModel:
    """One (model, version) plus its engine and (optional) batcher."""

    def __init__(self, name: str, version: int, model,
                 default_outputs: Optional[Sequence[str]] = None,
                 batching: bool = True, max_batch_size: int = 64,
                 max_latency_ms: float = 5.0, max_queue: int = 256,
                 cache_size: int = 16,
                 default_timeout_ms: float = 30_000.0,
                 fault_injector=None,
                 max_retries: int = 3,
                 retry_backoff_ms: float = 1.0):
        self.name = name
        self.version = int(version)
        self.model = model
        self.engine = InferenceEngine(
            model, default_outputs=default_outputs,
            max_batch_size=max_batch_size, cache_size=cache_size,
            fault_injector=fault_injector)
        self.batcher = MicroBatcher(
            self.engine, max_batch_size=max_batch_size,
            max_latency_ms=max_latency_ms, max_queue=max_queue,
            default_timeout_ms=default_timeout_ms,
            max_retries=max_retries,
            retry_backoff_ms=retry_backoff_ms) if batching else None

    @property
    def metrics(self) -> ServingMetrics:
        return self.engine.metrics

    def predict(self, inputs, outputs: Optional[Sequence[str]] = None,
                timeout_ms: Optional[float] = None,
                priority: str = "interactive", trace=None):
        if self.batcher is not None:
            return self.batcher.submit(inputs, outputs,
                                       timeout_ms=timeout_ms,
                                       priority=priority, trace=trace)
        # direct path (batching=False): synchronous, so timeout_ms has
        # no queue to bound — but request metrics must still flow,
        # including the live-occupancy gauge the /stats summary feeds
        # to routers (without it a saturated unbatched replica would
        # read as idle and keep attracting fleet traffic)
        m = self.metrics
        m.inc("requests")
        t0 = time.perf_counter()
        m.inc("inflight")
        try:
            res = self.engine.predict(inputs, outputs, trace=trace)
        finally:
            m.inc("inflight", -1)
        m.inc("responses")
        m.latency_ms.record((time.perf_counter() - t0) * 1e3)
        return res

    def warmup(self, buckets: Sequence[int], example=None,
               outputs: Optional[Sequence[str]] = None):
        return self.engine.warmup(buckets, example=example, outputs=outputs)

    def alive(self) -> bool:
        """Liveness (``/healthz``): the batcher's scheduler loop is
        not wedged. Unbatched models have no loop to stall."""
        return self.batcher.alive() if self.batcher is not None else True

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Reject new work (503 + Retry-After), finish in-flight
        requests, join the scheduler thread."""
        if self.batcher is not None:
            return self.batcher.drain(timeout_s)
        return True

    def stop(self):
        if self.batcher is not None:
            self.batcher.stop()

    def stats(self) -> Dict:
        s = self.metrics.snapshot()
        s["version"] = self.version
        s["model_class"] = type(self.model).__name__
        s["batching"] = self.batcher is not None
        return s

    def summary(self) -> Dict:
        """Compact machine-readable routing summary (the ``summary``
        block of ``GET /stats``): live occupancy, queue depth, and the
        draining flag — everything a load balancer needs to pick a
        replica, with no histogram parsing. ``load`` is the one-number
        backlog score routers sort by (queued + on-device rows)."""
        m = self.metrics
        cap = (self.batcher.max_batch_size if self.batcher is not None
               else self.engine.max_batch_size)
        active = m.inflight
        return {"mode": "predict",
                "queue_depth": m.queue_depth,
                "queue_max": m.queue_max,
                "active": active,
                "capacity": cap,
                "occupancy": round(active / cap, 4) if cap else 0.0,
                "draining": bool(self.batcher is not None
                                 and self.batcher.draining),
                "load": m.queue_depth + active,
                # shed total, so a fleet poller can aggregate per-
                # replica overload without parsing the full /stats
                "shed": m.shed}


class ServedGenerator:
    """One (causal LM, version) plus its continuous-batching generation
    engine — the token-by-token sibling of :class:`ServedModel`,
    routed at ``/v1/models/<name>/generate``."""

    def __init__(self, name: str, version: int, model,
                 num_slots: int = 8, max_queue: int = 256,
                 default_timeout_ms: float = 60_000.0, **engine_opts):
        # remaining GenerationEngine tuning (max_seq_len,
        # prompt_buckets, min_prompt_bucket, decode_impl, cache=
        # "slots"|"paged", block_size, num_blocks,
        # prefill_chunk_tokens, ...) passes through verbatim; unknown
        # keys fail loudly in the engine
        self.name = name
        self.version = int(version)
        self.model = model
        self.engine = GenerationEngine(
            model, num_slots=num_slots, max_queue=max_queue,
            default_timeout_ms=default_timeout_ms, **engine_opts)

    @property
    def metrics(self) -> GenerationMetrics:
        return self.engine.metrics

    def generate(self, prompt, **opts):
        return self.engine.generate(prompt, **opts)

    def stream(self, prompt, **opts):
        return self.engine.stream(prompt, **opts)

    def warmup(self, buckets: Optional[Sequence[int]] = None):
        return self.engine.warmup(buckets)

    def alive(self) -> bool:
        """Liveness (``/healthz``): the decode scheduler loop is not
        wedged (heartbeat watchdog in the engine)."""
        return self.engine.alive()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Reject new work (503 + Retry-After), let every in-flight
        generation finish, join the scheduler thread."""
        return self.engine.drain(timeout_s)

    def stop(self):
        self.engine.stop()

    def stats(self) -> Dict:
        s = self.metrics.snapshot()
        s["version"] = self.version
        s["model_class"] = type(self.model).__name__
        s["serving_mode"] = "generation"
        return s

    def summary(self) -> Dict:
        """Compact routing summary (see :meth:`ServedModel.summary`):
        for generation the live occupancy is ACTIVE KV-CACHE SLOTS —
        a request holds its slot for its whole decode lifetime, so
        slots are the capacity a router must balance."""
        m = self.metrics
        cap = m.num_slots
        active = m.active_slots
        return {"mode": "generation",
                "queue_depth": m.queue_depth,
                "queue_max": m.queue_max,
                "active": active,
                "capacity": cap,
                "occupancy": round(active / cap, 4) if cap else 0.0,
                "draining": self.engine.draining,
                "load": m.queue_depth + active,
                # shed total, so a fleet poller can aggregate per-
                # replica overload without parsing the full /stats
                "shed": m.shed}


class ModelRegistry:
    """register/get/unregister by name (+ version; default = latest)."""

    def __init__(self):
        self._models: Dict[str, Dict[int, ServedModel]] = {}
        self._lock = threading.Lock()

    def register(self, name: str, model,
                 version: Optional[int] = None, **opts) -> ServedModel:
        """Create the engine+batcher for ``model`` and route it at
        ``name``. ``version`` defaults to (latest + 1)."""
        return self._register(ServedModel, name, model, version, **opts)

    def register_generator(self, name: str, model,
                           version: Optional[int] = None,
                           **opts) -> ServedGenerator:
        """Create a continuous-batching generation engine for a causal
        LM and route it at ``/v1/models/<name>/generate``. Same
        name/version space as predict models — one name serves either
        mode, not both."""
        return self._register(ServedGenerator, name, model, version,
                              **opts)

    def _register(self, cls, name: str, model,
                  version: Optional[int] = None, **opts):
        if not name or not isinstance(name, str) or "/" in name \
                or "@" in name:
            # '/' breaks /v1/models/<name>/... routing (silent 404s);
            # '@' collides with the name@version keys stats() emits
            raise ValueError(f"invalid model name {name!r}: must be a "
                             "non-empty string without '/' or '@'")
        with self._lock:
            versions = self._models.setdefault(name, {})
            try:
                # one name serves ONE mode: silently flipping the
                # latest version from predict to generate (or back)
                # would 400 every existing client of the other route
                for existing in versions.values():
                    if type(existing) is not cls:
                        raise ValueError(
                            f"model {name!r} is already registered for "
                            f"{type(existing).__name__} serving — use a "
                            "different name for the other mode")
                if version is None:
                    version = max(versions) + 1 if versions else 1
                version = int(version)
                if version in versions:
                    raise ValueError(f"model {name!r} version {version} "
                                     "already registered")
                served = cls(name, version, model, **opts)
                versions[version] = served
                return served
            finally:
                # a failed construction must not leave an empty version
                # dict behind (it would break describe()/stats() forever)
                if not versions:
                    self._models.pop(name, None)

    def get(self, name: str, version: Optional[int] = None) -> ServedModel:
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelNotFound(f"unknown model {name!r}")
            if version is None:
                return versions[max(versions)]
            if int(version) not in versions:
                raise ModelNotFound(
                    f"model {name!r} has no version {version}")
            return versions[int(version)]

    def unregister(self, name: str, version: Optional[int] = None):
        """Remove (and stop) one version, or all versions of a name."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelNotFound(f"unknown model {name!r}")
            if version is None:
                stopped = list(versions.values())
                del self._models[name]
            else:
                if int(version) not in versions:
                    raise ModelNotFound(
                        f"model {name!r} has no version {version}")
                stopped = [versions.pop(int(version))]
                if not versions:
                    del self._models[name]
        for served in stopped:
            served.stop()

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def describe(self) -> Dict:
        with self._lock:
            return {name: {"versions": sorted(vs),
                           "latest": max(vs)}
                    for name, vs in self._models.items()}

    def stats(self) -> Dict:
        """Latest version under the bare name; older versions that are
        still live (pinnable via request "version") under name@v, so
        their traffic stays observable."""
        with self._lock:
            items = []
            for name, vs in self._models.items():
                latest = max(vs)
                items.append((name, vs[latest]))
                items.extend((f"{name}@{v}", served)
                             for v, served in vs.items() if v != latest)
        return {key: served.stats() for key, served in items}

    def summary(self) -> Dict:
        """Per-model routing summaries, keyed like :meth:`stats`
        (latest under the bare name, older under name@v)."""
        with self._lock:
            items = []
            for name, vs in self._models.items():
                latest = max(vs)
                items.append((name, vs[latest]))
                items.extend((f"{name}@{v}", served)
                             for v, served in vs.items() if v != latest)
        return {key: served.summary() for key, served in items}

    def health(self) -> Dict[str, bool]:
        """Liveness per served model (``/healthz``), keyed like
        :meth:`stats` (latest under the bare name, older under
        name@v)."""
        with self._lock:
            items = []
            for name, vs in self._models.items():
                latest = max(vs)
                items.append((name, vs[latest]))
                items.extend((f"{name}@{v}", served)
                             for v, served in vs.items() if v != latest)
        return {key: served.alive() for key, served in items}

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Drain every served model CONCURRENTLY (sequential drains
        would stack their timeouts): each rejects new work with 503
        while its in-flight requests finish, then its scheduler thread
        joins. Models stay registered — `/stats` and `/healthz` remain
        queryable after the drain. Returns True when every model
        drained cleanly within ``timeout_s``."""
        with self._lock:
            served = [s for vs in self._models.values()
                      for s in vs.values()]
        results: Dict[int, bool] = {}

        def go(s):
            try:
                results[id(s)] = bool(s.drain(timeout_s))
            except Exception:  # noqa: BLE001 — a failed drain is dirty
                results[id(s)] = False
        threads = [threading.Thread(target=go, args=(s,), daemon=True)
                   for s in served]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout_s + 5.0)
        return all(results.get(id(s), False) for s in served)

    def stop(self):
        with self._lock:
            stopped = [s for vs in self._models.values()
                       for s in vs.values()]
            self._models.clear()
        for served in stopped:
            served.stop()
