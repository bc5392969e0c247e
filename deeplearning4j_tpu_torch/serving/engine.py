"""Inference engine: bucketed batching and a bounded cache of one CUDA
graph per (signature, bucket) (counterpart of
``deeplearning4j_tpu/serving/engine.py``).

The JAX engine pads each request batch up to the next power-of-two
bucket and keeps a bounded LRU of ahead-of-time compiled executables
keyed by (row signature, bucket). Here each entry of that LRU is one
CUDA graph on the card: a static input buffer of the bucket's rows, the
network's forward captured over it (a transformer stack's flash
kernels included) and a static output that is copied to the host after
each replay. On the CPU the entry is the eager forward, cached and
counted the same way, so ``compiles``, hits, misses, evictions, the
bucket histogram and the warmed buckets move as the JAX engine's do for
the same calls. ``warmup(buckets=...)`` captures the hot buckets before
the server takes traffic.

JAX passes the weights as executable arguments, read live at every
call. A graph reads the addresses it captured instead: ``fit`` updates
the params and the layer state in place, so the graphs serve it; a
network's ``set_params`` or ``set_net_state`` replaces every leaf,
which the next call notices (the leaves' identity) and answers by
capturing that entry again over the new leaves, uncounted in
``compiles``, as JAX does not recompile for new weights of the same
shapes. ``captures`` counts every capture, so the batcher keeps a call
that paid one out of its device-time estimate. As in JAX, the served
forward is the uncast one of ``output()``: a network under the bf16
policy serves in f32.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..kernels import add_launches, tally_launches
from ..profiler import OpProfiler
from .metrics import ServingMetrics

#: one CUDA graph capture at a time in the process
_CAPTURE_LOCK = threading.Lock()


class ServingError(RuntimeError):
    """Base class for serving-layer failures (maps to HTTP 5xx)."""


class ClientError(ValueError):
    """Malformed request, the caller's fault (maps to HTTP 400)."""


def next_bucket(n: int, min_bucket: int = 1, max_bucket: int = 1 << 30) -> int:
    """Smallest power-of-two >= n, clamped to [min_bucket, max_bucket]."""
    if n <= 0:
        raise ClientError("empty batch")
    b = max(int(min_bucket), 1)
    while b < n:
        b <<= 1
    return min(b, int(max_bucket))


def _pad_rows(a: np.ndarray, bucket: int) -> np.ndarray:
    n = a.shape[0]
    if n == bucket:
        return a
    pad = np.zeros((bucket - n,) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


def _not_ported(what: str, item: int):
    raise NotImplementedError(f"serving {what} is not ported yet (ROADMAP.md "
                              f"queue A, item {item})")


def _pad_feed(feed, bucket: int):
    """An array feed, or a dict of them by input name, padded to
    ``bucket`` rows."""
    if isinstance(feed, dict):
        return {k: _pad_rows(v, bucket) for k, v in feed.items()}
    return _pad_rows(feed, bucket)


def _on_device(feed, device):
    if isinstance(feed, dict):
        return {k: torch.from_numpy(v).to(device) for k, v in feed.items()}
    return torch.from_numpy(feed).to(device)


def _to_host(out):
    if isinstance(out, (list, tuple)):
        return [o.to("cpu", copy=True) for o in out]
    return out.to("cpu", copy=True)


class _Eager:
    """A cache entry on the CPU: the forward, run eagerly per call."""

    def __init__(self, engine: "InferenceEngine", fn, padded):
        self._engine = engine
        self._fn = fn

    def __call__(self, padded):
        x = _on_device(padded, self._engine.device)
        with torch.no_grad():
            return self._fn(self._engine._params(), x)


@contextlib.contextmanager
def _gc_paused():
    """Python's cyclic garbage collector off for the block. A collection
    inside a capture can free a dead engine's CUDA graph, and destroying
    a graph is an operation a capture does not permit: the capture is
    invalidated and the next library call in it fails."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def capture_graph(run, what: str, pool=None):
    """Capture ``run()`` into a CUDA graph, in ``pool`` if given, in
    thread-local mode so that other threads' launches go on meanwhile,
    with the cyclic garbage collector paused (:func:`_gc_paused`).
    One capture at a time in the process (they share
    ``torch.cuda.graph``'s capture stream). The capture launches
    nothing: this thread's wrapper launches are tallied, not counted,
    and each replay adds the tally. A failed capture raises
    :class:`ServingError`. Returns (graph, the output ``run`` returned
    while captured, the launches one replay makes)."""
    graph = torch.cuda.CUDAGraph()
    with _CAPTURE_LOCK, tally_launches() as launches, _gc_paused():
        try:
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                out = run()
        except Exception as e:
            raise ServingError(f"capturing {what} into a CUDA graph "
                               f"failed: {e!r}") from e
    return graph, out, launches


def _record(run, engine: "InferenceEngine", device):
    """Capture ``run()`` in the engine's memory pool. One eager call on
    a side stream comes first: it loads the kernels and creates the
    library handles a capture must not."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        run()
    cur.wait_stream(side)
    return capture_graph(run, "the forward", engine._pool())


class _Graph:
    """A cache entry on the card: the forward captured over a static
    input buffer of the bucket's rows. A call loads the buffer, replays
    the graph (adding the launches its capture counted) and copies the
    static output to the host, under the entry's own lock, because the
    buffers are shared by every caller."""

    def __init__(self, engine: "InferenceEngine", fn, padded):
        self._engine = engine
        self._fn = fn
        self._lock = threading.Lock()
        self.x = _on_device(padded, engine.device)
        self._capture()

    def _capture(self):
        """Capture the forward over the live leaves, and hold them: the
        graph reads their addresses."""
        eng, x, fn = self._engine, self.x, self._fn
        params = eng._params()
        with eng._lock:
            eng.captures += 1
        with torch.no_grad():
            self.graph, self.out, self.launches = _record(
                lambda: fn(params, x), eng, eng.device)
        self.leaves = eng._leaves()

    def __call__(self, padded):
        with self._lock:
            if not self._engine._same_leaves(self.leaves):
                self._capture()  # new leaves, not a compile
            if isinstance(padded, dict):
                for k, v in padded.items():
                    self.x[k].copy_(torch.from_numpy(v))
            else:
                self.x.copy_(torch.from_numpy(padded))
            self.graph.replay()
            add_launches(self.launches)
            return _to_host(self.out)


class InferenceEngine:
    """Wraps a model behind a bucketed forward pass with a bounded cache
    of per-bucket entries.

    Served natively: the port's
    :class:`~deeplearning4j_tpu_torch.nn.MultiLayerNetwork` (kind
    ``"mln"``) and :class:`~deeplearning4j_tpu_torch.nn.ComputationGraph`
    (kind ``"graph"``: named inputs, a dict by input name or one array
    for a single-input graph, and named outputs, every output unless a
    request or ``default_outputs`` names some), on the device their
    params live on: one CUDA graph per (signature, bucket) on the card,
    the eager forward on the CPU, batch norm on its running stats. The
    engine never moves the model. Anything else with an ``output(x)``
    method (kind ``"duck"``) is called per batch, still bucket-padded,
    without the cache. A SameDiff graph raises
    :class:`NotImplementedError`: it is not ported yet.
    """

    def __init__(self, model, default_outputs: Optional[Sequence[str]] = None,
                 max_batch_size: int = 64, min_bucket: int = 1,
                 cache_size: int = 16,
                 metrics: Optional[ServingMetrics] = None,
                 fault_injector=None):
        self.model = model
        # serving/faults.py FaultInjector (or None, the default: the
        # hot path then pays one attribute load per call)
        self._faults = fault_injector
        self.default_outputs = list(default_outputs or [])
        self.max_batch_size = int(max_batch_size)
        self.min_bucket = int(min_bucket)
        self.metrics = metrics or ServingMetrics()
        self._cache: "OrderedDict[tuple, object]" = OrderedDict()
        self._cache_size = max(1, int(cache_size))
        self._lock = threading.Lock()
        self._compiling: Dict[tuple, threading.Event] = {}
        self._graph_pool = None
        # CUDA graph captures begun, counted in ``compiles`` or not (a
        # recapture over new leaves is not): the batcher keeps a call
        # that paid one out of its device-time estimate
        self.captures = 0
        self._profiler = OpProfiler.get_instance()
        self._kind, self._fn_for = self._adapt(model)
        self.device = self._device() if self._kind != "duck" else None

    # -- model adapters ------------------------------------------------
    def _adapt(self, model):
        """Returns (kind, fn_for(outputs) -> f(params, x), or None).
        Weights flow through ``params`` (:meth:`_params`, read from the
        model), never as closure constants."""
        from ..nn.graph import ComputationGraph
        from ..nn.multilayer import MultiLayerNetwork
        if hasattr(model, "_build") and hasattr(model, "_vars"):
            _not_ported("a SameDiff graph", 15)
        if isinstance(model, ComputationGraph):
            if model._params is None:
                model.init()

            def fn_for(outputs):
                names = list(outputs or model.conf.graph_outputs)

                def f(params, inputs):
                    acts, _ = model._forward(params, model._net_state,
                                             inputs, False, None)
                    return [acts[n] for n in names]
                return f
            return "graph", fn_for
        if isinstance(model, MultiLayerNetwork):
            if model._params is None:
                model.init()

            def f(params, x):
                return model._forward(params, x, False)
            return "mln", lambda outputs: f
        if not hasattr(model, "output"):
            raise ServingError(f"{type(model).__name__} has no output(...) "
                               "method — cannot serve it")
        return "duck", None

    def _device(self) -> torch.device:
        for p in self.model._params.values():
            for t in p.values():
                return t.device
        return self.model.device

    def _params(self):
        return self.model._params

    def _leaves(self) -> list:
        """The tensors a captured forward reads: params and layer
        state."""
        return [t for tree in (self.model._params,
                               self.model.get_net_state())
                for p in tree.values() for t in p.values()]

    def _same_leaves(self, leaves: list) -> bool:
        now = self._leaves()
        return len(now) == len(leaves) and all(
            a is b for a, b in zip(now, leaves))

    def _pool(self):
        """The memory pool the engine's graphs share (they replay one
        at a time on the caller's stream)."""
        with self._lock:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            return self._graph_pool

    # -- request normalization -----------------------------------------
    def normalize(self, inputs, outputs=None):
        """Parse a request payload into (feed, n_rows, signature): one
        array for a network, a dict by input name (or one array, for a
        single input) for a graph. Raises :class:`ClientError` on
        malformed payloads."""
        outs = tuple(outputs or self.default_outputs)
        if self._kind == "graph":
            return self._normalize_graph(inputs, outs)
        if outs and list(outs) != list(self.default_outputs):
            # one unnamed output head; returning it under the client's
            # requested name would be a lie
            raise ClientError(
                "this model has a single unnamed output — omit 'outputs'")
        if isinstance(inputs, dict):
            raise ClientError("this model takes a plain array input")
        try:
            x = np.asarray(inputs, np.float32)
        except (TypeError, ValueError) as e:
            raise ClientError(f"inputs is not a tensor: {e}")
        if x.ndim == 0:
            raise ClientError("inputs must be at least 1-D (a batch)")
        return x, x.shape[0], (self._kind, outs, x.shape[1:])

    def _normalize_graph(self, inputs, outs):
        conf = self.model.conf
        unknown = [o for o in outs if o not in conf.graph_outputs]
        if unknown:
            raise ClientError(f"unknown outputs {unknown} (graph outputs: "
                              f"{conf.graph_outputs})")
        if not isinstance(inputs, dict):
            if len(conf.graph_inputs) > 1:
                raise ClientError(
                    "multi-input graph needs {'inputs': {name: array}}")
            inputs = {conf.graph_inputs[0]: inputs}
        feed = {}
        for k, v in inputs.items():
            if k not in conf.graph_inputs:
                raise ClientError(f"unknown input {k!r} (graph inputs: "
                                  f"{conf.graph_inputs})")
            try:
                feed[k] = np.asarray(v, np.float32)
            except (TypeError, ValueError) as e:
                raise ClientError(f"input {k!r} is not a tensor: {e}")
        if set(feed) != set(conf.graph_inputs):
            raise ClientError(f"graph needs inputs {conf.graph_inputs}")
        for k, a in feed.items():
            if a.ndim == 0:
                raise ClientError(
                    f"input {k!r} must be at least 1-D (a batch)")
        ns = {a.shape[0] for a in feed.values()}
        if len(ns) != 1:
            raise ClientError(f"inconsistent batch sizes: {sorted(ns)}")
        sig = ("graph", outs, tuple(sorted((k, a.shape[1:])
                                           for k, a in feed.items())))
        return feed, ns.pop(), sig

    # -- the cache -----------------------------------------------------
    def _compiled(self, sig, bucket, feed):
        key = (sig, bucket)
        while True:
            with self._lock:
                hit = self._cache.get(key)
                if hit is not None:
                    self._cache.move_to_end(key)
                    self.metrics.cache_hits += 1
                    return hit
                ev = self._compiling.get(key)
                if ev is None:
                    # claim the capture; do it OUTSIDE the lock so hits
                    # for other buckets never wait on it
                    ev = threading.Event()
                    self._compiling[key] = ev
                    self.metrics.cache_misses += 1
                    break
            ev.wait()  # another thread is capturing this key: reuse it
        try:
            with self._profiler.record("serving.compile"):
                entry = (_Graph if self.device.type == "cuda"
                         else _Eager)(self, self._fn_for(sig[1]), feed)
            with self._lock:
                self.metrics.compiles += 1
                self._cache[key] = entry
                while len(self._cache) > self._cache_size:
                    self._cache.popitem(last=False)
                    self.metrics.cache_evictions += 1
                return entry
        finally:
            with self._lock:
                self._compiling.pop(key, None)
            ev.set()

    def warmup(self, buckets: Sequence[int], example=None,
               outputs: Optional[Sequence[str]] = None):
        """Capture the entries of the given batch buckets so the server
        never captures under traffic. ``example`` is one request payload
        (any batch size; row 0 is replicated); a network with an input
        type can omit it."""
        if example is None:
            example = self._infer_example()
        feed, _, sig = self.normalize(example, outputs)
        warmed = []
        for b in sorted(set(int(x) for x in buckets)):
            if b < 1 or b > self.max_batch_size:
                raise ValueError(f"bucket {b} outside [1, max_batch_size="
                                 f"{self.max_batch_size}]")
            self._compiled(sig, b, _pad_feed(_slice(feed, 0, 1), b))
            warmed.append(b)
        self.metrics.warmed_buckets = sorted(
            set(self.metrics.warmed_buckets) | set(warmed))
        return warmed

    def _infer_example(self):
        if self._kind == "graph":
            types = self.model.conf.input_types
            return {k: np.zeros((1,) + tuple(t.shape), np.float32)
                    for k, t in types.items()}
        shape = getattr(self.model, "_input_shape", None)
        if shape:
            return np.zeros((1,) + tuple(shape), np.float32)
        raise ValueError("cannot infer the input shape for this model — "
                         "pass example= to warmup()")

    # -- execution -----------------------------------------------------
    def predict(self, inputs, outputs: Optional[Sequence[str]] = None,
                trace=None):
        """Run one (possibly multi-request) batch. Batches larger than
        ``max_batch_size`` are chunked. Returns numpy results shaped
        like the model's own ``output(...)``. ``trace`` (a
        :class:`~..tracing.Trace`, or ``None``) records the device call
        as one retroactive span."""
        feed, n, sig = self.normalize(inputs, outputs)
        if trace is None:
            return self.predict_normalized(feed, n, sig)
        t0 = time.perf_counter()
        res = self.predict_normalized(feed, n, sig)
        trace.span("device", t_start=t0, t_end=time.perf_counter(),
                   rows=n, bucket=next_bucket(
                       min(n, self.max_batch_size), self.min_bucket,
                       self.max_batch_size))
        return res

    def predict_normalized(self, feed, n, sig):
        """Hot-path entry for callers that already hold a normalized
        (feed, n_rows, signature) triple: the batcher's device call goes
        through here, so the scheduler thread never re-validates rows
        that submit() validated."""
        if n > self.max_batch_size:
            parts = []
            for i in range(0, n, self.max_batch_size):
                part = _slice(feed, i, i + self.max_batch_size)
                parts.append(self.predict_normalized(
                    part, min(self.max_batch_size, n - i), sig))
            return _concat_results(parts)
        bucket = next_bucket(n, self.min_bucket, self.max_batch_size)
        self.metrics.bucket_hist.record(bucket)
        padded = _pad_feed(feed, bucket)
        if self._faults is not None:
            # injection seam: fires BEFORE the device call, so a
            # transient fault leaves no partial state and the batcher
            # above can retry the whole call
            self._faults.fire("device_step")
        if self._kind == "duck":
            with self._profiler.record("serving.device_call"):
                res = self.model.output(padded)
            return _trim(res, n, bucket, sig[1])
        entry = self._compiled(sig, bucket, padded)
        with self._profiler.record("serving.device_call"):
            res = entry(padded)
        return _trim(res, n, bucket, sig[1])


def _slice(tree, lo, hi):
    """Row-slice a feed or result (dict / list-of-heads / array)."""
    if isinstance(tree, dict):
        return {k: v[lo:hi] for k, v in tree.items()}
    if isinstance(tree, list):
        return [v[lo:hi] for v in tree]
    return tree[lo:hi]


def _row_aligned(v, bucket):
    """Padding and coalescing are only sound for outputs with one row
    per input row. A batch-reducing head (e.g. a mean over the batch)
    would silently fold the zero padding rows, and other requests'
    rows, into every answer, so fail loudly instead. Returns numpy (a
    tensor comes to the host)."""
    a = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
         else np.asarray(v))
    if a.ndim == 0 or a.shape[0] != bucket:
        raise ServingError(
            f"model output shape {a.shape} is not row-aligned with the "
            f"batch (expected leading dim {bucket}); batch-reducing "
            "outputs cannot be served through the dynamic batcher — "
            "compute them client-side or serve via model.output directly")
    return a


def _trim(res, n, bucket, outs):
    """Strip padding rows and convert to numpy."""
    if isinstance(res, dict):
        return {k: _row_aligned(v, bucket)[:n] for k, v in res.items()}
    if isinstance(res, (list, tuple)):
        trimmed = [_row_aligned(v, bucket)[:n] for v in res]
        if outs and len(outs) == len(trimmed):
            return dict(zip(outs, trimmed))
        return trimmed[0] if len(trimmed) == 1 else trimmed
    return _row_aligned(res, bucket)[:n]


def _concat_results(parts):
    first = parts[0]
    if isinstance(first, dict):
        return {k: np.concatenate([p[k] for p in parts]) for k in first}
    if isinstance(first, list):
        return [np.concatenate([p[i] for p in parts])
                for i in range(len(first))]
    return np.concatenate(parts)
