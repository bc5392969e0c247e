"""Serving runtime of the port (counterpart of
``deeplearning4j_tpu/serving/__init__.py``):

- :class:`~.engine.InferenceEngine`: pads request batches into
  power-of-two buckets and keeps a bounded LRU of one CUDA graph per
  (bucket, signature) on the card (the eager forward on the CPU), with
  ``warmup()`` so steady-state traffic never captures;
- :class:`~.batcher.MicroBatcher`: coalesces concurrent requests into
  one device call under a max_batch_size / max_latency_ms policy, with
  per-request deadlines, priority classes and a bounded queue that
  sheds load (503) instead of growing without limit;
- :class:`~.registry.ModelRegistry`: named, versioned multi-model
  hosting, routed at ``/v1/models/<name>/predict`` and
  ``/v1/models/<name>/generate``;
- :class:`~.generation.GenerationEngine`: continuous-batching decode on
  the slot KV cache or the paged block pool, with the fault ladder,
  speculative decoding, the host KV tier, request tracing and the
  Prometheus text of its ``stats()``;
- :class:`InferenceServer`: the HTTP JSON front-end over the registry,
  on an asyncio event loop (``http_backend="aio"``, the default,
  :mod:`.aio`) or one thread per connection (``"thread"``). The legacy
  single-model constructor (``InferenceServer(model, port=0)``) routes
  through the same runtime.

HTTP surface::

    POST /predict                      default model
    POST /v1/models/<name>/predict     named model (latest version)
    POST /generate                     default generator
    POST /v1/models/<name>/generate    continuous-batching generation
                                       ({"stream": true} -> chunked
                                       newline-delimited JSON tokens;
                                       {"session_id": "..."} pins the
                                       turn's KV blocks for prefix
                                       reuse on the next turn — paged
                                       backend)
    GET  /v1/models                    registry listing
    GET  /stats                        serving metrics per model, plus
                                       a compact top-level "summary"
                                       (per-model live occupancy /
                                       queue depth / draining flag)
    GET  /metrics                      the same counters as Prometheus
                                       text exposition
    GET  /debug/traces                 bounded ring of recent / slow /
                                       errored request traces; filter
                                       with ?request_id=<id>
    GET  /health                       legacy summary (always 200)
    GET  /healthz                      liveness: 503 when any engine
                                       loop is wedged (stall watchdog)
    GET  /readyz                       readiness: 503 + Retry-After
                                       while draining

Status codes: 400 malformed request (client), 404 unknown route/model,
413 body over ``max_body_bytes``, 431 request head over 256 KiB (aio),
500 internal failure (incl. quarantined poison requests), 503 load shed
(queue full) or draining — always with ``Retry-After``, 504 deadline
exceeded. Every request carries an ``X-Request-Id`` (accepted or
minted, echoed); ``?trace=1`` or a ``"trace": 1`` body field embeds the
request's timeline in the response. Requests may carry ``"priority":
"interactive"`` (default) or ``"batch"``, as a field or the
``X-Priority`` header; under pressure batch-class work is shed first.

``/predict`` serves the port's ``MultiLayerNetwork`` and
``ComputationGraph`` (named inputs and outputs) and any model with an
``output(x)`` method; SameDiff models are not ported yet (ROADMAP.md
queue A, item 15).

Fleets (:mod:`.fleet`): :class:`~.fleet.ReplicaFleet` holds N
``InferenceServer`` replicas (health polls of ``/healthz`` and the
``summary`` block of ``/stats``, eject and readmit, cordon, rolling
restart) and :class:`~.fleet.FleetRouter` routes to them by occupancy,
with session affinity, retries, hedging and backpressure, over the
same route table (``router.serve()``, aio or thread backend).
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Sequence
from urllib.parse import parse_qs

import numpy as np

from ..tracing import Tracer, new_request_id
from .batcher import (DeadlineExceededError, DrainingError, MicroBatcher,
                      QueueFullError)
from .engine import ClientError, InferenceEngine, ServingError, next_bucket
from .faults import (CorruptedStateFault, FaultInjector,
                     PoisonRequestError, TransientFault)
from .fleet import (FleetError, FleetMetrics, FleetRouter,
                    NoReplicasError, Replica, ReplicaFleet)
from .generation import GenerationEngine
from .kvcache import KVCache, SlotTable
from .metrics import (GenerationMetrics, ServingMetrics,
                      profiler_sections, prometheus_text)
from .offload import DiskRing, HostBlockStore, HostRun
from .paging import BlockAllocator, BlockTable, PagedKVCache
from .registry import (ModelNotFound, ModelRegistry, ServedGenerator,
                       ServedModel)

__all__ = [
    "InferenceServer", "InferenceEngine", "MicroBatcher", "ModelRegistry",
    "ModelNotFound", "ServedModel", "ServedGenerator", "GenerationEngine",
    "GenerationMetrics", "KVCache", "SlotTable", "PagedKVCache",
    "BlockAllocator", "BlockTable", "ServingMetrics",
    "HostBlockStore", "HostRun", "DiskRing",
    "ClientError", "ServingError", "QueueFullError",
    "DeadlineExceededError", "DrainingError", "FaultInjector",
    "TransientFault", "CorruptedStateFault", "PoisonRequestError",
    "ReplicaFleet", "FleetRouter", "Replica", "FleetMetrics",
    "FleetError", "NoReplicasError",
    "next_bucket", "export_stablehlo", "Tracer", "prometheus_text",
    "profiler_sections",
]


def export_stablehlo(fn_or_samediff, example_args=None,
                     outputs: Optional[Sequence[str]] = None,
                     placeholders: Optional[Dict[str, Any]] = None) -> str:
    """StableHLO text of a SameDiff graph or a jittable function: an
    XLA artifact, with SameDiff not ported yet (ROADMAP.md queue A,
    item 15)."""
    raise NotImplementedError("export_stablehlo (SameDiff and XLA "
                              "lowering) is not ported yet (ROADMAP.md "
                              "queue A, item 15)")


class _HTTPServer(ThreadingHTTPServer):
    # the stdlib default backlog of 5 drops SYNs under concurrent-client
    # load (clients then stall ~1s in retransmit — a fake p99); size it
    # for the serving queue instead
    request_queue_size = 128
    daemon_threads = True


def _status_for(exc: BaseException) -> int:
    if isinstance(exc, ModelNotFound):
        return 404
    if isinstance(exc, QueueFullError):
        return 503
    if isinstance(exc, DeadlineExceededError):
        return 504
    if isinstance(exc, ClientError):
        return 400
    return 500


class InferenceServer:
    """HTTP JSON inference front-end over registry + batcher (ref role:
    GraphServer.cpp).

    Single-model (legacy, still supported)::

        server = InferenceServer(model, port=0)

    Multi-model::

        server = InferenceServer(port=0)
        server.register("mnist", model_a)
        server.register("ranker", model_b, default_outputs=["score"])

    ``host`` defaults to loopback; pass ``host="0.0.0.0"`` to bind
    externally for multi-host deployments.

    ``http_backend`` selects the socket tier (docs/serving.md
    "Front-end architecture"): ``"aio"`` (default) serves every
    connection off one event loop — open connections cost a socket
    buffer, not a thread, so thousands of idle keep-alive or
    streaming clients don't breed thousands of blocked threads — with
    engine-blocking work on a bounded daemon pool and a
    ``http_header_timeout_s`` slow-loris cap the thread tier never
    had. ``"thread"`` is the original thread-per-connection
    ``ThreadingHTTPServer``. Routes, status codes, streaming framing,
    headers and the access log are identical across backends.
    """

    DEFAULT_MODEL = "default"

    def __init__(self, model=None, port: int = 0,
                 default_outputs: Optional[Sequence[str]] = None,
                 host: str = "127.0.0.1",
                 registry: Optional[ModelRegistry] = None,
                 batching: bool = True,
                 max_batch_size: int = 64,
                 max_latency_ms: float = 5.0,
                 max_queue: int = 256,
                 default_timeout_ms: float = 30_000.0,
                 warmup_buckets: Optional[Sequence[int]] = None,
                 warmup_example=None,
                 max_body_bytes: int = 256 * 1024 * 1024,
                 tracing: bool = False,
                 trace_ring: int = 256,
                 trace_slow_ms: float = 1000.0,
                 log_requests=False,
                 http_backend: str = "aio",
                 http_header_timeout_s: float = 10.0):
        self.max_body_bytes = int(max_body_bytes)
        self.registry = registry or ModelRegistry()
        self._owns_registry = registry is None
        self._ready = True            # flips off when drain() starts
        self._prev_handlers: Dict[int, Any] = {}
        self._signal_drain: Optional[threading.Thread] = None
        # request tracing (docs/observability.md): disabled by default
        # — Tracer.begin then returns None and every instrumented path
        # skips span work on a single attribute check. ?trace=1 still
        # traces one request through a disabled tracer.
        self.tracer = Tracer(enabled=bool(tracing), ring=trace_ring,
                             slow_ms=trace_slow_ms)
        # structured access log: False = off, True = stderr, else any
        # writable text stream (one JSON object per line)
        self._log_stream = (sys.stderr if log_requests is True
                            else (log_requests or None))
        self._log_lock = threading.Lock()
        # dead-socket writes swallowed by the handler (clients/routers
        # that timed out and hung up): invisible before this counter
        self.client_disconnects = 0
        self._disc_lock = threading.Lock()
        self._opts = dict(batching=batching, max_batch_size=max_batch_size,
                          max_latency_ms=max_latency_ms,
                          max_queue=max_queue,
                          default_timeout_ms=default_timeout_ms)
        self.model = model  # legacy attribute
        if model is not None:
            served = self.register(self.DEFAULT_MODEL, model,
                                   default_outputs=default_outputs)
            if warmup_buckets:
                served.warmup(warmup_buckets, example=warmup_example)
        server = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive: serving clients send many small requests, and
            # per-request TCP setup would dominate the batched path
            # (every response carries Content-Length, so 1.1 is safe)
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def log_request(self, code="-", size="-"):
                # send_response() calls this once per response — the
                # single choke point every success/error/stream path
                # goes through, so the access log is one line per
                # request with no per-branch bookkeeping
                if server._log_stream is None:
                    return
                try:
                    status = int(code)
                except (TypeError, ValueError):
                    status = str(code)
                t0 = getattr(self, "_t0", None)
                entry = {"ts": round(time.time(), 6),
                         "method": self.command,
                         "path": self.path,
                         "status": status,
                         "latency_ms": round(
                             (time.perf_counter() - t0) * 1e3, 3)
                         if t0 is not None else None,
                         "request_id": getattr(self, "_rid", None),
                         "priority": getattr(self, "_prio", None)}
                shed = getattr(self, "_shed", None)
                if shed is not None:
                    entry["shed_reason"] = shed
                server._access_log(entry)

            def _json(self, obj, code=200, headers=None):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                rid = getattr(self, "_rid", None)
                if rid:
                    self.send_header("X-Request-Id", rid)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _text(self, body: str, code=200):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", "text/plain; "
                                 "version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._t0 = time.perf_counter()
                self._rid = self.headers.get("X-Request-Id")
                path, _, query = self.path.partition("?")
                try:
                    if path == "/health":
                        self._json(server._health())
                    elif path == "/healthz":
                        code, body = server._healthz()
                        self._json(body, code)
                    elif path == "/readyz":
                        if server.ready():
                            self._json({"ready": True})
                        else:
                            self._json({"ready": False,
                                        "reason": "draining"}, 503,
                                       headers={"Retry-After": "1"})
                    elif path == "/stats":
                        self._json(server.stats())
                    elif path == "/metrics":
                        self._text(prometheus_text(server.stats()))
                    elif path == "/debug/traces":
                        q = parse_qs(query)
                        rid = (q.get("request_id") or q.get("id")
                               or [None])[0]
                        limit = int((q.get("limit") or [50])[0])
                        self._json({
                            "traces": server.tracer.dump(
                                request_id=rid, limit=limit),
                            "tracer": server.tracer.snapshot()})
                    elif path in ("/v1/models", "/v1/models/"):
                        self._json(server.registry.describe())
                    else:
                        self._json({"error": "not found"}, 404)
                except Exception as e:  # noqa: BLE001
                    self._json({"error": str(e)}, 500)

            def do_POST(self):
                self._t0 = time.perf_counter()
                # mint a request id unless the caller (router, client)
                # already tagged one — the id is the trace id, echoed
                # back as X-Request-Id and stitched across tiers
                self._rid = (self.headers.get("X-Request-Id")
                             or new_request_id())
                self._prio = self.headers.get("X-Priority")
                self._shed = None
                # drain the body first: on a keep-alive (1.1) connection
                # an unread body would be parsed as the next request
                # line, desyncing the socket. Bad/negative lengths are a
                # 400, never an unhandled exception or an
                # until-EOF read (a hung handler thread).
                if self.headers.get("Transfer-Encoding"):
                    # chunked framing isn't parsed here; without the
                    # body drained the keep-alive socket would desync
                    self._json({"error": "Transfer-Encoding not "
                                "supported; send Content-Length"}, 501)
                    self.close_connection = True
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    n = -1
                if n < 0:
                    self._json({"error": "bad Content-Length"}, 400)
                    self.close_connection = True  # body length unknown
                    return
                if n > server.max_body_bytes:
                    # one oversized request must not OOM the process —
                    # the queue bounds count rows, this bounds bytes
                    self._json({"error": "request body too large "
                                f"(limit {server.max_body_bytes} "
                                "bytes)"}, 413)
                    self.close_connection = True  # body left unread
                    return
                raw = self.rfile.read(n)
                path, _, query = self.path.partition("?")
                route = server._route(path)
                if route is None:
                    self._json({"error": "not found"}, 404)
                    return
                name, action = route
                if not server.ready():
                    # draining: shed BEFORE touching the registry so
                    # half-drained engines never see new work; clients
                    # retry against another replica after Retry-After
                    self._shed = "draining"
                    self._json({"error": "server is draining"}, 503,
                               headers={"Retry-After": "1"})
                    return
                req = None
                result = None
                trace = None
                span = None
                try:
                    try:
                        req = json.loads(raw)
                    except json.JSONDecodeError as e:
                        raise ClientError(f"malformed JSON: {e}")
                    # the X-Priority header maps to the "priority"
                    # field (routers/gateways tag traffic classes
                    # without rewriting bodies); the body field wins
                    prio_hdr = self.headers.get("X-Priority")
                    if prio_hdr and isinstance(req, dict) \
                            and "priority" not in req:
                        req["priority"] = prio_hdr
                    if isinstance(req, dict):
                        self._prio = req.get("priority", self._prio)
                    # ?trace=1 (or "trace": 1 in the body) forces a
                    # per-request trace even when the tracer is off;
                    # the field is popped so validators never see it
                    want_trace = bool(
                        (query and "trace=1" in query.split("&"))
                        or (isinstance(req, dict)
                            and req.pop("trace", None)))
                    trace = server.tracer.begin(self._rid,
                                                force=want_trace)
                    if trace is not None:
                        span = trace.span("http", path=path,
                                          model=name, action=action)
                    if action == "generate":
                        if isinstance(req, dict) and req.get("stream"):
                            # admission errors raise HERE (before any
                            # header goes out), so they still map to
                            # real status codes; mid-stream failures
                            # become a terminal error chunk instead
                            it = server._generate_stream(name, req,
                                                         trace=trace)
                            self._stream_ndjson(it)
                            if trace is not None:
                                span.end(status=200, stream=True)
                                server.tracer.finish(trace)
                            return
                        result = server._generate(name, req,
                                                  trace=trace)
                    else:
                        result = server._predict(name, req,
                                                 trace=trace)
                except Exception as e:  # noqa: BLE001
                    code = _status_for(e)
                    if code in (503, 504):
                        self._shed = str(e)
                    version = (req.get("version")
                               if isinstance(req, dict) else None)
                    server._count_error(name, code, version)
                    if trace is not None:
                        span.end(status=code, error=str(e))
                        server.tracer.finish(trace,
                                             error=code >= 500)
                    try:
                        self._json({"error": str(e)}, code,
                                   headers=({"Retry-After": "1"}
                                            if code == 503 else None))
                    except OSError:
                        server._count_disconnect()
                        self.close_connection = True
                    return
                if trace is not None:
                    span.end(status=200)
                    server.tracer.finish(trace)
                    if want_trace and isinstance(result, dict):
                        result = dict(result)
                        result["trace"] = trace.to_dict()
                try:
                    self._json(result)
                except OSError:
                    # the client hung up while the (possibly slow)
                    # request computed — routine once routers time out
                    # and abandon sockets, not a server error; a
                    # traceback per occurrence would spam stderr
                    server._count_disconnect()
                    self.close_connection = True

            def _stream_ndjson(self, it):
                """Chunked transfer-encoded newline-delimited JSON: one
                object per generated token as the scheduler emits it,
                a terminal ``{"done": true, ...}`` object, then the
                zero chunk. The keep-alive socket stays in sync —
                chunked framing is self-delimiting."""
                try:
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                except OSError:
                    # client vanished before the headers went out:
                    # abandon the generation (frees its slot) and do
                    # NOT fall through to a second response attempt
                    if hasattr(it, "close"):
                        it.close()
                    server._count_disconnect()
                    self.close_connection = True
                    return

                def chunk(obj):
                    data = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(f"{len(data):X}\r\n".encode()
                                     + data + b"\r\n")
                    self.wfile.flush()
                try:
                    try:
                        for item in it:
                            chunk(item)
                    except OSError:
                        # client went away mid-stream: routine, not a
                        # server error — close the iterator NOW (its
                        # cleanup abandons the request, freeing its
                        # cache slot) and drop the connection quietly
                        if hasattr(it, "close"):
                            it.close()
                        server._count_disconnect()
                        self.close_connection = True
                        return
                    except Exception as e:  # noqa: BLE001 — headers
                        # are already on the wire; deliver in-band
                        chunk({"error": str(e),
                               "status": _status_for(e), "done": True})
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    # the error/terminal chunk hit the dead socket too;
                    # never fall through to a second HTTP response
                    server._count_disconnect()
                    self.close_connection = True

        self.http_backend = http_backend
        self._aio = None
        self.httpd = None
        self._thread = None
        if http_backend == "thread":
            self.httpd = _HTTPServer((host, port), Handler)
            self.host = self.httpd.server_address[0]
            self.port = self.httpd.server_address[1]
            self._thread = threading.Thread(
                target=self.httpd.serve_forever, daemon=True)
            self._thread.start()
        elif http_backend == "aio":
            from .aio import AioReplicaFrontend
            self._aio = AioReplicaFrontend(
                self, host, port,
                header_timeout_s=http_header_timeout_s)
            self.host = self._aio.host
            self.port = self._aio.port
        else:
            raise ValueError(f"unknown http_backend {http_backend!r} "
                             "(use 'aio' or 'thread')")

    # -- model management ----------------------------------------------
    def register(self, name: str, model, **opts) -> ServedModel:
        """Register a model under ``name`` (engine + batcher built from
        the server's batching policy unless overridden in ``opts``)."""
        merged = dict(self._opts)
        merged.update(opts)
        return self.registry.register(name, model, **merged)

    def unregister(self, name: str, version: Optional[int] = None):
        self.registry.unregister(name, version)

    def served(self, name: str = DEFAULT_MODEL,
               version: Optional[int] = None) -> ServedModel:
        return self.registry.get(name, version)

    def register_generator(self, name: str, model, **opts) -> ServedGenerator:
        """Register a causal LM for continuous-batching generation at
        ``/v1/models/<name>/generate`` (queue bound and default
        timeout inherit the server's batching policy unless
        overridden)."""
        merged = {"max_queue": self._opts["max_queue"],
                  "default_timeout_ms": self._opts["default_timeout_ms"]}
        merged.update(opts)
        return self.registry.register_generator(name, model, **merged)

    # -- request handling ----------------------------------------------
    def _route(self, path: str):
        """Map a POST path to (model name, action); None = 404."""
        if path == "/predict":
            return self.DEFAULT_MODEL, "predict"
        if path == "/generate":
            return self.DEFAULT_MODEL, "generate"
        parts = [p for p in path.split("/") if p]
        if len(parts) == 4 and parts[:2] == ["v1", "models"] \
                and parts[3] in ("predict", "generate"):
            return parts[2], parts[3]
        return None

    def _predict(self, name: str, req, trace=None) -> dict:
        if not isinstance(req, dict):
            raise ClientError("request body must be a JSON object")
        if "inputs" not in req:
            raise ClientError("missing 'inputs'")
        version = req.get("version")
        if version is not None and (not isinstance(version, int)
                                    or isinstance(version, bool)):
            raise ClientError("'version' must be an integer")
        served = self.registry.get(name, version)
        if not hasattr(served, "predict"):
            raise ClientError(
                f"model {name!r} is a generation model — POST to "
                f"/v1/models/{name}/generate instead")
        outputs = req.get("outputs")
        if outputs is not None and not isinstance(outputs, (list, tuple)):
            raise ClientError("'outputs' must be a list of names")
        timeout_ms = req.get("timeout_ms")
        if timeout_ms is not None and (
                not isinstance(timeout_ms, (int, float))
                or isinstance(timeout_ms, bool)):
            raise ClientError("'timeout_ms' must be a number")
        priority = req.get("priority", "interactive")
        if not isinstance(priority, str):
            raise ClientError("'priority' must be a string")
        res = served.predict(req["inputs"], outputs, timeout_ms=timeout_ms,
                             priority=priority, trace=trace)
        if isinstance(res, dict):
            return {"outputs": {k: np.asarray(v).tolist()
                                for k, v in res.items()}}
        if isinstance(res, list):
            return {"outputs": [np.asarray(v).tolist() for v in res]}
        return {"outputs": np.asarray(res).tolist()}

    def _gen_opts(self, name: str, req):
        """Parse + validate a generate payload into (served, prompt,
        engine kwargs). Raises :class:`ClientError` on bad fields."""
        if not isinstance(req, dict):
            raise ClientError("request body must be a JSON object")
        if "prompt" not in req:
            raise ClientError("missing 'prompt' (a list of token ids)")
        version = req.get("version")
        if version is not None and not isinstance(version, int):
            raise ClientError("'version' must be an integer")
        served = self.registry.get(name, version)
        if not hasattr(served, "generate"):
            raise ClientError(
                f"model {name!r} is a predict model — POST to "
                f"/v1/models/{name}/predict instead")
        opts = {}
        for key, types in (("max_tokens", int), ("temperature",
                                                 (int, float)),
                           ("top_k", int), ("seed", int),
                           ("eos_id", int),
                           ("timeout_ms", (int, float))):
            if key in req and req[key] is not None:
                if not isinstance(req[key], types) or isinstance(
                        req[key], bool):
                    raise ClientError(f"{key!r} must be a number")
                opts[key] = req[key]
        priority = req.get("priority")
        if priority is not None:
            if not isinstance(priority, str):
                raise ClientError("'priority' must be a string")
            opts["priority"] = priority
        session_id = req.get("session_id")
        if session_id is not None:
            # length/backend validation stays in the engine — it owns
            # the session store; here only the JSON type is checked
            if not isinstance(session_id, str):
                raise ClientError("'session_id' must be a string")
            opts["session_id"] = session_id
        return served, req["prompt"], opts

    def _generate(self, name: str, req, trace=None) -> dict:
        served, prompt, opts = self._gen_opts(name, req)
        return served.generate(prompt, trace=trace, **opts)

    def _generate_stream(self, name: str, req, trace=None):
        served, prompt, opts = self._gen_opts(name, req)
        return served.stream(prompt, trace=trace, **opts)

    def _count_disconnect(self):
        """Count a swallowed dead-socket write (client hung up while a
        response or stream chunk was in flight). Routine under router
        timeouts/hedging, but a rate spike means clients are giving up
        before replies arrive — surfaced in ``summary()``."""
        with self._disc_lock:
            self.client_disconnects += 1

    def _access_log(self, entry: dict):
        """Emit one structured JSON access-log line (off unless the
        server was built with ``log_requests=``). Logging failures
        never take down a request handler."""
        stream = self._log_stream
        if stream is None:
            return
        try:
            line = json.dumps(entry, separators=(",", ":"))
            with self._log_lock:
                stream.write(line + "\n")
                stream.flush()
        except (OSError, ValueError):
            pass

    def _count_error(self, name: str, code: int, version=None):
        try:
            m = self.registry.get(
                name, version if isinstance(version, int) else None).metrics
        except Exception:  # noqa: BLE001 — unknown model has no metrics
            return
        if code == 400:
            m.inc("client_errors")
        elif code >= 500 and code not in (503, 504) \
                and not isinstance(m, GenerationMetrics):
            # generation 5xx are already counted at the engine
            # (GenerationEngine._fail) so direct-API users see them
            # too; counting here as well would double them
            m.inc("server_errors")

    def _health(self) -> dict:
        d = {"status": "ok", "models": self.registry.names()}
        if self.model is not None:
            d["model"] = type(self.model).__name__  # legacy field
        return d

    # -- lifecycle (docs/serving.md "Operating the server") ------------
    def ready(self) -> bool:
        """Readiness: True until :meth:`drain` starts. ``/readyz``
        mirrors this (200 vs 503 + Retry-After) so load balancers pull
        the replica before its in-flight work finishes."""
        return self._ready

    def _healthz(self):
        """Liveness: (status code, body). 503 only when some engine's
        scheduler loop is WEDGED — thread dead or heartbeat stale past
        its stall watchdog. Draining/stopped engines are alive (that's
        readiness's job), so a restart isn't provoked mid-drain."""
        models = self.registry.health()
        ok = all(models.values())
        return (200 if ok else 503), {
            "status": "ok" if ok else "stalled",
            "models": models}

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown, phase 1: flip readiness off (``/readyz``
        -> 503, new POSTs -> 503 + Retry-After), drain every engine
        (in-flight requests finish, scheduler threads join). The HTTP
        listener stays up so ``/stats``, ``/healthz`` and in-flight
        streaming responses keep flowing; call :meth:`stop` (phase 2)
        to tear it down. Returns True when everything drained within
        ``timeout_s``."""
        self._ready = False
        return self.registry.drain(timeout_s)

    def install_signal_handlers(self, signals=(signal.SIGTERM,),
                                drain_timeout_s: float = 30.0,
                                reraise: bool = True) -> bool:
        """Wire graceful drain to SIGTERM (the platform's preemption
        notice — same contract as
        :class:`~..parallel.elastic.PreemptionHandler` for training):
        on signal, drain + stop, then chain the previous handler (or
        re-deliver the default action so the process actually exits).
        Signal handlers are a main-thread-only facility; elsewhere
        this degrades to a no-op and returns False.

        The handler itself only flips readiness and hands off: Python
        runs it on the main thread between bytecodes, so the main
        thread may at that instant hold the very registry/batcher
        locks ``drain()`` needs — blocking in the handler would
        deadlock the process on a lock its own thread holds. The
        blocking drain + stop run on a dedicated thread. Chaining
        works by RESTORING the previous disposition in the handler
        (``signal.signal`` is itself main-thread-only) and having the
        worker re-deliver the signal after the drain: CPython then
        runs the previous handler on the main thread, the context it
        is entitled to (e.g. ``PreemptionHandler`` re-arms SIG_DFL,
        legal only there). A side effect is the usual graceful-then-
        forceful contract: a second signal during the drain takes the
        previous/default action immediately."""
        if threading.current_thread() is not threading.main_thread():
            return False

        def _handle(signum, frame):
            self._ready = False       # lock-free; /readyz flips now
            if self._signal_drain is not None \
                    and self._signal_drain.is_alive():
                return                # drain already in flight
            prev = self._prev_handlers.get(signum)
            if reraise and prev is not None:
                signal.signal(signum, prev)

            def _drain_and_exit():
                self.drain(drain_timeout_s)
                self.stop()
                if reraise and prev is not None \
                        and prev != signal.SIG_IGN:
                    os.kill(os.getpid(), signum)
            # non-daemon: interpreter exit waits for the (time-bounded)
            # drain instead of killing it mid-flight
            self._signal_drain = threading.Thread(
                target=_drain_and_exit, name="serving-signal-drain",
                daemon=False)
            self._signal_drain.start()
        for s in signals:
            self._prev_handlers[s] = signal.getsignal(s)
            signal.signal(s, _handle)
        return True

    def stats(self) -> dict:
        return {"summary": self.summary(),
                "models": self.registry.stats(),
                "profiler": profiler_sections()}

    def summary(self) -> dict:
        """Compact machine-readable routing summary, also embedded as
        the ``summary`` key of ``GET /stats``: per-model live
        occupancy / queue depth / draining flag plus a server-level
        ``load`` total — what :class:`~.fleet.FleetRouter` (or any
        external load balancer) reads to pick a replica without
        parsing nested histogram snapshots."""
        models = self.registry.summary()
        return {"ready": self.ready(),
                "draining": not self.ready(),
                "load": sum(m["load"] for m in models.values()),
                # server-level shed total: a fleet poller aggregates
                # these into per-replica overload counters
                "shed": sum(m.get("shed", 0) for m in models.values()),
                "client_disconnects": self.client_disconnects,
                "models": models}

    def stop(self):
        # readiness off FIRST: handler threads still in flight when the
        # listener stops would otherwise race the registry teardown and
        # answer 404 ("unknown model") — a lie that a router would pass
        # through as terminal. Shedding 503 + Retry-After instead keeps
        # even a hard (drain-less) stop retryable upstream.
        self._ready = False
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
        if self._aio is not None:
            self._aio.stop()
        if self._owns_registry:
            self.registry.stop()
