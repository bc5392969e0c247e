"""Event-loop HTTP front-ends of the serving plane (counterpart of
``deeplearning4j_tpu/serving/aio.py``, lifted).

The thread-per-connection front-end (``http.server.ThreadingHTTPServer``)
spends one OS thread per OPEN connection — not per in-flight request.
Both HTTP tiers run on one ``asyncio`` selector loop instead:

- :class:`AioReplicaFrontend`: the :class:`~.InferenceServer` listener.
  Routing, body discipline (400/413 + close), keep-alive, chunked
  ndjson streaming, ``X-Request-Id`` / ``X-Priority`` propagation,
  ``?trace=1``, the access log and the probe routes are
  byte-compatible with the thread backend — the server-level methods
  (``_route``, ``_predict``, ``_generate_stream``, ``_healthz`` …) are
  shared, only the socket tier differs.
- :class:`AioRouterFrontend`: the :class:`~.fleet.FleetRouter`
  listener. Streaming proxies are natively async end to end — one open
  proxied stream is two socket buffers and a coroutine, not a thread —
  over an async upstream connection pool (:class:`_AioConnPool`)
  mirroring the blocking ``_ConnPool``'s checkout semantics.

Concurrency model: the event loop owns every socket. Work that blocks
on an engine (predict/generate admission, pulling the next token of a
non-engine stream, the router's retry/hedge dispatch) runs on a bounded
daemon-thread pool — so the
THREAD cost of the process scales with in-flight *blocking work*,
never with open connections. A generation stream is consumed through
the engine's ``stream_notify`` hook and costs no thread while idle;
the loop wakes once for every stream a decode step fed.
Request heads that do not complete within ``header_timeout_s`` are
dropped without a thread ever having been committed to them
(slow-loris protection), and a head larger than 256 KiB is a 431.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import json
import queue as _queue
import threading
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs

from ..tracing import new_request_id
from .batcher import DeadlineExceededError

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    408: "Request Timeout", 413: "Payload Too Large",
    431: "Request Header Fields Too Large", 500: "Internal Server Error",
    501: "Not Implemented", 503: "Service Unavailable",
    504: "Gateway Timeout",
}

#: header-read cap: a request head larger than this is a 431, and the
#: StreamReader limit bounds buffering before the head even parses
_MAX_HEAD_BYTES = 256 * 1024

_END = object()          # stream-iterator exhaustion sentinel


def _status_for(exc: BaseException) -> int:
    from . import _status_for as impl     # parent package, post-init
    return impl(exc)


class _DaemonExecutor:
    """Minimal thread pool of DAEMON threads (lazily grown, bounded).

    ``concurrent.futures.ThreadPoolExecutor`` workers are non-daemon
    and joined at interpreter exit — one worker still blocked on a
    slow engine call would hang process shutdown. Serving work is
    always deadline-bounded, but the front-end must not make exit
    correctness depend on that; daemon workers cannot.
    """

    def __init__(self, max_workers: int, name: str):
        self._q: _queue.SimpleQueue = _queue.SimpleQueue()
        self._lock = threading.Lock()
        self._max = int(max_workers)
        self._name = name
        self._workers = 0
        self._idle = 0
        self._down = False

    def submit(self, fn, *args) -> concurrent.futures.Future:
        f: concurrent.futures.Future = concurrent.futures.Future()
        if self._down:
            f.set_exception(RuntimeError("executor is shut down"))
            return f
        self._q.put((f, fn, args))
        with self._lock:
            if self._idle == 0 and self._workers < self._max:
                self._workers += 1
                n = self._workers
                threading.Thread(target=self._work, daemon=True,
                                 name=f"{self._name}-{n}").start()
        return f

    def _work(self):
        while True:
            with self._lock:
                self._idle += 1
            item = self._q.get()
            with self._lock:
                self._idle -= 1
            if item is None:
                with self._lock:
                    self._workers -= 1
                return
            f, fn, args = item
            if not f.set_running_or_notify_cancel():
                continue
            try:
                f.set_result(fn(*args))
            except BaseException as e:  # noqa: BLE001 — future carries it
                f.set_exception(e)

    def shutdown(self):
        self._down = True
        with self._lock:
            n = self._workers
        for _ in range(n):
            self._q.put(None)


class _Headers:
    """Case-insensitive header lookup over the parsed request head."""

    __slots__ = ("_d",)

    def __init__(self, d: Dict[str, str]):
        self._d = d

    def get(self, name: str, default=None):
        return self._d.get(name.lower(), default)


class _Request:
    __slots__ = ("method", "target", "path", "query", "version",
                 "headers", "reader", "close")

    def __init__(self, method, target, version, headers, reader):
        self.method = method
        self.target = target
        self.path, _, self.query = target.partition("?")
        self.version = version
        self.headers = headers
        self.reader = reader
        conn = (headers.get("Connection") or "").lower()
        self.close = ("close" in conn
                      or (version == "HTTP/1.0"
                          and "keep-alive" not in conn))


class _Resp:
    """Per-request response writer + the state the access log reads."""

    __slots__ = ("_w", "rid", "prio", "shed", "status", "sent", "close",
                 "log_cb")

    def __init__(self, writer):
        self._w = writer
        self.rid: Optional[str] = None
        self.prio: Optional[str] = None
        self.shed: Optional[str] = None
        self.status: Optional[int] = None
        self.sent = False
        self.close = False
        self.log_cb = None

    async def _send(self, code: int, ctype: str, body: bytes,
                    headers: Optional[Dict[str, str]] = None,
                    chunked: bool = False):
        lines = [f"HTTP/1.1 {code} {_REASONS.get(code, 'Unknown')}",
                 f"Content-Type: {ctype}"]
        if chunked:
            lines.append("Transfer-Encoding: chunked")
        else:
            lines.append(f"Content-Length: {len(body)}")
            if self.rid:
                lines.append(f"X-Request-Id: {self.rid}")
        for k, v in (headers or {}).items():
            lines.append(f"{k}: {v}")
        head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
        self.status = code
        self.sent = True
        # access log fires at header-send time (like the thread
        # backend's send_response hook), so by the time a client can
        # read the response its log line is already written
        if self.log_cb is not None:
            cb, self.log_cb = self.log_cb, None
            cb()
        self._w.write(head + body)
        await self._w.drain()

    async def json(self, obj, code: int = 200,
                   headers: Optional[Dict[str, str]] = None):
        body = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
        await self._send(code, "application/json", body, headers)

    async def text(self, s: str, code: int = 200):
        await self._send(code, "text/plain; version=0.0.4; charset=utf-8",
                         s.encode(), None)

    async def start_stream(self):
        await self._send(200, "application/x-ndjson", b"", None,
                         chunked=True)

    async def chunk(self, data: bytes):
        self.chunk_now(data)
        await self._w.drain()

    def chunk_now(self, data: bytes):
        """Queue one chunk on the transport without waiting for it to
        drain (the caller checks the transport's buffer)."""
        self._w.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

    async def end_stream(self):
        self._w.write(b"0\r\n\r\n")
        await self._w.drain()


#: socket-level failures while talking to the downstream client —
#: asyncio surfaces resets as ConnectionError subclasses, but a
#: transport torn down mid-write can also raise bare OSError
_SOCK_EXC = (ConnectionError, OSError, asyncio.IncompleteReadError)


class _AioFrontend:
    """Shared event-loop listener: one daemon thread runs the loop, a
    bounded daemon pool runs blocking work. Subclasses provide the
    route tables (:meth:`handle_get` / :meth:`handle_post`) and the
    tier hooks (access log, request-id minting, disconnect counter).
    """

    def __init__(self, host: str, port: int, *, name: str,
                 max_body_bytes: int,
                 header_timeout_s: float = 10.0,
                 workers: int = 128):
        self.max_body_bytes = int(max_body_bytes)
        self.header_timeout_s = float(header_timeout_s)
        self._pool = _DaemonExecutor(workers, name + "-work")
        self._conns: set = set()
        self._server = None
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        self._loop = asyncio.new_event_loop()
        self._stopped = False
        started = threading.Event()
        boot_err: List[BaseException] = []

        def _run():
            loop = self._loop
            asyncio.set_event_loop(loop)
            try:
                self._server = loop.run_until_complete(
                    asyncio.start_server(self._serve_conn, host, port,
                                         limit=_MAX_HEAD_BYTES,
                                         backlog=512))
                addr = self._server.sockets[0].getsockname()
                self.host, self.port = addr[0], addr[1]
            except BaseException as e:  # noqa: BLE001 — report to ctor
                boot_err.append(e)
                started.set()
                return
            started.set()
            try:
                loop.run_forever()
            finally:
                tasks = asyncio.all_tasks(loop)
                for t in tasks:
                    t.cancel()
                try:
                    loop.run_until_complete(
                        asyncio.gather(*tasks, return_exceptions=True))
                except Exception:   # noqa: BLE001 — teardown best-effort
                    pass
                loop.close()

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name=name)
        self._thread.start()
        started.wait(10.0)
        if boot_err:
            raise boot_err[0]

    # -- tier hooks ----------------------------------------------------
    def _prepare_post(self, req: _Request, resp: _Resp):
        """Mint/propagate the request id before body discipline runs,
        so even a 413/400 reject echoes ``X-Request-Id``."""
        resp.rid = req.headers.get("X-Request-Id") or new_request_id()
        resp.prio = req.headers.get("X-Priority")

    def _oversize_msg(self) -> str:
        return "request body too large"

    def _access_log(self, entry: dict):   # pragma: no cover - overridden
        pass

    def _on_disconnect(self):
        pass

    async def handle_get(self, req: _Request, resp: _Resp):
        await resp.json({"error": "not found"}, 404)

    async def handle_post(self, req: _Request, resp: _Resp, raw: bytes):
        await resp.json({"error": "not found"}, 404)

    # -- blocking-work bridge ------------------------------------------
    async def _blocking(self, fn, *args):
        """Run ``fn`` on the daemon pool; await without holding the
        loop. Every engine touch goes through here."""
        return await asyncio.wrap_future(self._pool.submit(fn, *args))

    # -- connection loop -----------------------------------------------
    async def _serve_conn(self, reader, writer):
        self._conns.add(writer)
        try:
            while True:
                try:
                    head = await asyncio.wait_for(
                        reader.readuntil(b"\r\n\r\n"),
                        self.header_timeout_s)
                except (asyncio.TimeoutError, TimeoutError):
                    return            # slow-loris / idle past the cap
                except asyncio.LimitOverrunError:
                    await self._reject(writer, 431,
                                       "request head too large")
                    return
                except _SOCK_EXC:
                    return            # keep-alive peer went away
                req = self._parse_head(head, reader)
                if req is None:
                    await self._reject(writer, 400, "malformed request")
                    return
                t0 = time.perf_counter()
                resp = _Resp(writer)
                resp.rid = req.headers.get("X-Request-Id")
                resp.log_cb = (lambda r=req, rs=resp, t=t0:
                               self._log(r, rs, t))
                try:
                    if req.method == "GET":
                        await self.handle_get(req, resp)
                    elif req.method == "POST":
                        self._prepare_post(req, resp)
                        ok, raw = await self._read_body(req, resp)
                        if ok:
                            await self.handle_post(req, resp, raw)
                    else:
                        await resp.json(
                            {"error": "method not allowed"}, 501)
                        resp.close = True
                except _SOCK_EXC:
                    resp.close = True
                except Exception as e:  # noqa: BLE001 — last resort
                    if resp.sent:
                        resp.close = True
                    else:
                        try:
                            await resp.json({"error": str(e)}, 500)
                        except _SOCK_EXC:
                            resp.close = True
                if resp.close or req.close:
                    return
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
            except Exception:   # noqa: BLE001 — transport already dead
                pass

    @staticmethod
    def _parse_head(head: bytes, reader) -> Optional[_Request]:
        try:
            lines = head.decode("latin-1").split("\r\n")
            method, target, version = lines[0].split(" ", 2)
            hdrs: Dict[str, str] = {}
            for ln in lines[1:]:
                if not ln:
                    continue
                k, _, v = ln.partition(":")
                hdrs[k.strip().lower()] = v.strip()
        except ValueError:
            return None
        return _Request(method.upper(), target, version.strip(),
                        _Headers(hdrs), reader)

    async def _read_body(self, req: _Request,
                         resp: _Resp) -> Tuple[bool, bytes]:
        """Same keep-alive body discipline as the thread backend: an
        unread/unframed body would desync the next request on the
        socket, so every reject also closes the connection."""
        if req.headers.get("Transfer-Encoding"):
            await resp.json({"error": "Transfer-Encoding not "
                             "supported; send Content-Length"}, 501)
            resp.close = True
            return False, b""
        try:
            n = int(req.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            n = -1
        if n < 0:
            await resp.json({"error": "bad Content-Length"}, 400)
            resp.close = True
            return False, b""
        if n > self.max_body_bytes:
            await resp.json({"error": self._oversize_msg()}, 413)
            resp.close = True
            return False, b""
        raw = await req.reader.readexactly(n) if n else b""
        return True, raw

    async def _reject(self, writer, code: int, msg: str):
        body = json.dumps({"error": msg}).encode()
        try:
            writer.write(
                (f"HTTP/1.1 {code} {_REASONS.get(code, 'Unknown')}\r\n"
                 "Content-Type: application/json\r\n"
                 f"Content-Length: {len(body)}\r\n"
                 "Connection: close\r\n\r\n").encode() + body)
            await writer.drain()
        except _SOCK_EXC:
            pass

    def _log(self, req: _Request, resp: _Resp, t0: float):
        entry = {"ts": round(time.time(), 6),
                 "method": req.method,
                 "path": req.target,
                 "status": resp.status,
                 "latency_ms": round(
                     (time.perf_counter() - t0) * 1e3, 3),
                 "request_id": resp.rid,
                 "priority": resp.prio}
        if resp.shed is not None:
            entry["shed_reason"] = resp.shed
        self._access_log(entry)

    # -- lifecycle -----------------------------------------------------
    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        loop = self._loop

        async def _teardown():
            # the open connections close first: since Python 3.12
            # wait_closed() also waits for them, and a router's idle
            # keep-alive would hold it to the 5 s timeout below
            if self._server is not None:
                self._server.close()
            for w in list(self._conns):
                try:
                    w.close()
                except Exception:   # noqa: BLE001
                    pass
            if self._server is not None:
                await self._server.wait_closed()

        try:
            fut = asyncio.run_coroutine_threadsafe(_teardown(), loop)
            fut.result(timeout=5.0)
        except Exception:   # noqa: BLE001 — loop already down
            pass
        try:
            loop.call_soon_threadsafe(loop.stop)
        except RuntimeError:
            pass
        self._thread.join(timeout=5.0)
        self._pool.shutdown()


# ---------------------------------------------------------------------
# replica tier
# ---------------------------------------------------------------------

class _StreamPipe:
    """One generation stream of the replica tier, between its coroutine
    (:meth:`AioReplicaFrontend._stream_ndjson`) and the loop's wake
    callback. While the coroutine is parked waiting for items
    (``direct``), :meth:`pump` writes the queued tokens itself: a decode
    step costs each stream a queue read and a socket write on the loop,
    not a coroutine resume with its timer and future. A terminal item
    (kept in ``held``), a transport that is closing or over its
    high-water mark, or a wake while the coroutine runs hands the stream
    back to the coroutine through ``evt``. Loop thread only."""

    __slots__ = ("it", "req", "resp", "evt", "direct", "held")

    def __init__(self, it, resp: _Resp):
        self.it, self.req, self.resp = it, it._req, resp
        self.evt = asyncio.Event()
        self.direct = False
        self.held = None

    def take(self):
        """The next item, the held one first; None when none is queued."""
        if self.held is not None:
            item, self.held = self.held, None
            return item
        try:
            return self.req.stream_q.get_nowait()
        except _queue.Empty:
            return None

    def pump(self):
        if self.direct:
            transport = self.resp._w.transport
            lines = []
            if not transport.is_closing() and \
                    transport.get_write_buffer_size() \
                    <= transport.get_write_buffer_limits()[1]:
                it = self.it
                while True:
                    item = self.take()
                    if item is None:
                        break
                    if item[0] != "token":
                        self.held = item
                        self.direct = False
                        break
                    lines.append(f'{{"token": {int(item[1])}, '
                                 f'"index": {it._i}}}\n')
                    it._i += 1
                if lines:
                    self.resp.chunk_now("".join(lines).encode())
                if self.direct:
                    return
        self.direct = False
        self.evt.set()


class AioReplicaFrontend(_AioFrontend):
    """Event-loop listener for one :class:`~.InferenceServer` replica.
    Route table and semantics mirror the thread backend's handler; the
    server-level request methods are shared verbatim."""

    def __init__(self, server, host: str, port: int,
                 header_timeout_s: float = 10.0, workers: int = 128):
        self._srv = server
        # the streams marked since the loop last woke (see
        # _stream_waker): one wakeup carries every stream a decode step
        # fed, not one per token
        self._woken: set = set()
        self._woken_lock = threading.Lock()
        super().__init__(host, port, name="serving-aio",
                         max_body_bytes=server.max_body_bytes,
                         header_timeout_s=header_timeout_s,
                         workers=workers)

    def _oversize_msg(self) -> str:
        return (f"request body too large (limit "
                f"{self._srv.max_body_bytes} bytes)")

    def _access_log(self, entry: dict):
        if self._srv._log_stream is not None:
            self._srv._access_log(entry)

    def _on_disconnect(self):
        self._srv._count_disconnect()

    async def handle_get(self, req: _Request, resp: _Resp):
        from .metrics import prometheus_text
        server = self._srv
        path, query = req.path, req.query
        try:
            if path == "/health":
                await resp.json(server._health())
            elif path == "/healthz":
                code, body = server._healthz()
                await resp.json(body, code)
            elif path == "/readyz":
                if server.ready():
                    await resp.json({"ready": True})
                else:
                    await resp.json({"ready": False,
                                     "reason": "draining"}, 503,
                                    headers={"Retry-After": "1"})
            elif path == "/stats":
                await resp.json(server.stats())
            elif path == "/metrics":
                await resp.text(prometheus_text(server.stats()))
            elif path == "/debug/traces":
                q = parse_qs(query)
                rid = (q.get("request_id") or q.get("id") or [None])[0]
                limit = int((q.get("limit") or [50])[0])
                await resp.json({
                    "traces": server.tracer.dump(request_id=rid,
                                                 limit=limit),
                    "tracer": server.tracer.snapshot()})
            elif path in ("/v1/models", "/v1/models/"):
                await resp.json(server.registry.describe())
            else:
                await resp.json({"error": "not found"}, 404)
        except _SOCK_EXC:
            raise
        except Exception as e:  # noqa: BLE001 — route-level 500
            if resp.sent:
                raise
            await resp.json({"error": str(e)}, 500)

    async def handle_post(self, req: _Request, resp: _Resp, raw: bytes):
        from .engine import ClientError
        server = self._srv
        path, query = req.path, req.query
        route = server._route(path)
        if route is None:
            await resp.json({"error": "not found"}, 404)
            return
        name, action = route
        if not server.ready():
            resp.shed = "draining"
            await resp.json({"error": "server is draining"}, 503,
                            headers={"Retry-After": "1"})
            return
        parsed = None
        result = None
        trace = None
        span = None
        want_trace = False
        try:
            try:
                parsed = json.loads(raw)
            except json.JSONDecodeError as e:
                raise ClientError(f"malformed JSON: {e}")
            prio_hdr = req.headers.get("X-Priority")
            if prio_hdr and isinstance(parsed, dict) \
                    and "priority" not in parsed:
                parsed["priority"] = prio_hdr
            if isinstance(parsed, dict):
                resp.prio = parsed.get("priority", resp.prio)
            want_trace = bool(
                (query and "trace=1" in query.split("&"))
                or (isinstance(parsed, dict)
                    and parsed.pop("trace", None)))
            trace = server.tracer.begin(resp.rid, force=want_trace)
            if trace is not None:
                span = trace.span("http", path=path, model=name,
                                  action=action)
            if action == "generate":
                if isinstance(parsed, dict) and parsed.get("stream"):
                    # admission runs on the pool (it may block on the
                    # engine queue lock) and raises BEFORE headers go
                    # out, so shed/4xx still map to status codes
                    it = await self._blocking(
                        server._generate_stream, name, parsed, trace)
                    await self._stream_ndjson(resp, it)
                    if trace is not None:
                        span.end(status=200, stream=True)
                        server.tracer.finish(trace)
                    return
                result = await self._blocking(
                    server._generate, name, parsed, trace)
            else:
                result = await self._blocking(
                    server._predict, name, parsed, trace)
        except _SOCK_EXC:
            raise
        except Exception as e:  # noqa: BLE001 — engine/client failure
            code = _status_for(e)
            if code in (503, 504):
                resp.shed = str(e)
            version = (parsed.get("version")
                       if isinstance(parsed, dict) else None)
            server._count_error(name, code, version)
            if trace is not None:
                span.end(status=code, error=str(e))
                server.tracer.finish(trace, error=code >= 500)
            try:
                await resp.json({"error": str(e)}, code,
                                headers=({"Retry-After": "1"}
                                         if code == 503 else None))
            except _SOCK_EXC:
                server._count_disconnect()
                resp.close = True
            return
        if trace is not None:
            span.end(status=200)
            server.tracer.finish(trace)
            if want_trace and isinstance(result, dict):
                result = dict(result)
                result["trace"] = trace.to_dict()
        try:
            await resp.json(result)
        except _SOCK_EXC:
            # client hung up while the request computed — routine once
            # routers time out and abandon sockets
            server._count_disconnect()
            resp.close = True

    def _stream_waker(self, pipe: "_StreamPipe"):
        """The ``stream_notify`` hook of one stream, called on the
        scheduler thread after it queues items. It adds the stream to
        the set pending for the loop, and only a call that finds the set
        empty wakes the loop; the loop's callback takes the whole set and
        pumps every stream in it. At the end of a decode step the engine
        calls ``many`` once with the hooks of every stream the step fed,
        so the step wakes the loop once, not once a token."""
        def notify():
            self._wake([notify])
        notify.pipe = pipe
        notify.many = self._wake
        return notify

    def _wake(self, hooks):
        with self._woken_lock:
            first = not self._woken
            self._woken.update(h.pipe for h in hooks)
        if first:
            self._loop.call_soon_threadsafe(self._wake_streams)

    def _wake_streams(self):
        with self._woken_lock:
            pipes, self._woken = self._woken, set()
        for pipe in pipes:
            pipe.pump()

    async def _stream_ndjson(self, resp: _Resp, it):
        """Chunked ndjson: one object per token as the scheduler emits
        it, a terminal ``{"done": true}`` object, then the zero chunk.
        The objects queued when the stream is served go out in one
        chunk (one line each).

        Generation streams are consumed EVENT-DRIVEN: the engine's
        ``stream_notify`` hook marks the stream from the scheduler
        thread (:meth:`_stream_waker`); while this coroutine is parked
        the loop's wake callback writes the tokens (:class:`_StreamPipe`)
        and the coroutine drains the queue with ``get_nowait`` whenever
        it runs — an idle open stream costs two socket buffers and a
        parked coroutine, never a pool worker. (The executor-pump
        fallback below exists only for iterators without the
        ``_TokenStream`` queue shape.) That zero-thread idle cost is
        what lets one replica hold thousands of open streams."""
        server = self._srv
        req = getattr(it, "_req", None)
        if req is None or getattr(req, "stream_q", None) is None:
            def pull():
                try:
                    return next(it)
                except StopIteration:
                    return _END

            async def anext_item():
                return await self._blocking(pull)

            def ready_items():
                return [], None
        else:
            pipe = _StreamPipe(it, resp)
            evt = pipe.evt
            req.stream_notify = self._stream_waker(pipe)
            engine = it._engine

            def item_of(kind, payload):
                if kind == "token":
                    i = it._i
                    it._i += 1
                    return {"token": int(payload), "index": i}
                it._done = True
                if kind == "done":
                    engine.metrics.inc("responses")
                    final = req.result()
                    final["done"] = True
                    return final
                raise payload  # "error"

            def ready_items():
                """The items queued behind the one just taken, without
                waiting, and the error that ended them (or None)."""
                out = []
                while not it._done:
                    item = pipe.take()
                    if item is None:
                        break
                    kind, payload = item
                    try:
                        out.append(item_of(kind, payload))
                    except Exception as e:  # noqa: BLE001 — in-band
                        return out, e
                return out, None

            async def anext_item():
                # event-driven mirror of _TokenStream.__next__: same
                # deadline budget, same timeout/abandon accounting,
                # same item protocol — but parked on evt, not a thread
                if it._done:
                    return _END
                while True:
                    # clear BEFORE the queue check: a push landing
                    # after the check re-sets evt, so the wait below
                    # can never sleep through an item already queued
                    evt.clear()
                    item = pipe.take()
                    if item is not None:
                        break
                    budget = req.deadline - time.perf_counter() + 1.0
                    if budget <= 0:
                        it._done = True
                        req.abandoned = True
                        req.count_timeout_once(engine.metrics)
                        raise DeadlineExceededError(
                            "stream stalled past the deadline")
                    # while parked, the wake callback writes the tokens
                    # (_StreamPipe.pump) and wakes this coroutine only
                    # for the end, a full or closing socket, or a timeout
                    pipe.direct = True
                    try:
                        await asyncio.wait_for(evt.wait(), budget)
                    except (asyncio.TimeoutError, TimeoutError):
                        pass  # loop re-checks queue, then budget
                    finally:
                        pipe.direct = False
                return item_of(*item)

        try:
            await resp.start_stream()
        except _SOCK_EXC:
            # client vanished before headers: abandon the generation
            # (frees its slot/blocks), never try a second response
            if hasattr(it, "close"):
                it.close()
            if req is not None:
                req.stream_notify = None
            server._count_disconnect()
            resp.close = True
            return
        try:
            try:
                while True:
                    item = await anext_item()
                    if item is _END:
                        break
                    more, err = ready_items()
                    await resp.chunk("".join(
                        json.dumps(x) + "\n" for x in [item] + more)
                        .encode())
                    if err is not None:
                        raise err
            except _SOCK_EXC:
                # client went away mid-stream: close the iterator NOW
                # (abandons the request, freeing its cache slot)
                if hasattr(it, "close"):
                    it.close()
                server._count_disconnect()
                resp.close = True
                return
            except Exception as e:  # noqa: BLE001 — headers are on
                # the wire; deliver the failure in-band
                await resp.chunk((json.dumps(
                    {"error": str(e), "status": _status_for(e),
                     "done": True}) + "\n").encode())
            await resp.end_stream()
        except _SOCK_EXC:
            server._count_disconnect()
            resp.close = True
        finally:
            if req is not None:
                req.stream_notify = None


# ---------------------------------------------------------------------
# router tier
# ---------------------------------------------------------------------

class _AioUpstream:
    """One async keep-alive connection to a replica, with a de-chunking
    line reader over the open response. Only ever touched from the
    router frontend's event loop (single thread — no locking)."""

    __slots__ = ("host", "port", "_r", "_w", "_chunked", "_remaining",
                 "_buf", "_eof", "clean")

    def __init__(self, host: str, port: int, reader, writer):
        self.host = host
        self.port = port
        self._r = reader
        self._w = writer
        self._chunked = False
        self._remaining = 0
        self._buf = b""
        self._eof = False
        self.clean = False       # response fully consumed -> reusable

    @classmethod
    async def connect(cls, host: str, port: int,
                      timeout_s: float) -> "_AioUpstream":
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout_s)
        return cls(host, port, reader, writer)

    async def request(self, path: str, body: bytes,
                      headers: Optional[Dict[str, str]],
                      timeout_s: float) -> Tuple[int, Dict[str, str]]:
        """Send one POST, read the response head -> (status, headers).
        Resets per-response reader state for pooled reuse."""
        self._buf = b""
        self._eof = False
        self.clean = False
        lines = [f"POST {path} HTTP/1.1",
                 f"Host: {self.host}:{self.port}",
                 "Content-Type: application/json",
                 f"Content-Length: {len(body)}"]
        for k, v in (headers or {}).items():
            lines.append(f"{k}: {v}")
        self._w.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
                      + body)
        await asyncio.wait_for(self._w.drain(), timeout_s)
        head = await asyncio.wait_for(self._r.readuntil(b"\r\n\r\n"),
                                      timeout_s)
        try:
            hlines = head.decode("latin-1").split("\r\n")
            status = int(hlines[0].split(" ", 2)[1])
            hdrs: Dict[str, str] = {}
            for ln in hlines[1:]:
                if not ln:
                    continue
                k, _, v = ln.partition(":")
                hdrs[k.strip().lower()] = v.strip()
        except (ValueError, IndexError) as e:
            raise ConnectionError(f"bad upstream response head: {e}")
        self._chunked = ("chunked"
                         in hdrs.get("transfer-encoding", "").lower())
        if not self._chunked:
            try:
                self._remaining = int(hdrs.get("content-length", 0))
            except ValueError:
                raise ConnectionError("bad upstream Content-Length")
        return status, {k.title(): v for k, v in hdrs.items()}

    async def read_body(self, timeout_s: float) -> bytes:
        """Drain the whole response body (non-stream answers)."""
        out = []
        while True:
            line = await asyncio.wait_for(self._line(), timeout_s)
            if not line:
                return b"".join(out)
            out.append(line)

    async def readline(self) -> bytes:
        """Next line of the de-chunked response body; b'' at clean
        end. Raises on a connection torn mid-stream (the caller maps
        that to the in-band upstream-failure chunk)."""
        return await self._line()

    async def _line(self) -> bytes:
        while True:
            i = self._buf.find(b"\n")
            if i >= 0:
                line, self._buf = self._buf[:i + 1], self._buf[i + 1:]
                return line
            if self._eof:
                if self._buf:
                    line, self._buf = self._buf, b""
                    return line
                return b""
            await self._fill()

    async def _fill(self):
        if self._chunked:
            size_line = await self._r.readline()
            if not size_line:
                raise ConnectionError("upstream closed mid-stream")
            try:
                size = int(size_line.strip().split(b";")[0], 16)
            except ValueError:
                raise ConnectionError("bad upstream chunk framing")
            if size == 0:
                await self._r.readline()     # trailing CRLF
                self._eof = True
                self.clean = True
                return
            data = await self._r.readexactly(size + 2)
            self._buf += data[:-2]
        else:
            if self._remaining <= 0:
                self._eof = True
                self.clean = True
                return
            data = await self._r.read(min(65536, self._remaining))
            if not data:
                raise ConnectionError("upstream closed mid-body")
            self._remaining -= len(data)
            self._buf += data

    def close(self):
        try:
            self._w.close()
        except Exception:   # noqa: BLE001 — transport already dead
            pass


class _AioConnPool:
    """Async analogue of the router's blocking ``_ConnPool``: idle
    upstream connections checked out per stream, bounded per address,
    pruned on fleet membership change. Event-loop-thread only."""

    def __init__(self, max_per_key: int = 32):
        self._idle: Dict[Tuple[str, int], List[_AioUpstream]] = {}
        self.max_per_key = int(max_per_key)

    def take(self, host: str, port: int) -> Optional[_AioUpstream]:
        stack = self._idle.get((host, port))
        return stack.pop() if stack else None

    def give(self, up: _AioUpstream):
        stack = self._idle.setdefault((up.host, up.port), [])
        if len(stack) < self.max_per_key:
            stack.append(up)
        else:
            up.close()

    def prune(self, live_keys):
        dead = [k for k in self._idle if k not in live_keys]
        for k in dead:
            for up in self._idle.pop(k):
                up.close()

    def close_all(self):
        stacks, self._idle = self._idle, {}
        for stack in stacks.values():
            for up in stack:
                up.close()


class AioRouterFrontend(_AioFrontend):
    """Event-loop listener for a :class:`~.fleet.FleetRouter`. The
    streaming proxy path is natively async end to end (client socket,
    replica socket, relay) — holding an open proxied stream costs two
    buffers, never a thread. Non-streaming dispatch reuses the
    router's blocking retry/hedge machinery on the work pool."""

    def __init__(self, router, host: str, port: int,
                 max_body_bytes: int,
                 header_timeout_s: float = 10.0, workers: int = 128):
        self._router = router
        self._apool = _AioConnPool()
        self._live_addrs: set = set()
        super().__init__(host, port, name="fleet-aio",
                         max_body_bytes=max_body_bytes,
                         header_timeout_s=header_timeout_s,
                         workers=workers)

    def _access_log(self, entry: dict):
        if self._router._log_stream is not None:
            self._router._access_log(entry)

    async def handle_get(self, req: _Request, resp: _Resp):
        from .fleet import _get_json
        from .metrics import prometheus_text
        router = self._router
        path, query = req.path, req.query
        try:
            if path == "/stats":
                await resp.json(router.stats())
            elif path == "/metrics":
                await resp.text(prometheus_text(router.stats()))
            elif path == "/debug/traces":
                q = parse_qs(query)
                rid = (q.get("request_id") or q.get("id") or [None])[0]
                limit = int((q.get("limit") or [50])[0])
                await resp.json({
                    "traces": router.tracer.dump(request_id=rid,
                                                 limit=limit),
                    "tracer": router.tracer.snapshot()})
            elif path == "/healthz":
                ok = router.healthy()
                await resp.json({"status": "ok" if ok
                                 else "no replicas"},
                                200 if ok else 503)
            elif path == "/readyz":
                if router.ready():
                    await resp.json({"ready": True})
                else:
                    await resp.json({"ready": False,
                                     "reason": "no eligible replica"},
                                    503, headers={"Retry-After": "1"})
            elif path in ("/v1/models", "/v1/models/"):
                rep = router._pick(set())
                if rep is None:
                    await resp.json({"error": "no replica available"},
                                    503, headers={"Retry-After": "1"})
                else:
                    st, body = await self._blocking(
                        _get_json, rep.host, rep.port, "/v1/models",
                        router.timeout_s)
                    await resp.json(body, st)
            else:
                await resp.json({"error": "not found"}, 404)
        except _SOCK_EXC:
            raise
        except Exception as e:  # noqa: BLE001 — route-level 500
            if resp.sent:
                raise
            await resp.json({"error": str(e)}, 500)

    async def handle_post(self, req: _Request, resp: _Resp, raw: bytes):
        router = self._router
        path, query = req.path, req.query
        # X-Priority carries the request's shed class; X-Request-Id is
        # the cross-tier trace id — both must survive the proxy hop
        fwd = {"X-Request-Id": resp.rid}
        prio = req.headers.get("X-Priority")
        if prio is not None:
            fwd["X-Priority"] = prio
        want_trace = bool(query and "trace=1" in query.split("&"))
        trace = router.tracer.begin(resp.rid, force=want_trace)
        fspan = (trace.span("frontend", path=path)
                 if trace is not None else None)
        streaming = False
        session = None
        # only generate routes can stream — don't pay a JSON parse of
        # (possibly huge) predict bodies to sniff a flag they can't
        # carry; the same sniff pulls session_id for affinity routing
        if path == "/generate" or path.rstrip("/").endswith("/generate"):
            try:
                body = json.loads(raw)
                streaming = bool(isinstance(body, dict)
                                 and body.get("stream"))
                if isinstance(body, dict):
                    sid = body.get("session_id")
                    if isinstance(sid, str) and sid:
                        session = sid
            except ValueError:
                pass    # replica answers 400; just forward
        if streaming:
            await self._proxy_stream(req, resp, path, raw, fwd, trace,
                                     fspan, session)
            return
        status, hdrs, data = await self._blocking(
            lambda: router.post_raw(path, raw, fwd, trace=trace,
                                    session=session))
        if status in (503, 504):
            resp.shed = "overload"
        extra = {}
        if "Retry-After" in hdrs:
            extra["Retry-After"] = hdrs["Retry-After"]
        if trace is not None:
            fspan.end(status=status)
            router.tracer.finish(trace, error=status >= 500)
            if want_trace and status == 200:
                try:
                    body = json.loads(data)
                    if isinstance(body, dict):
                        body["router_trace"] = trace.to_dict()
                        data = json.dumps(body).encode()
                except ValueError:
                    pass
        try:
            await resp.json(data, status, headers=extra)
        except _SOCK_EXC:
            resp.close = True

    # -- streaming proxy (natively async) ------------------------------
    async def _open_stream(self, path: str, body: bytes,
                           headers: Dict[str, str], trace=None,
                           session: Optional[str] = None):
        """Async mirror of ``FleetRouter.open_stream``: same pick /
        retry / backpressure bookkeeping, but the upstream is an async
        pooled connection. Returns ``("stream", replica, upstream)``
        or ``("response", status, headers, data)``."""
        from .fleet import _timeout_response
        router = self._router
        router.metrics.inc("requests")
        excluded: set = set()
        last = None
        attempts = 0
        prefer = router._affinity_get(session)
        max_attempts = (router.max_attempts
                        or max(1, len(router.fleet.eligible())))
        # membership/port change: drop pooled keep-alives to addresses
        # that no longer exist (the blocking pool prunes in _pick)
        addrs = {(r.host, r.port) for r in router.fleet.replicas()}
        if addrs != self._live_addrs:
            self._live_addrs = addrs
            self._apool.prune(addrs)
        while attempts < max_attempts:
            t_pick = time.perf_counter()
            rep = router._pick(excluded, prefer=prefer)
            if rep is None:
                break
            if trace is not None:
                trace.span("pick", t_start=t_pick,
                           t_end=time.perf_counter(), replica=rep.id,
                           attempt=attempts + 1, stream=True)
            attempts += 1
            if attempts > 1:
                router.metrics.inc("retries")
                if trace is not None:
                    trace.span("retry", attempt=attempts,
                               replica=rep.id).end()
            rep.begin()
            router.metrics.inc("routed")
            t_dispatch = time.monotonic()
            span = (trace.span("dispatch", replica=rep.id, stream=True)
                    if trace is not None else None)
            up = None
            failure = None
            # a pooled keep-alive may be stale (replica restarted on
            # the same port): retry exactly once on a fresh connection
            # — mirroring the blocking _roundtrip discipline
            for fresh in (False, True):
                up = None if fresh else self._apool.take(rep.host,
                                                         rep.port)
                made_fresh = up is None
                try:
                    if up is None:
                        up = await _AioUpstream.connect(
                            rep.host, rep.port, router.timeout_s)
                    status, rhdrs = await up.request(
                        path, body, headers, router.timeout_s)
                    failure = None
                    break
                except (asyncio.TimeoutError, TimeoutError) as e:
                    if up is not None:
                        up.close()
                    failure = e
                    break
                except _SOCK_EXC as e:
                    if up is not None:
                        up.close()
                    failure = e
                    if made_fresh:
                        break
            if failure is not None:
                rep.end()
                if span is not None:
                    span.end(error=f"{type(failure).__name__}: "
                             f"{failure}")
                if isinstance(failure, (asyncio.TimeoutError,
                                        TimeoutError)):
                    st, hdrs, data = _timeout_response(router.timeout_s)
                    router.metrics.inc("server_errors")
                    return ("response", st, hdrs, data)
                router.fleet.note_failure(rep)
                excluded.add(rep.id)
                last = None
                continue
            if span is not None:
                # for a stream the span covers dispatch -> first byte
                # of response headers, not the whole generation
                span.end(status=status)
            if status != 200:
                try:
                    data = await up.read_body(router.timeout_s)
                except (asyncio.TimeoutError, TimeoutError, *_SOCK_EXC):
                    data = b""
                up.close()
                rep.end()
                router._note(rep, status, rhdrs, t_dispatch)
                if status == 503:
                    excluded.add(rep.id)
                    last = (status, rhdrs, data)
                    continue
                if 400 <= status < 500:
                    router.metrics.inc("client_errors")
                else:
                    router.metrics.inc("server_errors")
                return ("response", status, rhdrs, data)
            router.fleet.note_ok(rep, t_dispatch)
            router.metrics.inc("streams")
            router._affinity_note(session, rep.id)
            return ("stream", rep, up)
        router.metrics.inc("requests_lost")
        if last is not None:
            st, hdrs, data = last
            hdrs.setdefault("Retry-After", "1")
            return ("response", st, hdrs, data)
        return ("response", 503, {"Retry-After": "1"},
                json.dumps({"error": "no replica available"}).encode())

    async def _proxy_stream(self, req: _Request, resp: _Resp,
                            path: str, raw: bytes,
                            fwd: Dict[str, str], trace, fspan,
                            session: Optional[str]):
        router = self._router
        opened = await self._open_stream(path, raw, fwd, trace=trace,
                                         session=session)
        if trace is not None:
            fspan.end(status=(opened[1] if opened[0] == "response"
                              else 200), stream=True)
            router.tracer.finish(
                trace, error=(opened[0] == "response"
                              and opened[1] >= 500))
        if opened[0] == "response":
            _, status, hdrs, data = opened
            extra = {}
            if "Retry-After" in hdrs:
                extra["Retry-After"] = hdrs["Retry-After"]
            try:
                await resp.json(data, status, headers=extra)
            except _SOCK_EXC:
                resp.close = True
            return
        _, rep, up = opened
        try:
            try:
                await resp.start_stream()
            except _SOCK_EXC:
                resp.close = True
                return
            # upstream READ and downstream WRITE failures are distinct
            # events: a dying replica leaves a LIVE client owed the
            # same in-band error chunk the replica-direct path
            # delivers; a vanished client just needs the upstream
            # closed (aborting the generation, freeing slot/blocks)
            err = None
            while True:
                try:
                    line = await asyncio.wait_for(up.readline(),
                                                  router.timeout_s)
                except (asyncio.TimeoutError, TimeoutError,
                        *_SOCK_EXC) as e:
                    err = {"error": "replica stream failed: "
                                    f"{type(e).__name__}: {e}",
                           "status": 500, "done": True}
                    break
                if not line:
                    break
                if not line.strip():
                    continue
                try:
                    await resp.chunk(line)
                except _SOCK_EXC:
                    # downstream client vanished mid-stream
                    resp.close = True
                    return
            try:
                if err is not None:
                    await resp.chunk((json.dumps(err) + "\n").encode())
                await resp.end_stream()
            except _SOCK_EXC:
                resp.close = True
        finally:
            # clean end on a keep-alive upstream -> back to the pool;
            # anything else closes (aborting the generation upstream)
            if up.clean and not self._stopped:
                self._apool.give(up)
            else:
                up.close()
            rep.end()

    def stop(self):
        super().stop()
        self._apool.close_all()
