"""Event-loop HTTP front-end of one server replica (counterpart of
the replica half of ``deeplearning4j_tpu/serving/aio.py``, lifted; the
router half comes with the fleet, ROADMAP.md queue A, item 9c).

The thread-per-connection front-end (``http.server.ThreadingHTTPServer``)
spends one OS thread per OPEN connection — not per in-flight request.
:class:`AioReplicaFrontend` serves every connection of an
:class:`~.InferenceServer` off one ``asyncio`` selector loop instead.
Routing, body discipline (400/413 + close), keep-alive, chunked ndjson
streaming, ``X-Request-Id`` / ``X-Priority`` propagation, ``?trace=1``,
the access log and the probe routes are byte-compatible with the
thread backend — the server-level methods (``_route``, ``_predict``,
``_generate_stream``, ``_healthz`` …) are shared, only the socket tier
differs.

Concurrency model: the event loop owns every socket. Work that blocks
on an engine (predict/generate admission, pulling the next token of a
non-engine stream) runs on a bounded daemon-thread pool — so the
THREAD cost of the process scales with in-flight *blocking work*,
never with open connections. A generation stream is consumed through
the engine's ``stream_notify`` hook and costs no thread while idle.
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
        self._w.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        await self._w.drain()

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
            if self._server is not None:
                self._server.close()
                await self._server.wait_closed()
            for w in list(self._conns):
                try:
                    w.close()
                except Exception:   # noqa: BLE001
                    pass

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

class AioReplicaFrontend(_AioFrontend):
    """Event-loop listener for one :class:`~.InferenceServer` replica.
    Route table and semantics mirror the thread backend's handler; the
    server-level request methods are shared verbatim."""

    def __init__(self, server, host: str, port: int,
                 header_timeout_s: float = 10.0, workers: int = 128):
        self._srv = server
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

    async def _stream_ndjson(self, resp: _Resp, it):
        """Chunked ndjson: one object per token as the scheduler emits
        it, a terminal ``{"done": true}`` object, then the zero chunk.

        Generation streams are consumed EVENT-DRIVEN: the engine's
        ``stream_notify`` hook sets an ``asyncio.Event`` from the
        scheduler thread, and this coroutine drains the token queue
        with ``get_nowait`` — an idle open stream costs two socket
        buffers and a parked coroutine, never a pool worker. (The
        executor-pump fallback below exists only for iterators without
        the ``_TokenStream`` queue shape.) That zero-thread idle cost
        is what lets one replica hold thousands of open streams."""
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
        else:
            loop = asyncio.get_running_loop()
            evt = asyncio.Event()
            req.stream_notify = lambda: loop.call_soon_threadsafe(evt.set)
            engine = it._engine

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
                    try:
                        kind, payload = req.stream_q.get_nowait()
                        break
                    except _queue.Empty:
                        budget = req.deadline - time.perf_counter() + 1.0
                        if budget <= 0:
                            it._done = True
                            req.abandoned = True
                            req.count_timeout_once(engine.metrics)
                            raise DeadlineExceededError(
                                "stream stalled past the deadline")
                        try:
                            await asyncio.wait_for(evt.wait(), budget)
                        except (asyncio.TimeoutError, TimeoutError):
                            pass  # loop re-checks queue, then budget
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
                    await resp.chunk((json.dumps(item) + "\n").encode())
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
