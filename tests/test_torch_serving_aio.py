"""The port's asyncio front-end and the HTTP halves the serving shell
brings (CPU), each mirrored at its JAX test's assertions:

- ``tests/test_aio_frontend.py``: ``TestSocketEdgeCases``,
  ``TestIdleStreamCost`` and ``TestThreadBackendSelectable`` (replica
  and router);
- ``tests/test_fault_tolerance.py::test_healthz_flags_stalled_loop``;
- ``tests/test_observability.py``: ``TestReplicaTracingHTTP``,
  ``TestPrometheusExposition`` (``tests/_obs_util.py``'s parity walker
  over the port's ``/stats`` and ``/metrics``, a replica's and a
  router's), both sides of
  ``TestAccessLog::test_replica_and_router_log_lines_parse_with_propagated_rid``
  and ``TestFleetTraceStitching``;
- ``tests/test_kv_offload.py::TestOffloadObservability``;
- ``tests/test_generation.py::TestGenerationHTTP`` and
  ``tests/test_paged_generation.py``'s ``test_stats_over_http``.

Where the JAX test sleeps to let a state arrive (a wedged loop's
heartbeat going stale, streams going idle), the mirror waits for the
state itself.

``TestStreamWakeups`` holds the aio tier to one event-loop wakeup a
decode step for all of the step's streams (ROADMAP.md section C, fault
C5), with every stream's ndjson lines the direct engine's.
"""
import http.client
import io
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch.serving import (FaultInjector, FleetRouter,
                                              GenerationEngine,
                                              InferenceServer, ReplicaFleet)
from deeplearning4j_tpu_torch.zoo.transformer_lm import CausalTransformerLM

from _obs_util import assert_exposition_parity, parse_prometheus
from _torch_serving_util import get_json, port_mlp, wait_for


def _lm(vocab=64, d_model=16, n_layers=1, n_heads=2, max_seq_len=32,
        seed=0):
    return CausalTransformerLM(vocab_size=vocab, d_model=d_model,
                               n_layers=n_layers, n_heads=n_heads,
                               max_seq_len=max_seq_len, seed=seed,
                               device="cpu").init()


@pytest.fixture(scope="module")
def lm():
    return _lm()


class _Echo:
    """Duck-typed predict model: no cache, no capture."""

    def output(self, x):
        return np.asarray(x, np.float32) * 2.0


X = [[1.0, 2.0, 3.0, 4.0]]


def _predict_server(**kw):
    s = InferenceServer(port=0, max_batch_size=4, max_latency_ms=1.0, **kw)
    s.register("m", _Echo())
    return s


def _post(url, payload, headers=None, timeout=60):
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers=hdrs)
    resp = urllib.request.urlopen(req, timeout=timeout)
    return resp, json.loads(resp.read())


def _post_stream_head(host, port, body: bytes):
    """Open a streaming POST, read to the end of the response head, and
    return (socket, bytes past the head)."""
    sk = socket.create_connection((host, port), timeout=30)
    sk.sendall(b"POST /v1/models/lm/generate HTTP/1.1\r\n"
               b"Host: x\r\nContent-Type: application/json\r\n"
               + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    buf = b""
    sk.settimeout(30)
    while b"\r\n\r\n" not in buf:
        d = sk.recv(4096)
        assert d, f"closed before headers: {buf!r}"
        buf += d
    assert buf.startswith(b"HTTP/1.1 200"), buf[:80]
    return sk, buf.split(b"\r\n\r\n", 1)[1]


class TestSocketEdgeCases:
    """``tests/test_aio_frontend.py::TestSocketEdgeCases``."""

    def test_partial_header_dropped_after_timeout(self):
        srv = _predict_server(http_header_timeout_s=0.5)
        base = f"http://{srv.host}:{srv.port}"
        try:
            sk = socket.create_connection((srv.host, srv.port), timeout=10)
            sk.sendall(b"POST /v1/models/m/predict HTTP/1.1\r\n"
                       b"Host: x\r\n")          # head never finishes
            with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                assert r.status == 200
            sk.settimeout(5)
            t0 = time.monotonic()
            assert sk.recv(4096) == b""          # dropped, no response
            assert time.monotonic() - t0 < 4.0
            sk.close()
            with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                assert r.status == 200
        finally:
            srv.stop()

    def test_malformed_request_line_rejected_with_400(self):
        srv = _predict_server()
        try:
            sk = socket.create_connection((srv.host, srv.port), timeout=10)
            sk.sendall(b"GARBAGE\r\n\r\n")
            sk.settimeout(10)
            assert sk.recv(4096).startswith(b"HTTP/1.1 400")
            sk.close()
            sk = socket.create_connection((srv.host, srv.port), timeout=10)
            sk.sendall(b"BREW /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
            sk.settimeout(10)
            assert sk.recv(4096).startswith(b"HTTP/1.1 501")
            sk.close()
        finally:
            srv.stop()

    def test_oversized_head_rejected_with_431(self):
        srv = _predict_server()
        try:
            sk = socket.create_connection((srv.host, srv.port), timeout=10)
            sk.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n")
            filler = b"X-Filler: " + b"a" * 8000 + b"\r\n"
            try:
                for _ in range(40):              # > 256 KiB of head
                    sk.sendall(filler)
                sk.sendall(b"\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass                             # reject already sent
            sk.settimeout(10)
            buf = b""
            try:
                while len(buf) < 16:
                    d = sk.recv(4096)
                    if not d:
                        break
                    buf += d
            except (ConnectionResetError, socket.timeout):
                pass
            assert buf.startswith(b"HTTP/1.1 431"), buf[:80]
            sk.close()
        finally:
            srv.stop()

    def test_keepalive_reuse_under_many_idle_conns(self):
        srv = _predict_server()
        idle = []
        try:
            base_threads = threading.active_count()
            for _ in range(50):
                c = http.client.HTTPConnection(srv.host, srv.port,
                                               timeout=30)
                c.request("GET", "/healthz")
                assert c.getresponse().read()    # drain, keep open
                idle.append(c)
            assert threading.active_count() - base_threads <= 12
            busy = http.client.HTTPConnection(srv.host, srv.port,
                                              timeout=30)
            sock_id = None
            for _ in range(5):
                busy.request("POST", "/v1/models/m/predict",
                             body=json.dumps({"inputs": X}).encode())
                r = busy.getresponse()
                body = json.loads(r.read())
                assert r.status == 200
                assert body["outputs"] == [[2.0, 4.0, 6.0, 8.0]]
                if sock_id is None:
                    sock_id = id(busy.sock)
                assert id(busy.sock) == sock_id
            busy.close()
        finally:
            for c in idle:
                c.close()
            srv.stop()


class TestIdleStreamCost:
    def test_idle_streams_hold_no_pool_workers(self, lm):
        """24 streams on a 1-slot engine: 23 wait queued with their
        headers answered, and the thread count stays flat, because the
        aio tier consumes token queues through ``stream_notify``."""
        srv = InferenceServer(port=0)
        g = srv.register_generator("lm", lm, num_slots=1, max_queue=64,
                                   default_timeout_ms=120_000,
                                   prompt_buckets=[8])
        g.warmup()
        body = json.dumps({"prompt": [1, 2, 3], "max_tokens": 28,
                           "stream": True, "seed": 0,
                           "timeout_ms": 120_000}).encode()
        socks = []
        try:
            base_threads = threading.active_count()
            for _ in range(24):
                socks.append(_post_stream_head(srv.host, srv.port, body))
            assert threading.active_count() - base_threads <= 12, \
                "idle open streams must not hold threads"
            for sk, buf in socks:
                sk.settimeout(60)
                while not buf.endswith(b"0\r\n\r\n"):
                    d = sk.recv(65536)
                    assert d, f"truncated stream: {buf[-80:]!r}"
                    buf += d
                assert buf.count(b'"token"') == 28
        finally:
            for sk, _ in socks:
                sk.close()
            srv.stop()


class TestThreadBackendSelectable:
    def test_replica_thread_backend_roundtrip(self):
        srv = _predict_server(http_backend="thread")
        try:
            c = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
            c.request("POST", "/v1/models/m/predict",
                      body=json.dumps({"inputs": X}).encode())
            r = c.getresponse()
            assert r.status == 200
            assert json.loads(r.read())["outputs"] == [[2.0, 4.0, 6.0, 8.0]]
            c.close()
        finally:
            srv.stop()

    def test_router_thread_backend_roundtrip_and_stream(self, lm):
        srv = InferenceServer(port=0, http_backend="thread")
        g = srv.register_generator("lm", lm, num_slots=2, max_queue=16,
                                   prompt_buckets=[8])
        g.warmup()
        fleet = ReplicaFleet(poll_interval_s=None)
        fleet.add(srv)
        router = FleetRouter(fleet)
        host, port = router.serve(backend="thread")
        body = json.dumps({"prompt": [1, 2, 3], "max_tokens": 4,
                           "stream": True, "seed": 5,
                           "timeout_ms": 60_000}).encode()
        try:
            sk, buf = _post_stream_head(host, port, body)
            sk.settimeout(60)
            while not buf.endswith(b"0\r\n\r\n"):
                d = sk.recv(65536)
                assert d, f"truncated stream: {buf[-80:]!r}"
                buf += d
            assert buf.count(b'"token"') == 4
            sk.close()
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)

    def test_unknown_backend_rejected(self):
        with pytest.raises(ValueError):
            InferenceServer(port=0, http_backend="gevent")
        fleet = ReplicaFleet(poll_interval_s=None)
        router = FleetRouter(fleet)
        try:
            with pytest.raises(ValueError):
                router.serve(backend="gevent")
        finally:
            router.stop()
            fleet.stop()


def _read_chunked(sk, buf):
    """Read one chunked response to its end; returns its body's lines
    (the chunk framing removed)."""
    sk.settimeout(60)
    while not buf.endswith(b"0\r\n\r\n"):
        d = sk.recv(65536)
        assert d, f"truncated stream: {buf[-80:]!r}"
        buf += d
    body, rest = b"", buf
    while True:
        size, _, rest = rest.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            return body.decode().splitlines()
        body += rest[:n]
        rest = rest[n + 2:]


class TestStreamWakeups:
    """Fault C5: the aio tier wakes its event loop once for all the
    streams a decode step fed (the stream's ``stream_notify`` coalesces
    into one ``call_soon_threadsafe`` until the loop has run), not once
    a token, and every stream's lines stay the direct engine's."""

    def test_one_wakeup_a_step_for_all_streams(self, lm):
        reqs = [dict(prompt=[1 + i, 2, 3], max_tokens=24, seed=i,
                     temperature=0.8 if i % 2 else 0.0, top_k=8)
                for i in range(8)]
        eng = GenerationEngine(lm, num_slots=8, prompt_buckets=[8])
        try:
            want = [[json.dumps(item) for item in
                     eng.stream(timeout_ms=60_000, **q)] for q in reqs]
        finally:
            eng.stop()
        srv = InferenceServer(port=0)
        g = srv.register_generator("lm", lm, num_slots=8,
                                   prompt_buckets=[8])
        g.warmup()
        loop = srv._aio._loop
        wakeups = []
        call = loop.call_soon_threadsafe

        def counting(*a, **kw):
            if threading.current_thread() is g.engine._thread:
                wakeups.append(a[0])
            return call(*a, **kw)
        loop.call_soon_threadsafe = counting
        socks = []
        try:
            base_threads = threading.active_count()
            steps0 = g.engine.metrics.decode_steps
            for q in reqs:
                socks.append(_post_stream_head(
                    srv.host, srv.port,
                    json.dumps(dict(q, stream=True,
                                    timeout_ms=60_000)).encode()))
            assert threading.active_count() - base_threads <= 12
            got = [_read_chunked(sk, buf) for sk, buf in socks]
            steps = g.engine.metrics.decode_steps - steps0
        finally:
            for sk, _ in socks:
                sk.close()
            srv.stop()
        assert got == want
        assert steps >= 23
        # 8 tokens a step would wake the loop 8 times a step
        assert len(wakeups) <= 2 * steps, (len(wakeups), steps)


def test_healthz_flags_stalled_loop(lm):
    srv = InferenceServer(port=0)
    eng = srv.register_generator("gen", lm, num_slots=2,
                                 min_prompt_bucket=4).engine
    base = f"http://{srv.host}:{srv.port}"
    jam = threading.Event()

    class _Jam:
        """Injector stand-in that wedges the scheduler loop once."""

        def fire(self, seam, worker=None):
            if seam == "latency" and not jam.is_set():
                jam.wait(10.0)
            return False
    try:
        eng._stall_timeout_s = 0.5
        eng._faults = _Jam()
        wait_for(lambda: not eng.alive(), "the heartbeat to go stale")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/healthz", timeout=10)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["status"] == "stalled"
        jam.set()  # unwedge: liveness recovers
        wait_for(eng.alive, "the heartbeat to resume")
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.status == 200
    finally:
        jam.set()
        eng._faults = None
        eng._stall_timeout_s = 30.0
        srv.stop()


MX = np.arange(4, dtype=np.float32).reshape(1, 4).tolist()


class TestReplicaTracingHTTP:
    """``tests/test_observability.py::TestReplicaTracingHTTP``."""

    @pytest.fixture(scope="class")
    def server(self):
        srv = InferenceServer(port=0, tracing=True)
        srv.register("default", port_mlp())
        yield srv
        srv.stop()

    def test_request_id_minted_and_echoed(self, server):
        base = f"http://{server.host}:{server.port}"
        resp, _ = _post(base + "/predict", {"inputs": MX})
        minted = resp.headers.get("X-Request-Id")
        assert minted and re.fullmatch(r"[0-9a-f]{16}", minted)
        resp2, _ = _post(base + "/predict", {"inputs": MX},
                         headers={"X-Request-Id": "caller-chose-this"})
        assert resp2.headers.get("X-Request-Id") == "caller-chose-this"

    def test_trace_query_param_embeds_timeline(self, server):
        base = f"http://{server.host}:{server.port}"
        _, body = _post(base + "/predict?trace=1", {"inputs": MX})
        tl = body["trace"]
        kinds = [s["kind"] for s in tl["spans"]]
        assert kinds[0] == "http"
        assert {"admission", "queue", "device"} <= set(kinds)
        adm = next(s for s in tl["spans"] if s["kind"] == "admission")
        assert adm["attrs"]["verdict"] == "admitted"
        assert "device_ewma_ms" in adm["attrs"]
        assert "est_wait_ms" in adm["attrs"]
        assert tl["duration_ms"] > 0

    def test_trace_body_flag_equivalent(self, server):
        base = f"http://{server.host}:{server.port}"
        _, body = _post(base + "/predict", {"inputs": MX, "trace": 1})
        assert {"admission", "queue", "device"} <= {
            s["kind"] for s in body["trace"]["spans"]}

    def test_debug_traces_filter_by_request_id(self, server):
        base = f"http://{server.host}:{server.port}"
        _post(base + "/predict", {"inputs": MX},
              headers={"X-Request-Id": "findme-0001"})
        doc = get_json(base, "/debug/traces?request_id=findme-0001")
        assert [t["trace_id"] for t in doc["traces"]] == ["findme-0001"]
        assert doc["tracer"]["enabled"] is True
        assert doc["tracer"]["finished"] >= 1
        everything = get_json(base, "/debug/traces?limit=2")
        assert len(everything["traces"]) <= 2


def _metrics(base):
    resp = urllib.request.urlopen(base + "/metrics", timeout=30)
    ctype = resp.headers.get("Content-Type", "")
    return ctype, parse_prometheus(resp.read().decode())


def settled(served, timeout_s: float = 30.0):
    """Wait until the generator's engine has collected its trailing
    decode step. The pipelined loop keeps one step in flight: a request
    returns when step n is collected, and step n+1 records its counters
    (``decode_step_ms`` and the rest) afterwards, so ``/stats`` and
    ``/metrics`` read one after the other could straddle that record.
    Settled means no step pending and ``decode_steps`` and
    ``decode_step_ms``'s count unchanged over three polls."""
    eng = served.engine
    deadline = time.monotonic() + timeout_s
    last, still = None, 0
    while time.monotonic() < deadline:
        snap = eng.metrics.snapshot()
        cur = (snap["decode_steps"], snap["decode_step_ms"]["count"],
               len(eng._pending))
        still = still + 1 if cur == last and not cur[2] else 0
        if still >= 3:
            return
        last = cur
        time.sleep(0.01)
    raise AssertionError(f"the engine did not settle: {last}")


class TestPrometheusExposition:
    """``tests/test_observability.py::TestPrometheusExposition``."""

    def test_fleet_metrics_parse_and_agree_with_stats(self):
        fleet = ReplicaFleet(poll_interval_s=None)
        srv = InferenceServer(port=0)
        srv.register("default", port_mlp())
        fleet.add(srv)
        fleet.poll_now()
        router = FleetRouter(fleet)
        try:
            host, port = router.serve()
            base = f"http://{host}:{port}"
            for _ in range(2):
                _post(base + "/predict", {"inputs": MX})
            stats = get_json(base, "/stats")
            _, (samples, types) = _metrics(base)
            assert_exposition_parity(stats, samples, types)
            assert samples[("dl4j_fleet_requests_total", "")] == \
                stats["fleet"]["requests"]
            # per-replica families carry {replica=...}
            assert any(n == "dl4j_replica_in_flight" and "replica=" in lab
                       for n, lab in samples)
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)

    def test_replica_metrics_parse_and_agree_with_stats(self):
        srv = InferenceServer(port=0)
        srv.register("default", port_mlp())
        try:
            base = f"http://{srv.host}:{srv.port}"
            for _ in range(3):
                _post(base + "/predict", {"inputs": MX})
            stats = get_json(base, "/stats")
            ctype, (samples, types) = _metrics(base)
            assert ctype.startswith("text/plain; version=0.0.4")
            assert types, "no # TYPE lines"
            checked = assert_exposition_parity(stats, samples, types)
            assert checked > 20
            key = ("dl4j_model_requests_total", '{model="default"}')
            assert samples[key] == stats["models"]["default"]["requests"]
            assert types["dl4j_model_latency_ms"] == "summary"
            assert any(n == "dl4j_model_batch_hist" and "bucket=" in lab
                       for n, lab in samples)
        finally:
            srv.stop()

    def test_prefix_cache_counters_parse_and_agree_with_stats(self, lm):
        srv = InferenceServer(port=0)
        g = srv.register_generator(
            "lm", lm, num_slots=2, max_seq_len=32, prompt_buckets=[8],
            cache="paged", block_size=8, prefill_chunk_tokens=8)
        g.warmup()
        try:
            prompt = [1, 5, 2, 9, 3, 7, 4, 6, 8, 10, 1, 5, 2, 9, 3, 7]
            g.generate(prompt, max_tokens=3, timeout_ms=60_000)
            g.generate(prompt, max_tokens=3, timeout_ms=60_000,
                       session_id="s1")
            settled(g)
            base = f"http://{srv.host}:{srv.port}"
            stats = get_json(base, "/stats")
            pc = stats["models"]["lm"]["paged"]["prefix_cache"]
            assert pc["prefix_hits"] >= 1 and pc["sessions_live"] == 1
            _, (samples, types) = _metrics(base)
            assert_exposition_parity(stats, samples, types)
            lab = '{model="lm"}'
            stem = "dl4j_model_paged_prefix_cache_"
            assert samples[(f"{stem}prefix_hits_total", lab)] == \
                pc["prefix_hits"]
            assert types[f"{stem}sessions_live"] == "gauge"
        finally:
            srv.stop()

    def test_spec_counters_parse_and_agree_with_stats(self, lm):
        srv = InferenceServer(port=0)
        g = srv.register_generator(
            "lm", lm, num_slots=2, max_seq_len=32, prompt_buckets=[8],
            speculation_k=2)
        g.warmup()
        try:
            for i in range(3):
                g.generate([1 + i, 5, 2, 9], max_tokens=8, temperature=0.0,
                           seed=i, timeout_ms=60_000)
            settled(g)
            base = f"http://{srv.host}:{srv.port}"
            stats = get_json(base, "/stats")
            sp = stats["models"]["lm"]["spec"]
            assert sp["enabled"] is True
            assert sp["verify_batches"] >= 1
            assert sp["draft_tokens_proposed"] == 2 * sp["verify_batches"]
            _, (samples, types) = _metrics(base)
            assert_exposition_parity(stats, samples, types)
            lab = '{model="lm"}'
            assert samples[("dl4j_model_spec_verify_batches_total",
                            lab)] == sp["verify_batches"]
            assert types["dl4j_model_spec_accept_rate"] == "gauge"
        finally:
            srv.stop()

    def test_offload_counters_parse_and_agree_with_stats(self):
        """``tests/test_kv_offload.py::TestOffloadObservability``."""
        vocab = 64
        lm = _lm(d_model=32, n_layers=2)
        srv = InferenceServer(port=0)
        g = srv.register_generator(
            "lm", lm, num_slots=2, min_prompt_bucket=4, cache="paged",
            block_size=8, prefill_chunk_tokens=8, num_blocks=9,
            offload_host_bytes=1 << 20)
        g.warmup()

        def prompt(i):
            return [(3 * i + j) % (vocab - 8) + 1 for j in range(16)]
        try:
            outs = {}
            for i in range(4):
                outs[i] = g.generate(prompt(i), max_tokens=5,
                                     session_id=f"s{i}",
                                     timeout_ms=120_000)["tokens"]
            for i in range(4):
                g.generate(prompt(i) + outs[i] + [7, 11], max_tokens=4,
                           session_id=f"s{i}", timeout_ms=120_000)
            settled(g)
            base = f"http://{srv.host}:{srv.port}"
            stats = get_json(base, "/stats")
            off = stats["models"]["lm"]["paged"]["offload"]
            assert off["enabled"] is True
            assert off["demotions"] > 0 and off["restores"] > 0
            _, (samples, types) = _metrics(base)
            assert_exposition_parity(stats, samples, types)
            lab = '{model="lm"}'
            stem = "dl4j_model_paged_offload_"
            assert samples[(f"{stem}demotions_total", lab)] == \
                off["demotions"]
            assert samples[(f"{stem}restores_total", lab)] == \
                off["restores"]
            assert types[f"{stem}host_bytes"] == "gauge"
            assert types[f"{stem}restore_ms"] == "summary"
        finally:
            srv.stop()


class TestAccessLog:
    """``tests/test_observability.py::TestAccessLog``'s fleet case."""

    def test_replica_and_router_log_lines_parse_with_propagated_rid(self):
        rep_log, rtr_log = io.StringIO(), io.StringIO()
        srv = InferenceServer(port=0, log_requests=rep_log)
        srv.register("default", port_mlp())
        fleet = ReplicaFleet(poll_interval_s=None)
        fleet.add(srv)
        fleet.poll_now()
        router = FleetRouter(fleet)
        try:
            host, port = router.serve(log_requests=rtr_log)
            rid = "acclog-rid-42"
            resp, _ = _post(f"http://{host}:{port}/predict",
                            {"inputs": MX},
                            headers={"X-Request-Id": rid,
                                     "X-Priority": "batch"})
            assert resp.status == 200

            def entries(buf):
                return [json.loads(line) for line in
                        buf.getvalue().splitlines() if line]

            for log, path in ((rtr_log, "/predict"),
                              (rep_log, "/predict")):
                es = [e for e in entries(log)
                      if e.get("request_id") == rid]
                assert es, f"no access-log line with rid in {log}"
                e = es[0]
                assert e["method"] == "POST" and e["path"] == path
                assert e["status"] == 200
                assert e["latency_ms"] >= 0
                assert e["priority"] == "batch"
                assert "ts" in e and "shed_reason" not in e
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)


class TestFleetTraceStitching:
    """``tests/test_observability.py::TestFleetTraceStitching``: one
    stitched trace for a hedged and retried generate through a
    3-replica fleet, over HTTP."""

    def test_hedged_and_retried_generate_yields_one_stitched_trace(
            self, lm):
        def mk():
            server = InferenceServer(port=0, tracing=True)
            g = server.register_generator(
                "lm", lm, num_slots=2, max_seq_len=32,
                prompt_buckets=[8], cache="paged", block_size=4,
                num_blocks=16)
            g.warmup()
            return server, g

        (sa, ga), (sb, gb), (sc, gc) = mk(), mk(), mk()
        # slow generation on B and C so the hedge timer always fires
        for g in (gb, gc):
            g.engine.set_fault_injector(FaultInjector(
                rates={"latency": 1.0}, latency_ms=5.0))
        fleet = ReplicaFleet(poll_interval_s=None)
        for s in (sa, sb, sc):
            fleet.add(s)
        fleet.poll_now()
        sa.drain(timeout_s=10)       # A sheds 503 fast -> retry path
        by_port = {r.port: r for r in fleet.replicas()}
        # bias occupancy so the router picks A, then B, hedges to C
        by_port[sb.port].begin()
        by_port[sc.port].begin()
        by_port[sc.port].begin()
        router = FleetRouter(fleet, hedge_after_ms=30.0,
                             hedge_generate=True, tracing=True)
        try:
            host, port = router.serve()
            rid = "e2e-trace-1"
            resp, body = _post(
                f"http://{host}:{port}/v1/models/lm/generate",
                {"prompt": [1, 2, 3], "max_tokens": 16, "seed": 7},
                headers={"X-Request-Id": rid})
            assert resp.status == 200
            assert resp.headers.get("X-Request-Id") == rid
            assert len(body["tokens"]) == 16
            snap = fleet.snapshot()
            assert snap["retries"] >= 1, "A's 503 must have retried"
            assert snap["hedges"] >= 1, "the hedge timer must have fired"

            def dump(base):
                return get_json(
                    base, f"/debug/traces?request_id={rid}")["traces"]

            # the router's fragment: the hedge pair shares the trace,
            # the losing arm is marked discarded
            rt = dump(f"http://{host}:{port}")
            assert len(rt) == 1 and rt[0]["trace_id"] == rid
            rkinds = [s["kind"] for s in rt[0]["spans"]]
            assert rkinds[0] == "frontend"
            assert {"pick", "dispatch", "retry", "hedge"} <= set(rkinds)
            hedge = next(s for s in rt[0]["spans"]
                         if s["kind"] == "hedge")
            dispatches = [s for s in rt[0]["spans"]
                          if s["kind"] in ("dispatch", "hedge")]
            assert sum(1 for s in dispatches
                       if s["attrs"].get("discarded")) == 1
            arms = {s["attrs"].get("replica") for s in dispatches}
            assert len(arms) >= 2, "hedge arms hit distinct replicas"
            assert hedge["attrs"]["replica"] in arms

            # the winning replica's fragment carries the queue,
            # admission, prefill and decode picture under the SAME id
            winner = next(s["attrs"]["replica"] for s in dispatches
                          if s["attrs"].get("status") == 200
                          and not s["attrs"].get("discarded"))
            win_rep = next(r for r in fleet.replicas()
                           if r.id == winner)
            wt = dump(f"http://{win_rep.host}:{win_rep.port}")
            assert len(wt) == 1 and wt[0]["trace_id"] == rid
            wkinds = {s["kind"] for s in wt[0]["spans"]}
            assert {"http", "admission", "queue", "prefill",
                    "decode"} <= wkinds
            assert {t["trace_id"] for t in rt + wt} == {rid}
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)
            for s in (sa, sb, sc):
                s.stop()

    def test_cooldown_wait_span_recorded_when_fleet_cooling(self):
        fleet = ReplicaFleet(poll_interval_s=None)
        srv = InferenceServer(port=0)
        srv.register("default", port_mlp())
        fleet.add(srv)
        fleet.poll_now()
        rep = fleet.replicas()[0]
        rep.cooldown_until = time.monotonic() + 0.15
        router = FleetRouter(fleet, cooldown_wait_s=1.0, tracing=True)
        try:
            status, _hdrs, _body = router.post_raw(
                "/predict", json.dumps({"inputs": MX}).encode(),
                {"X-Request-Id": "cool-1"})
            assert status == 200
            t = router.tracer.dump(request_id="cool-1")[0]
            kinds = [s["kind"] for s in t["spans"]]
            assert "cooldown_wait" in kinds
            cw = next(s for s in t["spans"]
                      if s["kind"] == "cooldown_wait")
            assert cw["duration_ms"] > 0
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)


class TestGenerationHTTP:
    """``tests/test_generation.py::TestGenerationHTTP``."""

    @pytest.fixture(scope="class")
    def server(self):
        srv = InferenceServer(port=0)
        g = srv.register_generator("lm", _lm(d_model=32, n_layers=2,
                                             n_heads=4), num_slots=4)
        g.warmup()
        yield srv
        srv.stop()

    def _post(self, srv, path, payload, timeout=60):
        return _post(f"http://127.0.0.1:{srv.port}{path}", payload,
                     timeout=timeout)[1]

    def test_generate_roundtrip(self, server):
        r = self._post(server, "/v1/models/lm/generate",
                       {"prompt": [1, 2, 3], "max_tokens": 5})
        assert len(r["tokens"]) == 5
        assert r["finish_reason"] in ("length", "eos")

    def test_streaming_chunked(self, server):
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        body = json.dumps({"prompt": [1, 2, 3], "max_tokens": 5,
                           "stream": True}).encode()
        conn.request("POST", "/v1/models/lm/generate", body=body)
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Transfer-Encoding") == "chunked"
        items = [json.loads(line) for line in
                 resp.read().decode().strip().splitlines()]
        conn.close()
        tokens = [c["token"] for c in items if "token" in c]
        assert len(tokens) == 5
        assert items[-1]["done"] is True
        assert items[-1]["tokens"] == tokens

    def test_keepalive_socket_survives_stream(self, server):
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        conn.request("POST", "/v1/models/lm/generate",
                     body=json.dumps({"prompt": [2], "max_tokens": 3,
                                      "stream": True}).encode())
        conn.getresponse().read()
        conn.request("POST", "/v1/models/lm/generate",
                     body=json.dumps({"prompt": [2],
                                      "max_tokens": 3}).encode())
        r2 = json.loads(conn.getresponse().read())
        conn.close()
        assert len(r2["tokens"]) == 3

    def test_error_codes(self, server):
        for payload, want in ((["list"], 400),
                              ({"prompt": []}, 400),
                              ({"no_prompt": 1}, 400),
                              ({"prompt": [1], "max_tokens": "x"}, 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                self._post(server, "/v1/models/lm/generate", payload)
            assert e.value.code == want
        with pytest.raises(urllib.error.HTTPError) as e:
            self._post(server, "/v1/models/ghost/generate", {"prompt": [1]})
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            self._post(server, "/v1/models/lm/predict", {"inputs": [[1.0]]})
        assert e.value.code == 400   # a generator can't predict

    def test_stats_exposes_generation_metrics(self, server):
        self._post(server, "/v1/models/lm/generate",
                   {"prompt": [4, 5], "max_tokens": 4})
        stats = get_json(f"http://127.0.0.1:{server.port}", "/stats")
        m = stats["models"]["lm"]
        assert m["serving_mode"] == "generation"
        assert m["tokens_generated"] > 0
        assert m["ttft_ms"]["count"] > 0
        assert m["slots"]["occupancy_hist"]
        assert "tokens_per_sec" in m

    def test_shed_and_timeout_counted_in_stats(self):
        srv = InferenceServer(port=0)
        g = srv.register_generator("g", _lm(d_model=32, n_layers=2,
                                            n_heads=4),
                                   num_slots=1, max_queue=1)
        g.warmup([8])
        base = f"http://127.0.0.1:{srv.port}"
        codes = []

        def client(i, timeout_ms):
            try:
                _post(base + "/v1/models/g/generate",
                      {"prompt": [1 + i], "max_tokens": 24,
                       "timeout_ms": timeout_ms})
                codes.append(200)
            except urllib.error.HTTPError as e:
                codes.append(e.code)

        threads = [threading.Thread(target=client, args=(i, 60_000))
                   for i in range(6)]
        threads.append(threading.Thread(target=client, args=(9, 0)))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = get_json(base, "/stats")["models"]["g"]
        assert 503 in codes or 504 in codes
        assert stats["shed"] + stats["timeouts"] >= 1
        if 503 in codes:
            assert stats["shed"] >= 1
        if 504 in codes:
            assert stats["timeouts"] >= 1
        srv.stop()


def test_paged_stats_over_http():
    """``tests/test_paged_generation.py``'s ``test_stats_over_http``."""
    srv = InferenceServer(port=0)
    g = srv.register_generator("plm", _lm(d_model=32, n_layers=2,
                                          n_heads=4), num_slots=2,
                               cache="paged", block_size=8,
                               prefill_chunk_tokens=8, min_prompt_bucket=4)
    g.warmup()
    try:
        r = _post(f"http://127.0.0.1:{srv.port}/v1/models/plm/generate",
                  {"prompt": list(range(1, 12)), "max_tokens": 4})[1]
        assert len(r["tokens"]) == 4
        stats = get_json(f"http://127.0.0.1:{srv.port}", "/stats")
        m = stats["models"]["plm"]
        assert m["cache_backend"] == "paged"
        assert m["paged"]["blocks_total"] > 0
        assert m["paged"]["prefill_chunks"] >= 2
    finally:
        srv.stop()
