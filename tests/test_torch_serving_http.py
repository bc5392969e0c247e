"""The port's InferenceServer against the JAX package's (CPU), on both
HTTP backends, and ``tests/test_serving_runtime.py::TestInferenceServerHTTP``
mirrored at JAX's assertions.

The same scripted request sequence goes to a JAX server and to the
port's (the MLP of ``test_serving_runtime.py:21`` as the default model,
a 1-layer LM generator, and a held duck model for the 503/504 paths, the
JAX weights carried into the port), on the ``aio`` backend and on
``thread``. The two must agree on:
- every response's status code and whether it carries ``Retry-After``
  and ``X-Request-Id`` (400, 404, 413, 431, 503, 504; a POST without
  Content-Length, which neither server answers with 411, reads as an
  empty body: 400);
- the key sets of ``/stats``, ``/v1/models`` and ``/health``, compared
  recursively (the port's generator adds its two speculation
  reservoirs, ``spec_draft_ms`` and ``spec_verify_ms``, as
  ``tests/test_torch_metrics.py`` records);
- the Prometheus family names of ``/metrics`` (but those two);
- identical greedy tokens from ``/generate``, streamed and not, and
  ``/predict`` outputs within rtol 1e-4 and atol 1e-5.
The SameDiff case (``test_serving_runtime.py:502``) becomes an assert
that the port's server raises NotImplementedError citing item 15. No
sleep decides an assertion: the 503/504 paths hold a duck model's call
(``_torch_serving_util.Gate``).
"""
import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import profiler as jax_profiler
from deeplearning4j_tpu.serving import InferenceServer as JaxServer
from deeplearning4j_tpu_torch import profiler as port_profiler
from deeplearning4j_tpu_torch.serving import InferenceServer

from _obs_util import parse_prometheus
from _torch_serving_util import (Gate, code_of, get_json, key_tree,
                                 lm_pair, mlp_conf, net_pair, port_mlp,
                                 post, wait_for)

LM_CFG = dict(vocab_size=64, d_model=16, n_layers=1, n_heads=2,
              max_seq_len=32, seed=0)
PORT_ONLY = frozenset({"spec_draft_ms", "spec_verify_ms"})
#: the families (a summary's and its _mean/_max/_count gauges) of those
#: two reservoirs
PORT_ONLY_FAMILIES = frozenset({"dl4j_model_spec_draft_ms",
                                "dl4j_model_spec_verify_ms"})
X = [[0.5, -1.0, 2.0, 0.25]]


def _raw(port, method, path, headers=(), body=b""):
    """One request with hand-set headers; returns (status, headers)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.putrequest(method, path, skip_accept_encoding=True)
        for k, v in headers:
            conn.putheader(k, v)
        conn.endheaders(body or None)
        r = conn.getresponse()
        r.read()
        return r.status, r.headers
    finally:
        conn.close()


def _oversized_head(port):
    """A request head over 256 KiB: the status line the server sends."""
    sk = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        sk.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n")
        try:
            for _ in range(40):
                sk.sendall(b"X-Filler: " + b"a" * 8000 + b"\r\n")
            sk.sendall(b"\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass                             # the reject went out first
        buf = b""
        try:
            while b"\r\n" not in buf:
                d = sk.recv(4096)
                if not d:
                    break
                buf += d
        except (ConnectionResetError, socket.timeout):
            pass
        return buf.split(b"\r\n", 1)[0].decode()
    finally:
        sk.close()


def _stream_tokens(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/models/lm/generate",
                     body=json.dumps(dict(body, stream=True)))
        r = conn.getresponse()
        items = [json.loads(ln) for ln in r.read().decode().splitlines()
                 if ln.strip()]
        return r.status, r.getheader("Transfer-Encoding"), items
    finally:
        conn.close()


def _script(srv, gate):
    """Run the scripted sequence; returns (observations, tokens,
    outputs, documents)."""
    port = srv.port
    base = f"http://127.0.0.1:{port}"
    obs = []

    def see(label, path, data, headers=None):
        req = urllib.request.Request(base + path, data=data,
                                     headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                body = r.read()
                h, code = r.headers, r.status
        except urllib.error.HTTPError as e:
            body, h, code = e.read(), e.headers, e.code
        obs.append((label, code, "Retry-After" in h, "X-Request-Id" in h))
        return body

    def js(obj):
        return json.dumps(obj).encode()

    out = json.loads(see("predict", "/predict", js({"inputs": X})))
    see("not json", "/predict", b"not json")
    see("empty object", "/predict", b"{}")
    see("strings", "/predict", js({"inputs": [["a", "b"]]}))
    see("outputs not a list", "/predict",
        js({"inputs": X, "outputs": "x"}))
    see("named output", "/predict", js({"inputs": X, "outputs": ["o"]}))
    see("dict inputs", "/predict", js({"inputs": {"x": X}}))
    see("bad priority", "/predict", js({"inputs": X, "priority": "urgent"}))
    see("bad priority header", "/predict", js({"inputs": X}),
        {"X-Priority": "urgent"})
    see("version string", "/predict", js({"inputs": X, "version": "1"}))
    see("unknown version", "/predict", js({"inputs": X, "version": 9}))
    see("unknown model", "/v1/models/ghost/predict", js({"inputs": X}))
    see("unknown route", "/nope", b"{}")
    see("predict a generator", "/v1/models/lm/predict", js({"inputs": X}))
    see("generate a predictor", "/v1/models/default/generate",
        js({"prompt": [1]}))
    for label, payload in (("list body", ["list"]), ("empty prompt",
                           {"prompt": []}), ("no prompt", {"x": 1}),
                           ("max_tokens string",
                            {"prompt": [1], "max_tokens": "x"}),
                           ("session on slots",
                            {"prompt": [1], "session_id": "s"})):
        see(label, "/v1/models/lm/generate", js(payload))
    see("generate unknown model", "/v1/models/ghost/generate",
        js({"prompt": [1]}))
    see("body too large", "/predict", b"{" + b" " * 5000 + b"}")
    obs.append(("no content-length",) + (
        _raw(port, "POST", "/predict")[0],))
    obs.append(("bad content-length",) + (
        _raw(port, "POST", "/predict", [("Content-Length", "abc")])[0],))
    obs.append(("oversized head", _oversized_head(port)))
    obs.append(("unknown method", _raw(port, "DELETE", "/stats")[0]))
    for path in ("/nope", "/health", "/healthz", "/readyz", "/v1/models",
                 "/debug/traces?limit=1"):
        try:
            with urllib.request.urlopen(base + path, timeout=30) as r:
                obs.append((path, r.status))
        except urllib.error.HTTPError as e:
            obs.append((path, e.code))
    greedy = post(base, "/v1/models/lm/generate",
                  {"prompt": [1, 2, 3], "max_tokens": 6})
    status, te, items = _stream_tokens(port, {"prompt": [5, 9, 2, 7],
                                              "max_tokens": 6})
    obs.append(("stream", status, te, items[-1]["done"],
                sorted(items[-1])))
    tokens = (greedy["tokens"], [i["token"] for i in items if "token" in i],
              items[-1]["tokens"])
    # 504 and 503 on the held model: A inside the device call, D's
    # 50 ms budget runs out in the queue, then the queue (max 1, D in
    # it) is full for E
    a = threading.Thread(target=see, args=(
        "held", "/v1/models/gated/predict",
        js({"inputs": [[1.0, 2.0]], "timeout_ms": 30_000})))
    a.start()
    gate.wait_entered()
    see("deadline", "/v1/models/gated/predict",
        js({"inputs": [[1.0, 2.0]], "timeout_ms": 50}))
    see("queue full", "/v1/models/gated/predict",
        js({"inputs": [[1.0, 2.0]], "timeout_ms": 30_000}))
    gate.release.set()
    a.join()
    docs = dict(stats=get_json(base, "/stats"),
                models=get_json(base, "/v1/models"),
                health=get_json(base, "/health"))
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        docs["families"] = set(parse_prometheus(r.read().decode())[1])
    assert srv.drain(timeout_s=30.0)
    obs.append(("readyz draining",) + code_of(base, "/readyz", None))
    see("post draining", "/predict", js({"inputs": X}))
    return obs, tokens, out["outputs"], docs


@pytest.fixture(scope="module")
def pairs():
    return net_pair(mlp_conf), lm_pair(**LM_CFG)


def _build(Server, backend, mlp, lm, gate):
    srv = Server(mlp, port=0, http_backend=backend, max_body_bytes=4096,
                 max_batch_size=4, max_latency_ms=1.0)
    srv.register_generator("lm", lm, num_slots=2, prompt_buckets=[8]) \
        .warmup()
    srv.register("gated", gate, max_batch_size=1, max_queue=1,
                 max_latency_ms=1.0)
    return srv


@pytest.mark.parametrize("backend", ["aio", "thread"])
def test_same_script_same_answers_as_jax(pairs, backend):
    (jn, tn), (jlm, tlm) = pairs
    for prof in (jax_profiler.OpProfiler.get_instance(),
                 port_profiler.OpProfiler.get_instance()):
        prof.set_mode(type(prof.mode).DISABLED)
        prof.reset()
    runs = {}
    for side, Server, net, lm in (("jax", JaxServer, jn, jlm),
                                  ("port", InferenceServer, tn, tlm)):
        gate = Gate()
        srv = _build(Server, backend, net, lm, gate)
        try:
            runs[side] = _script(srv, gate)
        finally:
            gate.release.set()
            srv.stop()
    (jobs, jtok, jout, jdocs), (tobs, ttok, tout, tdocs) = \
        runs["jax"], runs["port"]
    assert tobs == jobs
    codes = {o[1] for o in tobs}
    assert {400, 404, 413, 503, 504} <= codes
    assert ttok == jtok and ttok[1] == ttok[2] and len(ttok[0]) == 6
    np.testing.assert_allclose(np.asarray(tout), np.asarray(jout),
                               rtol=1e-4, atol=1e-5)
    for doc in ("stats", "models", "health"):
        assert key_tree(tdocs[doc], drop=PORT_ONLY) == \
            key_tree(jdocs[doc]), doc
    port_only = {f for f in tdocs["families"]
                 if f.startswith(tuple(PORT_ONLY_FAMILIES))}
    assert port_only and tdocs["families"] - port_only == jdocs["families"]


class TestInferenceServerHTTP:
    """``tests/test_serving_runtime.py::TestInferenceServerHTTP``."""

    def test_32_concurrent_clients_end_to_end(self):
        net = port_mlp()
        server = InferenceServer(net, port=0, max_batch_size=16,
                                 max_latency_ms=10.0)
        served = server.served()
        served.warmup([1, 2, 4, 8, 16])
        base = f"http://127.0.0.1:{server.port}"
        errs = []

        def client(i):
            try:
                rs = np.random.RandomState(i)
                for _ in range(3):
                    x = rs.randn(1 + (i % 4), 4).astype(np.float32)
                    out = post(base, "/predict", {"inputs": x.tolist()})
                    np.testing.assert_allclose(np.asarray(out["outputs"]),
                                               net.output(x).numpy(),
                                               rtol=1e-4, atol=1e-6)
            except Exception as e:  # noqa: BLE001
                errs.append((i, e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        try:
            assert not errs, errs[:3]
            stats = get_json(base, "/stats")
            m = stats["models"]["default"]
            assert m["responses"] == 96
            assert m["mean_batch"] > 1.0          # batcher coalesced
            cc = m["compile_cache"]
            assert cc["compiles"] <= len(cc["warmed_buckets"])
            assert m["batch_hist"]
            assert m["latency_ms"]["count"] == 96
            assert m["latency_ms"]["p99"] >= m["latency_ms"]["p50"]
        finally:
            server.stop()

    def test_multi_model_routing(self, np_rng):
        server = InferenceServer(port=0)
        net_a, net_b = port_mlp(seed=1), port_mlp(seed=2, n_in=6, n_out=2)
        server.register("alpha", net_a)
        server.register("beta", net_b)
        base = f"http://127.0.0.1:{server.port}"
        try:
            xa = np_rng.randn(2, 4).astype(np.float32)
            xb = np_rng.randn(3, 6).astype(np.float32)
            oa = post(base, "/v1/models/alpha/predict",
                      {"inputs": xa.tolist()})
            ob = post(base, "/v1/models/beta/predict",
                      {"inputs": xb.tolist()})
            np.testing.assert_allclose(np.asarray(oa["outputs"]),
                                       net_a.output(xa).numpy(),
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(np.asarray(ob["outputs"]),
                                       net_b.output(xb).numpy(),
                                       rtol=1e-4, atol=1e-6)
            assert sorted(get_json(base, "/v1/models")) == ["alpha", "beta"]
        finally:
            server.stop()

    def test_error_code_mapping(self):
        class _Boom:
            def output(self, x):
                raise RuntimeError("boom")

        server = InferenceServer(port_mlp(), port=0)
        server.register("boom", _Boom())
        base = f"http://127.0.0.1:{server.port}"
        try:
            assert code_of(base, "/predict", b"not json")[0] == 400
            assert code_of(base, "/predict", b"{}")[0] == 400
            assert code_of(base, "/predict", json.dumps(
                {"inputs": [["a", "b"]]}).encode())[0] == 400
            assert code_of(base, "/predict", json.dumps(
                {"inputs": [[1.0]], "outputs": "x"}).encode())[0] == 400
            assert code_of(base, "/v1/models/ghost/predict", json.dumps(
                {"inputs": [[1.0]]}).encode())[0] == 404
            assert code_of(base, "/nope", b"{}")[0] == 404
            assert code_of(base, "/v1/models/boom/predict", json.dumps(
                {"inputs": [[1.0, 2.0]]}).encode())[0] == 500
            stats = get_json(base, "/stats")
            assert stats["models"]["default"]["client_errors"] >= 4
            assert stats["models"]["boom"]["server_errors"] >= 1
        finally:
            server.stop()

    def test_shed_and_timeout_codes(self):
        gate = Gate()
        server = InferenceServer(gate, port=0, max_batch_size=1,
                                 max_latency_ms=1.0, max_queue=1)
        base = f"http://127.0.0.1:{server.port}"
        codes = []

        def client(timeout_ms=None):
            body = {"inputs": [[1.0, 2.0]]}
            if timeout_ms is not None:
                body["timeout_ms"] = timeout_ms
            codes.append(code_of(base, "/predict",
                                 json.dumps(body).encode())[0])

        try:
            threads = [threading.Thread(target=client) for _ in range(6)]
            threads[0].start()
            # one inside the device call for at least 0.4 s (JAX's
            # device time here), which the deadline budget below reads
            gate.wait_entered()
            t_in = time.perf_counter()
            for t in threads[1:]:
                t.start()
            wait_for(lambda: codes.count(503) >= 4, "four sheds")
            wait_for(lambda: time.perf_counter() - t_in >= 0.4, "0.4 s")
            gate.release.set()
            for t in threads:
                t.join()
            gate.wait_entered()          # the queued one's call
            assert 503 in codes          # bounded queue shed load
            # deadline: the worker is held, a tight-deadline request
            # expires
            gate.release.clear()
            t = threading.Thread(target=client)
            t.start()
            gate.wait_entered()
            client(timeout_ms=50)
            gate.release.set()
            t.join()
            assert 504 in codes
            m = get_json(base, "/stats")["models"]["default"]
            assert m["shed"] >= codes.count(503)
            assert m["timeouts"] >= 1
        finally:
            gate.release.set()
            server.stop()

    def test_bad_content_length_is_400(self):
        server = InferenceServer(port_mlp(), port=0)
        try:
            status, _ = _raw(server.port, "POST", "/predict",
                             [("Content-Length", "abc")])
            assert status == 400
        finally:
            server.stop()

    def test_host_parameter(self, np_rng):
        server = InferenceServer(port_mlp(), port=0, host="0.0.0.0")
        try:
            assert server.host == "0.0.0.0"
            x = np_rng.randn(1, 4).astype(np.float32)
            out = post(f"http://127.0.0.1:{server.port}", "/predict",
                       {"inputs": x.tolist()})
            assert np.asarray(out["outputs"]).shape == (1, 3)
        finally:
            server.stop()

    def test_keep_alive_connection_reuse(self, np_rng):
        net = port_mlp()
        server = InferenceServer(net, port=0)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=10)
            x = np_rng.randn(2, 4).astype(np.float32)
            for _ in range(3):  # same socket, three requests
                conn.request("POST", "/predict",
                             body=json.dumps({"inputs": x.tolist()}))
                resp = conn.getresponse()
                out = json.loads(resp.read())
                assert resp.status == 200
                np.testing.assert_allclose(np.asarray(out["outputs"]),
                                           net.output(x).numpy(),
                                           rtol=1e-4, atol=1e-6)
            conn.request("POST", "/v1/models/ghost/predict",
                         body=json.dumps({"inputs": x.tolist()}))
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 404
            conn.request("POST", "/predict",
                         body=json.dumps({"inputs": x.tolist()}))
            resp = conn.getresponse()
            assert resp.status == 200
            resp.read()
            conn.close()
        finally:
            server.stop()

    def test_samediff_default_outputs_raise_not_ported(self):
        from deeplearning4j_tpu.autodiff import SameDiff
        sd = SameDiff.create()
        x = sd.placeholder("x", (None, 2))
        w = sd.var("w", value=np.eye(2, dtype=np.float32))
        (x @ w).rename("out")
        with pytest.raises(NotImplementedError, match="item 15"):
            InferenceServer(sd, port=0, default_outputs=["out"])
