"""The port's fleet tier (CPU): every class of ``tests/test_fleet.py``
mirrored at its JAX assertions on the port's ``ReplicaFleet``,
``FleetRouter`` and ``InferenceServer`` replicas (the JAX file's MLP and
its d16 x L1 LM, built by the port on the CPU), and one scripted
sequence through a JAX fleet and the port's (``TestFleetParity``).

Where the JAX test sleeps for a state (a breaker window ending, a
cooldown lapsing, traffic rolling before a restart, a freed slot), the
mirror waits for the state itself. The slow replica of
``test_occupancy_steers_away_from_loaded_replica`` is a duck model held
on an Event (``_torch_serving_util.Gate``), not a sleep.

``test_zero_loss_bit_identical_predict`` fails in the reference: its
rows are computed at bucket 1 and served in buckets of 1, 2 or 4 rows,
and XLA's CPU executable for another bucket gives other last bits (up to
2 ulp, 6e-8, in the same row for the same input and bucket; PERF.md
section 6). The mirror holds each served row within
``PREDICT_ROW_TOL`` of the restart-free answer, and
``test_served_rows_keep_their_bits_in_every_bucket`` holds the port's
rows bit-identical across buckets and positions on the CPU, so the
tolerance hides nothing the port does.
"""
import gc
import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest

from deeplearning4j_tpu_torch.serving import (FaultInjector, FleetRouter,
                                              GenerationEngine,
                                              InferenceEngine,
                                              InferenceServer, ReplicaFleet)
from deeplearning4j_tpu_torch.zoo.transformer_lm import CausalTransformerLM

from _torch_serving_util import (Gate, get_json, key_tree, lm_pair,
                                 mlp_conf, net_pair, port_mlp, wait_for)

#: a served predict row against the restart-free answer: the row may be
#: computed in a bucket of 1, 2 or 4 rows, and another GEMM shape may sum
#: in another order (XLA's CPU executables differ by up to 2 ulp there;
#: the port's CPU GEMMs give the same bits, which the bucket test holds)
PREDICT_ROW_TOL = 1e-6

X = np.arange(4, dtype=np.float32).reshape(1, 4).tolist()


@pytest.fixture(scope="module")
def mlp():
    return port_mlp()


@pytest.fixture(scope="module")
def tiny_lm():
    return CausalTransformerLM(vocab_size=64, d_model=16, n_layers=1,
                               n_heads=2, max_seq_len=32, seed=0,
                               device="cpu").init()


def _predict_factory(model, fault_injector=None, backend="aio"):
    """A warmed single-model replica (the shape a rolling restart's
    factory must have: ready before it returns)."""
    def factory():
        server = InferenceServer(port=0, max_batch_size=4,
                                 max_latency_ms=2.0, http_backend=backend)
        server.register("default", model, fault_injector=fault_injector)
        server.served().warmup([1, 2, 4])
        return server
    return factory


def _gen_factory(lm, **opts):
    def factory():
        server = InferenceServer(port=0)
        merged = dict(num_slots=2, max_seq_len=32, prompt_buckets=[8],
                      cache="paged", block_size=4, num_blocks=16)
        merged.update(opts)
        g = server.register_generator("lm", lm, **merged)
        g.warmup()
        return server
    return factory


def _mkfleet(factories, poll_interval_s=None, **fleet_kw):
    fleet = ReplicaFleet(poll_interval_s=poll_interval_s, **fleet_kw)
    for f in factories:
        fleet.add(f(), factory=f)
    return fleet


def _polled(fleet, cond):
    """A condition on polled state: one poll, then the check."""
    def check():
        fleet.poll_now()
        return cond()
    return check


class TestStatsSummary:
    def test_summary_shape_predict_and_generation(self, mlp, tiny_lm):
        server = InferenceServer(port=0)
        server.register("m", mlp)
        server.register_generator("lm", tiny_lm, num_slots=2,
                                  max_seq_len=32, prompt_buckets=[8])
        try:
            stats = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/stats",
                timeout=30).read())
            s = stats["summary"]
            assert s["ready"] is True and s["draining"] is False
            assert s["load"] == 0
            m = s["models"]["m"]
            assert m["mode"] == "predict"
            assert m["capacity"] == 64 and m["occupancy"] == 0.0
            assert m["queue_depth"] == 0 and m["draining"] is False
            g = s["models"]["lm"]
            assert g["mode"] == "generation"
            assert g["capacity"] == 2 and g["active"] == 0
            assert g["draining"] is False and g["load"] == 0
        finally:
            server.stop()

    def test_summary_reflects_live_occupancy_and_drain(self, tiny_lm):
        server = InferenceServer(port=0)
        g = server.register_generator("lm", tiny_lm, num_slots=2,
                                      max_seq_len=32, prompt_buckets=[8])
        g.warmup()
        try:
            stream = g.stream([1, 2, 3], max_tokens=64, seed=0,
                              timeout_ms=60_000)
            next(stream)   # a generation is now live in a slot
            s = server.summary()
            lm = s["models"]["lm"]
            assert lm["active"] == 1 and lm["occupancy"] == 0.5
            assert s["load"] >= 1
            stream.close()
            server.drain(timeout_s=30.0)
            s = server.summary()
            assert s["ready"] is False and s["draining"] is True
            assert s["models"]["lm"]["draining"] is True
        finally:
            server.stop()

    def test_summary_carries_every_field_the_poll_reads(self, mlp):
        """``ReplicaFleet._poll_replica`` reads ``ready``, ``load`` and
        ``shed`` of the summary (JAX ``fleet.py:413-445``)."""
        server = InferenceServer(port=0)
        server.register("m", mlp)
        fleet = ReplicaFleet(poll_interval_s=None)
        try:
            rep = fleet.add(server)
            fleet.poll_now()
            assert {"ready", "load", "shed"} <= set(rep.summary)
            assert rep.ready is True and rep.score() == 0
        finally:
            fleet.stop(stop_replicas=True)


class TestRouting:
    def test_occupancy_steers_away_from_loaded_replica(self, mlp):
        """The router picks by live queue/occupancy pulled from /stats,
        not round-robin: a replica with a backed-up queue stops
        attracting new work even though it is healthy."""
        gate = Gate()
        slow = InferenceServer(port=0, max_batch_size=2,
                               max_latency_ms=1.0)
        slow.register("default", gate)
        fast = _predict_factory(mlp)()
        fleet = ReplicaFleet(poll_interval_s=None)
        r_slow = fleet.add(slow)
        r_fast = fleet.add(fast)
        router = FleetRouter(fleet)
        try:
            # back the slow replica up with direct traffic (not via the
            # router: another router's or a direct client's)
            def direct():
                try:
                    urllib.request.urlopen(urllib.request.Request(
                        f"http://127.0.0.1:{slow.port}/predict",
                        data=json.dumps({"inputs": X}).encode()),
                        timeout=60).read()
                except Exception:   # noqa: BLE001 — load only
                    pass
            ts = [threading.Thread(target=direct) for _ in range(4)]
            for t in ts:
                t.start()
            gate.wait_entered()
            wait_for(_polled(fleet,
                             lambda: r_slow.summary.get("load", 0) >= 1),
                     "the slow replica's load in its summary")
            assert r_slow.summary["load"] >= 1
            assert r_fast.summary["load"] == 0
            # every routed request now lands on the idle replica
            for _ in range(4):
                assert router._pick(set()) is r_fast
            before = r_slow.routed
            for _ in range(4):
                st, body = router.post("/predict", {"inputs": X})
                assert st == 200
            assert r_slow.routed == before
            gate.release.set()
            for t in ts:
                t.join()
        finally:
            gate.release.set()
            router.stop()
            fleet.stop(stop_replicas=True)

    def test_equal_replicas_share_load(self, mlp):
        f = _predict_factory(mlp)
        fleet = _mkfleet([f, f])
        router = FleetRouter(fleet)
        try:
            for _ in range(6):
                st, _ = router.post("/predict", {"inputs": X})
                assert st == 200
            r0, r1 = fleet.replicas()
            # tie-break rotation: equal-score replicas both serve
            assert r0.routed == 3 and r1.routed == 3
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)

    def test_draining_replica_is_retried_elsewhere(self, mlp):
        """A draining replica's 503 + Retry-After answers are retried
        against a live replica: no client-visible failure."""
        f = _predict_factory(mlp)
        fleet = _mkfleet([f, f])
        router = FleetRouter(fleet)
        draining = fleet.replicas()[0]
        try:
            expect = None
            draining.server.drain(timeout_s=10.0)
            for _ in range(6):
                st, body = router.post("/predict", {"inputs": X})
                assert st == 200
                expect = expect or body["outputs"]
                assert body["outputs"] == expect
            m = fleet.metrics
            assert m.requests_lost == 0 and m.responses == 6
            assert m.retries >= 1      # at least one shed was rerouted
            # after a poll the drained replica leaves the eligible set
            fleet.poll_now()
            assert not draining.eligible() and draining.admitted
            assert [r.id for r in fleet.eligible()] == \
                [fleet.replicas()[1].id]
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)

    def test_dead_replica_ejected_then_readmitted(self, mlp):
        f = _predict_factory(mlp)
        fleet = _mkfleet([f, f], eject_after=2)
        router = FleetRouter(fleet)
        dead = fleet.replicas()[0]
        try:
            dead.server.stop()         # replica process "dies"
            fleet.poll_now()
            fleet.poll_now()
            assert not dead.admitted
            assert fleet.metrics.ejections == 1
            # traffic keeps flowing through the survivor
            st, _ = router.post("/predict", {"inputs": X})
            assert st == 200
            # recovery: the replica comes back (new process, new port)
            new = f()
            with dead._lock:
                dead.server, dead.host, dead.port = new, new.host, new.port
            fleet.poll_now()
            assert dead.admitted and dead.eligible()
            assert fleet.metrics.readmissions == 1
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)


class TestHedging:
    def test_straggler_hedged_first_response_wins(self, mlp):
        """A deterministic straggler (a seeded injector sleeps every
        device call 300 ms) is hedged after hedge_after_ms; the fast
        replica's answer wins, so no request pays the full stall."""
        inj = FaultInjector(seed=0, rates={"device_step": 1.0},
                            slow_ms={"device_step": 300.0})
        fleet = _mkfleet([_predict_factory(mlp, fault_injector=inj),
                          _predict_factory(mlp)])
        router = FleetRouter(fleet, hedge_after_ms=40.0,
                             hedge_budget_ratio=0.5,
                             hedge_budget_burst=2.0)
        n = 10
        try:
            expect = None
            t0 = time.perf_counter()
            for _ in range(n):
                st, body = router.post("/predict", {"inputs": X})
                assert st == 200
                expect = expect or body["outputs"]
                assert body["outputs"] == expect
            dt = time.perf_counter() - t0
            m = fleet.metrics
            assert m.hedges >= 1 and m.hedges_won >= 1
            assert m.hedges <= 2.0 + 0.5 * n     # budget bound
            assert m.requests_lost == 0 and m.responses == n
            # without hedging every request on the straggler pays
            # 300 ms+; with it the sequential run beats n * stall
            assert dt < n * 0.3
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)

    def test_hedge_budget_is_never_exceeded(self):
        """burst=1, ratio=0: exactly ONE hedge is ever allowed, however
        slow the fleet is."""
        def slow_factory():
            inj = FaultInjector(seed=0, rates={"device_step": 1.0},
                                slow_ms={"device_step": 150.0})
            return _predict_factory(port_mlp(), fault_injector=inj)()
        fleet = ReplicaFleet(poll_interval_s=None)
        fleet.add(slow_factory())
        fleet.add(slow_factory())
        router = FleetRouter(fleet, hedge_after_ms=20.0,
                             hedge_budget_ratio=0.0,
                             hedge_budget_burst=1.0)
        try:
            for _ in range(4):
                st, _ = router.post("/predict", {"inputs": X})
                assert st == 200
            m = fleet.metrics
            assert m.hedges == 1                  # the single token
            assert m.hedge_budget_denied >= 1     # later wants denied
            assert m.responses == 4 and m.requests_lost == 0
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)


def _stream_head(host, port, payload):
    sk = socket.create_connection((host, port), timeout=30)
    sk.sendall(b"POST /v1/models/lm/generate HTTP/1.1\r\n"
               b"Host: x\r\nContent-Type: application/json\r\n"
               + f"Content-Length: {len(payload)}\r\n\r\n".encode()
               + payload)
    return sk


class TestStreamingThroughRouter:
    def test_stream_matches_direct_engine(self, tiny_lm):
        ref_eng = GenerationEngine(tiny_lm, num_slots=1, max_seq_len=32,
                                   prompt_buckets=[8])
        ref = ref_eng.generate([1, 2, 3], max_tokens=6, seed=7,
                               timeout_ms=60_000)["tokens"]
        ref_eng.stop()
        fleet = _mkfleet([_gen_factory(tiny_lm)] * 2)
        router = FleetRouter(fleet)
        try:
            toks = [it["token"] for it in
                    router.stream("/v1/models/lm/generate",
                                  {"prompt": [1, 2, 3], "max_tokens": 6,
                                   "seed": 7, "timeout_ms": 60_000})
                    if "token" in it]
            assert toks == ref
            st, body = router.post("/v1/models/lm/generate",
                                   {"prompt": [1, 2, 3], "max_tokens": 6,
                                    "seed": 7, "timeout_ms": 60_000})
            assert st == 200 and body["tokens"] == ref
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)

    @pytest.mark.parametrize("backend", ["aio", "thread"])
    def test_midstream_disconnect_frees_replica_promptly(self, tiny_lm,
                                                         backend):
        """A client that vanishes mid-stream THROUGH the router frees
        the backing replica's slot and blocks and drops its live
        occupancy."""
        fleet = _mkfleet([_gen_factory(tiny_lm)] * 2)
        router = FleetRouter(fleet)
        host, port = router.serve(backend=backend)
        payload = json.dumps({"prompt": [1, 2, 3], "max_tokens": 200,
                              "seed": 1, "stream": True,
                              "timeout_ms": 120_000}).encode()
        try:
            sk = _stream_head(host, port, payload)
            got = b""
            while got.count(b"token") < 3:
                chunk = sk.recv(4096)
                assert chunk, "stream ended before 3 tokens"
                got += chunk
            sk.close()                 # client hangs up mid-stream

            def engines():
                return [rep.server.registry.get("lm").engine
                        for rep in fleet.replicas()]

            wait_for(lambda: all(e.metrics.active_slots == 0
                                 for e in engines())
                     and all(r.in_flight == 0 for r in fleet.replicas()),
                     "the abandoned stream's slot and in-flight count",
                     timeout=20)
            for e in engines():
                pg = e.stats()["paged"]
                assert pg["blocks_free"] == pg["blocks_total"]
            # the freed capacity is immediately reusable
            st, body = router.post("/v1/models/lm/generate",
                                   {"prompt": [1, 2, 3], "max_tokens": 4,
                                    "seed": 2, "timeout_ms": 60_000})
            assert st == 200 and len(body["tokens"]) == 4
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)

    def test_upstream_stall_midstream_yields_inband_error(self, tiny_lm):
        """The UPSTREAM (replica) failing mid-stream leaves the
        still-connected client a terminal in-band error chunk and a
        well-formed chunked ending, driven by a seeded injector stalling
        every decode step past the router's socket timeout."""
        inj = FaultInjector(seed=0, rates={"device_step": 1.0},
                            slow_ms={"device_step": 2500.0})

        def factory():
            server = InferenceServer(port=0)
            g = server.register_generator(
                "lm", tiny_lm, num_slots=2, max_seq_len=32,
                prompt_buckets=[8], cache="paged", block_size=4,
                num_blocks=16, fault_injector=inj)
            g.warmup()
            return server
        fleet = ReplicaFleet(poll_interval_s=None)
        rep = fleet.add(factory())
        router = FleetRouter(fleet, timeout_s=1.0)
        host, port = router.serve()
        payload = json.dumps({"prompt": [1, 2, 3], "max_tokens": 20,
                              "seed": 3, "stream": True,
                              "timeout_ms": 120_000}).encode()
        try:
            sk = _stream_head(host, port, payload)
            got = b""
            while not got.endswith(b"0\r\n\r\n"):
                chunk = sk.recv(4096)
                assert chunk, f"truncated stream: {got[-120:]!r}"
                got += chunk
            sk.close()
            # the prefill's first token streamed before the stall...
            assert got.count(b'"token"') >= 1
            # ...and the stall surfaced as the terminal in-band error
            lines = [ln for ln in got.split(b"\r\n")
                     if ln.startswith(b"{")]
            last = json.loads(lines[-1])
            assert last.get("done") is True
            assert "error" in last, last
            # the router released its in-flight count
            wait_for(lambda: rep.in_flight == 0, "in_flight back to 0",
                     timeout=10)
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)


def _rolling(fleet, n_clients, request, done):
    """Client threads calling ``request(i)`` until stopped, a rolling
    restart once every client has an answer, and traffic after it until
    every client has another. Returns (restart's result, failures)."""
    stop = threading.Event()
    failures = []

    def client(i):
        while not stop.is_set():
            try:
                bad = request(i)
            except Exception as e:   # noqa: BLE001
                failures.append(repr(e))
                continue
            if bad is not None:
                failures.append(bad)
            else:
                done[i] += 1
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    try:
        for t in threads:
            t.start()
        wait_for(lambda: all(done), "traffic rolling", timeout=60)
        ok = fleet.rolling_restart(drain_timeout_s=30.0,
                                   ready_timeout_s=120.0)
        after = list(done)
        wait_for(lambda: all(d > a for d, a in zip(done, after)),
                 "traffic after the restarts", timeout=60)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    return ok, failures


class TestRollingRestart:
    def test_zero_loss_predict_rows_within_tolerance(self, mlp):
        """With requests in flight against a 3-replica fleet, draining
        and restarting EVERY replica in turn loses zero accepted
        requests, and every row is the restart-free answer within
        ``PREDICT_ROW_TOL`` (the reference's bit-identity gate fails in
        JAX; see the module doc)."""
        expected = {}
        for i in range(6):
            x = (np.arange(4, dtype=np.float32) + i).reshape(1, 4)
            expected[i] = np.asarray(mlp.output(x))
        f = _predict_factory(mlp)
        fleet = _mkfleet([f, f, f], poll_interval_s=0.05)
        router = FleetRouter(fleet, hedge_after_ms=500.0,
                             hedge_budget_ratio=0.1,
                             hedge_budget_burst=2.0)
        counts = [0] * 6

        def request(i):
            x = (np.arange(4, dtype=np.float32) + i).reshape(1, 4)
            st, body = router.post("/predict", {"inputs": x.tolist(),
                                                "timeout_ms": 60_000})
            if st != 200:
                return (i, st, body)
            err = float(np.abs(np.asarray(body["outputs"])
                               - expected[i]).max())
            if err > PREDICT_ROW_TOL:
                return (i, "mismatch", err, body["outputs"])
            return None
        try:
            ok, failures = _rolling(fleet, 6, request, counts)
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)
        assert ok, "a replica failed to drain/return ready"
        assert not failures, failures[:5]
        assert all(c > 0 for c in counts)
        m = fleet.metrics
        assert m.restarts == 3
        assert m.requests_lost == 0
        assert m.requests == m.responses

    def test_served_rows_keep_their_bits_in_every_bucket(self, mlp):
        """The cause of the reference's red case, held in the port: a
        row's bits do not depend on the bucket it is served in or its
        place there (on the CPU), so every served row of the rolling
        restart is the restart-free row."""
        eng = InferenceEngine(mlp)
        rows = [np.arange(4, dtype=np.float32) + i for i in range(6)]
        for i in range(6):
            alone = np.asarray(mlp.output(rows[i][None]))[0]
            for b in (1, 2, 4):
                for pos in range(b):
                    batch = np.stack([rows[(i + k + 1) % 6]
                                      for k in range(b)])
                    batch[pos] = rows[i]
                    got = np.asarray(eng.predict(batch))[pos]
                    assert got.tobytes() == alone.tobytes(), (i, b, pos)

    def test_zero_loss_token_identical_generation(self, tiny_lm):
        """Rolling-restarting all replicas under live generate traffic
        loses nothing, and per-seed outputs are token-identical to a
        restart-free engine."""
        ref_eng = GenerationEngine(tiny_lm, num_slots=1, max_seq_len=32,
                                   prompt_buckets=[8])
        ref = {s: ref_eng.generate([1 + s, 2, 3], max_tokens=6, seed=s,
                                   timeout_ms=60_000)["tokens"]
               for s in range(4)}
        ref_eng.stop()
        f = _gen_factory(tiny_lm)
        fleet = _mkfleet([f, f, f], poll_interval_s=0.05)
        router = FleetRouter(fleet)
        done = [0] * 4

        def request(s):
            st, body = router.post("/v1/models/lm/generate",
                                   {"prompt": [1 + s, 2, 3],
                                    "max_tokens": 6, "seed": s,
                                    "timeout_ms": 60_000})
            if st != 200:
                return (s, st, body)
            if body["tokens"] != ref[s]:
                return (s, "mismatch", body["tokens"])
            return None
        try:
            ok, failures = _rolling(fleet, 4, request, done)
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)
        assert ok
        assert not failures, failures[:5]
        assert all(c > 0 for c in done)
        assert fleet.metrics.restarts == 3
        assert fleet.metrics.requests_lost == 0

    def test_restarted_replica_releases_its_engine(self, tiny_lm):
        """A stopped replica's engine, caches and graphs are garbage
        once the restart replaced it (the card's memory check in
        chip_smoke.py phase 17b, here on the CPU through weak
        references)."""
        f = _gen_factory(tiny_lm)
        fleet = _mkfleet([f, f])
        old = [weakref.ref(rep.server.registry.get("lm").engine)
               for rep in fleet.replicas()]
        caches = [weakref.ref(rep.server.registry.get("lm").engine._cache)
                  for rep in fleet.replicas()]
        try:
            assert fleet.rolling_restart(drain_timeout_s=30.0,
                                         ready_timeout_s=60.0)
            gc.collect()
            assert [r() for r in old] == [None, None]
            assert [r() for r in caches] == [None, None]
        finally:
            fleet.stop(stop_replicas=True)


class TestFleetHTTP:
    @pytest.mark.parametrize("backend", ["aio", "thread"])
    def test_probes_and_stats(self, mlp, backend):
        f = _predict_factory(mlp)
        fleet = _mkfleet([f, f])
        router = FleetRouter(fleet)
        host, port = router.serve(backend=backend)
        base = f"http://{host}:{port}"
        try:
            hz = json.loads(urllib.request.urlopen(
                base + "/healthz", timeout=30).read())
            assert hz["status"] == "ok"
            rz = json.loads(urllib.request.urlopen(
                base + "/readyz", timeout=30).read())
            assert rz["ready"] is True
            models = json.loads(urllib.request.urlopen(
                base + "/v1/models", timeout=30).read())
            assert "default" in models
            st, _ = router.post("/predict", {"inputs": X})
            assert st == 200
            stats = json.loads(urllib.request.urlopen(
                base + "/stats", timeout=30).read())["fleet"]
            assert stats["responses"] >= 1
            assert len(stats["replicas"]) == 2
            for rep in stats["replicas"]:
                assert {"id", "address", "eligible", "in_flight",
                        "requests_routed", "score"} <= set(rep)
            # readiness follows the eligible set
            for rep in fleet.replicas():
                fleet.cordon(rep.id)
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(base + "/readyz", timeout=30)
            assert exc.value.code == 503
            assert exc.value.headers.get("Retry-After")
            for rep in fleet.replicas():
                fleet.uncordon(rep.id)
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)

    def test_no_replicas_is_shed_not_crash(self):
        fleet = ReplicaFleet(poll_interval_s=None)
        router = FleetRouter(fleet)
        try:
            st, body = router.post("/predict", {"inputs": X})
            assert st == 503 and "error" in body
            assert fleet.metrics.requests_lost == 1
        finally:
            router.stop()
            fleet.stop()


class _FlipServer:
    """Minimal stdlib HTTP replica that answers POST /predict with 503 +
    Retry-After while ``mode == "shed"`` and 200 once flipped; ``hits``
    counts requests that reached the socket."""

    def __init__(self, retry_after="0"):
        import http.server
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — stdlib name
                self.rfile.read(int(self.headers.get("Content-Length",
                                                     0) or 0))
                outer.hits += 1
                if outer.mode == "shed":
                    body = json.dumps({"error": "shedding"}).encode()
                    self.send_response(503)
                    self.send_header("Retry-After", outer.retry_after)
                else:
                    body = json.dumps({"outputs": [[0.0]]}).encode()
                    self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.mode = "shed"
        self.retry_after = retry_after
        self.hits = 0
        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class TestBackpressure:
    """Retry-After honored as a routing cooldown, and the
    consecutive-shed circuit breaker (closed -> open -> half_open ->
    closed), distinct from health ejection."""

    def _rep(self, **fleet_kw):
        fleet = ReplicaFleet(poll_interval_s=None, **fleet_kw)
        # never contacted: these tests drive note_shed/note_ok directly
        rep = fleet.add(host="127.0.0.1", port=9)
        return fleet, rep

    def test_breaker_trips_after_consecutive_sheds(self):
        fleet, rep = self._rep(breaker_threshold=3, breaker_open_s=60.0)
        try:
            for _ in range(2):
                fleet.note_shed(rep, retry_after_s=0)
                assert rep.breaker_state() == "closed"
                assert fleet.routable(rep)          # strikes, not open
            fleet.note_shed(rep, retry_after_s=0)   # third strike
            assert rep.breaker_state() == "open"
            assert not fleet.routable(rep)
            assert fleet.metrics.breaker_trips == 1
            assert fleet.metrics.sheds == 3
            assert rep.eligible()
            assert fleet.metrics.ejections == 0
            snap = rep.snapshot()
            assert snap["breaker"] == "open"
            assert snap["consecutive_sheds"] == 3
        finally:
            fleet.stop()

    def test_half_open_single_probe_then_recovery(self):
        fleet, rep = self._rep(breaker_threshold=2, breaker_open_s=0.15)
        try:
            fleet.note_shed(rep, retry_after_s=0)
            fleet.note_shed(rep, retry_after_s=0)
            assert rep.breaker_state() == "open"
            wait_for(lambda: rep.breaker_state() == "half_open",
                     "the open window to end")
            assert fleet.routable(rep)              # probe slot open
            assert fleet.claim_probe(rep)           # first probe wins
            assert not fleet.claim_probe(rep)       # one per window
            assert not fleet.routable(rep)          # slot now claimed
            fleet.note_ok(rep)                      # probe succeeded
            assert rep.breaker_state() == "closed"
            assert fleet.routable(rep)
            assert rep.consecutive_sheds == 0
            assert fleet.metrics.breaker_probes == 1
            assert fleet.metrics.breaker_recoveries == 1
        finally:
            fleet.stop()

    def test_failed_probe_reopens_breaker(self):
        fleet, rep = self._rep(breaker_threshold=2, breaker_open_s=0.15)
        try:
            fleet.note_shed(rep, retry_after_s=0)
            fleet.note_shed(rep, retry_after_s=0)
            wait_for(lambda: rep.breaker_state() == "half_open",
                     "the open window to end")
            assert fleet.claim_probe(rep)
            fleet.note_shed(rep, retry_after_s=0)   # probe answered 503
            assert rep.breaker_state() == "open"    # window re-opened
            assert not fleet.routable(rep)
            assert fleet.metrics.breaker_trips == 1  # no double-count
        finally:
            fleet.stop()

    def test_retry_after_cooldown_is_capped(self):
        fleet, rep = self._rep(cooldown_cap_s=0.15,
                               breaker_threshold=100)
        try:
            fleet.note_shed(rep, retry_after_s=9999)
            assert not fleet.routable(rep)
            assert rep.cooldown_until <= time.monotonic() + 0.15
            wait_for(lambda: fleet.routable(rep), "the capped cooldown")
            # malformed Retry-After falls back to a finite default
            fleet.note_shed(rep, retry_after_s="soon")
            assert not fleet.routable(rep)
            assert fleet.metrics.cooldowns == 2
        finally:
            fleet.stop()

    def test_stale_ok_does_not_clear_fresh_cooldown(self):
        """A 200 for a request dispatched BEFORE the shed landed is
        stale evidence and changes nothing."""
        fleet, rep = self._rep(breaker_threshold=1)
        try:
            t_before = time.monotonic()
            wait_for(lambda: time.monotonic() > t_before,
                     "the clock to move")
            fleet.note_shed(rep, retry_after_s=30)
            assert not fleet.routable(rep)
            assert rep.breaker_state() == "open"
            fleet.note_ok(rep, dispatched_at=t_before)   # stale answer
            assert not fleet.routable(rep)               # still cooling
            assert rep.breaker_state() == "open"
            assert rep.consecutive_sheds == 1
            assert fleet.metrics.breaker_recoveries == 0
            # an answer to a request dispatched AFTER the shed is real
            # evidence of recovery
            fleet.note_ok(rep, dispatched_at=time.monotonic())
            assert fleet.routable(rep)
            assert rep.breaker_state() == "closed"
            assert fleet.metrics.breaker_recoveries == 1
        finally:
            fleet.stop()

    def test_non_2xx_answers_are_not_recovery(self):
        fleet, rep = self._rep(breaker_threshold=100)
        router = FleetRouter(fleet)
        try:
            fleet.note_shed(rep, retry_after_s=30)
            assert not fleet.routable(rep)
            router._note(rep, 500, {}, time.monotonic())
            router._note(rep, 404, {}, time.monotonic())
            assert not fleet.routable(rep)               # cooldown holds
            assert rep.consecutive_sheds == 1
            router._note(rep, 200, {}, time.monotonic())
            assert fleet.routable(rep)
            assert rep.consecutive_sheds == 0
        finally:
            router.stop()
            fleet.stop()

    def test_rebuilt_replica_starts_with_clean_slate(self):
        fleet, rep = self._rep(breaker_threshold=1)
        try:
            fleet.note_shed(rep, retry_after_s=30)
            assert rep.breaker_state() == "open"
            rep.reset_backpressure()                 # rolling restart
            assert rep.breaker_state() == "closed"
            assert fleet.routable(rep)
            assert rep.consecutive_sheds == 0
        finally:
            fleet.stop()

    def test_router_honors_retry_after_cooldown_then_expiry(self):
        """A 503 + Retry-After takes the replica out of the routable
        set for the advertised window (the socket sees no contact), and
        the cooldown expires."""
        flip = _FlipServer(retry_after="0.3")
        fleet = ReplicaFleet(poll_interval_s=None, breaker_threshold=100)
        router = FleetRouter(fleet)
        try:
            rep = fleet.add(host="127.0.0.1", port=flip.port)
            st, _ = router.post("/predict", {"inputs": X})
            assert st == 503                        # the shed passes up
            assert flip.hits == 1
            assert not fleet.routable(rep)          # cooling
            st, body = router.post("/predict", {"inputs": X})
            assert st == 503 and "error" in body
            assert flip.hits == 1                   # NEVER re-contacted
            assert fleet.metrics.sheds == 1
            wait_for(lambda: fleet.routable(rep), "the cooldown to expire")
            flip.mode = "ok"
            st, body = router.post("/predict", {"inputs": X})
            assert st == 200 and body["outputs"] == [[0.0]]
            assert flip.hits == 2
            assert fleet.routable(rep)              # note_ok cleared it
            assert rep.consecutive_sheds == 0
            snap = fleet.snapshot()
            assert snap["sheds"] == 1
            assert snap["cooldowns"] == 1
            assert 0.0 < snap["goodput"] <= 1.0
        finally:
            router.stop()
            fleet.stop()
            flip.stop()

    def test_breaker_opens_through_router_traffic(self):
        """Consecutive 503s observed by the ROUTER trip the breaker;
        after the open window a half-open probe finds the replica
        recovered and traffic resumes."""
        flip = _FlipServer(retry_after="0")
        fleet = ReplicaFleet(poll_interval_s=None, breaker_threshold=3,
                             breaker_open_s=0.2)
        router = FleetRouter(fleet)
        try:
            rep = fleet.add(host="127.0.0.1", port=flip.port)
            for _ in range(3):
                st, _ = router.post("/predict", {"inputs": X})
                assert st == 503
            assert rep.breaker_state() == "open"
            assert flip.hits == 3
            st, _ = router.post("/predict", {"inputs": X})
            assert st == 503 and flip.hits == 3     # open: no contact
            flip.mode = "ok"
            wait_for(lambda: rep.breaker_state() == "half_open",
                     "the open window to end")
            st, body = router.post("/predict", {"inputs": X})
            assert st == 200                        # the probe, via _pick
            assert rep.breaker_state() == "closed"
            assert fleet.metrics.breaker_probes >= 1
            assert fleet.metrics.breaker_recoveries == 1
        finally:
            router.stop()
            fleet.stop()
            flip.stop()


class TestPriorityThroughRouter:
    """The replica-level priority contract (X-Priority classifies the
    request, an unknown class is a 400) holds THROUGH the router."""

    @pytest.mark.parametrize("backend", ["aio", "thread"])
    def test_x_priority_header_survives_proxy_hop(self, mlp, backend):
        fleet = _mkfleet([_predict_factory(mlp)])
        router = FleetRouter(fleet)
        host, port = router.serve(backend=backend)

        def post(prio):
            req = urllib.request.Request(
                f"http://{host}:{port}/predict",
                data=json.dumps({"inputs": X}).encode(),
                headers={"Content-Type": "application/json",
                         "X-Priority": prio})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        try:
            st, out = post("batch")
            assert st == 200 and "outputs" in out
            # a bogus class must 400 at the REPLICA: a router that
            # stripped the header would have it admitted as interactive
            st, out = post("urgent")
            assert st == 400
            assert "priority" in out.get("error", "").lower()
            assert router.metrics.snapshot()["client_errors"] == 1
        finally:
            router.stop()
            fleet.stop(stop_replicas=True)


# ---------------------------------------------------------------------
# one scripted sequence through a JAX fleet and the port's
# ---------------------------------------------------------------------
LM_CFG = dict(vocab_size=64, d_model=16, n_layers=1, n_heads=2,
              max_seq_len=32, seed=0)
GEN_OPTS = dict(num_slots=2, max_seq_len=32, prompt_buckets=[8],
                cache="paged", block_size=4, num_blocks=16)


def _read_stream(host, port, body):
    """The ndjson items of one streamed POST through the router."""
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("POST", "/v1/models/lm/generate",
                     body=json.dumps(dict(body, stream=True)),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        return [json.loads(ln) for ln in resp.read().decode().splitlines()
                if ln.strip()]
    finally:
        conn.close()


def _fleet_script(server_cls, router_cls, fleet_cls, net, lm):
    """Two replicas (the MLP as "default", the LM as "lm") behind a
    router on its aio front-end: a predict, a generate, the first
    replica drained so that its 503s are retried on the second (two
    predicts and a generate), then a stream. Returns what it saw."""
    servers = []
    for _ in range(2):
        srv = server_cls(port=0, max_batch_size=4, max_latency_ms=2.0)
        srv.register("default", net)
        srv.served().warmup([1])
        srv.register_generator("lm", lm, **GEN_OPTS).warmup()
        servers.append(srv)
    fleet = fleet_cls(poll_interval_s=None)
    for srv in servers:
        fleet.add(srv)
    fleet.poll_now()
    router = router_cls(fleet)
    host, port = router.serve()
    base = f"http://{host}:{port}"
    gen = {"prompt": [1, 2, 3], "max_tokens": 6, "seed": 7,
           "timeout_ms": 60_000}
    out = {}
    try:
        x = [[0.5, -1.0, 2.0, 0.25]]
        out["predict"] = [router.post("/predict", {"inputs": x})]
        out["generate"] = [router.post("/v1/models/lm/generate", gen)]
        servers[0].drain(timeout_s=10.0)
        for _ in range(2):
            out["predict"].append(router.post("/predict", {"inputs": x}))
        out["generate"].append(router.post("/v1/models/lm/generate",
                                           dict(gen, seed=8)))
        out["stream"] = _read_stream(host, port, dict(gen, seed=9))
        out["stats"] = get_json(base, "/stats")
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            out["metrics"] = r.read().decode()
    finally:
        router.stop()
        fleet.stop(stop_replicas=True)
    return out


class TestFleetParity:
    def test_scripted_sequence_matches_the_jax_fleet(self):
        from deeplearning4j_tpu.serving import (
            FleetRouter as JaxRouter, InferenceServer as JaxServer,
            ReplicaFleet as JaxFleet)

        from _obs_util import assert_exposition_parity, parse_prometheus
        jnet, tnet = net_pair(mlp_conf)
        jlm, lm = lm_pair(**LM_CFG)
        want = _fleet_script(JaxServer, JaxRouter, JaxFleet, jnet, jlm)
        got = _fleet_script(InferenceServer, FleetRouter, ReplicaFleet,
                            tnet, lm)
        # every answer: same status, same tokens, predict rows close
        for (js, jb), (ts, tb) in zip(want["predict"], got["predict"]):
            assert js == ts == 200
            np.testing.assert_allclose(tb["outputs"], jb["outputs"],
                                       rtol=1e-4, atol=1e-5)
        for (js, jb), (ts, tb) in zip(want["generate"], got["generate"]):
            assert js == ts == 200
            assert tb["tokens"] == jb["tokens"]
        assert [i.get("token") for i in got["stream"]] == \
            [i.get("token") for i in want["stream"]]
        assert got["stream"][-1]["tokens"] == want["stream"][-1]["tokens"]
        # the router's /stats: JAX's key set, recursively, and its
        # deterministic counters
        assert key_tree(got["stats"]) == key_tree(want["stats"])
        jf, tf = want["stats"]["fleet"], got["stats"]["fleet"]
        for k in ("requests", "responses", "retries", "requests_lost",
                  "streams", "routed", "sheds"):
            assert tf[k] == jf[k], k
        assert tf["retries"] >= 1 and tf["requests_lost"] == 0
        # /metrics: the families JAX exposes for a fleet snapshot, and
        # every sample the port's snapshot implies
        samples, types = parse_prometheus(got["metrics"])
        _, jtypes = parse_prometheus(want["metrics"])
        assert types == jtypes
        assert_exposition_parity(got["stats"], samples, types)
