"""The port's MicroBatcher and admission control (CPU): the batcher cases
of ``tests/test_serving_runtime.py`` and ``tests/test_overload.py``
mirrored at JAX's assertions, on the port's engines.

The JAX tests stall the device with ``time.sleep`` and then sleep again
to guess when a request is inside the call or queued; two of them fail
under a loaded CPU (ROADMAP.md section C). Here the stalled device is a
duck model held on a ``threading.Event`` (``_torch_serving_util.Gate``):
a test waits for the state it needs (a call inside the device, a
request in the queue, a deadline passed), then releases the call, so no
sleep decides an assertion. Where JAX's assertion rests on a measured
device time (the EWMA), the held call is timed by the test
(``hold_call``) and the request's budget is taken from the measured
estimate, so the verdict cannot flip with the machine's load.
``test_cold_batcher_admits_everything`` runs the batcher's clock frozen:
its claim is the cold estimate at submit, and a 5 ms budget would
otherwise also bet on how soon the scheduler thread wakes.
The generation-engine cases run on the port's GenerationEngine.
``TestStatsUnderOverload`` also checks the fleet aggregates: a fleet's
poll carries the replica's shed total into its snapshot.
"""
import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch.serving import (ClientError,
                                              DeadlineExceededError,
                                              GenerationEngine,
                                              InferenceEngine,
                                              InferenceServer, MicroBatcher,
                                              QueueFullError, ReplicaFleet)
from deeplearning4j_tpu_torch.serving import batcher as batcher_mod
from deeplearning4j_tpu_torch.serving import engine as port_engine
from deeplearning4j_tpu_torch.tracing import Trace
from deeplearning4j_tpu_torch.zoo.transformer_lm import CausalTransformerLM

from _torch_serving_util import (Gate, hold_call, port_mlp, recording_graphs,
                                 wait_for)

X1 = np.ones((1, 2), np.float32)


@pytest.fixture(scope="module")
def lm():
    return CausalTransformerLM(vocab_size=64, d_model=16, n_layers=1,
                               n_heads=2, max_seq_len=32, seed=0,
                               device="cpu").init()


def _bg(fn, *args, **kw):
    """Run ``fn`` on a thread; returns (thread, outcome list)."""
    out = []

    def go():
        try:
            out.append(fn(*args, **kw))
        except BaseException as e:  # noqa: BLE001 — inspected by the test
            out.append(e)
    t = threading.Thread(target=go)
    t.start()
    return t, out


def _queued(batcher, n=1):
    wait_for(lambda: batcher._queue.qsize() >= n, f"{n} queued")


class TestMicroBatcher:
    """``tests/test_serving_runtime.py::TestMicroBatcher``, mirrored."""

    def test_concurrent_clients_coalesce_and_match(self, np_rng):
        net = port_mlp()
        eng = InferenceEngine(net, max_batch_size=16)
        eng.warmup([1, 2, 4, 8, 16])
        batcher = MicroBatcher(eng, max_latency_ms=10.0)
        xs = [np_rng.randn(1 + (i % 3), 4).astype(np.float32)
              for i in range(32)]
        wants = [net.output(x).numpy() for x in xs]
        errs = []

        def client(i):
            try:
                got = batcher.submit(xs[i])
                np.testing.assert_allclose(got, wants[i], rtol=1e-4,
                                           atol=1e-6)
            except Exception as e:  # noqa: BLE001
                errs.append((i, e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        batcher.stop()
        assert not errs
        assert eng.metrics.responses == 32
        assert eng.metrics.mean_batch() > 1.0  # actually coalesced
        assert eng.metrics.compiles == 5       # still only the warmups

    def test_deadline_exceeded_in_queue(self):
        gate = Gate()
        eng = InferenceEngine(gate, max_batch_size=4)
        batcher = MicroBatcher(eng, max_latency_ms=1.0)
        t, _ = _bg(batcher.submit, X1)
        gate.wait_entered()   # the worker is inside the held device call
        with pytest.raises(DeadlineExceededError):
            batcher.submit(X1, timeout_ms=50)
        gate.release.set()
        t.join()
        batcher.stop()
        assert eng.metrics.timeouts >= 1

    def test_queue_full_sheds(self):
        gate = Gate()
        eng = InferenceEngine(gate, max_batch_size=1)
        batcher = MicroBatcher(eng, max_latency_ms=1.0, max_queue=1)
        results = []

        def client():
            try:
                batcher.submit(X1)
                results.append("ok")
            except QueueFullError:
                results.append("shed")

        first = threading.Thread(target=client)
        first.start()
        gate.wait_entered()
        threads = [threading.Thread(target=client) for _ in range(5)]
        for t in threads:
            t.start()
        wait_for(lambda: results.count("shed") >= 4, "four sheds")
        gate.release.set()
        for t in [first] + threads:
            t.join()
        batcher.stop()
        assert "shed" in results          # bounded queue dropped load
        assert eng.metrics.shed >= 1

    def test_oversize_request_rejected(self, np_rng):
        eng = InferenceEngine(port_mlp(), max_batch_size=4)
        batcher = MicroBatcher(eng)
        with pytest.raises(ClientError):
            batcher.submit(np_rng.randn(5, 4).astype(np.float32))
        batcher.stop()


class TestBatcherDeadlineAdmission:
    """``tests/test_overload.py::TestBatcherDeadlineAdmission``."""

    def test_blown_deadline_shed_at_dequeue_zero_device_steps(self):
        gate = Gate()
        eng = InferenceEngine(gate, max_batch_size=1)
        batcher = MicroBatcher(eng, max_latency_ms=1.0)
        a, a_out = _bg(batcher.submit, X1, timeout_ms=30_000)
        gate.wait_entered()   # A is inside the held device call
        # the EWMA is still cold (no completed call), so B passes the
        # submit-time check and queues behind A; once its 80 ms budget
        # is gone, A's release lets the scheduler reach it
        b, b_out = _bg(batcher.submit, X1, timeout_ms=80)
        _queued(batcher)
        deadline = batcher._queue.queue[0].deadline
        wait_for(lambda: time.perf_counter() > deadline, "B's deadline")
        gate.release.set()
        a.join()
        b.join()
        assert isinstance(b_out[0], DeadlineExceededError)
        assert not isinstance(a_out[0], BaseException)
        batcher.stop()
        assert eng.metrics.batches == 1          # only A reached the device
        assert gate.calls == 1
        assert eng.metrics.shed_deadline == 1
        assert eng.metrics.timeouts >= 1

    def test_hopeless_deadline_rejected_504_at_submit(self):
        gate = Gate()
        eng = InferenceEngine(gate, max_batch_size=1)
        batcher = MicroBatcher(eng, max_latency_ms=1.0)
        t, _ = _bg(batcher.submit, X1, timeout_ms=30_000)
        hold_call(gate, 0.2)                     # warms the EWMA (>=200ms)
        t.join()
        ewma = batcher._device_ewma_ms
        assert ewma >= 200.0
        batches = eng.metrics.batches
        with pytest.raises(DeadlineExceededError, match="one device"):
            batcher.submit(X1, timeout_ms=ewma / 4)
        batcher.stop()
        assert eng.metrics.batches == batches    # zero device steps spent
        assert eng.metrics.shed_deadline == 1
        assert eng.metrics.timeouts == 1         # a deadline verdict (504)

    def test_queue_wait_over_budget_shed_503_at_submit(self):
        gate = Gate()
        eng = InferenceEngine(gate, max_batch_size=1)
        batcher = MicroBatcher(eng, max_latency_ms=1.0)
        t, _ = _bg(batcher.submit, X1, timeout_ms=30_000)
        hold_call(gate, 0.2)                     # warms the EWMA (>=200ms)
        t.join()
        ewma = batcher._device_ewma_ms
        gate.release.clear()
        batches = eng.metrics.batches
        occupiers = [_bg(batcher.submit, X1, timeout_ms=30_000)
                     for _ in range(2)]
        gate.wait_entered()                      # one occupier inside
        _queued(batcher)                         # the other queued
        # the budget covers one device call (the EWMA), not the queue's
        # estimated wait on top of it
        with pytest.raises(QueueFullError, match="estimated queue wait"):
            batcher.submit(X1, timeout_ms=1.5 * ewma)
        gate.release.set()
        for t, _ in occupiers:
            t.join()
        batcher.stop()
        assert eng.metrics.shed_deadline == 1
        assert eng.metrics.shed == 1             # visible as a shed (503)
        assert eng.metrics.batches >= batches    # occupiers still served

    def test_cold_batcher_admits_everything(self, monkeypatch):
        """No measured data -> no shedding: a cold batcher must not
        reject on a fictional estimate (the batcher's clock frozen, see
        the module doc)."""
        t_frozen = time.perf_counter()
        clock = types.SimpleNamespace(perf_counter=lambda: t_frozen,
                                      monotonic=time.monotonic,
                                      sleep=time.sleep)
        monkeypatch.setattr(batcher_mod, "time", clock)
        eng = InferenceEngine(port_mlp(), max_batch_size=4)
        eng.warmup([1])
        batcher = MicroBatcher(eng, max_latency_ms=1.0)
        trace = Trace("cold")
        out = batcher.submit(np.ones((1, 4), np.float32), timeout_ms=5,
                             trace=trace)
        assert np.asarray(out).shape == (1, 3)
        batcher.stop()
        assert eng.metrics.shed_deadline == 0
        adm = next(s for s in trace.spans if s.kind == "admission")
        assert adm.attrs["verdict"] == "admitted"
        assert adm.attrs["est_wait_ms"] == 0.0


class TestAdmissionEstimates:
    """``tests/test_overload.py::TestAdmissionEstimates``."""

    def test_compile_sample_never_feeds_device_ewma(self):
        eng = InferenceEngine(port_mlp(), max_batch_size=4)
        batcher = MicroBatcher(eng, max_latency_ms=1.0)
        x = np.ones((1, 4), np.float32)
        batcher.submit(x, timeout_ms=30_000)    # pays the lazy capture
        assert eng.metrics.compiles >= 1
        assert batcher._device_ewma_ms == 0.0   # poisoned sample dropped
        compiles = eng.metrics.compiles
        batcher.submit(x, timeout_ms=30_000)    # warmed: cache hit
        batcher.stop()
        assert eng.metrics.compiles == compiles
        assert batcher._device_ewma_ms > 0.0    # clean sample landed

    def test_recapture_over_new_weights_never_feeds_device_ewma(
            self, monkeypatch):
        """After ``set_params`` the next call of a cached bucket captures
        its graph again, uncounted in ``compiles`` (JAX does not
        recompile for new weights). That call's time stays out of the
        estimate too: a capture that takes a minute on the batcher's
        clock would otherwise shed every short-deadline request at
        submit. The graphs are the CPU stand-ins of
        ``recording_graphs``; each capture moves the batcher's clock on
        by 60 s."""
        skew = [0.0]
        clock = types.SimpleNamespace(
            perf_counter=lambda: time.perf_counter() + skew[0],
            monotonic=time.monotonic, sleep=time.sleep)
        monkeypatch.setattr(batcher_mod, "time", clock)
        captures = recording_graphs(monkeypatch)
        record = port_engine._record

        def slow_record(run, engine, device):
            skew[0] += 60.0
            return record(run, engine, device)
        monkeypatch.setattr(port_engine, "_record", slow_record)
        net = port_mlp()
        eng = InferenceEngine(net, max_batch_size=4)
        eng.warmup([1])
        batcher = MicroBatcher(eng, max_latency_ms=1.0)
        x = np.ones((1, 4), np.float32)
        batcher.submit(x, timeout_ms=30_000)    # warmed: a clean sample
        ewma = batcher._device_ewma_ms
        assert 0.0 < ewma < 5_000.0
        net.set_params(port_mlp(seed=7).params())
        out = batcher.submit(x, timeout_ms=300_000)  # pays the recapture
        np.testing.assert_allclose(out, net.output(x).numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert len(captures) == 2 and eng.captures == 2
        assert eng.metrics.compiles == 1
        assert batcher._device_ewma_ms == ewma  # the sample was dropped
        # a 5 s budget is still admitted (and met)
        out = batcher.submit(x, timeout_ms=5_000)
        np.testing.assert_allclose(out, net.output(x).numpy(),
                                   rtol=1e-5, atol=1e-6)
        batcher.stop()
        assert eng.metrics.shed_deadline == 0 and eng.metrics.timeouts == 0

    def test_queue_wait_estimate_counts_rows_not_requests(self):
        eng = InferenceEngine(port_mlp(), max_batch_size=4)
        batcher = MicroBatcher(eng, max_latency_ms=1.0)
        batcher.stop()
        batcher._device_ewma_ms = 100.0
        # 8 queued ROWS are 2 device calls at max_batch_size=4 even
        # when they arrived as fewer (multi-row) requests
        assert batcher._est_queue_wait_ms(8) == 200.0
        assert batcher._est_queue_wait_ms(1) == 100.0
        assert batcher._est_queue_wait_ms(0) == 0.0

    def test_pending_rows_gauge_counts_rows(self):
        gate = Gate()
        eng = InferenceEngine(gate, max_batch_size=4)
        batcher = MicroBatcher(eng, max_latency_ms=1.0)
        done = []

        def client(n):
            batcher.submit(np.ones((n, 2), np.float32), timeout_ms=30_000)
            done.append(n)

        a = threading.Thread(target=client, args=(1,))
        a.start()
        gate.wait_entered()  # A is inside the held device call
        b = threading.Thread(target=client, args=(4,))
        b.start()
        wait_for(lambda: batcher._pending_rows >= 4, "four pending rows")
        assert batcher._queue.qsize() <= 1      # one request queued...
        assert batcher._pending_rows == 4       # ...but FOUR rows
        gate.release.set()
        a.join()
        b.join()
        batcher.stop()
        assert batcher._pending_rows == 0
        assert sorted(done) == [1, 4]

    @pytest.mark.parametrize("cache", ["slots", "paged"])
    def test_generation_cost_uses_padded_bucket(self, lm, cache):
        kw = dict(num_slots=1, min_prompt_bucket=8)
        if cache == "paged":
            kw.update(cache="paged", block_size=4, num_blocks=16)
        eng = GenerationEngine(lm, **kw)
        try:
            eng._prefill_ms_per_tok = 1.0   # 1 ms per PADDED token
            eng._decode_ewma_ms = 2.0
            assert eng._padded_prefill_len(2) == 8
            assert eng._est_cost_ms(2, 3) == 8.0 + 3 * 2.0
        finally:
            eng.stop()


class TestBatcherPriorityShedding:
    """``tests/test_overload.py::TestBatcherPriorityShedding``."""

    def test_batch_class_shed_first_interactive_still_admitted(self):
        gate = Gate()
        eng = InferenceEngine(gate, max_batch_size=1)
        batcher = MicroBatcher(eng, max_latency_ms=1.0, max_queue=4)
        assert batcher._batch_queue_limit == 2
        results = []

        def client():
            results.append(batcher.submit(X1, timeout_ms=30_000))

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        gate.wait_entered()
        _queued(batcher, 2)
        with pytest.raises(QueueFullError, match="batch-class"):
            batcher.submit(X1, timeout_ms=30_000, priority="batch")
        # interactive may still use the remaining queue
        t, got = _bg(batcher.submit, X1, timeout_ms=30_000)
        _queued(batcher, 4)
        gate.release.set()
        t.join()
        assert np.asarray(got[0]).shape == (1, 1)
        for t in threads:
            t.join()
        batcher.stop()
        assert eng.metrics.shed_batch >= 1
        assert len(results) == 4                 # no interactive loss

    def test_unknown_priority_is_client_error(self):
        eng = InferenceEngine(port_mlp(), max_batch_size=4)
        batcher = MicroBatcher(eng)
        with pytest.raises(ClientError, match="priority"):
            batcher.submit(np.ones((1, 4), np.float32), priority="urgent")
        batcher.stop()


class TestGenerationDeadlineAdmission:
    """``tests/test_overload.py::TestGenerationDeadlineAdmission`` on the
    port's GenerationEngine."""

    @pytest.mark.parametrize("cache", ["slots", "paged"])
    def test_blown_deadline_shed_at_dequeue_zero_prefills(self, lm, cache):
        kw = dict(num_slots=1, max_queue=8, min_prompt_bucket=4)
        if cache == "paged":
            kw.update(cache="paged", block_size=4, num_blocks=16)
        eng = GenerationEngine(lm, **kw)
        eng.warmup([4])
        prefills = eng.metrics.prefills + eng.metrics.prefill_chunks
        with pytest.raises(DeadlineExceededError):
            eng.generate([4, 5], max_tokens=4, timeout_ms=0)
        assert eng.metrics.shed_deadline == 1
        assert eng.metrics.prefills + eng.metrics.prefill_chunks == \
            prefills                     # the shed request never prefilled
        r = eng.generate([1, 2], max_tokens=2, timeout_ms=30_000)
        assert len(r["tokens"]) == 2
        eng.stop()

    def test_hopeless_cost_rejected_at_submit(self, lm):
        eng = GenerationEngine(lm, num_slots=1, max_queue=8,
                               min_prompt_bucket=4)
        eng.warmup([4])
        eng.generate([1, 2, 3], max_tokens=8,
                     timeout_ms=30_000)  # warms prefill/decode EWMAs
        assert eng._decode_ewma_ms > 0.0
        prefills = eng.metrics.prefills
        with pytest.raises(DeadlineExceededError, match="estimated cost"):
            eng.generate([1, 2, 3], max_tokens=16, timeout_ms=1)
        assert eng.metrics.prefills == prefills  # zero device steps spent
        assert eng.metrics.shed_deadline == 1
        assert eng.metrics.timeouts >= 1
        eng.stop()

    def test_batch_class_shed_first_in_generation_queue(self, lm):
        eng = GenerationEngine(lm, num_slots=1, max_queue=2,
                               min_prompt_bucket=4)
        eng.warmup([4])
        s = eng.stream([1, 2, 3], max_tokens=25, temperature=0.5,
                       timeout_ms=60_000)
        next(s)                         # occupy the only slot
        got = []

        def client():
            got.append(eng.generate([1, 2], max_tokens=2,
                                    timeout_ms=30_000))

        t = threading.Thread(target=client)
        t.start()
        wait_for(lambda: eng._queue.qsize() >= 1, "one queued")
        with pytest.raises(QueueFullError, match="batch-class"):
            eng.generate([1, 2], max_tokens=2, timeout_ms=30_000,
                         priority="batch")
        assert eng.metrics.shed_batch == 1
        s.close()                        # free the slot; interactive runs
        t.join()
        assert len(got) == 1 and len(got[0]["tokens"]) == 2
        eng.stop()

    def test_unknown_priority_is_client_error(self, lm):
        eng = GenerationEngine(lm, num_slots=1, max_queue=2,
                               min_prompt_bucket=4)
        with pytest.raises(ClientError, match="priority"):
            eng.generate([1, 2], max_tokens=2, priority="urgent")
        eng.stop()


class TestStatsUnderOverload:
    """``tests/test_overload.py::TestStatsUnderOverload``, with the
    stalled device held on an Event."""

    @pytest.mark.parametrize("backend", ["aio", "thread"])
    def test_stats_reflect_saturation(self, backend):
        gate = Gate()
        server = InferenceServer(port=0, max_batch_size=1,
                                 max_latency_ms=1.0, max_queue=4,
                                 http_backend=backend)
        served = server.register("default", gate)
        base = f"http://127.0.0.1:{server.port}"
        payload = json.dumps(
            {"inputs": X1.tolist(), "timeout_ms": 30_000}).encode()
        outcomes = []

        def client():
            req = urllib.request.Request(
                base + "/predict", data=payload,
                headers={"Content-Type": "application/json"})
            try:
                urllib.request.urlopen(req, timeout=60).read()
                outcomes.append(200)
            except urllib.error.HTTPError as e:
                outcomes.append(e.code)

        threads = [threading.Thread(target=client) for _ in range(12)]
        fleet = ReplicaFleet(poll_interval_s=None)
        try:
            for t in threads:
                t.start()
            gate.wait_entered()  # 1 in the device call...
            # ...and every other client queued (4) or shed (7)
            wait_for(lambda: served.metrics.queue_depth
                     + outcomes.count(503) >= 11, "a backed-up queue")
            stats = json.loads(urllib.request.urlopen(
                base + "/stats", timeout=30).read())
            m = stats["summary"]["models"]["default"]
            assert m["queue_depth"] >= 1
            assert stats["summary"]["load"] >= 1
            gate.release.set()
            for t in threads:
                t.join()
            assert outcomes.count(503) >= 1      # bounded queue shed
            assert outcomes.count(200) >= 1      # but work still flowed
            stats = json.loads(urllib.request.urlopen(
                base + "/stats", timeout=30).read())
            model = stats["models"]["default"]
            assert model["shed"] >= 1
            assert stats["summary"]["models"]["default"]["shed"] >= 1
            assert stats["summary"]["shed"] >= 1
            # fleet-level: the poll carries the shed total into the
            # replica summary and the snapshot aggregates it
            rep = fleet.add(server)
            fleet.poll_now()
            snap = fleet.snapshot()
            assert snap["fleet_shed"] >= 1
            rs = rep.snapshot()
            assert rs["breaker"] == "closed"
            assert rs["cooling"] is False
            assert rs["consecutive_sheds"] == 0
        finally:
            gate.release.set()
            fleet.stop()
            server.stop()


class TestPriorityOverHTTP:
    """``tests/test_overload.py::TestPriorityOverHTTP``."""

    @pytest.fixture(scope="class")
    def server(self):
        srv = InferenceServer(port=0, max_batch_size=4,
                              max_latency_ms=2.0)
        srv.register("default", port_mlp())
        srv.served().warmup([1])
        yield srv
        srv.stop()

    def _post(self, server, payload, headers=None):
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/predict",
            data=json.dumps(payload).encode(), headers=hdrs)
        return json.loads(urllib.request.urlopen(req, timeout=30).read())

    def test_header_sets_priority(self, server):
        out = self._post(server, {"inputs": [[0, 1, 2, 3]]},
                         headers={"X-Priority": "batch"})
        assert len(out["outputs"]) == 1   # admitted: unloaded queue

    def test_bogus_header_is_400(self, server):
        with pytest.raises(urllib.error.HTTPError) as ei:
            self._post(server, {"inputs": [[0, 1, 2, 3]]},
                       headers={"X-Priority": "urgent"})
        assert ei.value.code == 400

    def test_body_field_wins_over_header(self, server):
        out = self._post(server, {"inputs": [[0, 1, 2, 3]],
                                  "priority": "interactive"},
                         headers={"X-Priority": "urgent"})
        assert len(out["outputs"]) == 1
