"""The port's InferenceEngine and ModelRegistry against the JAX package's
(CPU): the engine and registry cases of ``tests/test_serving_runtime.py``
mirrored at JAX's assertions, plus parity with the JAX engine.

- Outputs: the same numpy-seeded requests through JAX's InferenceEngine
  and the port's, one network on each side with the JAX weights carried
  across (the MLP of ``test_serving_runtime.py:21`` and a d64 x L2
  transformer classifier at T=16), agree within rtol 1e-4 and atol 1e-5
  (f32 on both sides, summed in another order;
  ``tests/test_torch_multilayer.py``'s tolerance).
- Counters: ``compiles``, hits, misses, evictions, the bucket histogram
  and the warmed buckets are equal after the same call sequence, LRU
  evictions included.
- The CUDA graph entry's logic on the CPU: with the capture replaced by
  a stand-in whose replay reruns the captured forward over the params
  it captured (``_torch_serving_util.recording_graphs``), a ``fit``
  after warmup is served (the leaves change in place), a
  ``set_params`` is served through one uncounted recapture, each replay
  adds the launches its capture counted, and a failed capture raises
  ServingError and caches nothing.
- The SameDiff cases (``:115`` and the SameDiff head of ``:185``)
  become asserts that the port raises NotImplementedError citing
  ROADMAP.md queue A item 15; the batch-reducing head is held on a duck
  model instead. The ComputationGraph case (``:132``) serves the port's
  graph with JAX's params and holds its rows to the JAX engine's.
"""
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import InferenceEngine as JaxEngine
from deeplearning4j_tpu_torch.convert import network_params_from_jax
from deeplearning4j_tpu_torch.kernels import (add_launches, count_launch,
                                              launch_counts, tally_launches)
from deeplearning4j_tpu_torch.serving import (ClientError, InferenceEngine,
                                              ModelNotFound, ModelRegistry,
                                              ServingError, export_stablehlo,
                                              next_bucket)
from deeplearning4j_tpu_torch.serving import engine as port_engine

from _torch_serving_util import (classifier_conf, key_tree, mlp_conf,
                                 net_pair, port_mlp, recording_graphs)

RTOL, ATOL = 1e-4, 1e-5


def _counters(eng):
    s = eng.metrics.snapshot()
    return dict(s["compile_cache"], bucket_hist=s["bucket_hist"])


class _Duck:
    """Duck-typed model: rows times two, no cache."""

    def output(self, x):
        return np.asarray(x, np.float32) * 2.0


class _Reduce:
    """Duck-typed model with a batch-reducing head."""

    def output(self, x):
        return np.asarray(x, np.float32).mean(axis=0)


class TestBucketing:
    def test_next_bucket_powers_of_two(self):
        assert [next_bucket(n) for n in (1, 2, 3, 4, 5, 8, 9, 17)] == \
            [1, 2, 4, 4, 8, 8, 16, 32]

    def test_next_bucket_clamps(self):
        assert next_bucket(3, min_bucket=8) == 8
        assert next_bucket(100, max_bucket=32) == 32

    def test_empty_batch_rejected(self):
        with pytest.raises(ClientError):
            next_bucket(0)


class TestAgainstJax:
    """The same requests through both engines."""

    # sizes chosen to hit every bucket, the chunking past
    # max_batch_size and, through a 2-entry cache, evictions and
    # re-captures of evicted buckets
    SEQUENCES = {"lru": ((1, 3, 5, 16, 2, 1, 21, 8), 2),
                 "warm": ((1, 2, 3, 5, 7, 11, 16), 16)}

    @pytest.mark.parametrize("seq", sorted(SEQUENCES))
    @pytest.mark.parametrize("warm", [False, True])
    def test_mlp_outputs_and_counters(self, np_rng, seq, warm):
        sizes, cache = self.SEQUENCES[seq]
        jn, tn = net_pair(mlp_conf)
        je = JaxEngine(jn, max_batch_size=16, cache_size=cache)
        te = InferenceEngine(tn, max_batch_size=16, cache_size=cache)
        if warm:
            assert je.warmup([1, 2, 4, 8, 16]) == te.warmup([1, 2, 4, 8, 16])
        for n in sizes:
            x = np_rng.randn(n, 4).astype(np.float32)
            got = te.predict(x)
            assert isinstance(got, np.ndarray)
            np.testing.assert_allclose(got, je.predict(x), rtol=RTOL,
                                       atol=ATOL)
        assert _counters(te) == _counters(je)
        assert len(te._cache) == len(je._cache)

    def test_transformer_classifier(self, np_rng):
        jn, tn = net_pair(classifier_conf)
        je = JaxEngine(jn, max_batch_size=8, cache_size=16)
        te = InferenceEngine(tn, max_batch_size=8, cache_size=16)
        ex = np.zeros((1, 16), np.float32)
        assert je.warmup([1, 2, 4], example=ex) == \
            te.warmup([1, 2, 4], example=ex)
        for n in (1, 3, 4, 6, 2):
            ids = np_rng.randint(0, 64, (n, 16)).astype(np.float32)
            np.testing.assert_allclose(te.predict(ids.tolist()),
                                       je.predict(ids.tolist()),
                                       rtol=RTOL, atol=ATOL)
        assert _counters(te) == _counters(je)

    def test_engine_never_moves_the_model(self):
        tn = port_mlp()
        eng = InferenceEngine(tn, max_batch_size=4)
        assert eng.device == torch.device("cpu") == tn.device
        eng.predict(np.ones((1, 4), np.float32))
        assert all(t.device.type == "cpu" for p in tn.params().values()
                   for t in p.values())


class TestInferenceEngine:
    """``tests/test_serving_runtime.py::TestInferenceEngine``, mirrored."""

    def test_matches_reference_across_sizes(self, np_rng):
        net = port_mlp()
        eng = InferenceEngine(net, max_batch_size=16)
        for n in (1, 3, 5, 16):
            x = np_rng.randn(n, 4).astype(np.float32)
            np.testing.assert_allclose(eng.predict(x),
                                       net.output(x).numpy(),
                                       rtol=1e-5, atol=1e-6)

    def test_chunking_beyond_max_batch(self, np_rng):
        net = port_mlp()
        eng = InferenceEngine(net, max_batch_size=8)
        x = np_rng.randn(21, 4).astype(np.float32)
        np.testing.assert_allclose(eng.predict(x), net.output(x).numpy(),
                                   rtol=1e-5, atol=1e-6)

    def test_warmup_then_zero_recompiles(self, np_rng):
        net = port_mlp()
        eng = InferenceEngine(net, max_batch_size=16)
        warmed = eng.warmup([1, 2, 4, 8, 16])  # example inferred
        assert warmed == [1, 2, 4, 8, 16]
        assert eng.metrics.compiles == 5
        for n in (1, 2, 3, 5, 7, 11, 16):  # mixed request shapes
            eng.predict(np_rng.randn(n, 4).astype(np.float32))
        assert eng.metrics.compiles == 5  # steady state never captures
        assert eng.metrics.cache_hits >= 7

    def test_lru_cache_is_bounded(self, np_rng):
        net = port_mlp()
        eng = InferenceEngine(net, max_batch_size=16, cache_size=2)
        for n in (1, 2, 4, 8):  # four buckets through a 2-slot cache
            eng.predict(np_rng.randn(n, 4).astype(np.float32))
        assert len(eng._cache) <= 2
        assert eng.metrics.cache_evictions >= 2
        # an evicted bucket is captured again (correctly, not wrongly
        # served)
        x = np_rng.randn(1, 4).astype(np.float32)
        np.testing.assert_allclose(eng.predict(x), net.output(x).numpy(),
                                   rtol=1e-5)

    def test_samediff_raises_not_ported(self, np_rng):
        from deeplearning4j_tpu.autodiff import SameDiff
        sd = SameDiff.create()
        x = sd.placeholder("x", (None, 3))
        w = sd.var("w", value=np_rng.randn(3, 2).astype(np.float32))
        (x @ w).rename("out")
        with pytest.raises(NotImplementedError, match="item 15"):
            InferenceEngine(sd, default_outputs=["out"], max_batch_size=8)
        with pytest.raises(NotImplementedError, match="item 15"):
            export_stablehlo(sd, outputs=["out"])

    def test_computation_graph_raises_not_ported(self):
        from deeplearning4j_tpu.learning import Adam
        from deeplearning4j_tpu.nn import (ComputationGraph,
                                           NeuralNetConfiguration)
        from deeplearning4j_tpu.nn.conf import InputType
        from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
        conf = (NeuralNetConfiguration.builder().seed(0).updater(Adam(1e-2))
                .weight_init("xavier")
                .graph_builder()
                .add_inputs("in")
                .set_input_types(InputType.feed_forward(4))
                .add_layer("d", DenseLayer(n_out=8, activation="relu"), "in")
                .add_layer("out", OutputLayer(n_out=3, loss="mcxent",
                                              activation="softmax"), "d")
                .set_outputs("out").build())
        g = ComputationGraph(conf).init()
        from deeplearning4j_tpu.serving.engine import \
            InferenceEngine as JInferenceEngine
        from deeplearning4j_tpu_torch.convert import graph_params_from_jax
        from deeplearning4j_tpu_torch.nn import ComputationGraph as TGraph
        from deeplearning4j_tpu_torch.nn.graph import \
            ComputationGraphConfiguration
        tg = TGraph(ComputationGraphConfiguration.from_json(conf.to_json()),
                    device="cpu").init()
        tg.set_params(graph_params_from_jax(jax.tree.map(np.asarray,
                                                         g.params())))
        eng = InferenceEngine(tg, max_batch_size=8)
        x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
        want = JInferenceEngine(g, max_batch_size=8).predict(x)
        np.testing.assert_allclose(eng.predict(x), np.asarray(want),
                                   atol=1e-6)
        assert eng.metrics.compiles == 1

    def test_duck_model_fallback(self):
        eng = InferenceEngine(_Duck(), max_batch_size=8)
        out = eng.predict(np.ones((3, 2), np.float32))
        assert out.shape == (3, 2)
        assert eng.metrics.compiles == 0  # the duck kind has no cache
        assert eng.metrics.snapshot()["bucket_hist"] == {"4": 1}

    def test_serves_live_weights_after_fit(self, np_rng):
        # fit() updates the leaves in place: a fit after warmup is
        # visible on the next request, with no recapture
        net = port_mlp()
        eng = InferenceEngine(net, max_batch_size=8)
        eng.warmup([1, 2, 4, 8])
        x = np_rng.randn(3, 4).astype(np.float32)
        before = eng.predict(x)
        xt = np_rng.randn(64, 4).astype(np.float32)
        yt = np.eye(3, dtype=np.float32)[np_rng.randint(0, 3, 64)]
        net.fit([(xt, yt)], epochs=3)
        after = eng.predict(x)
        assert np.abs(before - after).max() > 1e-6
        np.testing.assert_allclose(after, net.output(x).numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert eng.metrics.compiles == 4  # still only the warmups

    def test_unknown_outputs_rejected_for_array_models(self, np_rng):
        eng = InferenceEngine(port_mlp(), max_batch_size=8)
        with pytest.raises(ClientError):
            eng.predict(np_rng.randn(1, 4).astype(np.float32),
                        outputs=["embedding"])
        with pytest.raises(ClientError, match="plain array"):
            eng.predict({"x": np_rng.randn(1, 4).tolist()})

    def test_batch_reducing_output_fails_loudly(self, np_rng):
        eng = InferenceEngine(_Reduce(), max_batch_size=8)
        with pytest.raises(ServingError, match="row-aligned"):
            eng.predict(np_rng.randn(3, 2).astype(np.float32))


class TestGraphEntries:
    """The card's per-bucket graph entries, run on the CPU through a
    stand-in capture (see the module doc)."""

    def test_counters_and_launches_as_the_eager_entries(self, monkeypatch,
                                                        np_rng):
        xs = [np_rng.randn(n, 4).astype(np.float32)
              for n in (1, 3, 5, 16, 2, 1, 9)]
        eager = InferenceEngine(port_mlp(), max_batch_size=16, cache_size=2)
        want = [eager.predict(x) for x in xs]
        captures = recording_graphs(
            monkeypatch, {"flash_attention.launches": 2})
        graphed = InferenceEngine(port_mlp(), max_batch_size=16,
                                  cache_size=2)
        before = launch_counts()["flash_attention.launches"]
        try:
            for x, w in zip(xs, want):
                np.testing.assert_allclose(graphed.predict(x), w, rtol=1e-6)
            assert all(isinstance(e, port_engine._Graph)
                       for e in graphed._cache.values())
        finally:
            added = launch_counts()["flash_attention.launches"] - before
            add_launches({"flash_attention.launches": -added})
        assert added == 2 * len(xs)    # one replay a call
        assert _counters(graphed) == _counters(eager)
        assert len(captures) == graphed.metrics.compiles

    @pytest.mark.parametrize("graphs", [False, True])
    def test_fit_then_set_params_are_served(self, monkeypatch, np_rng,
                                            graphs):
        captures = recording_graphs(monkeypatch) if graphs else []
        net = port_mlp()
        eng = InferenceEngine(net, max_batch_size=8)
        eng.warmup([1, 2, 4, 8])
        x = np_rng.randn(3, 4).astype(np.float32)
        before = eng.predict(x)
        xt = np_rng.randn(32, 4).astype(np.float32)
        yt = np.eye(3, dtype=np.float32)[np_rng.randint(0, 3, 32)]
        net.fit([(xt, yt)], epochs=2)
        after_fit = eng.predict(x)
        np.testing.assert_allclose(after_fit, net.output(x).numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert np.abs(after_fit - before).max() > 1e-6
        net.set_params(port_mlp(seed=7).params())   # every leaf replaced
        after_set = eng.predict(x)
        np.testing.assert_allclose(after_set, net.output(x).numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert np.abs(after_set - after_fit).max() > 1e-6
        assert eng.metrics.compiles == 4            # no counted capture
        # on the graph path the bucket served again captured once more
        assert len(captures) == (5 if graphs else 0)
        eng.predict(x)
        assert len(captures) == (5 if graphs else 0)

    def test_concurrent_callers_each_get_their_own_rows(self, monkeypatch):
        """An entry's static buffers are shared by every caller (the
        unbatched path calls the engine from each HTTP thread): under a
        shortened switch interval, more threads than cores each get
        their own rows back."""
        recording_graphs(monkeypatch)
        net = port_mlp()
        eng = InferenceEngine(net, max_batch_size=4)
        eng.warmup([4])
        rs = np.random.RandomState(3)
        xs = [rs.randn(4, 4).astype(np.float32) for _ in range(8)]
        wants = [net.output(x).numpy() for x in xs]
        n_threads = (os.cpu_count() or 1) + 4
        bad, done = [], []

        def client(t):
            for i in range(12):
                k = (t + i) % len(xs)
                if not np.allclose(eng.predict(xs[k]), wants[k], rtol=1e-6):
                    bad.append((t, i))
            done.append(t)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert len(done) == n_threads and not bad
        assert eng.metrics.compiles == 1

    def test_failed_capture_raises_and_caches_nothing(self, monkeypatch):
        def broken(run, engine, device):
            raise port_engine.ServingError("capturing the forward into a "
                                           "CUDA graph failed: boom")
        monkeypatch.setattr(port_engine, "_record", broken)
        monkeypatch.setattr(port_engine, "_Eager", port_engine._Graph)
        eng = InferenceEngine(port_mlp(), max_batch_size=4)
        with pytest.raises(ServingError, match="CUDA graph"):
            eng.predict(np.ones((1, 4), np.float32))
        assert not eng._cache and not eng._compiling
        assert eng.metrics.compiles == 0 and eng.metrics.cache_misses == 1


class TestLaunchCounting:
    """A capture tallies its own thread's launches only: a generation
    engine's loop launching beside it still counts, and each replay
    later adds the tally. Counts from several threads are not lost."""

    KEY = "decode_attention.launches"

    def test_capture_tallies_only_its_own_thread(self):
        before = launch_counts()[self.KEY]
        entered, go = threading.Event(), threading.Event()

        def other_thread():
            entered.wait()
            for _ in range(7):
                count_launch(self.KEY)
            go.set()
        t = threading.Thread(target=other_thread)
        t.start()
        try:
            with tally_launches() as tally:
                count_launch(self.KEY)
                entered.set()
                go.wait()
                count_launch(self.KEY)
            t.join()
            assert tally == {self.KEY: 2}
            assert launch_counts()[self.KEY] - before == 7
            add_launches(tally)                  # one replay
            assert launch_counts()[self.KEY] - before == 9
        finally:
            add_launches({self.KEY: before - launch_counts()[self.KEY]})

    def test_concurrent_counts_are_not_lost(self):
        before = launch_counts()[self.KEY]
        n_threads, n = 8, 2000

        def counting():
            for i in range(n):
                if i % 2:
                    count_launch(self.KEY)
                else:
                    add_launches({self.KEY: 1})
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=counting)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            sys.setswitchinterval(old)
        added = launch_counts()[self.KEY] - before
        add_launches({self.KEY: -added})
        assert added == n_threads * n


def test_capture_pauses_the_garbage_collector(monkeypatch):
    """A cyclic collection inside a capture could destroy a dead
    engine's CUDA graph, which the capture does not permit: the
    collector is off while ``run`` is captured, and back on after a
    capture that fails too. ``torch.cuda.graph`` is a stand-in here (no
    card)."""
    import contextlib
    import gc

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: "graph")
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    seen = []

    def run():
        seen.append(gc.isenabled())
        return "out"

    assert gc.isenabled()
    assert port_engine.capture_graph(run, "a test")[:2] == ("graph", "out")
    assert seen == [False] and gc.isenabled()

    def failing():
        seen.append(gc.isenabled())
        raise RuntimeError("capture invalidated")
    with pytest.raises(ServingError, match="a failing test"):
        port_engine.capture_graph(failing, "a failing test")
    assert seen == [False, False] and gc.isenabled()


class TestModelRegistry:
    """``tests/test_serving_runtime.py::TestModelRegistry``, mirrored."""

    def test_register_get_versions(self):
        reg = ModelRegistry()
        a1 = reg.register("m", port_mlp(seed=1), batching=False)
        a2 = reg.register("m", port_mlp(seed=2), batching=False)
        assert (a1.version, a2.version) == (1, 2)
        assert reg.get("m").version == 2           # latest wins
        assert reg.get("m", version=1) is a1
        with pytest.raises(ModelNotFound):
            reg.get("m", version=9)
        with pytest.raises(ModelNotFound):
            reg.get("ghost")
        reg.unregister("m", version=2)
        assert reg.get("m").version == 1
        reg.stop()

    def test_stats_keyed_by_name(self):
        reg = ModelRegistry()
        reg.register("a", port_mlp(), batching=False)
        reg.register("b", port_mlp(n_in=6), batching=False)
        assert sorted(reg.stats()) == ["a", "b"]
        assert reg.describe()["a"]["latest"] == 1
        reg.stop()

    def test_served_model_stats_keys_are_jaxs(self, np_rng):
        from deeplearning4j_tpu.serving import ModelRegistry as JaxRegistry
        jn, tn = net_pair(mlp_conf)
        jr, tr = JaxRegistry(), ModelRegistry()
        try:
            for reg, net in ((jr, jn), (tr, tn)):
                served = reg.register("m", net, batching=False)
                served.predict(np_rng.randn(2, 4).astype(np.float32))
            js, ts = jr.stats()["m"], tr.stats()["m"]
            assert set(ts) == set(js)
            for k, v in js.items():
                if isinstance(v, dict):
                    assert set(ts[k]) == set(v), k
            assert jr.summary() == tr.summary()
        finally:
            jr.stop()
            tr.stop()

    def test_bad_names_and_mode_collisions(self):
        reg = ModelRegistry()
        for bad in ("", "a/b", "a@1"):
            with pytest.raises(ValueError):
                reg.register(bad, port_mlp())
        reg.register("m", port_mlp(), batching=False)
        with pytest.raises(ValueError, match="already registered"):
            reg.register("m", port_mlp(), version=1, batching=False)
        reg.stop()


def test_serving_metrics_snapshot_keys_are_jaxs():
    """``ServingMetrics.snapshot()``'s key set, recursively, is the JAX
    class's, with every counter and histogram moved."""
    from deeplearning4j_tpu.serving.metrics import \
        ServingMetrics as JaxMetrics
    from deeplearning4j_tpu_torch.serving import ServingMetrics
    snaps = []
    for m in (JaxMetrics(), ServingMetrics()):
        for field in ("requests", "shed", "retries", "batches"):
            m.inc(field)
        m.batch_hist.record(3)
        m.bucket_hist.record(4)
        m.latency_ms.record(1.5)
        m.device_ms.record(0.5)
        m.warmed_buckets = [1, 2]
        snaps.append(m.snapshot())
    assert key_tree(snaps[1]) == key_tree(snaps[0])
    assert snaps[1] == snaps[0]


def test_carried_weights_are_the_jax_networks():
    """The parity above rests on the carried weights: the port's
    network holds exactly the JAX leaves."""
    jn, tn = net_pair(mlp_conf)
    want = network_params_from_jax(jax.tree.map(np.asarray, jn.params()))
    for k, p in want.items():
        for n, t in p.items():
            assert torch.equal(tn.params()[k][n].detach(), t)
