"""The predict path's CUDA graphs on the card: the InferenceEngine's
per-bucket graphs against the network's own eager forward, live
weights, a lazy capture while a generation engine decodes, and a
failed capture; and a two-replica fleet (its tokens against one
replica's, and a rolling restart that loses nothing and leaks no device
memory).

Every test here carries the ``gpu`` marker and skips itself without a
CUDA device. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_serving_gpu.py

``chip_smoke.py`` phase 16 serves the same path at the served width, and
phase 17 the two-replica fleet that the last two tests run small.
"""
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import flash_attention as fa

pytestmark = pytest.mark.gpu

# softmax outputs of an f32 network: the graph's buckets run other GEMM
# shapes and the flash kernel's key groups follow the batch, so the
# last bits move; 1e-4 as chip_smoke.py's FLASH_TOL
TOL = 1e-4
T, V = 16, 64


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _classifier(seed=0, layers=2, cls=None):
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (GlobalPoolingLayer,
                                                    OutputLayer)
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        TransformerEncoderLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import \
        EmbeddingSequenceLayer
    b = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-2))
         .weight_init("xavier").list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=64)))
    for _ in range(layers):
        b = b.layer(TransformerEncoderLayer(n_heads=2, d_ff=256,
                                            causal=False))
    conf = (b.layer(GlobalPoolingLayer("avg"))
            .layer(OutputLayer(n_out=5, loss="mcxent", activation="softmax"))
            .input_type_recurrent(1, timesteps=T).build())
    return (cls or MultiLayerNetwork)(conf).init()


def _ids(rs, n):
    return rs.randint(0, V, (n, T)).astype(np.float32)


def _alone(net, x):
    return np.concatenate([net.output(row[None]).cpu().numpy()
                           for row in x])


def test_bucket_graphs_match_the_eager_forward():
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    _device()
    net = _classifier()
    eng = InferenceEngine(net, max_batch_size=8)
    assert eng.warmup([1, 2, 4, 8], example=np.zeros((1, T), np.float32)) \
        == [1, 2, 4, 8]
    assert eng.metrics.compiles == 4
    rs = np.random.RandomState(0)
    before = fa.launches
    for n in (1, 3, 8, 5, 2):
        x = _ids(rs, n)
        got = eng.predict(x)
        assert isinstance(got, np.ndarray) and got.shape == (n, 5)
        np.testing.assert_allclose(got, _alone(net, x), atol=TOL)
    # each replay counts one flash forward a layer; the references
    # above count their own (one a row and layer)
    assert fa.launches - before == 2 * 5 + 2 * (1 + 3 + 8 + 5 + 2)
    assert eng.metrics.compiles == 4 and eng.metrics.cache_hits == 5


def test_fit_and_set_params_are_served_without_a_counted_capture():
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    dev = _device()
    net = _classifier()
    eng = InferenceEngine(net, max_batch_size=4)
    eng.warmup([1, 4], example=np.zeros((1, T), np.float32))
    rs = np.random.RandomState(1)
    x = _ids(rs, 3)
    before = eng.predict(x)
    y = torch.zeros((4, 5), device=dev)
    y[torch.arange(4), torch.arange(4)] = 1.0
    net.fit(_ids(rs, 4), y)
    after_fit = eng.predict(x)
    np.testing.assert_allclose(after_fit, _alone(net, x), atol=TOL)
    assert np.abs(after_fit - before).max() > 10 * TOL
    net.set_params(_classifier(seed=3).params())
    after_set = eng.predict(x)
    np.testing.assert_allclose(after_set, _alone(net, x), atol=TOL)
    assert np.abs(after_set - after_fit).max() > 10 * TOL
    assert eng.metrics.compiles == 2


def test_lazy_capture_beside_live_generation():
    """Predict misses capture their buckets (on a side stream, in
    thread-local mode) while a generation engine's loop replays its
    decode graph: both answers stay right, and each side's launches
    count as its own (a capture tallies its own thread's launches
    only)."""
    from deeplearning4j_tpu_torch.serving import InferenceServer
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    _device()
    lm = CausalTransformerLM(vocab_size=V, d_model=64, n_layers=2,
                             n_heads=2, max_seq_len=256, seed=0).init()
    net = _classifier()
    srv = InferenceServer(port=0)
    try:
        gen = srv.register_generator("lm", lm, num_slots=4)
        gen.warmup()
        served = srv.register("cls", net, max_batch_size=8)
        prompts = [[1 + i, 7, 3, 9] for i in range(4)]

        def start():
            streams = [gen.stream(p, max_tokens=200) for p in prompts]
            return streams, [next(s) for s in streams]  # all decoding

        def tokens(streams, first):
            return [[f["token"]] + [item["token"] for item in s
                                    if "token" in item]
                    for f, s in zip(first, streams)]
        quiet = tokens(*start())     # the loop is idle again after it
        before = kernels.launch_counts()
        steps, prefills = (gen.engine.metrics.decode_steps,
                           gen.engine.metrics.prefills)
        streams, first = start()
        rs = np.random.RandomState(2)
        xs = [_ids(rs, n) for n in (1, 2, 3, 5, 8, 4)]
        outs, errors = [None] * len(xs), []

        def client(i):
            try:
                outs[i] = served.predict(xs[i])
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        toks = tokens(streams, first)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert not errors, errors
        # B1: a launch a layer and decode step; B3: a launch a layer and
        # prefill, and for the classifier a layer and device call (each
        # capture's eager warm call, then one replay a call)
        steps = gen.engine.metrics.decode_steps - steps
        prefills = gen.engine.metrics.prefills - prefills
        calls = served.metrics.compiles + served.metrics.bucket_hist.total()
        assert after["decode_attention.launches"] \
            - before["decode_attention.launches"] == 2 * steps
        assert after["flash_attention.launches"] \
            - before["flash_attention.launches"] == 2 * prefills + 2 * calls
        assert steps >= 199 and prefills >= 1
        assert toks == quiet and all(len(t) == 200 for t in toks)
        for x, out in zip(xs, outs):
            np.testing.assert_allclose(out, _alone(net, x), atol=TOL)
        assert served.metrics.compiles >= 1
        assert gen.stats()["compile_cache"]["compiles"] == \
            len(gen.engine.graph_plan())            # nothing recaptured
    finally:
        srv.stop()


def test_failed_capture_raises_and_caches_nothing():
    """A forward that syncs the host cannot be captured: the request
    raises ServingError naming the CUDA graph, with no eager fallback
    and nothing cached. Last in the file: the card's state after a
    failed capture is not the other tests' business."""
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import InferenceEngine, ServingError
    _device()

    class Syncing(MultiLayerNetwork):
        def _forward(self, params, x, train, upto=None, fmask=None):
            out = super()._forward(params, x, train, upto, fmask)
            if not bool(torch.isfinite(out).all()):   # a host sync
                raise AssertionError("non-finite output")
            return out

    eng = InferenceEngine(_classifier(cls=Syncing), max_batch_size=4)
    with pytest.raises(ServingError, match="CUDA graph"):
        eng.predict(np.zeros((2, T), np.float32))
    assert not eng._cache and eng.metrics.compiles == 0


def _fleet_lm():
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    return CausalTransformerLM(vocab_size=256, d_model=64, n_layers=2,
                               n_heads=2, max_seq_len=128, seed=0).init()


#: a replica's generators: "lm" on slots, "plm" on the paged pool
_FLEET_GENS = (("lm", dict(num_slots=8, prompt_buckets=[16, 32])),
               ("plm", dict(num_slots=8, cache="paged", block_size=8,
                            num_blocks=128, prefill_chunk_tokens=32)))
_FLEET_REQS = [dict(prompt=list(range(1 + i, 9 + 3 * i)), max_tokens=12,
                    seed=i, temperature=0.7 if i % 3 == 2 else 0.0,
                    top_k=8) for i in range(6)]


def _fleet_factory(lm):
    from deeplearning4j_tpu_torch.serving import InferenceServer

    def factory():
        srv = InferenceServer(port=0)
        for name, kw in _FLEET_GENS:
            srv.register_generator(name, lm, **kw).warmup()
        return srv
    return factory


def _through(router, reqs, name):
    out = [None] * len(reqs)

    def go(i):
        if i % 2:
            out[i] = [x["token"] for x in router.stream(
                f"/v1/models/{name}/generate", reqs[i]) if "token" in x]
        else:
            st, body = router.post(f"/v1/models/{name}/generate", reqs[i])
            assert st == 200, body
            out[i] = body["tokens"]
    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(reqs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out


def test_two_replica_fleet_tokens_equal_a_single_replica():
    from deeplearning4j_tpu_torch.serving import FleetRouter, ReplicaFleet
    _device()
    lm = _fleet_lm()
    factory = _fleet_factory(lm)
    single = factory()
    try:
        want = {name: [single.registry.get(name).generate(
            timeout_ms=120_000, **q)["tokens"] for q in _FLEET_REQS]
            for name, _ in _FLEET_GENS}
    finally:
        single.stop()
    fleet = ReplicaFleet(poll_interval_s=0.05)
    router = FleetRouter(fleet)
    try:
        for _ in range(2):
            fleet.add(factory(), factory=factory)
        for name, _ in _FLEET_GENS:
            assert _through(router, _FLEET_REQS, name) == want[name]
        assert min(r.routed for r in fleet.replicas()) >= 1
        m = fleet.metrics
        assert m.requests_lost == 0 and m.server_errors == 0
        for rep in fleet.replicas():
            for name, _ in _FLEET_GENS:
                eng = rep.server.registry.get(name).engine
                assert eng.stats()["compile_cache"]["compiles"] == \
                    len(eng.graph_plan())
    finally:
        router.stop()
        fleet.stop(stop_replicas=True)


def test_rolling_restart_loses_nothing_and_leaks_no_memory():
    import gc
    from deeplearning4j_tpu_torch.serving import FleetRouter, ReplicaFleet
    _device()
    lm = _fleet_lm()
    factory = _fleet_factory(lm)
    fleet = ReplicaFleet(poll_interval_s=0.05)
    router = FleetRouter(fleet)
    reqs = [dict(q, temperature=0.0) for q in _FLEET_REQS]
    try:
        for _ in range(2):
            fleet.add(factory(), factory=factory)
        want = _through(router, reqs, "lm")

        def memory():
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            return torch.cuda.memory_allocated()
        mem0 = memory()
        stop, got, errors = threading.Event(), [], []

        def client(i):
            while not stop.is_set():
                try:
                    st, body = router.post("/v1/models/lm/generate",
                                           reqs[i])
                    got.append((i, st, body.get("tokens")))
                except Exception as e:  # noqa: BLE001 — asserted below
                    errors.append(repr(e))
        ts = [threading.Thread(target=client, args=(i,))
              for i in range(len(reqs))]
        for t in ts:
            t.start()
        try:
            assert fleet.rolling_restart(drain_timeout_s=60.0,
                                         ready_timeout_s=120.0)
        finally:
            stop.set()
            for t in ts:
                t.join()
        mem1 = memory()
        assert not errors, errors[:3]
        assert got and all(st == 200 and toks == want[i]
                           for i, st, toks in got)
        assert fleet.metrics.restarts == 2
        assert fleet.metrics.requests_lost == 0
        assert abs(mem1 - mem0) <= 0.05 * mem0, (mem0, mem1)
    finally:
        router.stop()
        fleet.stop(stop_replicas=True)
