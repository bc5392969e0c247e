"""The port's gradient compression (``parallel/compression.py``) against
the JAX package's, on numpy inputs from a seed (CPU): the host codec,
top-k, the in-step Strom encodes, the adaptive threshold rule and the
three classes (``EncodingHandler``, ``LoopbackBus``,
``EncodedGradientsAccumulator``), after the primitive cases of
``tests/test_gradient_sharing.py``. Every result is compared bit for
bit: the port runs the same f32 operations in the same order."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import compression as J
from deeplearning4j_tpu_torch.parallel import compression as P

SHAPES = [(7,), (5, 3), (4, 3, 2)]
THRESHOLDS = [1e-3, 0.05, 0.4]


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("thr", THRESHOLDS)
def test_threshold_codec_matches_jax(shape, thr):
    u = _rand(shape, 1, 0.3)
    enc, res = P.threshold_encode(u, thr)
    jenc, jres = J.threshold_encode(u, thr)
    assert enc.dtype == jenc.dtype == np.int64
    assert np.array_equal(enc, jenc) and np.array_equal(res, jres)
    out = _rand(shape, 2)
    dec = P.threshold_decode(enc, shape, thr, out.copy())
    jdec = J.threshold_decode(jenc, shape, thr, out.copy())
    assert np.array_equal(dec, jdec)
    assert np.array_equal(P.threshold_decode(enc, shape, thr),
                          J.threshold_decode(jenc, shape, thr))
    # error feedback: decoded + residual is the update
    np.testing.assert_allclose(P.threshold_decode(enc, shape, thr) + res,
                               u, atol=1e-6)


@pytest.mark.parametrize("k", [1, 3, 6])
def test_topk_matches_jax(k):
    u = _rand((3, 4), 3)
    idx, vals, res = P.topk_encode(torch.from_numpy(u), k)
    jidx, jvals, jres = J.topk_encode(jnp.asarray(u), k)
    assert idx.dtype == torch.int32
    assert np.array_equal(_np(idx), np.asarray(jidx))
    assert np.array_equal(_np(vals), np.asarray(jvals))
    assert np.array_equal(_np(res), np.asarray(jres))
    dec = P.topk_decode(idx, vals, (3, 4))
    assert np.array_equal(_np(dec), np.asarray(J.topk_decode(jidx, jvals,
                                                             (3, 4))))


@pytest.mark.parametrize("name", ["strom_encode_decode",
                                  "strom_value_encode_decode"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("thr", THRESHOLDS)
def test_strom_matches_jax(name, shape, thr):
    u, r = _rand(shape, 4, 0.2), _rand(shape, 5, 0.05)
    t = np.float32(thr)
    dec, res = getattr(P, name)(torch.from_numpy(u), torch.from_numpy(r),
                                torch.tensor(t))
    jdec, jres = getattr(J, name)(jnp.asarray(u), jnp.asarray(r),
                                  jnp.asarray(t))
    assert np.array_equal(_np(dec), np.asarray(jdec))
    assert np.array_equal(_np(res), np.asarray(jres))


def test_strom_primitives():
    """tests/test_gradient_sharing.py's TestStromPrimitives on the port."""
    dec, res = P.strom_encode_decode(
        torch.tensor([0.5, -0.3, 0.05, 0.0, -2.0]), torch.zeros(5), 0.1)
    np.testing.assert_allclose(_np(dec), [0.1, -0.1, 0.0, 0.0, -0.1],
                               atol=1e-7)
    u, r, fired = torch.full((1,), 0.03), torch.zeros(1), 0.0
    for _ in range(4):
        d, r = P.strom_encode_decode(u, r, 0.1)
        fired += float(d[0])
    assert fired > 0.0 and abs(4 * 0.03 - (fired + float(r[0]))) < 1e-6
    dec, _ = P.strom_value_encode_decode(
        torch.tensor([0.5, -0.3, 0.05, 0.0, -2.0]), torch.zeros(5), 0.1)
    np.testing.assert_allclose(_np(dec), [0.5, -0.3, 0.0, 0.0, -2.0],
                               atol=1e-7)


@pytest.mark.parametrize("sparsity", [0.5, 5e-3, 1e-6, 1e-2, 1e-4])
@pytest.mark.parametrize("t", [1e-3, 0.37])
def test_adapt_threshold_matches_jax(sparsity, t):
    thr, sp = np.float32(t), np.float32(sparsity)
    got = P.adapt_threshold(torch.tensor(thr), torch.tensor(sp))
    want = J.adapt_threshold(jnp.asarray(thr), jnp.asarray(sp))
    assert got.dtype == torch.float32
    assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("band", [(1e-4, 1e-2), (0.2, 0.4)])
def test_encoding_handler_matches_jax(band):
    h = P.EncodingHandler(threshold=1e-3, min_sparsity=band[0],
                          max_sparsity=band[1])
    jh = J.EncodingHandler(threshold=1e-3, min_sparsity=band[0],
                           max_sparsity=band[1])
    for step in range(4):
        u = _rand((6, 5), 10 + step, 0.1)
        enc, jenc = h.encode(u), jh.encode(u)
        assert np.array_equal(enc, jenc), step
        assert h.threshold == jh.threshold
        assert h.last_sparsity == jh.last_sparsity
        assert np.array_equal(h.residual(), jh.residual())


def test_loopback_bus_fans_out_exactly_once():
    for mod in (P, J):
        bus = mod.LoopbackBus()
        for n in range(3):
            bus.register(n)
        bus.broadcast(0, "a")
        bus.broadcast(2, "b")
        assert bus.drain(1) == [(0, "a"), (2, "b")]
        assert bus.drain(0) == [(2, "b")] and bus.drain(2) == [(0, "a")]
        assert bus.drain(1) == []


def test_loopback_bus_under_threads():
    bus = P.LoopbackBus()
    for n in range(4):
        bus.register(n)

    def send(n):
        for i in range(200):
            bus.broadcast(n, i)
    threads = [threading.Thread(target=send, args=(n,)) for n in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for n in range(4):
        assert len(bus.drain(n)) == 3 * 200


def test_encoded_gradients_accumulator_matches_jax():
    shapes = {"W": (4, 3), "b": (3,)}
    sides = []
    for mod in (P, J):
        bus = mod.LoopbackBus()
        accs = [mod.EncodedGradientsAccumulator(i, bus, shapes,
                                                threshold=0.05)
                for i in range(3)]
        outs = []
        for step in range(3):
            for i, a in enumerate(accs):
                a.store_update({k: _rand(s, 100 * step + 10 * i, 0.1)
                                for k, s in shapes.items()})
            outs.append([a.apply_update({k: np.zeros(s, np.float32)
                                         for k, s in shapes.items()})
                         for a in accs])
        sides.append((outs, [{k: (h.threshold, h.residual())
                              for k, h in a.handlers.items()}
                             for a in accs]))
    (outs, hs), (jouts, jhs) = sides
    for step, (o, jo) in enumerate(zip(outs, jouts)):
        for a, ja in zip(o, jo):
            for k in shapes:
                assert np.array_equal(a[k], ja[k]), (step, k)
    for h, jh in zip(hs, jhs):
        for k in shapes:
            assert h[k][0] == jh[k][0]
            assert np.array_equal(h[k][1], jh[k][1])
