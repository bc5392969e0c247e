"""The zoo's graphs in the port against the JAX package's (CPU): ResNet50
at full depth on 32x32 images (one forward, one Adam step), and
InceptionResNetV1, FaceNetNN4Small2 and SqueezeNet forward at the JAX
zoo tests' small inputs. One JAX build per model, shared by a module
fixture. Tolerances, each with its reason:

- ``init`` from the zoo's seed: within 8 f32 ulp of each weight
  (``random.normal`` is within 3 ulp of JAX's unit draw, and the scale
  by the He std rounds each side once more);
- forward activations: 1e-4 of the node's largest |value| (53 f32
  convolutions and batch norms summed in another order);
- the step's gradient (JAX's params carried across, 16 images), taken
  in f64 on both sides: each leaf within 1e-9 of its largest |value|
  (measured 7e-13). In f32 a training-mode ResNet at random init is
  ill-conditioned in its gradients: JAX's own f32 gradient moves by a
  median 4.2% and up to 5.1% of a leaf's L2 norm (0.47 of its largest
  |value|) when the params move by 1e-7 relative; a larger input does
  not cure it (0.22 of the largest |value| at 64x64, 0.30 at 64
  images). So f64 is what holds the gradient's math;
- the f32 step: the loss within 1e-4 relative, the new running stats
  within 1e-4 of the leaf's largest |value|, Adam's m equal to 0.1 of
  the port's own f32 gradient (1e-6 of the leaf's max) and within 0.15
  of JAX's m in L2 (3x the most JAX's own gradient moves), which a
  zeroed or halved leaf fails.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import zoo as JZ
from deeplearning4j_tpu_torch import zoo as TZ
from deeplearning4j_tpu_torch.convert import (graph_params_from_jax,
                                              graph_state_from_jax,
                                              graph_updater_state_from_jax)
from deeplearning4j_tpu_torch.nn import ComputationGraph

ACT_TOL = 1e-4
LOSS_RTOL = 1e-4
STATE_TOL = 1e-4
GRAD64_TOL = 1e-9
M_SELF_TOL = 1e-6
M_L2_TOL = 0.15


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models' ~25 M-param draws and steps on one intra-op thread:
    the suite's six workers share the CPU, and PyTorch's thread pool,
    oversubscribed there, ran this file 3.4x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(name, **kw):
    jm = getattr(JZ, name)(**kw).init()
    tm = getattr(TZ, name)(device="cpu", **kw).init()
    return jm, tm


@pytest.fixture(scope="module")
def resnet():
    return _build("ResNet50", num_classes=9, input_shape=(32, 32, 3))


@pytest.fixture(scope="module")
def inception():
    return _build("InceptionResNetV1", num_classes=8,
                  input_shape=(96, 96, 3))


@pytest.fixture(scope="module")
def facenet():
    return _build("FaceNetNN4Small2", num_classes=8, input_shape=(96, 96, 3))


@pytest.fixture(scope="module")
def squeezenet():
    return _build("SqueezeNet", num_classes=5, input_shape=(67, 67, 3))


def test_all_sixteen_names():
    assert len(TZ.ALL_MODELS) == 16
    assert [m.name for m in TZ.ALL_MODELS] == [m.name for m in JZ.ALL_MODELS]
    for t, j in zip(TZ.ALL_MODELS, JZ.ALL_MODELS):
        assert t.__name__ == j.__name__
        assert tuple(getattr(t, "input_shape", ())) == tuple(
            getattr(j, "input_shape", ()))


class _ConfJson:
    """Stands in for a network class: ``init()`` returns the built
    configuration's JSON (no params are drawn)."""

    def __init__(self, conf, device=None):
        self.conf = conf

    def init(self):
        return self.conf.to_json()


@pytest.mark.parametrize("name", ["TinyYOLO", "YOLO2"])
def test_models_whose_layers_wait_raise(name, monkeypatch):
    """The detectors' layers are ported: their configurations build and
    equal JAX's (their params and steps: tests/test_torch_zoo_yolo.py)."""
    import deeplearning4j_tpu.nn.graph as jgraph
    import deeplearning4j_tpu.zoo.simple as jsimple
    monkeypatch.setattr(jsimple, "MultiLayerNetwork", _ConfJson)
    monkeypatch.setattr(jgraph, "ComputationGraph", _ConfJson)
    tm = getattr(TZ, name)(device="cpu", input_shape=(32, 32, 3))
    monkeypatch.setattr(tm, "_net", lambda conf: conf.to_json())
    monkeypatch.setattr(tm, "_graph", lambda conf: conf.to_json())
    text = tm.init()
    assert text == getattr(JZ, name)(input_shape=(32, 32, 3)).init()
    assert '"yolo2output"' in text


def _same_init(jm, tm):
    assert isinstance(tm, ComputationGraph)
    assert tm._order == jm._order
    assert tm.conf.to_json() == jm.conf.to_json()
    assert tm.num_params() == jm.num_params()
    for k, p in jm.params().items():
        for n, v in p.items():
            a, b = np.asarray(v), _np(tm.params()[k][n])
            assert np.all(np.abs(a - b) <= 8 * np.spacing(np.abs(a))), (k, n)
    for k, st in jm._net_state.items():
        for n, v in st.items():
            assert np.array_equal(np.asarray(v), _np(tm.get_net_state()[k][n]))


def _carry(jm, tm):
    tm.set_params(graph_params_from_jax(jax.tree.map(np.asarray,
                                                     jm.params())))
    tm.set_net_state(graph_state_from_jax(jax.tree.map(np.asarray,
                                                       jm._net_state)))
    tm.set_updater_state(graph_updater_state_from_jax(
        jax.tree.map(np.asarray, jm._opt_state)))


def _same_forward(jm, tm, shape, nodes, batch=2):
    x = np.random.default_rng(0).normal(size=(batch,) + shape).astype(
        np.float32)
    ja, ta = jm.feed_forward(x), tm.feed_forward(x)
    for n in nodes:
        assert _rel(ta[n], ja[n]) <= ACT_TOL, n
    out, want = _np(tm.output(x)), np.asarray(jm.output(x))
    assert out.shape == want.shape and np.all(np.isfinite(out))
    assert np.abs(out - want).max() <= ACT_TOL


def test_resnet50_init_is_jax_init(resnet):
    jm, tm = resnet
    _same_init(jm, tm)
    # the bottleneck stages at full depth: 53 convolutions
    convs = [n for n, node in tm.conf.nodes.items()
             if node.layer is not None and node.layer.kind == "conv2d"]
    assert len(convs) == 53 and tm.num_params() > 20_000_000


def test_resnet50_forward_follows_jax(resnet):
    jm, tm = resnet
    _carry(jm, tm)
    _same_forward(jm, tm, (32, 32, 3),
                  ["stem", "stem_pool", "s0b0", "s1b3", "s2b5", "s3b2",
                   "avgpool"])


def _l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-30)


def test_resnet50_one_adam_step_follows_jax(resnet):
    jm, tm = resnet
    _carry(jm, tm)
    rs = np.random.RandomState(1)
    x = rs.randn(16, 32, 32, 3).astype(np.float32)
    y = np.eye(9, dtype=np.float32)[rs.randint(0, 9, 16)]
    jnp = jax.numpy
    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), tree)
        s64 = f64(jm._net_state)
        want = jax.tree.map(np.asarray, jax.jit(jax.grad(
            lambda p: jm._loss_fn(p, s64, {"in": jnp.asarray(x, jnp.float64)},
                                  {"out": jnp.asarray(y, jnp.float64)},
                                  None, True, None)[0]))(f64(jm.params())))
    p64 = {k: {n: t.detach().double().requires_grad_(True)
               for n, t in p.items()} for k, p in tm.params().items()}
    s64 = {k: {n: t.double() for n, t in st.items()}
           for k, st in tm.get_net_state().items()}
    keys = [(k, n) for k, p in p64.items() for n in p]
    loss = tm._loss_fn(p64, s64, {"in": torch.from_numpy(x).double()},
                       {"out": torch.from_numpy(y).double()}, None, True,
                       None)[0]
    got = torch.autograd.grad(loss, [p64[k][n] for k, n in keys])
    assert len(keys) == sum(len(p) for p in want.values())
    for (k, n), g in zip(keys, got):
        v = want[k][n]
        assert g.dtype == torch.float64 and v.dtype == np.float64
        assert np.abs(g.numpy() - v).max() <= \
            GRAD64_TOL * np.abs(v).max(), (k, n)
    _, g32, _, _ = tm._grads(tm._as_inputs(x), tm._as_labels(y), None, None)
    jm.fit(x, y)
    tm.fit(x, y)
    assert tm._step == jm._step == 1
    assert abs(tm.score_ - float(jm.score_)) <= \
        LOSS_RTOL * abs(float(jm.score_))
    jopt = jax.tree.map(np.asarray, jm._opt_state)
    for k, st in jopt.items():
        for n, v in st["m"].items():
            m = tm.get_updater_state()[k]["m"][n]
            assert _rel(m, 0.1 * _np(g32[k][n])) <= M_SELF_TOL, (k, n)
            assert _l2(m, v) <= M_L2_TOL, (k, n)
    for k, st in jm._net_state.items():
        for n, v in st.items():
            assert _rel(tm.get_net_state()[k][n], v) <= STATE_TOL, (k, n)


def test_inception_resnet_v1_forward_follows_jax(inception):
    jm, tm = inception
    _same_init(jm, tm)
    _carry(jm, tm)
    _same_forward(jm, tm, (96, 96, 3),
                  ["stem6", "a4", "redA", "b9", "redB", "c4", "embeddings"])


def test_facenet_nn4_small2_forward_follows_jax(facenet):
    jm, tm = facenet
    _same_init(jm, tm)
    _carry(jm, tm)
    _same_forward(jm, tm, (96, 96, 3),
                  ["p2", "i3a", "i3c", "i4e", "i5b", "embeddings"])


def test_squeezenet_forward_follows_jax(squeezenet):
    jm, tm = squeezenet
    _same_init(jm, tm)
    _carry(jm, tm)
    _same_forward(jm, tm, (67, 67, 3), ["p1", "f3", "f5", "f9", "avgpool"])
