"""The zoo's conv-family models in the port against the JAX package's
(CPU), at the JAX zoo tests' sizes (``tests/test_zoo.py``): UNet 64x64,
Xception 71x71, NASNet 64x64 with two cells a stack, and Darknet19
64x64. For each: ``init`` from the zoo's seed equal to JAX's; every
node's forward on JAX's carried params; one training step; the
configuration's JSON read back by each package; JAX's archive restored
by the port. The port's archive is restored by JAX for a small graph
holding every new leaf (JAX's restore draws the whole model's init
again, 14-18 s on the CPU for UNet and NASNet;
``test_torch_serializer.py`` holds a sequential network's port archive
restored by JAX). One JAX
build per model, shared by a module fixture.

Tolerances, each with its reason:

- ``init``: within 8 f32 ulp of each weight (``random.normal`` is
  within 3 ulp of JAX's unit draw, and the He scale rounds each side
  once more);
- forward activations: 1e-4 of the node's largest |value| (up to ~90
  f32 convolutions and batch norms summed in another order);
- the step's gradient, taken in f64 on both sides: each leaf within
  1e-9 of its largest |value|. In f32 a training-mode batch-norm graph
  at random init is ill-conditioned in its gradients
  (``tests/test_torch_zoo_graph.py``: JAX's own ResNet gradient moves by
  up to 0.47 of a leaf's max under a 1e-7 relative move of the params),
  so f64 is what holds the gradient's math;
- the f32 step (Adam, as the zoo trains): the loss within 1e-4
  relative and the new running stats within 1e-4 of the leaf's largest
  |value|. Adam's m within 1e-3 of JAX's (a leaf's max) for UNet and
  Darknet19 (measured 2.4e-6 and 1.2e-4), and within 0.15 in L2 for
  Xception and NASNet (measured 0.017; a zeroed or halved leaf is 0.5
  away). Adam's first step moves an element by lr g / (|g| + eps), so
  an element whose f32 gradient flips sign moves 2 lr from JAX's: at
  most 1% of a model's elements may move more than lr apart (measured
  0.33% Xception, 0.006% NASNet, 0.0008% Darknet19, 0 UNet).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import zoo as JZ
from deeplearning4j_tpu.util.serializer import ModelSerializer as JSer
from deeplearning4j_tpu_torch import zoo as TZ
from deeplearning4j_tpu_torch.convert import (network_params_from_jax,
                                              network_state_from_jax,
                                              updater_state_from_jax)
from deeplearning4j_tpu_torch.nn import ComputationGraph
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

INIT_ULP = 8
ACT_TOL = 1e-4
GRAD64_TOL = 1e-9
LOSS_RTOL = 1e-4
STATE_TOL = 1e-4
M_TOL = 1e-3
L2_TOL = 0.15
MOVED_APART = 0.01

#: the deep batch-norm graphs, whose f32 training gradient at random
#: init is ill-conditioned: their gradient is held in f64
F64_GRADS = {"Xception", "NASNet"}

#: name -> (constructor kwargs, input shape), JAX's tests/test_zoo.py sizes
MODELS = {
    "UNet": (dict(input_shape=(64, 64, 3)), (64, 64, 3)),
    "Xception": (dict(num_classes=5, input_shape=(71, 71, 3)), (71, 71, 3)),
    "NASNet": (dict(num_classes=5, input_shape=(64, 64, 3), n_cells=2),
               (64, 64, 3)),
    "Darknet19": (dict(num_classes=6, input_shape=(64, 64, 3)),
                  (64, 64, 3)),
}


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-30)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models' draws and steps on one intra-op thread: the suite's
    workers share the CPU, and PyTorch's thread pool, oversubscribed
    there, runs the zoo's files several times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    name = request.param
    kw, shape = MODELS[name]
    jm = getattr(JZ, name)(**kw).init()
    tm = getattr(TZ, name)(device="cpu", **kw).init()
    return name, jm, tm, shape


def _batch(jm, shape, n=2, seed=1):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, *shape).astype(np.float32)
    out = np.asarray(jm.output(x))
    if out.ndim == 2:
        y = np.eye(out.shape[1], dtype=np.float32)[rs.randint(0, out.shape[1],
                                                              n)]
    else:                                          # UNet's mask
        y = (rs.rand(*out.shape) > 0.5).astype(np.float32)
    return x, y


def _graph(tm) -> bool:
    return isinstance(tm, ComputationGraph)


def _carry(jm, tm):
    tree = jax.tree.map(np.asarray, jm.params())
    tm.set_params(network_params_from_jax(tree))
    tm.set_net_state(network_state_from_jax(
        jax.tree.map(np.asarray, jm._net_state)))
    tm.set_updater_state(updater_state_from_jax(
        jax.tree.map(np.asarray, jm._opt_state)))


def test_init_is_jax_init(model):
    name, jm, tm, _ = model
    assert type(tm).__name__ == type(jm).__name__
    if _graph(tm):
        assert tm._order == jm._order
    assert tm.conf.to_json() == jm.conf.to_json()
    assert tm.num_params() == jm.num_params()
    for k, p in jm.params().items():
        for n, v in p.items():
            a, b = np.asarray(v), _np(tm.params()[k][n])
            assert np.all(np.abs(a - b) <= INIT_ULP * np.spacing(np.abs(a))), \
                (k, n)
    for k, st in jm._net_state.items():
        for n, v in st.items():
            assert np.array_equal(np.asarray(v), _np(tm.get_net_state()[k][n]))


def test_every_node_follows_jax(model):
    name, jm, tm, shape = model
    _carry(jm, tm)
    x = np.random.default_rng(0).normal(size=(2,) + shape).astype(np.float32)
    ja, ta = jm.feed_forward(x), tm.feed_forward(x)
    if _graph(tm):
        nodes = [n for n in tm._order if torch.is_tensor(ta[n])]
        assert len(nodes) > 20
        pairs = [(n, ta[n], ja[n]) for n in nodes]
    else:
        assert len(ta) == len(ja) == len(tm.layers) + 1
        pairs = [(i, t, j) for i, (t, j) in enumerate(zip(ta, ja))]
    for n, t, j in pairs:
        assert tuple(t.shape) == tuple(np.shape(j)), n
        assert _rel(t, j) <= ACT_TOL, n
    out, want = _np(tm.output(x)), np.asarray(jm.output(x))
    assert out.shape == want.shape and np.all(np.isfinite(out))
    assert np.abs(out - want).max() <= ACT_TOL * max(np.abs(want).max(), 1.0)


def _f64_grads(jm, tm, x, y):
    """Both packages' gradients of the training loss (no dropout), in
    f64."""
    graph = _graph(tm)
    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), tree)
        s64 = f64(jm._net_state)
        jx, jy = jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)
        if graph:
            def loss(p):
                return jm._loss_fn(p, s64, {"in": jx}, {"out": jy}, None,
                                   True, None)[0]
        else:
            def loss(p):
                return jm._loss_fn(p, s64, jx, jy, None, True, None)[0]
        want = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(
            f64(jm.params())))
    p64 = {k: {n: t.detach().double().requires_grad_(True)
               for n, t in p.items()} for k, p in tm.params().items()}
    s64 = {k: {n: t.double() for n, t in st.items()}
           for k, st in tm.get_net_state().items()}
    tx, ty = torch.from_numpy(x).double(), torch.from_numpy(y).double()
    if graph:
        loss = tm._loss_fn(p64, s64, {"in": tx}, {"out": ty}, None, True,
                           None)[0]
    else:
        loss = tm._loss_fn(p64, s64, tx, ty, None, True, None)[0]
    keys = [(k, n) for k, p in p64.items() for n in p]
    got = torch.autograd.grad(loss, [p64[k][n] for k, n in keys])
    return keys, got, want


def test_one_adam_step_follows_jax(model):
    name, jm, tm, shape = model
    _carry(jm, tm)
    x, y = _batch(jm, shape)
    if name in F64_GRADS:
        keys, got, want = _f64_grads(jm, tm, x, y)
        assert len(keys) == sum(len(p) for p in want.values())
        for (k, n), g in zip(keys, got):
            v = want[k][n]
            assert g.dtype == torch.float64 and v.dtype == np.float64
            assert np.abs(g.numpy() - v).max() <= \
                GRAD64_TOL * max(np.abs(v).max(), 1e-30), (k, n)
    before = jax.tree.map(np.asarray, jm.params())
    jm.fit(x, y)
    tm.fit(x, y)
    assert tm._step == jm._step == 1
    assert abs(tm.score_ - float(jm.score_)) <= \
        LOSS_RTOL * abs(float(jm.score_))
    after = jax.tree.map(np.asarray, jm.params())
    jopt = jax.tree.map(np.asarray, jm._opt_state)
    lr = 1e-3                                      # the zoo's Adam(1e-3)
    moved_apart = total = 0
    for k, st in jopt.items():
        for n, v in st["m"].items():
            m = tm.get_updater_state()[k]["m"][n]
            if name in F64_GRADS:
                assert _l2(m, v) <= L2_TOL, (k, n)
            else:
                assert _rel(m, v) <= M_TOL, (k, n)
            gap = np.abs((_np(tm.params()[k][n]) - before[k][n])
                         - (after[k][n] - before[k][n]))
            moved_apart += int((gap > lr).sum())
            total += gap.size
    assert moved_apart <= MOVED_APART * total
    for k, st in jm._net_state.items():
        for n, v in st.items():
            assert _rel(tm.get_net_state()[k][n], v) <= STATE_TOL, (k, n)


def test_configuration_round_trips_both_ways(model):
    """Each package reads the other's JSON of the model's configuration
    back to the same JSON: what restoring an archive parses."""
    name, jm, tm, _ = model
    jmod = __import__(type(jm.conf).__module__, fromlist=["x"])
    tmod = __import__(type(tm.conf).__module__, fromlist=["x"])
    text = jm.conf.to_json()
    assert getattr(tmod, type(tm.conf).__name__).from_json(text).to_json() \
        == text
    assert getattr(jmod, type(jm.conf).__name__).from_json(
        tm.conf.to_json()).to_json() == text


def test_archives_restore_across_packages(model, tmp_path):
    """JAX's archive of the model (params and layer state) restored by
    the port."""
    name, jm, tm, shape = model
    path = str(tmp_path / f"{name}.zip")
    JSer.write_model(jm, path, save_updater=False)
    back = ModelSerializer.restore(path, load_updater=False, device="cpu")
    assert type(back).__name__ == type(jm).__name__
    assert back.conf.to_json() == jm.conf.to_json()
    for k, p in jm.params().items():
        for n, v in p.items():
            assert np.array_equal(_np(back.params()[k][n]), np.asarray(v))
    for k, st in jm._net_state.items():
        for n, v in st.items():
            assert np.array_equal(_np(back.get_net_state()[k][n]),
                                  np.asarray(v))
    # the batch size JAX's forward already compiled for
    x = np.random.default_rng(3).random((2,) + shape).astype(np.float32)
    got, want = _np(back.output(x)), np.asarray(jm.output(x))
    assert np.abs(got - want).max() <= ACT_TOL * max(np.abs(want).max(), 1.0)


def _leaf_graph(N, L, C, I, U):
    """A graph with one of each conv-family layer that has params."""
    return (N.NeuralNetConfiguration.builder().seed(5)
            .updater(U.Adam(1e-2)).graph_builder()
            .add_inputs("in")
            .set_input_types(I.convolutional(8, 8, 3))
            .add_layer("dc", C.Deconvolution2D(n_out=4, kernel=(3, 3),
                                               stride=(2, 2),
                                               padding="same"), "in")
            .add_layer("dw", C.DepthwiseConvolution2D(depth_multiplier=2),
                       "dc")
            .add_layer("sep", C.SeparableConvolution2D(n_out=6,
                                                       stride=(2, 2)), "dw")
            .add_layer("pr", C.PReLULayer(alpha_init=0.1,
                                          shared_axes=[1, 2]), "sep")
            .add_layer("ew", C.ElementWiseMultiplicationLayer(), "pr")
            .add_layer("lc", C.LocallyConnected2D(n_out=3, kernel=(3, 2),
                                                  stride=(2, 2)), "ew")
            .add_layer("gp", L.GlobalPoolingLayer("avg"), "lc")
            .add_layer("out", L.OutputLayer(n_out=3), "gp")
            .set_outputs("out").build())


def test_graph_archive_of_every_new_leaf_cross_restores(tmp_path):
    """``dW``/``pW``, ``alpha``, ``w``, the deconvolution's ``W`` and
    LocallyConnected2D's [oh*ow, C*kh*kw, n_out] ``W`` and [oh, ow,
    n_out] ``b``: each package restores the other's archive, and
    ``convert.py``'s trees carry them across."""
    import deeplearning4j_tpu.learning as JU
    import deeplearning4j_tpu.nn as JN
    import deeplearning4j_tpu.nn.conf as JCf
    import deeplearning4j_tpu.nn.layers as JL
    import deeplearning4j_tpu.nn.layers.convolutional as JC
    import deeplearning4j_tpu_torch.learning as TU
    import deeplearning4j_tpu_torch.nn as TN
    import deeplearning4j_tpu_torch.nn.conf as TCf
    import deeplearning4j_tpu_torch.nn.layers as TL
    import deeplearning4j_tpu_torch.nn.layers.convolutional as TC
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    jg = JGraph(_leaf_graph(JN, JL, JC, JCf.InputType, JU)).init()
    tg = TN.ComputationGraph(_leaf_graph(TN, TL, TC, TCf.InputType, TU),
                             device="cpu").init()
    assert tg.conf.to_json() == jg.conf.to_json()
    assert {n: set(p) for n, p in tg.params().items()} == \
        {n: set(p) for n, p in jg.params().items()}
    assert tuple(tg.params()["lc"]["W"].shape) == (12, 36, 3)
    assert tuple(tg.params()["lc"]["b"].shape) == (3, 4, 3)
    rs = np.random.RandomState(6)
    x = rs.randn(4, 8, 8, 3).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 4)]
    jg.fit(x, y)
    tg.fit(x, y)
    pj, pt = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    JSer.write_model(jg, pj)
    ModelSerializer.write_model(tg, pt)
    jr = JSer.restore(pt)
    tr = ModelSerializer.restore(pj, device="cpu")
    for k, p in tg.params().items():
        for n, t in p.items():
            assert np.array_equal(np.asarray(jr.params()[k][n]), _np(t))
            assert np.array_equal(_np(tr.params()[k][n]),
                                  np.asarray(jg.params()[k][n]))
    carried = network_params_from_jax(jax.tree.map(np.asarray, jg.params()))
    tg.set_params(carried)
    assert _rel(tg.output(x), np.asarray(jg.output(x))) <= ACT_TOL
