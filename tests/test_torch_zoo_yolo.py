"""The zoo's detectors in the port against the JAX package's (CPU):
TinyYOLO (a MultiLayerNetwork) and YOLO2 (a ComputationGraph, its
passthrough through ``SpaceToDepthLayer`` and a ``MergeVertex``) at
64x64 inputs, at the zoo's widths. For each: ``init`` from the zoo's
seed equal to JAX's; every node's forward on JAX's carried params; one
Adam step on YOLO labels drawn from a seed; the configuration's JSON
read back by each package; an archive each package restores from the
other's. One build per model and package, shared by a module fixture.

Tolerances, each with its reason:

- ``init``: within 8 f32 ulp of each weight (``random.normal`` is
  within 3 ulp of JAX's unit draw, and the He scale rounds each side
  once more);
- forward activations: 1e-4 of the node's largest |value| (up to 23
  f32 convolutions and batch norms summed in another order);
- the step's gradient, taken in f64 on both sides: each leaf within
  1e-9 of its largest |value|. Both are batch-norm stacks at random
  init, whose f32 training gradient is ill-conditioned
  (``tests/test_torch_zoo_graph.py``), so f64 holds the gradient's math;
- the f32 step (Adam, as the zoo trains): the loss within 1e-4
  relative, the new running stats within 1e-4 of the leaf's largest
  |value|, Adam's m within 0.15 of JAX's in L2 (a zeroed or halved leaf
  is 0.5 away), and at most 1% of the elements moved more than lr apart
  (an element whose f32 gradient flips sign moves 2 lr from JAX's).
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
L2_TOL = 0.15
MOVED_APART = 0.01
INIT_THREADS = 4   # the port's threefry draws of YOLO2's 67 M params (at
#                    init and in restore, which draws the init first)

#: name -> constructor kwargs; the input is 64x64x3 (a 2x2 grid)
MODELS = {
    "TinyYOLO": dict(num_classes=3, input_shape=(64, 64, 3)),
    "YOLO2": dict(num_classes=4, input_shape=(64, 64, 3)),
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
    """The steps on one intra-op thread: the suite's workers share the
    CPU, and PyTorch's oversubscribed thread pool runs the zoo's files
    several times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    name = request.param
    kw = MODELS[name]
    jm = getattr(JZ, name)(**kw).init()
    n = torch.get_num_threads()
    torch.set_num_threads(INIT_THREADS)
    try:
        tm = getattr(TZ, name)(device="cpu", **kw).init()
    finally:
        torch.set_num_threads(n)
    return name, jm, tm, kw["input_shape"]


def _graph(tm) -> bool:
    return isinstance(tm, ComputationGraph)


def _yolo_labels(shape, anchors, classes, seed, objects=(1, 3)):
    """YOLO labels from a seed: a few objects an image, each in one cell
    and one anchor, xy in (0, 1), wh > 0, a one-hot class and
    confidence 1."""
    rs = np.random.RandomState(seed)
    y = np.zeros(shape, np.float32)
    B, H, W = shape[:3]
    for b in range(B):
        for _ in range(rs.randint(objects[0], objects[1] + 1)):
            i, j, a = rs.randint(H), rs.randint(W), rs.randint(anchors)
            s = a * (5 + classes)
            y[b, i, j, s:s + 2] = rs.uniform(0.05, 0.95, 2)
            y[b, i, j, s + 2:s + 4] = rs.uniform(0.3, 4.0, 2)
            y[b, i, j, s + 4] = 1.0
            y[b, i, j, s + 5 + rs.randint(classes)] = 1.0
    return y


def _batch(name, jm, shape, n=2, seed=1):
    x = np.random.RandomState(seed).rand(n, *shape).astype(np.float32)
    out_shape = np.shape(jm.output(x))
    zoo = getattr(JZ, name)
    return x, _yolo_labels(out_shape, len(zoo.anchors),
                           MODELS[name]["num_classes"], seed + 1)


def _carry(jm, tm):
    tm.set_params(network_params_from_jax(jax.tree.map(np.asarray,
                                                       jm.params())))
    tm.set_net_state(network_state_from_jax(
        jax.tree.map(np.asarray, jm._net_state)))
    tm.set_updater_state(updater_state_from_jax(
        jax.tree.map(np.asarray, jm._opt_state)))


def test_init_is_jax_init(model):
    name, jm, tm, shape = model
    assert type(tm).__name__ == type(jm).__name__
    assert _graph(tm) == (name == "YOLO2")
    if _graph(tm):
        assert tm._order == jm._order
        assert "reorg" in tm._order and "route" in tm._order
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
        assert len(nodes) > 40
        pairs = [(n, ta[n], ja[n]) for n in nodes]
    else:
        assert len(ta) == len(ja) == len(tm.layers) + 1
        pairs = [(i, t, j) for i, (t, j) in enumerate(zip(ta, ja))]
    for n, t, j in pairs:
        assert tuple(t.shape) == tuple(np.shape(j)), n
        assert _rel(t, j) <= ACT_TOL, n
    out, want = _np(tm.output(x)), np.asarray(jm.output(x))
    A = len(getattr(TZ, name).anchors)
    assert out.shape == want.shape == (2, 2, 2,
                                       A * (5 + MODELS[name]["num_classes"]))
    assert np.all(np.isfinite(out))
    assert np.abs(out - want).max() <= ACT_TOL * max(np.abs(want).max(), 1.0)


def _f64_grads(jm, tm, x, y):
    """Both packages' gradients of the training loss in f64: the forward
    up to the head and the YOLO loss on its f64 features (the networks'
    ``_loss_fn`` casts the head's input to f32)."""
    graph = _graph(tm)
    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), tree)
        s64 = f64(jm._net_state)
        jx, jy = jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)
        if graph:
            def loss(p):
                acts = jm._forward(p, s64, {"in": jx}, True, None)[0]
                return jm.conf.nodes["yolo"].layer.compute_loss(
                    {}, acts["pred"], jy)
        else:
            def loss(p):
                feats = jm._forward(p, s64, jx, True, None,
                                    upto=len(jm.layers) - 1)[0]
                return jm.layers[-1].compute_loss({}, feats, jy)
        want = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(
            f64(jm.params())))
    p64 = {k: {n: t.detach().double().requires_grad_(True)
               for n, t in p.items()} for k, p in tm.params().items()}
    s64 = {k: {n: t.double() for n, t in st.items()}
           for k, st in tm.get_net_state().items()}
    tx, ty = torch.from_numpy(x).double(), torch.from_numpy(y).double()
    if graph:
        acts = tm._forward(p64, s64, {"in": tx}, True, None,
                           skip=tm._loss_only)[0]
        loss = tm.conf.nodes["yolo"].layer.compute_loss({}, acts["pred"], ty)
    else:
        feats = tm._forward_state(p64, s64, tx, True, None,
                                  upto=len(tm.layers) - 1)[0]
        loss = tm.layers[-1].compute_loss({}, feats, ty)
    keys = [(k, n) for k, p in p64.items() for n in p]
    got = torch.autograd.grad(loss, [p64[k][n] for k, n in keys])
    return keys, got, want


def test_one_adam_step_follows_jax(model):
    name, jm, tm, shape = model
    _carry(jm, tm)
    x, y = _batch(name, jm, shape)
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
            assert _l2(tm.get_updater_state()[k]["m"][n], v) <= L2_TOL, (k, n)
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
    back to the same JSON (the Yolo2OutputLayer's anchors and lambdas,
    the SpaceToDepthLayer and the MergeVertex among it)."""
    name, jm, tm, _ = model
    jmod = __import__(type(jm.conf).__module__, fromlist=["x"])
    tmod = __import__(type(tm.conf).__module__, fromlist=["x"])
    text = jm.conf.to_json()
    assert '"yolo2output"' in text
    assert getattr(tmod, type(tm.conf).__name__).from_json(text).to_json() \
        == text
    assert getattr(jmod, type(jm.conf).__name__).from_json(
        tm.conf.to_json()).to_json() == text


def test_archives_restore_across_packages(model, tmp_path):
    """JAX's archive (params and layer state) restored by the port, and
    the port's restored by JAX, every leaf bit for bit and the served
    maps equal."""
    name, jm, tm, shape = model
    _carry(jm, tm)
    pj, pt = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    JSer.write_model(jm, pj, save_updater=False)
    ModelSerializer.write_model(tm, pt, save_updater=False)
    n = torch.get_num_threads()
    torch.set_num_threads(INIT_THREADS)   # restore draws the init first
    try:
        back = ModelSerializer.restore(pj, load_updater=False, device="cpu")
    finally:
        torch.set_num_threads(n)
    jback = JSer.restore(pt, load_updater=False)
    assert type(back).__name__ == type(jm).__name__
    assert back.conf.to_json() == jback.conf.to_json() == jm.conf.to_json()
    for k, p in jm.params().items():
        for n, v in p.items():
            assert np.array_equal(_np(back.params()[k][n]), np.asarray(v))
            assert np.array_equal(np.asarray(jback.params()[k][n]),
                                  np.asarray(v))
    for k, st in jm._net_state.items():
        for n, v in st.items():
            assert np.array_equal(_np(back.get_net_state()[k][n]),
                                  np.asarray(v))
    x = np.random.default_rng(3).random((2,) + shape).astype(np.float32)
    got, want = _np(back.output(x)), np.asarray(jm.output(x))
    assert np.abs(got - want).max() <= ACT_TOL * max(np.abs(want).max(), 1.0)
