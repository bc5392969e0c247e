"""The port's CNN training core against the JAX package (f32, CPU):
BASELINE config 1 (LeNet on the vendored real digits) and a small
SimpleCNN (two conv + batch-norm blocks and dropout) trained through
``fit`` from carried weights, ``evaluate``, ``summary``, ``clone``,
listeners, the dataset iterators and the zoo.

Tolerances, with their reasons:
- losses and params after N Adam steps from carried weights: 1e-4
  absolute. Both sides run f32 convolutions and GEMMs summed in
  another order; Adam's first steps move a param by ~lr * sign(g), and
  eps keeps a near-zero gradient's step far below 1e-4 (as in
  ``tests/test_torch_multilayer.py``). The dropout masks are JAX's bit
  for bit (the same key chain), so they add no error;
- batch norm's running stats after those steps: 1e-5 (means and
  variances of f32 activations, summed in another order);
- ``output()`` in inference: 1e-5;
- ``Evaluation`` on the same outputs: exact (the port's copy of the
  numpy evaluation).

BASELINE config 1 itself (12 epochs of 11 batches of 128, the JAX
test's configuration) must reach 0.98 on the 360-image test split, as
``tests/test_real_digits.py`` holds the JAX package.
"""
import shutil

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datasets as JDS
from deeplearning4j_tpu.eval import Evaluation as JEvaluation
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.optimize import TrainingListener as JListener
import deeplearning4j_tpu_torch.datasets as TDS
from deeplearning4j_tpu_torch.convert import (network_params_from_jax,
                                              network_state_from_jax)
from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.optimize import TrainingListener
from _torch_threads import one_torch_thread  # noqa: F401,E402

STEP_ATOL = 1e-4
STATE_ATOL = 1e-5


def lenet_conf(Conf, L, Opt):
    """BASELINE config 1, as tests/test_real_digits.py builds it."""
    return (Conf.builder().seed(123).updater(Opt(1e-3)).weight_init("relu")
            .list()
            .layer(L.ConvolutionLayer(n_out=20, kernel=(5, 5),
                                      activation="relu"))
            .layer(L.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(L.ConvolutionLayer(n_out=50, kernel=(5, 5),
                                      activation="relu"))
            .layer(L.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(L.DenseLayer(n_out=500, activation="relu"))
            .layer(L.OutputLayer(n_out=10, loss="mcxent",
                                 activation="softmax"))
            .input_type_convolutional(28, 28, 1).build())


def small_cnn_conf(Conf, L, Opt, bn_first=False):
    """SimpleCNN's blocks at a small size: conv (ReLU) + BN + pool
    twice, dropout 0.5, dense, softmax. ``bn_first`` puts the ReLU
    after the batch norm (Darknet's order)."""
    b = (Conf.builder().seed(7).updater(Opt(1e-3)).weight_init("relu")
         .activation("relu").list())
    for n_out in (8, 16):
        if bn_first:
            b.layer(L.ConvolutionLayer(n_out=n_out, kernel=(3, 3),
                                       activation="identity"))
            b.layer(L.BatchNormalization(activation="relu"))
        else:
            b.layer(L.ConvolutionLayer(n_out=n_out, kernel=(3, 3)))
            b.layer(L.BatchNormalization())
        b.layer(L.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
    b.layer(L.DropoutLayer(dropout=0.5))
    b.layer(L.DenseLayer(n_out=32, activation="relu"))
    b.layer(L.OutputLayer(n_out=10, loss="mcxent"))
    return b.input_type_convolutional(16, 16, 3).build()


def _pair(make):
    jn = JNet(make(JConf, JL, JAdam)).init()
    tn = MultiLayerNetwork(make(NeuralNetConfiguration, TL, Adam),
                           device="cpu").init()
    tn.set_params(network_params_from_jax(
        jax.tree.map(np.asarray, jn.params())))
    tn.set_net_state(network_state_from_jax(
        jax.tree.map(np.asarray, jn._net_state)))
    return jn, tn


def _learnable_images(seed, n=32, shape=(16, 16, 3)):
    """Labels from the inputs (the mean of a channel's top half against
    its bottom half), so the loss can fall."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, *shape).astype(np.float32)
    h = shape[0] // 2
    cls = (x[:, :h].mean((1, 2)) > x[:, h:].mean((1, 2))) @ [1, 2, 4]
    return x, np.eye(10, dtype=np.float32)[cls.astype(int)]


def _assert_same_params(tn, jn, atol=STEP_ATOL):
    jp = jn.params()
    assert sorted(tn.params()) == sorted(jp)
    for key, p in tn.params().items():
        for name, t in p.items():
            np.testing.assert_allclose(t.detach().numpy(), jp[key][name],
                                       rtol=0, atol=atol,
                                       err_msg=f"{key}.{name}")


def _digit_batches(n_batches, batch=64):
    it = TDS.MnistDataSetIterator(batch=batch, train=True, flatten=False,
                                  shuffle=True, seed=3)
    return [b for _, b in zip(range(n_batches), it)]


def test_lenet_fit_follows_jax():
    jn, tn = _pair(lenet_conf)
    batches = _digit_batches(4)
    for x, y in batches:
        jn.fit(x, y)
        tn.fit(x, y)
        np.testing.assert_allclose(tn.score_, float(jn._last_loss), rtol=0,
                                   atol=STEP_ATOL)
    _assert_same_params(tn, jn)
    assert tn._step == jn._step == 4
    x, y = batches[0]
    np.testing.assert_allclose(tn.output(x).numpy(), np.asarray(jn.output(x)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tn.score(x, y), jn.score(x, y), rtol=1e-5)


def test_small_simple_cnn_fit_follows_jax():
    jn, tn = _pair(small_cnn_conf)
    for step in range(4):
        x, y = _learnable_images(step)
        jn.fit(x, y)
        tn.fit(x, y)
        np.testing.assert_allclose(tn.score_, float(jn._last_loss), rtol=0,
                                   atol=STEP_ATOL)
    _assert_same_params(tn, jn)
    assert [int(v) for v in tn._rng] == [int(v) for v in np.asarray(jn._rng)]
    moved = 0
    for key, st in tn.get_net_state().items():
        for name, t in st.items():
            np.testing.assert_allclose(t.numpy(), jn._net_state[key][name],
                                       rtol=0, atol=STATE_ATOL,
                                       err_msg=f"{key}.{name}")
            moved += int(not np.allclose(t.numpy(),
                                         0.0 if name == "mean" else 1.0))
    assert moved == 4          # both BN layers' mean and var moved
    x, _ = _learnable_images(9)
    np.testing.assert_allclose(tn.output(x).numpy(), np.asarray(jn.output(x)),
                               rtol=1e-5, atol=1e-5)
    # train-mode output normalises with batch statistics
    np.testing.assert_allclose(tn.output(x, train=True).numpy(),
                               np.asarray(jn.output(x, train=True)),
                               rtol=1e-5, atol=1e-5)


def test_gradients_with_dropout_match_jax():
    """One step's loss and every gradient with a dropout key: the
    port's masks are JAX's. In Darknet's order (BN, then ReLU, then the
    pool) a pool window's tied maxima are exact zeros on both sides.
    In SimpleCNN's order (ReLU, BN, pool) they are a channel's zeros
    mapped by the batch norm, and the two frameworks round that map in
    their last bit at other places, so a few windows tie on one side
    only (1 of 8,192 at this size) and route their gradient to another
    element: the convolutions below then differ by ~1% of their
    largest gradient, while the loss and the trajectory of fit (held
    above) agree."""
    jn, tn = _pair(lambda *a: small_cnn_conf(*a, bn_first=True))
    x, y = _learnable_images(11)
    jkey = jax.random.PRNGKey(5)
    from deeplearning4j_tpu_torch import random as R

    def jloss(p):
        return jn._loss_fn(p, jn._net_state, x, y, None, True, jkey)[0]
    jl, jg = jax.value_and_grad(jloss)(jn.params())
    tl, tg, state = tn._step_grads(*tn._to_device(x, y), True,
                                   R.PRNGKey(5))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for key in jg:
        for name in jg[key]:
            np.testing.assert_allclose(tg[key][name].numpy(), jg[key][name],
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{key}.{name}")
    jstate = jn._loss_fn(jn.params(), jn._net_state, x, y, None, True,
                         jkey)[1][0]
    for key, st in state.items():
        for name, t in st.items():
            np.testing.assert_allclose(t.numpy(), jstate[key][name],
                                       rtol=0, atol=STATE_ATOL)


def test_cnnflat_input_reshapes():
    def conf(Conf, L, Opt):
        from_mod = __import__(Conf.__module__, fromlist=["InputType"])
        return (Conf.builder().seed(1).updater(Opt(1e-2)).list()
                .layer(L.ConvolutionLayer(n_out=3, kernel=(3, 3)))
                .layer(L.OutputLayer(n_out=2))
                .input_type(from_mod.InputType.convolutional_flat(5, 4, 2))
                .build())
    jn, tn = _pair(conf)
    x = np.random.RandomState(0).rand(6, 40).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1, 1, 0, 1, 0]]
    jn.fit(x, y)
    tn.fit(x, y)
    np.testing.assert_allclose(tn.output(x).numpy(), np.asarray(jn.output(x)),
                               rtol=1e-5, atol=STEP_ATOL)


def test_evaluate_matches_jax():
    jn, tn = _pair(lenet_conf)
    for x, y in _digit_batches(3):
        jn.fit(x, y)
        tn.fit(x, y)
    te = TDS.MnistDataSetIterator(batch=100, train=False, flatten=False)
    jte = JDS.MnistDataSetIterator(batch=100, train=False, flatten=False)
    tev, jev = tn.evaluate(te), jn.evaluate(jte)
    assert tev._conf.sum() == jev._conf.sum() == 360
    # outputs within 1e-5 can flip an argmax only at a near-tie
    assert np.abs(tev._conf - jev._conf).sum() <= 2
    # the same outputs give the same statistics, exactly
    rs = np.random.RandomState(4)
    labels = np.eye(5, dtype=np.float32)[rs.randint(0, 5, 50)]
    preds = rs.rand(50, 5).astype(np.float32)
    mask = (rs.rand(50) > 0.2).astype(np.float32)
    a, b = Evaluation(), JEvaluation()
    a.eval(labels, preds, mask)
    b.eval(labels, preds, mask)
    assert a.stats() == b.stats()
    assert (a.accuracy(), a.precision(), a.recall(), a.f1()) == \
        (b.accuracy(), b.precision(), b.recall(), b.f1())


def test_summary_matches_jax():
    jn, tn = _pair(small_cnn_conf)
    assert tn.summary() == jn.summary()
    assert tn.num_params() == jn.num_params()


def test_clone_and_feed_forward():
    jn, tn = _pair(small_cnn_conf)
    x, y = _learnable_images(1)
    tn.fit(x, y)
    c = tn.clone()
    assert c.device == tn.device and c is not tn
    for key, p in tn.params().items():
        for name, t in p.items():
            assert torch.equal(c.params()[key][name], t)
            assert c.params()[key][name] is not t
    for key, st in tn.get_net_state().items():
        for name, t in st.items():
            assert torch.equal(c.get_net_state()[key][name], t)
    np.testing.assert_array_equal(c.output(x).numpy(), tn.output(x).numpy())
    c.fit(x, y)
    assert not torch.equal(c.params()["layer_0"]["W"],
                           tn.params()["layer_0"]["W"])
    acts = tn.feed_forward(x)
    assert len(acts) == len(tn.layers) + 1
    np.testing.assert_array_equal(acts[-1].numpy(), tn.output(x).numpy())
    jn2, tn2 = _pair(small_cnn_conf)
    jacts = jn2.feed_forward(x)
    for a, b in zip(tn2.feed_forward(x), jacts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def _recorder(Base):
    class Rec(Base):
        def __init__(self, name, log):
            self.name, self.log = name, log

        def iteration_done(self, model, iteration, epoch):
            self.log.append((self.name, "iter", iteration, epoch))

        def on_timing(self, model, seconds, batch_size):
            self.log.append((self.name, "timing", batch_size))

        def on_epoch_end(self, model):
            self.log.append((self.name, "epoch_end", model._epoch))
    return Rec


def test_listeners_fire_in_jax_order():
    jn, tn = _pair(small_cnn_conf)
    data = [_learnable_images(s, n=8) for s in range(3)]
    logs = []
    for net, Base in ((jn, JListener), (tn, TrainingListener)):
        log = []
        Rec = _recorder(Base)
        net.set_listeners(Rec("a", log))
        net.add_listeners(Rec("b", log))
        net.fit(data, epochs=2)
        logs.append(log)
    assert logs[0] == logs[1]
    assert len(logs[1]) == 2 * (2 * 3 * 2 + 2)


def test_port_listeners_report():
    from deeplearning4j_tpu_torch.optimize import (EvaluativeListener,
                                                   PerformanceListener,
                                                   ScoreIterationListener)
    _, tn = _pair(small_cnn_conf)
    out = []
    data = [_learnable_images(s, n=8) for s in range(2)]
    ev = EvaluativeListener(data, report=out.append)
    tn.set_listeners(ScoreIterationListener(1, out=out.append),
                     PerformanceListener(2, report=out.append), ev)
    tn.fit(data, epochs=1)
    assert out[0].startswith("Score at iteration 1 is")
    assert any("samples/sec" in line for line in out)
    assert out[-1].startswith("Accuracy:") and ev.last_evaluation is not None


# -- the real-digit fixture (tests/test_real_digits.py, mirrored) --------
def test_fixture_is_the_jax_packages():
    for name in ("manifest.json", "train-images-idx3-ubyte.gz",
                 "train-labels-idx1-ubyte.gz", "t10k-images-idx3-ubyte.gz",
                 "t10k-labels-idx1-ubyte.gz"):
        with open(f"{TDS._REAL_DIGITS_DIR}/{name}", "rb") as a, \
                open(f"{JDS._REAL_DIGITS_DIR}/{name}", "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("train", [True, False])
def test_manifest_checksums_verify(train):
    imgs, labels = TDS._load_real_digits(train=train)
    jimgs, jlabels = JDS._load_real_digits(train=train)
    assert imgs.shape == ((1437 if train else 360), 28, 28)
    assert imgs.dtype == np.uint8
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labels, jlabels)
    assert set(np.unique(labels)) == set(range(10))


def _corrupt_copy(tmp_path, name):
    bad = tmp_path / "real_digits"
    shutil.copytree(TDS._REAL_DIGITS_DIR, bad)
    p = bad / name
    data = bytearray(p.read_bytes())
    data[-1] ^= 0xFF
    p.write_bytes(bytes(data))
    return bad


def test_corrupt_fixture_raises(tmp_path, monkeypatch):
    bad = _corrupt_copy(tmp_path, "t10k-images-idx3-ubyte.gz")
    monkeypatch.setattr(TDS, "_REAL_DIGITS_DIR", str(bad))
    with pytest.raises(IOError, match="checksum"):
        TDS._load_real_digits(train=False)


def test_iterator_surfaces_corruption_not_synthetic(tmp_path, monkeypatch):
    if TDS._find_mnist() is not None:
        pytest.skip("real MNIST present locally; fixture not used")
    bad = _corrupt_copy(tmp_path, "train-images-idx3-ubyte.gz")
    monkeypatch.setattr(TDS, "_REAL_DIGITS_DIR", str(bad))
    with pytest.raises(IOError, match="checksum"):
        TDS.MnistDataSetIterator(batch=8, train=True)


def test_iterator_missing_fixture_falls_back(tmp_path, monkeypatch):
    if TDS._find_mnist() is not None:
        pytest.skip("real MNIST present locally; fixture not used")
    monkeypatch.setattr(TDS, "_REAL_DIGITS_DIR", str(tmp_path / "nothing"))
    it = TDS.MnistDataSetIterator(batch=8, train=True, num_examples=64)
    assert it.source == "synthetic" and it.synthetic
    for got, want in zip(TDS._synthetic_mnist(64, seed=1),
                         JDS._synthetic_mnist(64, seed=1)):
        np.testing.assert_array_equal(got, want)


def test_iterator_matches_jax_and_reports_provenance():
    it = TDS.MnistDataSetIterator(batch=32, train=True, flatten=False)
    if it.source == "mnist":
        pytest.skip("real MNIST present locally; fixture not used")
    assert it.source == "real-digits-8x8" and it.synthetic is False
    jit = JDS.MnistDataSetIterator(batch=32, train=True, flatten=False)
    for _ in range(2):    # two passes: each draws its own shuffle
        for (x, y), (jx, jy) in zip(it, jit):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
    x, _ = next(iter(it))
    assert x.shape == (32, 28, 28, 1)
    assert 0.0 <= float(x.min()) and float(x.max()) <= 1.0
    flat = TDS.MnistDataSetIterator(batch=16, train=False)
    assert next(iter(flat))[0].shape == (16, 784)


def test_test_split_fully_evaluated():
    it = TDS.MnistDataSetIterator(batch=512, train=False, flatten=False)
    n = sum(len(b[0]) for b in it)
    assert n == it.total_examples() == 360


def test_iris_async_and_dataset():
    ti, ji = TDS.IrisDataSetIterator(batch=50, shuffle=True), \
        JDS.IrisDataSetIterator(batch=50, shuffle=True)
    for (x, y), (jx, jy) in zip(ti, ji):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    base = TDS.ArrayDataSetIterator(np.arange(20.).reshape(10, 2),
                                    np.arange(10.), batch=3, keep_last=True)
    want = [tuple(map(np.copy, b)) for b in base]
    got = list(TDS.AsyncDataSetIterator(base, prefetch=2))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    ds = TDS.DataSet(np.arange(10.), np.arange(10.) * 2)
    ds.shuffle(3)
    jds = JDS.DataSet(np.arange(10.), np.arange(10.) * 2)
    jds.shuffle(3)
    np.testing.assert_array_equal(ds.features, jds.features)
    tr, te = ds.split_test_and_train(7)
    assert tr.num_examples() == 7 and te.num_examples() == 3
    # a network fits DataSet items
    _, tn = _pair(small_cnn_conf)
    x, y = _learnable_images(2, n=8)
    tn.fit([TDS.DataSet(x, y)])
    assert tn._step == 1


# -- the zoo ----------------------------------------------------------
class _ConfOnly:
    """Stands in for MultiLayerNetwork: init() returns the built
    configuration (the widths' params are not drawn)."""

    def __init__(self, conf, device=None):
        self.conf = conf

    def init(self):
        shape = self.conf.input_type.shape
        out = []
        for layer in self.conf.layers:
            layer.build(shape, self.conf.defaults)
            out.append((type(layer).__name__, layer.param_shapes(),
                        layer.output_shape(shape)))
            shape = layer.output_shape(shape)
        return out


@pytest.mark.parametrize("name", ["LeNet", "SimpleCNN", "AlexNet", "VGG16",
                                  "VGG19", "Darknet19",
                                  "TextGenerationLSTM"])
def test_zoo_models_match_jax(name, monkeypatch):
    import deeplearning4j_tpu.zoo.simple as jsimple
    import deeplearning4j_tpu_torch.nn as tnn
    from deeplearning4j_tpu import zoo as jzoo
    from deeplearning4j_tpu_torch import zoo as tzoo
    monkeypatch.setattr(jsimple, "MultiLayerNetwork", _ConfOnly)
    monkeypatch.setattr(tnn, "MultiLayerNetwork", _ConfOnly)
    assert getattr(tzoo, name)(device="cpu").init() == \
        getattr(jzoo, name)().init()
    # TinyYOLO is sequential too; YOLO2 (a graph) builds in
    # tests/test_torch_zoo_yolo.py
    assert tzoo.TinyYOLO(device="cpu").init() == jzoo.TinyYOLO().init()


def test_zoo_pretrained_round_trip(tmp_path):
    from deeplearning4j_tpu_torch.zoo import SimpleCNN
    zoo = SimpleCNN(device="cpu", input_shape=(16, 16, 3))
    net = zoo.init()
    x, y = _learnable_images(3)
    net.fit(x, y)
    path = zoo.save_pretrained(net, str(tmp_path / "scnn.npz"))
    back = zoo.init_pretrained(path)
    np.testing.assert_array_equal(back.output(x).numpy(),
                                  net.output(x).numpy())
    with open(path, "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01")
    with pytest.raises(IOError, match="checksum"):
        zoo.init_pretrained(path)


def test_entry_points_default_to_the_card():
    from deeplearning4j_tpu_torch.zoo import LeNet
    if torch.cuda.is_available():
        assert LeNet().init().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LeNet().init()


def test_baseline_config_1_reaches_098_on_real_digits():
    """BASELINE config 1 on the port, on the CPU: LeNet fitted for 12
    epochs at batch 128 over the vendored real digits must reach 0.98
    on the 360-image test split."""
    tr = TDS.MnistDataSetIterator(batch=128, train=True, flatten=False,
                                  shuffle=True)
    if tr.source == "synthetic":
        pytest.skip("no real digit data available")
    net = MultiLayerNetwork(lenet_conf(NeuralNetConfiguration, TL, Adam),
                            device="cpu").init()
    net.fit(tr, epochs=12)
    assert net._step == 132
    te = TDS.MnistDataSetIterator(batch=512, train=False, flatten=False)
    acc = net.evaluate(te).accuracy()
    assert acc >= 0.98, f"real-digit accuracy {acc:.4f} < 0.98"


def test_port_lenet_example_runs_on_the_cpu():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "examples" / \
        "torch" / "lenet_mnist.py"
    spec = importlib.util.spec_from_file_location("torch_lenet_example",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(quick=True, device="cpu") > 0.5
