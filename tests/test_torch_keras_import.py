"""Keras import on the port (``modelimport/keras.py`` over the port's
own HDF5 reader) against the JAX package's importer, class for class
of ``tests/test_modelimport.py``.

Every case reads the same ``.h5`` through both packages and asserts:
- the configuration JSON equal key for key;
- params and batch-norm state bit for bit (same keys, dtypes, bytes);
- outputs within ``tests/test_modelimport.py``'s tolerance of Keras's
  (rtol 1e-3/atol 1e-5 for ``y1``-``y3``, rtol 1e-4/atol 1e-5 for the
  extra set, its own atol for the architectures and masking models) and
  within ``JAX_OUT`` of JAX's (f32 sums in another order: 1e-5 read at
  most, on MobileNetV2 at 224);
- one fit step from the same params and key: every leaf within 1e-5 of
  its largest magnitude of JAX's (``STEP_TOL``), or for the full
  architectures, whose batch norms' f32 gradients are ill-conditioned
  at random init, the step of :func:`_step64` (the gradient in f64);
- the same refusals, with the same exception types.

The committed fixtures need no Keras. The files that need Keras to be
written (the three ``keras.applications`` architectures, the compiled
models, the masking models) are written once per module, as the JAX
tests write them, and skip without Keras (``importorskip``): importing
TensorFlow alone takes ~20 s on an 8-core CPU. Every case held to Keras's
outputs takes a fit step but MobileNet's (its head maps to no output
layer, so it has no loss). Torch runs on one thread here, as the zoo files do.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport import KerasModelImport as JK
from deeplearning4j_tpu_torch.modelimport import KerasModelImport as TK
from deeplearning4j_tpu_torch.modelimport import keras as tkeras
from _torch_threads import one_torch_thread  # noqa: F401,E402

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
MOBILENET = os.path.join(HERE, "..", "deeplearning4j_tpu_torch",
                         "modelimport", "fixtures",
                         "keras_mobilenet_v2_224")

JAX_OUT = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = 1e-5
# the full architectures' step (:func:`_step64`), as
# tests/test_torch_zoo_graph.py holds ResNet50's
GRAD64_TOL = 1e-9    # f64 gradient, over the leaf's largest |value| or
#                      FLOOR of the network's largest, whichever is larger
LOSS_RTOL = 1e-4     # the f32 loss against JAX's f64 one, or 3x the
#                      distance of JAX's own f32 loss from it, whichever
#                      is larger (ResNet50's f32 loss stands 3.2e-4 from
#                      its f64 one in JAX, 1.8e-4 in the port)
STATE_TOL = 1e-4     # the f32 running stats against JAX's f64 ones, over
#                      the leaf's largest |value| or FLOOR of the largest
#                      of any stat, or 3x the distance of JAX's own f32
#                      stats from them, whichever is largest (ResNet50's
#                      conv5_block3_2_bn mean: JAX's f32 1.3e-4 of the
#                      leaf's max from its f64, the port's 9.1e-5)
FLOOR = 1e-3         # a leaf that is zero in exact arithmetic holds
#                      round-off alone: a conv bias or a batch-norm beta
#                      that reaches the loss only through another batch
#                      norm (ResNet50's conv1_conv.b, 4e-13 of f64 noise
#                      where the largest gradient is 367), a running mean
#                      after a 1x1 conv of centred channels (MobileNetV2's
#                      Conv_1_bn, 3e-11 in f32)
STEP_PIXELS = 96     # the MobileNetV2 fixture's step on a 96x96 centre
#                      crop of 2 of its images: XLA's CPU convolutions in
#                      f64 take 33 s for JAX's gradient at 224, 6 s at 96
UPDATE_TOL = 1e-6    # the f32 params after the step against the port's
#                      updater applied to its own f32 gradient


def _np(t):
    return t.detach().cpu().numpy()


def _tree_equal(jtree, ttree):
    """Bit for bit: the same keys, and each leaf the same dtype, shape
    and bytes."""
    jtree = jtree or {}
    assert set(ttree) == set(jtree), set(ttree) ^ set(jtree)
    for k in jtree:
        assert set(ttree[k]) == set(jtree[k]), k
        for n, v in jtree[k].items():
            a, b = np.asarray(v), _np(ttree[k][n])
            assert a.dtype == b.dtype and a.shape == b.shape, (k, n)
            assert a.tobytes() == b.tobytes(), (k, n)


def _import(path, graph: bool, **kw):
    if graph:
        return (JK.import_keras_model_and_weights(path, **kw),
                TK.import_keras_model_and_weights(path, device="cpu", **kw))
    return (JK.import_keras_sequential_model_and_weights(path, **kw),
            TK.import_keras_sequential_model_and_weights(path, device="cpu",
                                                         **kw))


def _same_import(jm, tm):
    assert type(tm).__name__ == type(jm).__name__
    assert json.loads(tm.conf.to_json()) == json.loads(jm.conf.to_json())
    _tree_equal(jax.tree.map(np.asarray, jm.params()), tm.params())
    _tree_equal(jax.tree.map(np.asarray, jm._net_state), tm._net_state)


def _outputs(jm, tm, x, graph: bool):
    if graph:
        j, t = jm.output([x]), tm.output([x])
    else:
        j, t = jm.output(x), tm.output(x)
    j = np.asarray(j[0] if isinstance(j, list) else j)
    t = _np(t[0] if isinstance(t, list) else t)
    np.testing.assert_allclose(t, j, **JAX_OUT)
    return t


def _fit_step(jm, tm, x, graph: bool, seed=0):
    """One fit step on one-hot labels of the output's shape; every
    param leaf within STEP_TOL of its largest magnitude of JAX's."""
    with torch.no_grad():
        out = tm.output([x] if graph else x)
    out = out[0] if isinstance(out, list) else out
    c = out.shape[-1]
    rs = np.random.RandomState(seed)
    y = np.eye(c, dtype=np.float32)[rs.randint(0, c, out.shape[:-1])]
    if graph:
        jm.fit([x], [y])
        tm.fit([x], [y])
    else:
        jm.fit(x, y)
        tm.fit(x, y)
    jp = jax.tree.map(np.asarray, jm.params())
    for k, p in jp.items():
        for n, v in p.items():
            got = _np(tm.params()[k][n])
            scale = max(float(np.abs(v).max()), 1e-30)
            assert np.abs(got - v).max() <= STEP_TOL * scale, (k, n)
    assert np.isfinite(float(tm.score_))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _step64(jm, tm, x, seed=0):
    """A graph's fit step where f32 cannot hold the params to JAX's:
    the batch norms of a full architecture at random init make its f32
    gradient ill-conditioned (``tests/test_torch_zoo_graph.py``: JAX's
    own moves by up to 0.47 of a leaf's max under a 1e-7 move of the
    params). So the gradient is held in f64 on both sides, leaf by leaf
    (``GRAD64_TOL``); then one f32 fit: its loss and new running stats
    against JAX's f64 ones (with JAX's own f32 forward as the witness of
    how far f32 stands from them), and every param after it against the
    port's
    updater (the file's, or the default) applied to the port's own f32
    gradient of the same batch, which a missing or partial update
    fails."""
    import copy
    jnp = jax.numpy
    out = _np(tm.output([x])[0])
    c = out.shape[-1]
    y = np.eye(c, dtype=np.float32)[
        np.random.RandomState(seed).randint(0, c, len(x))]
    xin, yout = tm.conf.graph_inputs[0], tm.conf.graph_outputs[0]
    def host(tree):
        return jax.tree.map(lambda v: np.asarray(v, np.float64), tree)
    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), tree)
        s64 = f64(jm._net_state)
        (jloss, jstate), want = jax.jit(jax.value_and_grad(
            lambda p: jm._loss_fn(p, s64, {xin: jnp.asarray(x, jnp.float64)},
                                  {yout: jnp.asarray(y, jnp.float64)},
                                  None, True, None), has_aux=True))(
            f64(jm.params()))
        jloss, want, jstate = float(jloss), host(want), host(jstate)
    loss32, state32 = jax.jit(lambda p, s: jm._loss_fn(
        p, s, {xin: x}, {yout: y}, None, True, None))(jm.params(),
                                                      jm._net_state)
    loss32, state32 = float(loss32), host(state32)
    p64 = {k: {n: t.detach().double().requires_grad_(True)
               for n, t in p.items()} for k, p in tm.params().items()}
    s64 = {k: {n: t.double() for n, t in st.items()}
           for k, st in tm.get_net_state().items()}
    keys = [(k, n) for k, p in p64.items() for n in p]
    loss = tm._loss_fn(p64, s64, {xin: torch.from_numpy(x).double()},
                       {yout: torch.from_numpy(y).double()}, None, True,
                       None)[0]
    got = torch.autograd.grad(loss, [p64[k][n] for k, n in keys])
    assert len(keys) == sum(len(p) for p in want.values())
    top = max(float(np.abs(v).max()) for p in want.values()
              for v in p.values())
    for (k, n), g in zip(keys, got):
        v = want[k][n]
        assert g.dtype == torch.float64 and v.dtype == np.float64
        assert np.abs(g.numpy() - v).max() <= GRAD64_TOL * max(
            float(np.abs(v).max()), FLOOR * top), (k, n)
    _, g32, _, _ = tm._grads(tm._as_inputs([x]), tm._as_labels([y]), None,
                             None)
    expect = {}
    for k, p in tm.params().items():
        _, u = copy.deepcopy(tm._updaters[k]).apply(
            copy.deepcopy(tm._opt_state[k]), g32[k], tm._step)
        expect[k] = {n: _np(t - u[n]) for n, t in p.items()}
    tm.fit([x], [y])
    assert abs(float(tm.score_) - jloss) <= max(LOSS_RTOL * abs(jloss),
                                                3 * abs(loss32 - jloss))
    for k, p in tm.params().items():
        for n, t in p.items():
            assert _rel(_np(t), expect[k][n]) <= UPDATE_TOL, (k, n)
    top = max(float(np.abs(v).max()) for st in jstate.values()
              for v in st.values())
    for k, st in jstate.items():
        for n, v in st.items():
            err = np.abs(_np(tm.get_net_state()[k][n]) - v).max()
            witness = np.abs(state32[k][n] - v).max()
            assert err <= max(STATE_TOL * max(float(np.abs(v).max()),
                                              FLOOR * top),
                              3 * witness), (k, n)


def _case(path, x, want, graph=False, tol=None, step=True):
    jm, tm = _import(path, graph)
    _same_import(jm, tm)
    got = _outputs(jm, tm, x, graph)
    if want is not None:
        np.testing.assert_allclose(got, want, **(tol or {}))
    if step == "f64":
        _step64(jm, tm, x)
    elif step:
        _fit_step(jm, tm, x, graph)
    return jm, tm


# -- the committed fixtures (tests/fixtures) ----------------------------

class TestKerasSequentialImport:
    def test_cnn_predictions_match_keras(self):
        exp = np.load(os.path.join(FIX, "keras_expected.npz"))
        _case(os.path.join(FIX, "keras_seq_cnn.h5"), exp["x1"], exp["y1"],
              tol=dict(rtol=1e-3, atol=1e-5))

    def test_lstm_predictions_match_keras(self):
        exp = np.load(os.path.join(FIX, "keras_expected.npz"))
        _case(os.path.join(FIX, "keras_seq_lstm.h5"), exp["x2"],
              exp["y2"], tol=dict(rtol=1e-3, atol=1e-5))

    def test_imported_model_is_trainable(self):
        from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
        net = TK.import_keras_sequential_model_and_weights(
            os.path.join(FIX, "keras_seq_cnn.h5"), device="cpu")
        rs = np.random.RandomState(0)
        X = rs.rand(32, 8, 8, 1).astype(np.float32)
        Y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 32)]
        net.fit(ArrayDataSetIterator(X, Y, batch=16), epochs=1)
        assert np.isfinite(float(net._last_loss))

    def test_wrong_importer_raises(self):
        for imp in (JK, TK):
            kw = {} if imp is JK else {"device": "cpu"}
            with pytest.raises(ValueError, match="Functional"):
                imp.import_keras_sequential_model_and_weights(
                    os.path.join(FIX, "keras_func.h5"), **kw)
            with pytest.raises(ValueError, match="Sequential"):
                imp.import_keras_model_and_weights(
                    os.path.join(FIX, "keras_seq_cnn.h5"), **kw)

    def test_entry_points_default_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default is cuda")
        for fn in (TK.import_keras_sequential_model_and_weights,
                   TK.import_keras_model_and_weights, TK.import_model):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn(os.path.join(FIX, "keras_seq_cnn.h5"))


class TestKerasFunctionalImport:
    def test_functional_predictions_match_keras(self):
        exp = np.load(os.path.join(FIX, "keras_expected.npz"))
        _case(os.path.join(FIX, "keras_func.h5"), exp["x3"], exp["y3"],
              graph=True, tol=dict(rtol=1e-3, atol=1e-5))

    def test_import_model_dispatch(self):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        m1 = TK.import_model(os.path.join(FIX, "keras_seq_cnn.h5"),
                             device="cpu")
        m2 = TK.import_model(os.path.join(FIX, "keras_func.h5"),
                             device="cpu")
        assert isinstance(m1, MultiLayerNetwork)
        assert isinstance(m2, ComputationGraph)
        assert m1.device.type == m2.device.type == "cpu"


class TestKerasExtendedLayers:
    @pytest.mark.parametrize("name, key", [
        ("keras_seq_convs.h5", "conv"), ("keras_seq_1d.h5", "1d"),
        ("keras_seq_gru.h5", "gru"), ("keras_seq_bidir.h5", "bidir"),
        ("keras_seq_3d.h5", "3d")])
    def test_matches_keras(self, name, key):
        exp = np.load(os.path.join(FIX, "keras_extra_expected.npz"))
        _case(os.path.join(FIX, name), exp[f"x_{key}"], exp[f"y_{key}"],
              tol=dict(rtol=1e-4, atol=1e-5))

    def test_1d_shape_mappers_config_only(self):
        from deeplearning4j_tpu.modelimport.keras import _map_layer as jmap
        for cls, cfg in (("ZeroPadding1D", {"name": "zp", "padding": [2, 1]}),
                         ("Cropping1D", {"name": "cr", "cropping": 1}),
                         ("UpSampling1D", {"name": "up", "size": 3})):
            t, j = tkeras._map_layer(cls, cfg), jmap(cls, cfg)
            assert type(t).__name__ == type(j).__name__
            assert t.to_json() == j.to_json()

    @pytest.mark.parametrize("cls, cfg, match", [
        ("Permute", {"name": "p", "dims": [2, 1]}, "unsupported Keras layer"),
        ("Dense", {"name": "d", "units": 2, "activation": "crelu"},
         "unsupported Keras activation"),
        ("ReLU", {"name": "r", "max_value": 3.0}, "unsupported ReLU"),
        ("Bidirectional", {"name": "b", "layer": {
            "class_name": "LSTM", "config": {"units": 2}}},
         "return_sequences=False"),
    ])
    def test_refusals_match_jax(self, cls, cfg, match):
        from deeplearning4j_tpu.modelimport.keras import _map_layer as jmap
        for fn in (jmap, tkeras._map_layer):
            with pytest.raises(ValueError, match=match):
                fn(cls, cfg)


class TestMobileNetV2Fixture:
    """The port's committed MobileNetV2 (alpha 1.0, 224x224x3, 1,000
    classes, non-trivial batch-norm statistics; written by
    ``tools/make_keras_fixture.py``): Keras's softmax and pooled
    features on 8 seeded images."""

    @pytest.fixture(scope="class")
    def pair(self):
        e = np.load(MOBILENET + ".npz")
        jm, tm = _import(MOBILENET + ".h5", graph=True,
                         enforce_training_config=True)
        x = e["pixels"].astype(np.float32) / np.float32(127.5) - \
            np.float32(1.0)
        return jm, tm, x, e

    def test_import_is_bit_for_bit(self, pair):
        jm, tm, _, _ = pair
        _same_import(jm, tm)
        assert tm.num_params() + sum(
            int(v.numel()) for s in tm._net_state.values()
            for v in s.values()) == 3_538_984

    def test_outputs_match_keras_and_jax(self, pair):
        jm, tm, x, e = pair
        got = _outputs(jm, tm, x, graph=True)
        np.testing.assert_allclose(got, e["probs"], rtol=1e-3, atol=1e-5)
        with torch.no_grad():
            feats = _np(tm.feed_forward([x])["global_average_pooling2d"])
        np.testing.assert_allclose(feats, e["features"], rtol=1e-4,
                                   atol=1e-5)

    def test_training_config(self, pair):
        jm, tm, _, _ = pair
        upd = next(iter(tm._updaters.values()))
        assert type(upd).__name__ == "Adam"
        assert upd.learning_rate == pytest.approx(1e-4)
        assert tm.conf.nodes["predictions"].layer.loss.name == "mcxent"

    def test_fit_step_follows_jax(self, pair):
        """Last in the class: the step moves the shared pair's params."""
        jm, tm, x, _ = pair
        a = (x.shape[1] - STEP_PIXELS) // 2
        _step64(jm, tm, np.ascontiguousarray(
            x[:2, a:a + STEP_PIXELS, a:a + STEP_PIXELS]))


# -- files written here by Keras, once per module ----------------------

@pytest.fixture(scope="module")
def kfiles(tmp_path_factory):
    """Every Keras-written file of the JAX tests, with Keras's
    predictions where they compare to them."""
    keras = pytest.importorskip("keras")
    keras.utils.set_random_seed(0)
    d = tmp_path_factory.mktemp("keras")
    out = {}

    def save(name, m):
        p = str(d / f"{name}.h5")
        m.save(p)
        out[name] = p
        return p

    def seq_compiled(name, optimizer, loss="categorical_crossentropy"):
        m = keras.Sequential([keras.layers.Input((4,)),
                              keras.layers.Dense(8, activation="relu"),
                              keras.layers.Dense(3, activation="softmax")])
        m.compile(optimizer=optimizer, loss=loss)
        save(name, m)

    seq_compiled("adam", keras.optimizers.Adam(0.003))
    seq_compiled("sgd", keras.optimizers.SGD(0.05, momentum=0.9))
    m = keras.Sequential([keras.layers.Input((4,)),
                          keras.layers.Dense(3, activation="softmax")])
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    save("sparse", m)
    save("uncompiled", keras.Sequential([keras.layers.Input((4,)),
                                         keras.layers.Dense(2)]))
    inp = keras.Input((6,))
    h = keras.layers.Dense(8, activation="relu")(inp)
    m = keras.Model(inp, keras.layers.Dense(2, activation="softmax")(h))
    m.compile(optimizer=keras.optimizers.RMSprop(0.002),
              loss="categorical_crossentropy")
    save("rmsprop_func", m)
    for name, losses in (("two_heads", {"head_a": "categorical_crossentropy",
                                        "head_b": "mse"}),
                         ("two_heads_sparse",
                          {"head_a": "sparse_categorical_crossentropy",
                           "head_b": "mse"})):
        inp = keras.Input((6,), name="inp")
        h = keras.layers.Dense(8, activation="relu", name="trunk")(inp)
        a = keras.layers.Dense(2, activation="softmax", name="head_a")(h)
        b = keras.layers.Dense(1, activation="linear", name="head_b")(h)
        m = keras.Model(inp, [a, b])
        m.compile(optimizer=keras.optimizers.Adam(1e-3), loss=losses)
        save(name, m)
    # masking (TestKerasMasking's three models and inputs)
    rs = np.random.RandomState(0)
    x = rs.rand(4, 6, 3).astype(np.float32)
    x[0, 4:] = 0.0
    x[1, 2:] = 0.0
    xg = x.copy()
    xg[0, 4:] = 9.0
    m = keras.Sequential([keras.layers.Input((6, 3)),
                          keras.layers.Masking(mask_value=0.0),
                          keras.layers.LSTM(5, return_sequences=False),
                          keras.layers.Dense(2, activation="softmax")])
    save("mask", m)
    out["mask_io"] = (x, np.asarray(m.predict(x, verbose=0)), xg,
                      np.asarray(m.predict(xg, verbose=0)))
    m = keras.Sequential([keras.layers.Input((6, 3)),
                          keras.layers.Masking(mask_value=0.0),
                          keras.layers.Dropout(0.25),
                          keras.layers.LSTM(5),
                          keras.layers.Dense(2, activation="softmax")])
    save("mask_dropout", m)
    x1 = np.random.RandomState(1).rand(4, 6, 3).astype(np.float32)
    x1[0, 3:] = 0.0
    out["mask_dropout_io"] = (x1, np.asarray(m.predict(x1, verbose=0)))
    inp = keras.Input((6, 3))
    msk = keras.layers.Masking(mask_value=0.0)(inp)
    cat = keras.layers.Concatenate()([keras.layers.LSTM(4)(msk),
                                      keras.layers.LSTM(4)(msk)])
    m = keras.Model(inp, keras.layers.Dense(2, activation="softmax")(cat))
    save("mask_func", m)
    x2 = np.random.RandomState(0).rand(4, 6, 3).astype(np.float32)
    x2[0, 4:] = 0.0
    out["mask_func_io"] = (x2, np.asarray(m.predict(x2, verbose=0)))
    # the full architectures of TestKerasFullArchitectures
    apps = keras.applications
    for name, m, seed in (
            ("mobilenet_v1", apps.MobileNet(alpha=0.25,
                                            input_shape=(64, 64, 3),
                                            weights=None, classes=10), 0),
            ("mobilenet_v2", apps.MobileNetV2(alpha=0.35,
                                              input_shape=(64, 64, 3),
                                              weights=None, classes=7), 1),
            ("resnet50", apps.ResNet50(input_shape=(64, 64, 3),
                                       weights=None, classes=7), 2)):
        x = np.random.RandomState(seed).rand(2, 64, 64, 3).astype(
            np.float32)
        out[f"{name}_io"] = (x, np.asarray(m.predict(x, verbose=0)))
        save(name, m)
    return out


class TestKerasFullArchitectures:
    @pytest.mark.parametrize("name, atol", [
        ("mobilenet_v1", 1e-6), ("mobilenet_v2", 1e-6), ("resnet50", 1e-5)])
    def test_matches_keras_and_jax(self, kfiles, name, atol):
        """With a fit step in f64 (:func:`_step64`), but for MobileNet,
        whose head ends in a softmax activation after a reshape: it maps
        to no output layer in either package, so it has no loss to fit."""
        x, want = kfiles[f"{name}_io"]
        jm, tm = _case(kfiles[name], x, want, graph=True,
                       tol=dict(atol=atol),
                       step=None if name == "mobilenet_v1" else "f64")
        if name == "mobilenet_v1":
            for m in (jm, tm):
                (out,) = m.conf.graph_outputs
                assert type(m.conf.nodes[out].layer).__name__ == \
                    "ActivationLayer"


class TestKerasTrainingConfigImport:
    def test_adam_lr_and_loss_restored(self, kfiles):
        jm, tm = _import(kfiles["adam"], graph=False,
                         enforce_training_config=True)
        _same_import(jm, tm)
        assert tm.layers[-1].loss.name == "mcxent"
        upd = tm._updaters[-1]
        assert type(upd).__name__ == "Adam"
        assert upd.learning_rate == pytest.approx(0.003)
        rs = np.random.RandomState(0)
        x = rs.rand(64, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[(x.sum(-1) * 2).astype(int) % 3]
        _fit_step(jm, tm, x, graph=False)
        s0 = tm.score(x, y)
        tm.fit(x, y, epochs=30)
        assert tm.score(x, y) < s0

    def test_sgd_momentum_maps_to_nesterovs(self, kfiles):
        import h5py
        from deeplearning4j_tpu.modelimport.keras import (
            _map_training_config as jmap)
        from deeplearning4j_tpu_torch.modelimport import _h5
        with h5py.File(kfiles["sgd"]) as f:
            jupd, jloss = jmap(f, enforce=True)
        with _h5.File(kfiles["sgd"]) as f:
            upd, loss = tkeras._map_training_config(f, enforce=True)
        assert type(upd).__name__ == "Nesterovs" == type(jupd).__name__
        assert upd.momentum == pytest.approx(0.9)
        assert upd.to_json() == jupd.to_json()
        assert loss == jloss == "categorical_crossentropy"
        jm, tm = _import(kfiles["sgd"], graph=False,
                         enforce_training_config=True)
        _same_import(jm, tm)
        _fit_step(jm, tm, np.random.RandomState(1).rand(16, 4).astype(
            np.float32), graph=False)

    def test_uncompiled_with_enforce_raises(self, kfiles):
        for imp in (JK, TK):
            kw = {} if imp is JK else {"device": "cpu"}
            with pytest.raises(ValueError, match="training_config"):
                imp.import_keras_sequential_model_and_weights(
                    kfiles["uncompiled"], enforce_training_config=True, **kw)
        jm, tm = _import(kfiles["uncompiled"], graph=False)
        _same_import(jm, tm)

    def test_functional_model_restores_compile_state(self, kfiles):
        jm, tm = _import(kfiles["rmsprop_func"], graph=True,
                         enforce_training_config=True)
        _same_import(jm, tm)
        upd = next(iter(tm._updaters.values()))
        assert type(upd).__name__ == "RmsProp"
        assert upd.learning_rate == pytest.approx(0.002)
        rs = np.random.RandomState(0)
        x = rs.rand(32, 6).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[(x.sum(-1) > 3).astype(int)]
        _fit_step(jm, tm, x, graph=True)
        s0 = tm.score([x], [y])
        tm.fit([x], [y], epochs=20)
        assert tm.score([x], [y]) < s0

    def test_sparse_ce_rejected_under_enforce(self, kfiles):
        for imp in (JK, TK):
            kw = {} if imp is JK else {"device": "cpu"}
            with pytest.raises(ValueError, match="sparse"):
                imp.import_keras_sequential_model_and_weights(
                    kfiles["sparse"], enforce_training_config=True, **kw)
        jm, tm = _import(kfiles["sparse"], graph=False)
        _same_import(jm, tm)


class TestPerOutputLossDict:
    def test_dict_losses_restored_per_output(self, kfiles):
        jm, tm = _import(kfiles["two_heads"], graph=True,
                         enforce_training_config=True)
        _same_import(jm, tm)
        got = {nm: getattr(tm.conf.nodes[nm].layer, "loss", None)
               for nm in ("head_a", "head_b")}
        assert got["head_a"].name == "mcxent"
        assert got["head_b"].name == "mse"
        rs = np.random.RandomState(2)
        x = rs.rand(8, 6).astype(np.float32)
        ya = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 8)]
        yb = rs.rand(8, 1).astype(np.float32)
        jm.fit([x], [ya, yb])
        tm.fit([x], [ya, yb])
        jp = jax.tree.map(np.asarray, jm.params())
        for k, p in jp.items():
            for n, v in p.items():
                scale = max(float(np.abs(v).max()), 1e-30)
                assert np.abs(_np(tm.params()[k][n]) - v).max() <= \
                    STEP_TOL * scale, (k, n)

    def test_dict_with_unmappable_entry_raises_under_enforce(self, kfiles):
        for imp in (JK, TK):
            kw = {} if imp is JK else {"device": "cpu"}
            with pytest.raises(ValueError, match="sparse"):
                imp.import_keras_model_and_weights(
                    kfiles["two_heads_sparse"], enforce_training_config=True,
                    **kw)
        jm, tm = _import(kfiles["two_heads_sparse"], graph=True)
        _same_import(jm, tm)


class TestMaskingGuardScope:
    """``_check_masking_semantics_graph`` on hand-written configs, the
    port's and JAX's side by side."""

    @staticmethod
    def _cfg(name, cls, inbound):
        return {"class_name": cls, "config": {"name": name},
                "inbound_nodes": [[[i, 0, 0, {}] for i in inbound]]}

    class _K:
        def __init__(self, kind):
            self.kind = kind

    def _both(self, cfgs, mapped_fn):
        from deeplearning4j_tpu.modelimport.keras import \
            _check_masking_semantics_graph as jcheck
        from deeplearning4j_tpu.nn.layers import MaskingLayer as JMask
        from deeplearning4j_tpu_torch.nn.layers import MaskingLayer as TMask
        return ((jcheck, mapped_fn(JMask)),
                (tkeras._check_masking_semantics_graph, mapped_fn(TMask)))

    def test_masked_seq_output_still_rejected(self):
        cfgs = [self._cfg("in", "InputLayer", []),
                self._cfg("m", "Masking", ["in"]),
                self._cfg("l", "LSTM", ["m"]),
                self._cfg("o", "Dense", ["l"])]
        for check, mapped in self._both(cfgs, lambda M: {
                "m": M(mask_value=0.0), "l": self._K("lstm"),
                "o": self._K("rnnoutput")}):
            with pytest.raises(ValueError, match="per-timestep"):
                check(cfgs, mapped)

    def test_unrelated_branch_seq_output_accepted(self):
        cfgs = [self._cfg("in1", "InputLayer", []),
                self._cfg("m", "Masking", ["in1"]),
                self._cfg("l1", "LSTM", ["m"]),
                self._cfg("pool", "Dense", ["l1"]),
                self._cfg("in2", "InputLayer", []),
                self._cfg("l2", "LSTM", ["in2"]),
                self._cfg("o2", "Dense", ["l2"])]
        for check, mapped in self._both(cfgs, lambda M: {
                "m": M(mask_value=0.0), "l1": self._K("lstm"),
                "pool": self._K("output"), "l2": self._K("lstm"),
                "o2": self._K("rnnoutput")}):
            check(cfgs, mapped)  # must NOT raise

    def test_masked_merge_with_unmasked_branch_rejected(self):
        cfgs = [self._cfg("in1", "InputLayer", []),
                self._cfg("in2", "InputLayer", []),
                self._cfg("m", "Masking", ["in1"]),
                self._cfg("cat", "Concatenate", ["m", "in2"]),
                self._cfg("o", "Dense", ["cat"])]
        for check, mapped in self._both(cfgs, lambda M: {
                "m": M(mask_value=0.0), "o": self._K("output")}):
            with pytest.raises(ValueError, match="merge vertex"):
                check(cfgs, mapped)


class TestKerasMasking:
    def test_masking_lstm_prediction_parity(self, kfiles):
        from deeplearning4j_tpu_torch.nn.layers import MaskingLayer
        x, want, xg, want_g = kfiles["mask_io"]
        jm, tm = _case(kfiles["mask"], x, want, tol=dict(atol=1e-5),
                       step=False)
        assert any(isinstance(la, MaskingLayer) for la in tm.layers)
        got_g = _outputs(jm, tm, xg, graph=False)
        assert not np.allclose(got_g[0], want[0])  # steps re-validated
        np.testing.assert_allclose(got_g, want_g, atol=1e-5)
        _fit_step(jm, tm, x, graph=False)

    def test_masking_through_dropout_matches_keras(self, kfiles):
        x, want = kfiles["mask_dropout_io"]
        jm, tm = _case(kfiles["mask_dropout"], x, want, tol=dict(atol=1e-5),
                       step=False)
        xg = x.copy()
        xg[0, 1] = 2.0
        assert not np.allclose(_outputs(jm, tm, xg, graph=False),
                               _np(tm.output(x)))
        _fit_step(jm, tm, x, graph=False)

    def test_functional_masking_two_branches_matches_keras(self, kfiles):
        x, want = kfiles["mask_func_io"]
        _case(kfiles["mask_func"], x, want, graph=True, tol=dict(atol=1e-5))
