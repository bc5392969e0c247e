"""Transfer learning and the frozen wrappers against the JAX package
(CPU): ``TransferLearning``, ``FineTuneConfiguration``, ``FrozenLayer``
and ``FrozenLayerWithBackprop``.

Each case builds the same network in both packages from the same seed,
carries JAX's params (and batch norm's running stats) across with
``convert.py``, and feeds both the same numpy-seeded batches; dropout
draws JAX's masks bit for bit (the same key chain). Frozen leaves must
stay bit for bit what they were.

Tolerances, with their reasons:
- params after a fine-tune (Sgd or Adam, f32): within 1e-5 absolute
  (f32 GEMMs summed in another order over a few steps; Adam's first
  steps move a param by ~lr * sign(g), and where |g| is near 0 eps
  keeps the step far below this);
- Adam's m and v: rtol 1e-3, atol 1e-7 (sums of gradients whose
  smallest entries carry the summation-order error);
- layer outputs and losses: rtol 1e-5, atol 1e-6.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JIter
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.learning import Sgd as JSgd
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.layers.attention import \
    TransformerEncoderLayer as JEncoder
from deeplearning4j_tpu.nn.layers.convolutional import \
    FrozenLayer as JFrozen
from deeplearning4j_tpu.nn.layers.misc import \
    FrozenLayerWithBackprop as JFrozenBP
from deeplearning4j_tpu.nn.layers.recurrent import \
    EmbeddingSequenceLayer as JEmb
from deeplearning4j_tpu.nn.layers.recurrent import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.transferlearning import \
    FineTuneConfiguration as JFineTune
from deeplearning4j_tpu.nn.transferlearning import \
    TransferLearning as JTransfer
from deeplearning4j_tpu_torch import random as R
from deeplearning4j_tpu_torch.convert import (network_params_from_jax,
                                              network_state_from_jax,
                                              updater_state_from_jax)
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.learning import Adam, Sgd
from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.layers import (FrozenLayer,
                                                FrozenLayerWithBackprop,
                                                from_json)
from deeplearning4j_tpu_torch.nn.layers.attention import \
    TransformerEncoderLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    EmbeddingSequenceLayer, RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.transferlearning import (
    FineTuneConfiguration, TransferLearning)
from _torch_threads import one_torch_thread  # noqa: F401,E402

PARAM_ATOL = 1e-5
MOMENT_RTOL, MOMENT_ATOL = 1e-3, 1e-7
OUT_RTOL, OUT_ATOL = 1e-5, 1e-6

J = dict(Conf=JConf, L=JL, Adam=JAdam, Sgd=JSgd, Frozen=JFrozen,
         FrozenBP=JFrozenBP, Transfer=JTransfer, FineTune=JFineTune,
         Iter=JIter)
T = dict(Conf=NeuralNetConfiguration, L=TL, Adam=Adam, Sgd=Sgd,
         Frozen=FrozenLayer, FrozenBP=FrozenLayerWithBackprop,
         Transfer=TransferLearning, FineTune=FineTuneConfiguration,
         Iter=ArrayDataSetIterator)


def _np(t):
    return t.detach().float().cpu().numpy()


def _jnp(tree):
    return jax.tree.map(np.asarray, tree)


def _carry(jn, tn):
    """JAX's params and layer state onto the port's network."""
    tn.set_params(network_params_from_jax(_jnp(jn.params())))
    if jn._net_state:
        tn.set_net_state(network_state_from_jax(_jnp(jn._net_state)))
    return tn


def _params_close(jn, tn, atol=PARAM_ATOL):
    for key, p in jn.params().items():
        for n, v in p.items():
            np.testing.assert_allclose(_np(tn.params()[key][n]),
                                       np.asarray(v), atol=atol,
                                       err_msg=f"{key}.{n}")


def _moments_close(jn, tn):
    want = updater_state_from_jax(_jnp(jn.get_updater_state()))
    for key, st in want.items():
        for part, leaves in st.items():
            for n, v in leaves.items():
                np.testing.assert_allclose(
                    _np(tn.get_updater_state()[key][part][n]), _np(v),
                    rtol=MOMENT_RTOL, atol=MOMENT_ATOL,
                    err_msg=f"{key}.{part}.{n}")


def _data(seed=0, n=96):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 4).astype(np.float32)
    Y = np.eye(2, dtype=np.float32)[(X[:, 0] + X[:, 1] > 0).astype(int)]
    return X, Y


def _base(side, seed=0):
    s = side
    return (s["Conf"].builder().seed(seed).updater(s["Adam"](0.05))
            .weight_init("xavier").list()
            .layer(s["L"].DenseLayer(n_out=16, activation="relu",
                                     name="feat"))
            .layer(s["L"].OutputLayer(n_out=2, loss="mcxent",
                                      activation="softmax", name="head"))
            .input_type_feed_forward(4).build())


def _transfer_pair():
    """A trained JAX base and its port copy, then each package's
    transfer-learned network (Sgd(0.5), layer 0 frozen, a new head);
    the port's new head takes JAX's draws."""
    X, Y = _data()
    jbase = JNet(_base(J)).init()
    jbase.fit(JIter(X, Y, batch=32), epochs=6)
    tbase = _carry(jbase, MultiLayerNetwork(_base(T), device="cpu").init())
    nets = []
    for side, base in ((J, jbase), (T, tbase)):
        nets.append(side["Transfer"].builder(base)
                    .fine_tune_configuration(
                        side["FineTune"].builder().updater(
                            side["Sgd"](0.5)).build())
                    .set_feature_extractor(0)
                    .remove_output_layer()
                    .add_layer(side["L"].OutputLayer(
                        n_out=2, loss="mcxent", activation="softmax"))
                    .build())
    jn, tn = nets
    _carry(jn, tn)
    return jbase, tbase, jn, tn, X, Y


# -- tests/test_training_infra.py::TestTransferLearning -----------------
def test_freeze_and_replace_head():
    jbase, tbase, jn, tn, X, Y = _transfer_pair()
    key = tn._layer_keys[0]
    assert key == jn._layer_keys[0]
    assert isinstance(tn.layers[0], FrozenLayer)
    w_before = tn.params()[key]["W"].detach().clone()
    # the trained features are copied in, as clones of the base's
    assert torch.equal(w_before, tbase.params()["layer_0_feat"]["W"])
    assert tn.params()[key]["W"].data_ptr() != \
        tbase.params()["layer_0_feat"]["W"].data_ptr()
    jn.fit(JIter(X, Y, batch=32), epochs=4)
    tn.fit(ArrayDataSetIterator(X, Y, batch=32), epochs=4)
    assert torch.equal(tn.params()[key]["W"], w_before)
    assert torch.equal(tn.params()[key]["b"], tbase.params()[
        "layer_0_feat"]["b"])
    _params_close(jn, tn)
    ev = tn.evaluate(ArrayDataSetIterator(X, Y, batch=32))
    assert ev.accuracy() > 0.7
    assert ev.accuracy() == pytest.approx(
        jn.evaluate(JIter(X, Y, batch=32)).accuracy())
    # the base network did not move
    assert torch.equal(tbase.params()["layer_0_feat"]["W"], w_before)


def test_remove_multiple_and_output_works():
    X, _ = _data(n=32)
    outs = []
    for side in (J, T):
        kw = {} if side is J else {"device": "cpu"}
        base = (JNet if side is J else MultiLayerNetwork)(_base(side),
                                                           **kw).init()
        net = (side["Transfer"].builder(base)
               .remove_layers_from_output(2)
               .add_layer(side["L"].DenseLayer(n_out=8, activation="tanh"))
               .add_layer(side["L"].OutputLayer(n_out=2, loss="mcxent",
                                                activation="softmax"))
               .build())
        outs.append(net)
    jn, tn = outs
    _carry(jn, tn)
    out = tn.output(X[:5])
    assert tuple(out.shape) == (5, 2)
    np.testing.assert_allclose(_np(out), np.asarray(jn.output(X[:5])),
                               rtol=OUT_RTOL, atol=OUT_ATOL)


def test_builder_rebuilds_updater_state_for_every_layer():
    """JAX's build() re-inits and rebuilds the updater state of every
    layer, frozen ones included: the same key set, all zeros."""
    jbase, tbase = _transfer_pair()[:2]
    jn2 = JTransfer.builder(jbase).set_feature_extractor(0).build()
    tn2 = TransferLearning.builder(tbase).set_feature_extractor(0).build()
    assert set(tn2.get_updater_state()) == set(jn2.get_updater_state())
    for key, st in tn2.get_updater_state().items():
        assert set(st) == set(jn2.get_updater_state()[key])
        for part in st.values():
            for t in part.values():
                assert not t.any()
    assert tn2.conf.seed == jn2.conf.seed
    assert type(tn2.conf.updater).__name__ == \
        type(jn2.conf.updater).__name__


# -- the frozen wrappers ------------------------------------------------
def test_frozen_layer_blocks_gradients():
    """tests/test_convolutional.py:155: no gradient reaches a frozen
    layer's params; its output is the inner layer's."""
    jl = JFrozen(JL.DenseLayer(n_out=3))
    tl = FrozenLayer(TL.DenseLayer(n_out=3))
    d = {"weight_init": "xavier", "activation": None}
    jl.build((4,), d)
    tl.build((4,), d)
    jp = jl.init_params(jax.random.PRNGKey(0))
    tp = {n: torch.from_numpy(np.array(v)).requires_grad_(True)
          for n, v in jp.items()}
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    out, _ = tl.apply(tp, torch.from_numpy(x), {}, False, None)
    jout, _ = jl.apply(jp, jnp.asarray(x), {}, False, None)
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    assert not out.requires_grad
    grads = jax.grad(lambda p: jnp.sum(
        jl.apply(p, jnp.asarray(x), {}, False, None)[0] ** 2))(jp)
    assert all(not np.asarray(g).any() for g in grads.values())


def _decay_conf(side):
    s = side
    return (s["Conf"].builder().seed(1).updater(s["Sgd"](0.5)).l2(0.1)
            .list()
            .layer(s["Frozen"](s["L"].DenseLayer(n_out=4, n_in=3,
                                                 activation="tanh")))
            .layer(s["L"].OutputLayer(n_out=2))
            .input_type_feed_forward(3).build())


def test_frozen_layer_ignores_weight_decay():
    """tests/test_review_fixes.py:57: a global l2 must not decay frozen
    params; the head trains as JAX's does."""
    jn = JNet(_decay_conf(J)).init()
    tn = _carry(jn, MultiLayerNetwork(_decay_conf(T), device="cpu").init())
    key = tn._layer_keys[0]
    before = tn.params()[key]["W"].detach().clone()
    rs = np.random.RandomState(0)
    x = rs.normal(size=(8, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 8)]
    for _ in range(5):
        jn.fit(x, y)
        tn.fit(x, y)
    assert torch.equal(tn.params()[key]["W"], before)
    assert tn.layers[0].l2 == 0.0 and jn.layers[0].l2 == 0.0
    _params_close(jn, tn)


def _mlp(side, *layers, seed=0):
    b = (side["Conf"].builder().seed(seed).updater(side["Adam"](1e-2))
         .weight_init("xavier").list())
    for l in layers:
        b = b.layer(l)
    return b.input_type_feed_forward(8).build()


def _bp_pair(make):
    jn = JNet(_mlp(J, *make(J))).init()
    tn = _carry(jn, MultiLayerNetwork(_mlp(T, *make(T)), device="cpu")
                .init())
    return jn, tn


def test_frozen_backprop_params_fixed_earlier_layers_train():
    """test_misc_samediff_layers.py::TestFrozenLayerWithBackprop: the
    wrapped layer stays put, the layer below it trains through it."""
    jn, tn = _bp_pair(lambda s: (
        s["L"].DenseLayer(n_out=6, activation="tanh"),
        s["FrozenBP"](s["L"].DenseLayer(n_out=6, activation="tanh")),
        s["L"].OutputLayer(n_out=2, loss="mcxent")))
    rs = np.random.RandomState(0)
    x = rs.rand(32, 8).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 32)]
    frozen_before = tn.params()[tn._layer_keys[1]]["W"].detach().clone()
    first_before = tn.params()[tn._layer_keys[0]]["W"].detach().clone()
    jn.fit(x, y, epochs=5)
    tn.fit(x, y, epochs=5)
    assert torch.equal(tn.params()[tn._layer_keys[1]]["W"], frozen_before)
    assert (tn.params()[tn._layer_keys[0]]["W"]
            - first_before).abs().max() > 1e-6
    _params_close(jn, tn)
    _moments_close(jn, tn)


def test_frozen_output_head_scores_but_does_not_move():
    jn, tn = _bp_pair(lambda s: (
        s["L"].DenseLayer(n_out=6, activation="tanh"),
        s["FrozenBP"](s["L"].OutputLayer(n_out=2, loss="mcxent"))))
    rs = np.random.RandomState(4)
    x = rs.rand(32, 8).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 32)]
    head_before = tn.params()[tn._layer_keys[1]]["W"].detach().clone()
    s0 = tn.score(x, y)
    assert np.isfinite(s0)
    assert s0 == pytest.approx(jn.score(x, y), rel=OUT_RTOL)
    jn.fit(x, y, epochs=5)
    tn.fit(x, y, epochs=5)
    assert torch.equal(tn.params()[tn._layer_keys[1]]["W"], head_before)
    _params_close(jn, tn)


def test_train_mode_dropout_still_active():
    """FrozenLayerWithBackprop keeps train-mode dropout (JAX's key, JAX's
    mask); FrozenLayer pins inference mode."""
    d = {"weight_init": "xavier"}
    x = np.ones((4, 16), np.float32)
    outs = {}
    for name, jcls, tcls in (("bp", JFrozenBP, FrozenLayerWithBackprop),
                             ("frozen", JFrozen, FrozenLayer)):
        jl = jcls(JL.DenseLayer(n_out=64, dropout=0.5,
                                activation="identity"))
        tl = tcls(TL.DenseLayer(n_out=64, dropout=0.5,
                                activation="identity"))
        jl.build((16,), d)
        tl.build((16,), d)
        jp = jl.init_params(jax.random.PRNGKey(3))
        tp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
        jt, _ = jl.apply(jp, jnp.asarray(x), {}, True,
                         jax.random.PRNGKey(5))
        tt, _ = tl.apply(tp, torch.from_numpy(x), {}, True, R.PRNGKey(5))
        ti, _ = tl.apply(tp, torch.from_numpy(x), {}, False, None)
        np.testing.assert_allclose(_np(tt), np.asarray(jt), rtol=OUT_RTOL,
                                   atol=OUT_ATOL)
        outs[name] = (tt, ti)
    assert not torch.allclose(*outs["bp"])
    assert torch.equal(*outs["frozen"])


@pytest.mark.parametrize("kind", ["frozen", "frozen_backprop"])
def test_json_equals_jax_and_round_trips(kind):
    jcls, tcls = {"frozen": (JFrozen, FrozenLayer),
                  "frozen_backprop": (JFrozenBP,
                                      FrozenLayerWithBackprop)}[kind]
    jl = jcls(JL.DenseLayer(n_out=3, dropout=0.2, l2=0.1))
    tl = tcls(TL.DenseLayer(n_out=3, dropout=0.2, l2=0.1))
    assert tl.to_json() == jl.to_json()
    d = {"weight_init": "xavier", "activation": "relu", "l2": 0.3}
    jl.build((5,), d)
    tl.build((5,), d)
    assert tl.to_json() == jl.to_json()
    back = from_json(json.loads(json.dumps(jl.to_json())))
    assert type(back) is tcls and isinstance(back.layer, TL.DenseLayer)
    assert back.to_json() == tl.to_json()


# -- a frozen conv + batch norm + dropout net ---------------------------
def _cnn_conf(side, wrap):
    s = side
    return (s["Conf"].builder().seed(7).updater(s["Adam"](1e-2))
            .weight_init("xavier").list()
            .layer(s["L"].ConvolutionLayer(n_out=4, kernel=(3, 3),
                                           activation="identity",
                                           has_bias=False))
            .layer(s[wrap](s["L"].BatchNormalization()))
            .layer(s[wrap](s["L"].DenseLayer(n_out=8, activation="relu",
                                             dropout=0.5)))
            .layer(s["L"].OutputLayer(n_out=3, loss="mcxent",
                                      activation="softmax"))
            .input_type_convolutional(6, 6, 2).build())


@pytest.mark.parametrize("wrap", ["Frozen", "FrozenBP"])
def test_frozen_conv_batchnorm_dropout_net(wrap):
    """FrozenLayer: batch norm's running stats unchanged and no dropout
    (the fit equals JAX's); FrozenLayerWithBackprop: the running stats
    move and dropout draws JAX's masks, while both wrapped layers'
    params stay put."""
    jn = JNet(_cnn_conf(J, wrap)).init()
    tn = _carry(jn, MultiLayerNetwork(_cnn_conf(T, wrap), device="cpu")
                .init())
    rs = np.random.RandomState(3)
    x = rs.randn(8, 6, 6, 2).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
    bn, dense = tn._layer_keys[1], tn._layer_keys[2]
    stats = {n: t.clone() for n, t in tn.get_net_state()[bn].items()}
    frozen = {k: {n: t.detach().clone() for n, t in tn.params()[k].items()}
              for k in (bn, dense)}
    for _ in range(3):
        jn.fit(x, y)
        tn.fit(x, y)
    for k, p in frozen.items():
        for n, t in p.items():
            assert torch.equal(tn.params()[k][n], t), (k, n)
    moved = any(not torch.equal(tn.get_net_state()[bn][n], t)
                for n, t in stats.items())
    assert moved == (wrap == "FrozenBP")
    for n, v in jn._net_state[bn].items():
        np.testing.assert_allclose(_np(tn.get_net_state()[bn][n]),
                                   np.asarray(v), rtol=OUT_RTOL,
                                   atol=OUT_ATOL)
    _params_close(jn, tn)
    assert [int(v) for v in tn._rng] == [int(v) for v in np.asarray(jn._rng)]
    # no dropout under FrozenLayer: the training loss of a frozen-layer
    # net does not depend on the key
    if wrap == "Frozen":
        a = tn.loss_and_gradients(x, y, rng=R.PRNGKey(1))[0]
        b = tn.loss_and_gradients(x, y, rng=R.PRNGKey(2))[0]
        assert float(a) == float(b)


# -- the transformer path at a small width -------------------------------
V, D, TT, B = 64, 32, 16, 4


def _lm_conf(side, impl):
    s = side
    Emb = JEmb if side is J else EmbeddingSequenceLayer
    Enc = JEncoder if side is J else TransformerEncoderLayer
    Out = JRnnOut if side is J else RnnOutputLayer
    b = (s["Conf"].builder().seed(0).updater(s["Adam"](1e-3))
         .weight_init("xavier").list().layer(Emb(n_in=V, n_out=D)))
    for _ in range(3):
        b = b.layer(Enc(n_heads=2, d_ff=64, causal=True,
                        implementation=impl))
    return (b.layer(Out(n_out=V, loss="mcxent", activation="softmax"))
            .input_type_recurrent(1, timesteps=TT).build())


def _lm_batch(seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, V, (B, TT))
    return x, np.eye(V, dtype=np.float32)[(5 * x + 3) % V]


@pytest.fixture
def counted(monkeypatch):
    """The flash Function's kernel wrappers, counted (on the CPU they
    run their plain versions and count nothing themselves)."""
    n = {"fwd": 0, "dq": 0, "dkv": 0}

    def wrap(name, fn):
        def call(*a, **kw):
            n[name] += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(fa, "flash_attention",
                        wrap("fwd", fa.flash_attention))
    monkeypatch.setattr(fa, "flash_attention_bwd_dq",
                        wrap("dq", fa.flash_attention_bwd_dq))
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv",
                        wrap("dkv", fa.flash_attention_bwd_dkv))
    return n


def test_transformer_feature_extractor_matches_jax(counted):
    """Phase 20a at a small width: a 3-block LM trained, then
    ``set_feature_extractor(2)`` (the embedding and blocks 1-2 frozen),
    the output layer replaced and fine-tuned. Frozen leaves stay bit for
    bit, trainable ones and Adam's moments follow JAX's, and the frozen
    prefix runs no backward: each step launches the forward kernel for
    every block but dQ and dK/dV for the one trainable block only."""
    jbase = JNet(_lm_conf(J, "flash")).init()
    tbase = _carry(jbase, MultiLayerNetwork(_lm_conf(T, "flash"),
                                            device="cpu").init())
    for s in range(2):
        x, y = _lm_batch(s)
        jbase.fit(x, y)
        tbase.fit(x, y)
    nets = []
    for side, base in ((J, jbase), (T, tbase)):
        Out = JRnnOut if side is J else RnnOutputLayer
        nets.append(side["Transfer"].builder(base)
                    .set_feature_extractor(2).remove_output_layer()
                    .add_layer(Out(n_out=V, loss="mcxent",
                                   activation="softmax"))
                    .build())
    jn, tn = nets
    _carry(jn, tn)
    frozen = {k: {n: t.detach().clone() for n, t in tn.params()[k].items()}
              for k in tn._layer_keys[:3]}
    for k in counted:
        counted[k] = 0
    steps = 3
    for s in range(steps):
        x, y = _lm_batch(10 + s)
        jn.fit(x, y)
        tn.fit(x, y)
        assert tn.score_ == pytest.approx(float(jn._last_loss),
                                          rel=OUT_RTOL)
    assert counted == {"fwd": 3 * steps, "dq": steps, "dkv": steps}
    for k, p in frozen.items():
        for n, t in p.items():
            assert torch.equal(tn.params()[k][n], t), (k, n)
    _params_close(jn, tn)
    _moments_close(jn, tn)


def test_port_transfer_example_runs_on_the_cpu():
    """``examples/torch/transfer_learning.py`` on the CPU reaches the
    accuracy JAX's ``examples/transfer_learning.py`` does."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent / "examples"
    accs = []
    for name, path in (("torch_transfer_example",
                        root / "torch" / "transfer_learning.py"),
                       ("jax_transfer_example",
                        root / "transfer_learning.py")):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        accs.append(mod.main(quick=True, device="cpu") if "torch" in name
                    else mod.main(quick=True))
    assert accs[0] > 0.8
    assert abs(accs[0] - accs[1]) < 0.1
