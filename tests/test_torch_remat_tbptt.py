"""Remat, truncated BPTT, ``rnn_time_step``, the anomaly guard, weight
noise and weight constraints of the port's ``MultiLayerNetwork``,
against the JAX package's (f32, CPU) and against the port's own runs
without each feature.

Tolerances, with their reasons:
- remat against the same network without it: exact (the recompute
  runs the same ops on the same inputs and keys); against JAX, losses
  1e-5 relative as ``tests/test_remat.py`` holds JAX to itself;
- TBPTT and trained networks against JAX from carried weights: losses
  1e-5 relative, params 1e-4 absolute (f32 GEMMs summed in another
  order; Adam moves a param by ~lr * sign(g));
- ``rnn_time_step`` against ``output`` over the whole sequence: 1e-5;
- DropConnect masks: bit for bit (JAX's key chain and counter layout);
  Gaussian weight noise: 1e-6 absolute on O(1) weights (the port's
  normal is within a few f32 ulp of JAX's);
- the guarded step against the unguarded one and against ``fit``:
  exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.learning import Sgd as JSgd
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import constraint as JC
from deeplearning4j_tpu.nn.conf import weightnoise as JWN
from deeplearning4j_tpu.nn.layers import attention as JA
from deeplearning4j_tpu.nn.layers import recurrent as JR
from deeplearning4j_tpu_torch import random as R
from deeplearning4j_tpu_torch.convert import (network_params_from_jax,
                                              network_state_from_jax)
from deeplearning4j_tpu_torch.learning import Adam, Sgd
from deeplearning4j_tpu_torch.nn import (MultiLayerConfiguration,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.conf import constraint as TC
from deeplearning4j_tpu_torch.nn.conf import weightnoise as TWN
from deeplearning4j_tpu_torch.nn.layers import attention as TA
from deeplearning4j_tpu_torch.nn.layers import recurrent as TR
from _torch_threads import one_torch_thread  # noqa: F401,E402

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
STEP_ATOL = 1e-5

JSIDE = dict(Conf=JConf, L=JL, R=JR, A=JA, Adam=JAdam, Sgd=JSgd, C=JC,
             WN=JWN)
TSIDE = dict(Conf=NeuralNetConfiguration, L=TL, R=TR, A=TA, Adam=Adam,
             Sgd=Sgd, C=TC, WN=TWN)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _pair(make, carry=True):
    """JAX's network and the port's from ``make(side)``, the port's
    params (and layer state) copied from JAX's."""
    jn = JNet(make(JSIDE)).init()
    tn = MultiLayerNetwork(make(TSIDE), device="cpu").init()
    if carry:
        tn.set_params(network_params_from_jax(
            jax.tree.map(np.asarray, jn.params())))
        tn.set_net_state(network_state_from_jax(
            jax.tree.map(np.asarray, jn._net_state)))
    return jn, tn


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = _np(v)
    return out


def _assert_close(jtree, ttree, atol=PARAM_ATOL):
    jf, tf = _flat(jtree), _flat(ttree)
    assert sorted(jf) == sorted(tf)
    for k, v in jf.items():
        np.testing.assert_allclose(tf[k], v, rtol=0, atol=atol, err_msg=k)


def _assert_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


# -- TBPTT ------------------------------------------------------------
def _tbptt_conf(s, tbptt=4, dropout=0.0):
    return (s["Conf"].builder().seed(1).updater(s["Adam"](1e-2))
            .dropout(dropout).list()
            .layer(s["R"].LSTM(n_out=6))
            .layer(s["R"].SimpleRnn(n_out=5))
            .layer(s["R"].RnnOutputLayer(n_out=2))
            .input_type_recurrent(2, 12).tbptt(tbptt).build())


def _seq_data(T, seed=3, n=8):
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(n, T, 2)).astype(np.float32)
    y = np.zeros((n, T, 2), np.float32)
    y[..., 0] = (x.sum(-1) > 0)
    y[..., 1] = 1 - y[..., 0]
    return x, y


@pytest.mark.parametrize("T", [12, 14])
def test_tbptt_matches_jax(T):
    """TBPTT(4) over T = 12 (three whole chunks) and T = 14 (a ragged
    tail of 2, padded with mask 0 as JAX pads it), dropout on (one key
    split a batch and one a chunk, in JAX's order): losses, params,
    Adam state, step counter and key chain against JAX's over 3 fits."""
    x, y = _seq_data(T)
    jn, tn = _pair(lambda s: _tbptt_conf(s, dropout=0.2))
    for _ in range(3):
        jn.fit(x, y)
        tn.fit(x, y)
        assert tn.score_ == pytest.approx(float(jn.score_), rel=LOSS_RTOL)
    assert tn._step == jn._step == 3
    assert [int(v) for v in tn._rng] == np.asarray(jn._rng).tolist()
    _assert_close(jn.params(), tn.params())
    _assert_close(jn.get_updater_state(), tn.get_updater_state())
    assert tn.score(x, y) == pytest.approx(float(jn.score(x, y)),
                                           rel=1e-4)


def test_tbptt_learns_and_keeps_jax_condition():
    """TBPTT lowers the loss (``tests/test_recurrent.py``), and only
    3-D input longer than a chunk goes through it, as in JAX: a
    sequence of the chunk's length trains as one step, equal to the
    network without TBPTT."""
    x, y = _seq_data(12)
    m = MultiLayerNetwork(_tbptt_conf(TSIDE), device="cpu").init()
    m.fit(x, y)
    first = m.score(x, y)
    for _ in range(30):
        m.fit(x, y)
    assert m.score(x, y) < first
    a = MultiLayerNetwork(_tbptt_conf(TSIDE, tbptt=12), device="cpu").init()
    b = MultiLayerNetwork(_tbptt_conf(TSIDE, tbptt=0), device="cpu").init()
    b.set_params(a.params())
    a.fit(x, y)
    b.fit(x, y)
    assert float(a.score_) == float(b.score_)
    _assert_equal(a.params(), b.params())


# -- remat ------------------------------------------------------------
def _mlp(s, remat):
    return (s["Conf"].builder().seed(5).updater(s["Adam"](1e-2))
            .weight_init("xavier").remat(remat).list()
            # no bias before batch norm (its gradient is 0 up to
            # rounding, which Adam's first steps would amplify), and the
            # ReLU after it: JAX and PyTorch round the normalization of
            # a ReLU's zeros differently
            .layer(s["L"].DenseLayer(n_out=16, activation="identity",
                                     has_bias=False))
            .layer(s["L"].BatchNormalization(activation="relu"))
            .layer(s["L"].DenseLayer(n_out=16, activation="tanh",
                                     dropout=0.3))
            .layer(s["L"].OutputLayer(n_out=3, loss="mcxent",
                                      activation="softmax"))
            .input_type_feed_forward(6).build())


def _mlp_data(seed=0, n=32, f=6, c=3):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, f).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rs.randint(0, c, n)]
    return x, y


class TestRemat:
    """``tests/test_remat.py``, each case also held bit for bit to the
    port's network without remat."""

    def test_mlp_losses_identical(self):
        x, y = _mlp_data()
        jrem, rem = _pair(lambda s: _mlp(s, True))
        base = MultiLayerNetwork(_mlp(TSIDE, False), device="cpu").init()
        base.set_params(rem.params())
        for _ in range(5):
            base.fit(x, y)
            rem.fit(x, y)
            jrem.fit(x, y)
            assert float(base.score_) == float(rem.score_)
            assert rem.score_ == pytest.approx(float(jrem.score_),
                                               rel=LOSS_RTOL)
        _assert_equal(base.params(), rem.params())
        # batch norm's running stats moved once a step, not twice
        _assert_equal(base.get_net_state(), rem.get_net_state())
        _assert_close(jrem._net_state, rem.get_net_state(), STEP_ATOL)
        np.testing.assert_array_equal(_np(base.output(x)),
                                      _np(rem.output(x)))

    def test_rnn_remat(self):
        def net(s, remat):
            return (s["Conf"].builder().seed(2).updater(s["Adam"](5e-3))
                    .weight_init("xavier").remat(remat).list()
                    .layer(s["R"].LSTM(n_out=8, activation="tanh"))
                    .layer(s["R"].RnnOutputLayer(n_out=2, loss="mcxent",
                                                 activation="softmax"))
                    .input_type_recurrent(4).build())
        rs = np.random.RandomState(1)
        x = rs.rand(8, 5, 4).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, (8, 5))]
        jrem, rem = _pair(lambda s: net(s, True))
        base = MultiLayerNetwork(net(TSIDE, False), device="cpu").init()
        base.set_params(rem.params())
        for _ in range(3):
            base.fit(x, y)
            rem.fit(x, y)
            jrem.fit(x, y)
            assert float(base.score_) == float(rem.score_)
            assert rem.score_ == pytest.approx(float(jrem.score_),
                                               rel=LOSS_RTOL)
        _assert_equal(base.params(), rem.params())

    def test_graph_remat(self):
        """``tests/test_remat.py``'s graph case: remat on a graph gives
        the losses and params of the graph without it, bit for bit, and
        JAX's remat graph's losses within LOSS_RTOL."""
        from deeplearning4j_tpu.nn import ComputationGraph as JGraph
        from deeplearning4j_tpu.nn.conf import InputType as JInputType
        from deeplearning4j_tpu_torch.convert import graph_params_from_jax
        from deeplearning4j_tpu_torch.nn import ComputationGraph
        from deeplearning4j_tpu_torch.nn.conf import InputType

        def conf(s, it, remat):
            g = (s["Conf"].builder().seed(3).updater(s["Adam"](1e-2))
                 .weight_init("xavier").remat(remat).graph_builder()
                 .add_inputs("in").set_input_types(it.feed_forward(6)))
            g.add_layer("d1", s["L"].DenseLayer(n_out=12, activation="relu"),
                        "in")
            g.add_layer("out", s["L"].OutputLayer(
                n_out=3, loss="mcxent", activation="softmax"), "d1")
            return g.set_outputs("out").build()
        x, y = _mlp_data(seed=4)
        base = ComputationGraph(conf(TSIDE, InputType, False),
                                device="cpu").init()
        rem = ComputationGraph(conf(TSIDE, InputType, True),
                               device="cpu").init()
        jrem = JGraph(conf(JSIDE, JInputType, True)).init()
        rem.set_params(graph_params_from_jax(jax.tree.map(
            np.asarray, jrem.params())))
        base.set_params(rem.params())
        for _ in range(4):
            base.fit(x, y)
            rem.fit(x, y)
            jrem.fit(x, y)
            assert float(base.score_) == float(rem.score_)
            assert rem.score_ == pytest.approx(float(jrem.score_),
                                               rel=LOSS_RTOL)
        _assert_equal(base.params(), rem.params())

    def test_remat_json_round_trip(self):
        m = MultiLayerNetwork(_mlp(TSIDE, True), device="cpu").init()
        conf2 = MultiLayerConfiguration.from_json(m.conf.to_json())
        assert conf2.remat is True
        assert conf2.to_json() == JNet(_mlp(JSIDE, True)).init() \
            .conf.to_json()
        MultiLayerNetwork(conf2, device="cpu").init()

    @pytest.mark.parametrize("implementation", ["plain", "flash"])
    def test_transformer_stack_identical(self, implementation):
        """A 2-block causal transformer stack with dropout under remat:
        losses, params and Adam state bit for bit those of the stack
        without it ("flash" runs the flash Function's plain versions on
        the CPU, its forward twice a layer a step)."""
        from deeplearning4j_tpu_torch.kernels import flash_attention as fa

        def conf(remat):
            b = (NeuralNetConfiguration.builder().seed(0).updater(Adam(1e-3))
                 .weight_init("xavier").dropout(0.1).remat(remat).list()
                 .layer(TR.EmbeddingSequenceLayer(n_in=40, n_out=16)))
            for _ in range(2):
                b = b.layer(TA.TransformerEncoderLayer(
                    n_heads=2, d_ff=32, causal=True,
                    implementation=implementation))
            return (b.layer(TR.RnnOutputLayer(n_out=40, loss="mcxent"))
                    .input_type_recurrent(1, timesteps=12).build())
        rs = np.random.RandomState(0)
        x = rs.randint(0, 40, (3, 12))
        y = np.eye(40, dtype=np.float32)[(x * 7 + 3) % 40]
        base = MultiLayerNetwork(conf(False), device="cpu").init()
        rem = MultiLayerNetwork(conf(True), device="cpu").init()
        rem.set_params(base.params())
        calls = []
        real = fa.flash_attention
        fa.flash_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            for _ in range(3):
                base.fit(x, y)
                n0 = len(calls)
                rem.fit(x, y)
                assert float(base.score_) == float(rem.score_)
                if implementation == "flash":
                    assert len(calls) - n0 == 2 * 2   # 2 blocks, twice
        finally:
            fa.flash_attention = real
        _assert_equal(base.params(), rem.params())
        _assert_equal(base.get_updater_state(), rem.get_updater_state())


# -- rnn_time_step ----------------------------------------------------
def _token_conf(s):
    return (s["Conf"].builder().seed(1).updater(s["Adam"](1e-2)).list()
            .layer(s["R"].EmbeddingSequenceLayer(n_in=20, n_out=8))
            .layer(s["R"].LSTM(n_out=6))
            .layer(s["R"].RnnOutputLayer(n_out=3))
            .input_type_recurrent(1, 5).build())


def test_int_token_input_lstm():
    """``tests/test_review_fixes.py::test_int_token_input_lstm``: int32
    tokens through an embedding into an LSTM train (f32 carries), the
    stateful path takes [B, T] tokens, and both match JAX."""
    jn, tn = _pair(_token_conf)
    tokens = np.random.default_rng(0).integers(0, 20, (4, 5)).astype(
        np.int32)
    y = np.zeros((4, 5, 3), np.float32)
    y[..., 0] = 1
    jn.fit(tokens, y)
    tn.fit(tokens, y)
    assert tn.score_ == pytest.approx(float(jn.score_), rel=LOSS_RTOL)
    out = tn.output(tokens)
    assert tuple(out.shape) == (4, 5, 3)
    tn.rnn_clear_previous_state()
    jn.rnn_clear_previous_state()
    a, b = tn.rnn_time_step(tokens[:, :2]), tn.rnn_time_step(tokens[:, 2:])
    assert tuple(b.shape) == (4, 3, 3)
    np.testing.assert_allclose(_np(torch.cat([a, b], 1)), _np(out),
                               atol=1e-5)
    ja = jn.rnn_time_step(tokens[:, :2])
    np.testing.assert_allclose(_np(a), np.asarray(ja), atol=STEP_ATOL)


def test_rnn_time_step_single_steps_and_clear():
    """The 2-D overload: one [B, C] step at a time equals ``output`` of
    the whole sequence; after ``rnn_clear_previous_state`` the first
    step again equals the first."""
    def conf(s):
        return (s["Conf"].builder().seed(4).updater(s["Sgd"](0.1)).list()
                .layer(s["R"].GravesLSTM(n_out=5))
                .layer(s["R"].GRU(n_out=4))
                .layer(s["R"].RnnOutputLayer(n_out=3))
                .input_type_recurrent(3, 9).build())
    jn, tn = _pair(conf)
    x = np.random.default_rng(1).normal(size=(2, 9, 3)).astype(np.float32)
    full = _np(tn.output(x))
    steps = [_np(tn.rnn_time_step(x[:, t])) for t in range(9)]
    assert steps[0].shape == (2, 3)
    np.testing.assert_allclose(np.stack(steps, 1), full, atol=1e-5)
    jsteps = [np.asarray(jn.rnn_time_step(x[:, t])) for t in range(9)]
    np.testing.assert_allclose(np.stack(steps, 1), np.stack(jsteps, 1),
                               atol=STEP_ATOL)
    tn.rnn_clear_previous_state()
    np.testing.assert_array_equal(_np(tn.rnn_time_step(x[:, 0])), steps[0])


# -- the anomaly guard ------------------------------------------------
def test_anomaly_guard():
    """A NaN batch leaves params, updater state and layer state as they
    were, with ok False on the device; over clean data the guarded
    step's trajectory is the unguarded one's and ``fit``'s, bit for
    bit."""
    x, y = _mlp_data(2)
    net = MultiLayerNetwork(_mlp(TSIDE, False), device="cpu").init()
    ref = net.clone()
    guarded, plain = net._make_step_fn(guard=True), net._make_step_fn()
    st_g = (net.params(), net.get_updater_state(), net.get_net_state())
    st_p = st_g
    key = R.PRNGKey(7)
    for step in range(3):
        keys = R.split(key)
        key, sub = R.key_at(keys, 0), R.key_at(keys, 1)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        *st_g, loss_g, ok = guarded(*st_g, step, xt, yt, None, sub)
        *st_p, loss_p = plain(*st_p, step, xt, yt, None, sub)
        assert ok.dtype == torch.bool and ok.device == xt.device and bool(ok)
        assert float(loss_g) == float(loss_p)
        for a, b in zip(st_g, st_p):
            _assert_equal(a, b)
    # fit over the same batches and keys: the same bits
    ref._rng = R.PRNGKey(7)
    for _ in range(3):
        ref.fit(x, y)
    _assert_equal(ref.params(), st_g[0])
    _assert_equal(ref.get_updater_state(), st_g[1])
    _assert_equal(ref.get_net_state(), st_g[2])
    bad = x.copy()
    bad[3, 2] = np.nan
    *after, loss, ok = guarded(*st_g, 3, torch.from_numpy(bad),
                               torch.from_numpy(y), None, key)
    assert not bool(ok) and not np.isfinite(float(loss))
    for a, b in zip(after, st_g):
        _assert_equal(a, b)
    assert all(torch.isfinite(t).all() for p in after[0].values()
               for t in p.values())


# -- weight noise and constraints -------------------------------------
@pytest.mark.parametrize("scheme", ["dropconnect", "additive",
                                    "multiplicative"])
def test_weight_noise_draws_jax_masks(scheme):
    spec = {"dropconnect": {"@class": "dropconnect", "keep_prob": 0.7},
            "additive": {"@class": "weight_gaussian_noise", "stddev": 0.2},
            "multiplicative": {"@class": "weight_gaussian_noise",
                               "stddev": 0.1, "mean": 1.0,
                               "additive": False}}[scheme]
    jl, tl = JL.DenseLayer(n_out=6, weight_noise=spec), \
        TL.DenseLayer(n_out=6, weight_noise=spec)
    assert tl.weight_noise.to_json() == jl.weight_noise.to_json()
    for layer in (jl, tl):
        layer.build((5,), {"weight_init": "xavier"})
    jp = jl.init_params(jax.random.PRNGKey(0))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    for seed in (3, 11):
        jk = jax.random.PRNGKey(seed)
        jw = jl._maybe_weight_noise(jp, True, jk)
        tw = tl._maybe_weight_noise(tp, True, R.PRNGKey(seed))
        np.testing.assert_array_equal(_np(tw["b"]), np.asarray(jw["b"]))
        if scheme == "dropconnect":
            np.testing.assert_array_equal(_np(tw["W"]), np.asarray(jw["W"]))
            kept = (_np(tw["W"]) != 0).mean()
            assert 0.5 < kept < 0.9
        else:
            np.testing.assert_allclose(_np(tw["W"]), np.asarray(jw["W"]),
                                       rtol=0, atol=1e-6)
    assert tl._maybe_weight_noise(tp, False, R.PRNGKey(0)) is tp


def _noise_conf(s, remat=False):
    return (s["Conf"].builder().seed(9).updater(s["Adam"](1e-2))
            .weight_noise(s["WN"].DropConnect(0.8)).remat(remat).list()
            .layer(s["L"].DenseLayer(n_out=12, activation="relu"))
            .layer(s["L"].OutputLayer(n_out=3))
            .input_type_feed_forward(6).build())


def test_weight_noise_training_matches_jax():
    """DropConnect as the configuration's default: the noise goes on in
    the forward where JAX puts it, so the trajectory is JAX's; under
    remat it is the same bits."""
    x, y = _mlp_data(4)
    jn, tn = _pair(_noise_conf)
    rem = MultiLayerNetwork(_noise_conf(TSIDE, True), device="cpu").init()
    rem.set_params(tn.params())
    for _ in range(3):
        jn.fit(x, y)
        tn.fit(x, y)
        rem.fit(x, y)
        assert tn.score_ == pytest.approx(float(jn.score_), rel=LOSS_RTOL)
        assert float(rem.score_) == float(tn.score_)
    _assert_close(jn.params(), tn.params())
    # no noise in inference
    np.testing.assert_allclose(_np(tn.output(x)), np.asarray(jn.output(x)),
                               atol=1e-5)


@pytest.mark.parametrize("which", ["max_norm", "min_max_norm", "unit_norm",
                                   "non_negative"])
def test_constrained_params_match_jax(which):
    def conf(s):
        c = {"max_norm": lambda: s["C"].MaxNormConstraint(0.5),
             "min_max_norm": lambda: s["C"].MinMaxNormConstraint(
                 0.3, 0.6, rate=0.5),
             "unit_norm": lambda: s["C"].UnitNormConstraint(
                 apply_to_biases=True),
             "non_negative": lambda: s["C"].NonNegativeConstraint()}[which]
        return (s["Conf"].builder().seed(2).updater(s["Sgd"](0.5))
                .constrain_weights(c()).list()
                .layer(s["L"].DenseLayer(n_out=7, activation="tanh"))
                .layer(s["L"].OutputLayer(n_out=3))
                .input_type_feed_forward(6).build())
    x, y = _mlp_data(5)
    jn, tn = _pair(conf)
    assert tn.conf.to_json() == jn.conf.to_json()
    for _ in range(2):
        jn.fit(x, y)
        tn.fit(x, y)
    _assert_close(jn.params(), tn.params(), STEP_ATOL)
    W = _np(tn.params()["layer_0"]["W"])
    norms = np.sqrt((W * W).sum(0))
    if which == "max_norm":
        assert norms.max() <= 0.5 + 1e-6
    elif which == "unit_norm":
        np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    elif which == "non_negative":
        assert (W >= 0).all() and (_np(tn.params()["layer_0"]["b"]) >= 0
                                   ).all()
