"""The port's recurrent layers against the JAX package's (f32, CPU):
every case of ``tests/test_recurrent.py`` (shapes, the Bidirectional
modes, masks holding state, masked equals truncated, the GRU cases,
learning and JSON), each layer's forward and gradients held to JAX's
from the same weights, and networks trained from carried weights.

Tolerances, with their reasons:
- forward outputs and carries: 1e-5 absolute. The same f32 gate math,
  the hoisted projection and the recurrent products summed in another
  order (XLA's dot against ATen's);
- gradients: 1e-4 of each leaf's largest magnitude (backprop through
  up to 7 steps accumulates those orderings);
- losses over training steps: 1e-5 relative, params 1e-4 absolute
  (Adam moves a param by ~lr * sign(g); eps keeps a near-zero
  gradient's step far below 1e-4, as in ``tests/test_torch_multilayer.py``).
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
from deeplearning4j_tpu.nn.layers import recurrent as JR
from deeplearning4j_tpu_torch import random as R
from deeplearning4j_tpu_torch.convert import network_params_from_jax
from deeplearning4j_tpu_torch.learning import Adam, Sgd
from deeplearning4j_tpu_torch.nn import (MultiLayerConfiguration,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.layers import recurrent as TR
from _torch_threads import one_torch_thread  # noqa: F401,E402

FWD_ATOL = 1e-5
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4

SIDES = ((JR, JL), (TR, TL))


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor)
                      else t)


def _build_pair(make, n_in=4, t=7, seed=0):
    """The layer built by ``make(R, L)`` on each side, JAX's params drawn
    from ``seed`` and copied to the port."""
    jl, tl = make(JR, JL), make(TR, TL)
    for layer in (jl, tl):
        layer.build((t, n_in), {"weight_init": "xavier", "activation": None})
    jp = jl.init_params(jax.random.PRNGKey(seed))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jl, jp, tl, tp


def _carries_close(jc, tc):
    jl, tl = jax.tree_util.tree_leaves(jc), jax.tree_util.tree_leaves(
        [list(c) if isinstance(c, tuple) else c for c in
         (tc if isinstance(tc, tuple) else (tc,))])
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0,
                                   atol=FWD_ATOL)


def _run_pair(jl, jp, tl, tp, x, mask=None):
    B = x.shape[0]
    jout, _, jc = jl.apply_seq(jp, jnp.asarray(x), {}, False, None,
                               jl.init_carry(B),
                               None if mask is None else jnp.asarray(mask))
    tout, _, tc = tl.apply_seq(tp, torch.from_numpy(x), {}, False, None,
                               tl.init_carry(B),
                               None if mask is None
                               else torch.from_numpy(mask))
    return jout, jc, tout, tc


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


RNN_KINDS = {
    "lstm": lambda R, L: R.LSTM(n_out=5),
    "graveslstm": lambda R, L: R.GravesLSTM(n_out=5),
    "simplernn": lambda R, L: R.SimpleRnn(n_out=5),
    "gru": lambda R, L: R.GRU(n_out=5),
    "gru_reset_after": lambda R, L: R.GRU(n_out=5, reset_after=True),
}


@pytest.mark.parametrize("kind", ["lstm", "graveslstm", "simplernn"])
def test_rnn_forward_shape(kind):
    jl, jp, tl, tp = _build_pair(RNN_KINDS[kind])
    x = _x((3, 7, 4))
    jout, jc, tout, tc = _run_pair(jl, jp, tl, tp, x)
    assert tuple(tout.shape) == (3, 7, 5)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=0,
                               atol=FWD_ATOL)
    _carries_close(jc, tc)


@pytest.mark.parametrize("mode,ch", [("concat", 10), ("add", 5),
                                     ("mul", 5), ("average", 5)])
def test_bidirectional_modes(mode, ch):
    jl, jp, tl, tp = _build_pair(
        lambda R, L: R.Bidirectional(R.LSTM(n_out=5), mode=mode))
    assert sorted(tp) == sorted(tl.param_shapes())
    x = _x((3, 7, 4))
    mask = np.ones((3, 7), np.float32)
    mask[1, 5:] = 0.0
    for m in (None, mask):
        jout, jc, tout, tc = _run_pair(jl, jp, tl, tp, x, m)
        assert tuple(tout.shape) == (3, 7, ch)
        np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=0,
                                   atol=FWD_ATOL)
        _carries_close(jc, tc)


def test_mask_holds_state_and_zeroes_output():
    """Masked steps emit zeros and hold the carry, as in JAX."""
    jl, jp, tl, tp = _build_pair(RNN_KINDS["lstm"])
    x = _x((2, 7, 4))
    mask = np.ones((2, 7), np.float32)
    mask[0, 4:] = 0.0
    jout, jc, out, (h, c) = _run_pair(jl, jp, tl, tp, x, mask)
    assert np.allclose(_np(out)[0, 4:], 0.0)
    _, _, _, (h4, c4) = _run_pair(jl, jp, tl, tp, x[:, :4], mask[:, :4])
    np.testing.assert_allclose(_np(h)[0], _np(h4)[0], atol=1e-6)
    np.testing.assert_allclose(_np(c)[0], _np(c4)[0], atol=1e-6)
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=0,
                               atol=FWD_ATOL)
    _carries_close(jc, (h, c))


def test_masked_equals_truncated():
    jl, jp, tl, tp = _build_pair(RNN_KINDS["graveslstm"])
    tp["p"] = torch.linspace(-0.5, 0.5, 15)     # live peepholes
    jp = dict(jp, p=jnp.asarray(tp["p"].numpy()))
    x = _x((1, 7, 4))
    mask = np.ones((1, 7), np.float32)
    mask[0, 5:] = 0.0
    jout, _, out_m, _ = _run_pair(jl, jp, tl, tp, x, mask)
    _, _, out_t, _ = _run_pair(jl, jp, tl, tp, x[:, :5])
    np.testing.assert_allclose(_np(out_m)[0, :5], _np(out_t)[0], atol=1e-5)
    np.testing.assert_allclose(_np(out_m), np.asarray(jout), rtol=0,
                               atol=FWD_ATOL)


def test_bidirectional_mask_aware_reverse():
    """The backward pass starts at each sequence's true end."""
    jl, jp, tl, tp = _build_pair(
        lambda R, L: R.Bidirectional(R.SimpleRnn(n_out=3), mode="concat"),
        t=6)
    x = _x((1, 6, 4))
    mask = np.ones((1, 6), np.float32)
    mask[0, 4:] = 0.0
    jout, _, out_m, _ = _run_pair(jl, jp, tl, tp, x, mask)
    _, _, out_t, _ = _run_pair(jl, jp, tl, tp, x[:, :4])
    np.testing.assert_allclose(_np(out_m)[0, :4], _np(out_t)[0], atol=1e-5)
    np.testing.assert_allclose(_np(out_m), np.asarray(jout), rtol=0,
                               atol=FWD_ATOL)


GRAD_KINDS = dict(RNN_KINDS, bidirectional=lambda R, L: R.Bidirectional(
    R.GRU(n_out=3), mode="mul"), lasttimestep=lambda R, L: R.LastTimeStep(
        R.LSTM(n_out=3)), maskzero=lambda R, L: R.MaskZeroLayer(
            R.SimpleRnn(n_out=3)))


@pytest.mark.parametrize("kind,masked", [(k, True) for k in sorted(
    GRAD_KINDS)] + [(k, False) for k in ("bidirectional", "graveslstm",
                                         "gru_reset_after", "lstm")])
def test_forward_and_gradients_match_jax(kind, masked):
    """sum(out^2) and its gradient for every param, from the same
    weights, input and mask, against JAX's autodiff of its scan."""
    jl, jp, tl, tp = _build_pair(GRAD_KINDS[kind], n_in=2, t=5)
    x = _x((2, 5, 2), seed=3)
    x[1, 4] = 0.0          # an all-zero step for MaskZeroLayer
    mask = None
    if masked:
        mask = np.ones((2, 5), np.float32)
        mask[0, 3:] = 0.0

    def jloss(p):
        out, _, _ = jl.apply_seq(p, jnp.asarray(x), {}, False, None,
                                 jl.init_carry(2),
                                 None if mask is None else jnp.asarray(mask))
        return jnp.sum(out ** 2)

    jv, jg = jax.value_and_grad(jloss)(jp)
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    out, _, _ = tl.apply_seq(tp, torch.from_numpy(x), {}, False, None,
                             tl.init_carry(2),
                             None if mask is None
                             else torch.from_numpy(mask))
    tv = (out ** 2).sum()
    tg = dict(zip(tp, torch.autograd.grad(tv, list(tp.values()))))
    assert float(tv.detach()) == pytest.approx(float(jv), rel=LOSS_RTOL)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        ref = np.asarray(jg[k])
        err = np.abs(_np(tg[k]) - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= GRAD_TOL, (k, err)


def _carry_net(jconf, tconf):
    jn = JNet(jconf).init()
    tn = MultiLayerNetwork(tconf, device="cpu").init()
    tn.set_params(network_params_from_jax(
        jax.tree.map(np.asarray, jn.params())))
    return jn, tn


def _assert_params_close(jn, tn, atol=PARAM_ATOL):
    for key, p in jn.params().items():
        for n, v in p.items():
            np.testing.assert_allclose(_np(tn.params()[key][n]),
                                       np.asarray(v), rtol=0, atol=atol,
                                       err_msg=f"{key}.{n}")


def _lasttimestep_conf(side):
    R, L = SIDES[side]
    Conf, Opt = (JConf, JAdam) if side == 0 else (NeuralNetConfiguration,
                                                   Adam)
    return (Conf.builder().seed(7).updater(Opt(5e-2)).list()
            .layer(R.LastTimeStep(R.LSTM(n_out=8)))
            .layer(L.OutputLayer(n_out=2))
            .input_type_recurrent(3, 6).build())


def test_lstm_lasttimestep_training_learns():
    """Sequence classification (the class is the sign of the mean
    input): the port learns it, step for step with JAX for the first
    steps."""
    rs = np.random.default_rng(42)
    x = rs.normal(size=(64, 6, 3)).astype(np.float32)
    labels = (x.mean(axis=(1, 2)) > 0).astype(int)
    y = np.eye(2, dtype=np.float32)[labels]
    jn, tn = _carry_net(_lasttimestep_conf(0), _lasttimestep_conf(1))
    for _ in range(3):
        jn.fit(x, y)
        tn.fit(x, y)
        assert tn.score_ == pytest.approx(float(jn.score_), rel=LOSS_RTOL)
    _assert_params_close(jn, tn)
    for _ in range(57):
        tn.fit(x, y)
    pred = _np(tn.output(x)).argmax(1)
    assert (pred == labels).mean() > 0.9


def _stateful_conf(side):
    R, L = SIDES[side]
    Conf, Opt = (JConf, JSgd) if side == 0 else (NeuralNetConfiguration, Sgd)
    return (Conf.builder().seed(5).updater(Opt(0.1)).list()
            .layer(R.LSTM(n_out=4))
            .layer(R.RnnOutputLayer(n_out=2))
            .input_type_recurrent(3, 8).build())


def test_rnn_time_step_stateful_matches_full():
    jn, tn = _carry_net(_stateful_conf(0), _stateful_conf(1))
    x = np.random.default_rng(0).normal(size=(2, 8, 3)).astype(np.float32)
    tn.rnn_clear_previous_state()
    jn.rnn_clear_previous_state()
    a = tn.rnn_time_step(x[:, :5])
    b = tn.rnn_time_step(x[:, 5:])
    ja = jn.rnn_time_step(x[:, :5])
    jb = jn.rnn_time_step(x[:, 5:])
    full = _np(tn.output(x))
    np.testing.assert_allclose(_np(b), full[:, 5:], atol=1e-5)
    np.testing.assert_allclose(_np(a), full[:, :5], atol=1e-5)
    np.testing.assert_allclose(_np(a), np.asarray(ja), atol=FWD_ATOL)
    np.testing.assert_allclose(_np(b), np.asarray(jb), atol=FWD_ATOL)


def test_maskzero_derives_mask():
    jl, jp, tl, tp = _build_pair(
        lambda R, L: R.MaskZeroLayer(R.SimpleRnn(n_out=3)), t=6)
    x = _x((1, 6, 4))
    x[0, 4:] = 0.0          # padding rows
    jout, jc, out, tc = _run_pair(jl, jp, tl, tp, x)
    assert np.allclose(_np(out)[0, 4:], 0.0)
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=FWD_ATOL)
    _carries_close(jc, tc)


def test_embedding_sequence_and_repeat():
    emb = TR.EmbeddingSequenceLayer(n_in=10, n_out=4)
    emb.build((5,), {"weight_init": "xavier"})
    p = emb.init_params(R.PRNGKey(0))
    out, _ = emb.apply(p, torch.tensor([[1, 2, 3, 4, 5]]), {}, False, None)
    assert tuple(out.shape) == (1, 5, 4)
    np.testing.assert_array_equal(_np(out)[0], _np(p["W"])[1:6])
    rv, jrv = TR.RepeatVector(n=3), JR.RepeatVector(n=3)
    rv.build((4,), {})
    jrv.build((4,), {})
    x = _x((2, 4))
    out2, _ = rv.apply({}, torch.from_numpy(x), {}, False, None)
    assert tuple(out2.shape) == (2, 3, 4)
    np.testing.assert_array_equal(
        _np(out2), np.asarray(jrv.apply({}, jnp.asarray(x), {}, False,
                                        None)[0]))


def _json_conf(side):
    R, L = SIDES[side]
    Conf, Opt = (JConf, JAdam) if side == 0 else (NeuralNetConfiguration,
                                                   Adam)
    return (Conf.builder().seed(1).updater(Opt(1e-3)).list()
            .layer(R.Bidirectional(R.LSTM(n_out=8), mode="add"))
            .layer(R.GravesBidirectionalLSTM(n_out=4))
            .layer(R.RnnOutputLayer(n_out=3))
            .input_type_recurrent(4, 10).tbptt(5).build())


def test_json_roundtrip_recurrent():
    conf = _json_conf(1)
    assert conf.to_json() == _json_conf(0).to_json()
    c2 = MultiLayerConfiguration.from_json(conf.to_json())
    assert c2.to_json() == conf.to_json()
    m = MultiLayerNetwork(c2, device="cpu").init()
    out = m.output(np.zeros((2, 10, 4), np.float32))
    assert tuple(out.shape) == (2, 10, 3)


def _gru_conf(side, reset_after):
    R, L = SIDES[side]
    Conf, Opt = (JConf, JAdam) if side == 0 else (NeuralNetConfiguration,
                                                   Adam)
    return (Conf.builder().seed(3).updater(Opt(5e-3))
            .weight_init("xavier").list()
            .layer(R.GRU(n_out=10, reset_after=reset_after))
            .layer(R.RnnOutputLayer(n_out=2, loss="mcxent",
                                    activation="softmax"))
            .input_type_recurrent(4).build())


class TestGRU:
    """``tests/test_recurrent.py::TestGRU``: both GRU forms."""

    @pytest.mark.parametrize("reset_after", [False, True])
    def test_learns_sequence_task(self, reset_after):
        rs = np.random.RandomState(0)
        x = rs.rand(32, 6, 4).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[(x.sum(-1) > 2.0).astype(int)]
        jn, tn = _carry_net(_gru_conf(0, reset_after),
                            _gru_conf(1, reset_after))
        losses = []
        for i in range(60):
            tn.fit(x, y)
            losses.append(tn.score_)
            if i < 3:
                jn.fit(x, y)
                assert tn.score_ == pytest.approx(float(jn.score_),
                                                  rel=LOSS_RTOL)
        assert losses[-1] < losses[0] - 0.1, (losses[0], losses[-1])

    def test_masking_holds_state(self):
        jl, jp, tl, tp = _build_pair(lambda R, L: R.GRU(n_out=3), t=5)
        x = np.random.RandomState(1).rand(2, 5, 4).astype(np.float32)
        mask = np.asarray([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
        jout, jh, out, h = _run_pair(jl, jp, tl, tp, x, mask)
        assert (_np(out)[0, 3:] == 0).all()
        _, _, _, h_short = _run_pair(jl, jp, tl, tp, x[:, :3])
        np.testing.assert_allclose(_np(h)[0], _np(h_short)[0], rtol=1e-5)
        np.testing.assert_allclose(_np(h), np.asarray(jh), atol=FWD_ATOL)

    def test_json_round_trip(self):
        conf = _gru_conf(1, True)
        conf2 = MultiLayerConfiguration.from_json(conf.to_json())
        assert isinstance(conf2.layers[0], TR.GRU)
        assert conf2.layers[0].reset_after is True
        assert conf2.layers[0].to_json() == _gru_conf(0, True).layers[
            0].to_json()
        MultiLayerNetwork(conf2, device="cpu").init()

    def test_gradcheck(self):
        """The port's autograd against central differences, as JAX's
        test checks its own."""
        tl = TR.GRU(n_out=3, reset_after=True)
        tl.build((4, 2), {"weight_init": "xavier"})
        p = {k: v.double() for k, v in
             tl.init_params(R.PRNGKey(1)).items()}
        p["b"] = torch.linspace(-0.3, 0.3, 9, dtype=torch.float64)
        p["b_rec"] = torch.linspace(0.2, -0.2, 9, dtype=torch.float64)
        x = torch.from_numpy(np.random.RandomState(2).rand(3, 4, 2))

        def loss(params):
            out, _, _ = tl.apply_seq(params, x, {}, False, None,
                                     tl.init_carry(3, torch.float64), None)
            return (out ** 2).sum()

        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        g = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                 list(leaves.values()))))
        eps = 1e-6
        for name in ("W", "U", "b", "b_rec"):
            idx = (0,) * p[name].ndim
            pp, pm = dict(p), dict(p)
            pp[name] = p[name].clone()
            pp[name][idx] += eps
            pm[name] = p[name].clone()
            pm[name][idx] -= eps
            num = (float(loss(pp)) - float(loss(pm))) / (2 * eps)
            assert abs(float(g[name][idx]) - num) < 1e-6 * max(1.0, abs(num))
