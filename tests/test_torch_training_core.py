"""The port's training core against the JAX package (f32, CPU):
activations, losses, updaters, the configuration builder and the
array iterator, on the same numpy-seeded inputs.

Tolerance: 1e-6 absolute and relative for elementwise functions and
losses (the same f32 formulas; a loss sum of ~18 summed in another
order moves by a few ulps, ~2e-6), rtol 1e-5 for updater steps
(Adam's bias correction is computed in f32 on both sides, in another
order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import activations as JA
from deeplearning4j_tpu import learning as JU
from deeplearning4j_tpu import losses as JL
from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JIter
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu_torch import activations as A
from deeplearning4j_tpu_torch import learning as U
from deeplearning4j_tpu_torch import losses as L
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.precision import compute_dtype

ATOL = RTOL = 1e-6


def _x(seed, *shape, scale=2.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


@pytest.mark.parametrize("name", ["identity", "softmax", "gelu", "relu",
                                  "tanh", "sigmoid"])
def test_activation_matches_jax(name):
    x = _x(0, 4, 7)
    np.testing.assert_allclose(A.get(name)(torch.from_numpy(x)).numpy(),
                               np.asarray(JA.get(name)(jnp.asarray(x))),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("precise", [True, False])
def test_gelu_forms(precise):
    """The gelu ACTIVATION is the exact erf form by default; the tanh
    form is what the transformer MLP uses (jax.nn.gelu's default)."""
    x = _x(1, 64)
    got = A.GELU(precise=precise)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(JA.GELU(precise=precise)(jnp.asarray(x))),
        rtol=0, atol=ATOL)
    assert A.get("gelu") == A.GELU(precise=True)
    assert A.get({"@class": "gelu", "precise": False}) == A.GELU(False)
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert (exact.numpy() == got).all() == precise


def test_unported_names_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        A.get("swish")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        L.get("binaryxent")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        U.get("rmsprop")
    # the bf16 policy is ported: the half names map to bf16
    assert compute_dtype("bfloat16") == torch.bfloat16
    assert compute_dtype("float") is None


def _loss_case(seed, n=6, o=5):
    rs = np.random.RandomState(seed)
    labels = np.eye(o, dtype=np.float32)[rs.randint(0, o, n)]
    preout = rs.randn(n, o).astype(np.float32) * 2
    row_mask = (rs.rand(n) > 0.3).astype(np.float32)
    row_mask[0] = 1.0
    return labels, preout, row_mask


@pytest.mark.parametrize("loss,act", [("mcxent", "softmax"),
                                      ("mcxent", "sigmoid"),
                                      ("mse", "identity"),
                                      ("mse", "tanh")])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_matches_jax(loss, act, masked):
    labels, preout, mask = _loss_case(len(loss) + len(act))
    m = mask if masked else None
    want_arr = JL.get(loss).score_array(jnp.asarray(labels),
                                        jnp.asarray(preout), JA.get(act),
                                        None if m is None else jnp.asarray(m))
    want = JL.get(loss).score(jnp.asarray(labels), jnp.asarray(preout),
                              JA.get(act),
                              None if m is None else jnp.asarray(m))
    tm = None if m is None else torch.from_numpy(m)
    got_arr = L.get(loss).score_array(torch.from_numpy(labels),
                                      torch.from_numpy(preout), A.get(act),
                                      tm)
    got = L.get(loss).score(torch.from_numpy(labels),
                            torch.from_numpy(preout), A.get(act), tm)
    np.testing.assert_allclose(got_arr.numpy(), np.asarray(want_arr),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                               atol=ATOL)


def test_masked_score_divides_by_live_rows():
    labels, preout, mask = _loss_case(9)
    loss = L.LossMCXENT()
    arr = loss.score_array(torch.from_numpy(labels),
                           torch.from_numpy(preout), A.Softmax())
    got = loss.score(torch.from_numpy(labels), torch.from_numpy(preout),
                     A.Softmax(), torch.from_numpy(mask))
    want = float((arr * torch.from_numpy(mask)).sum()) / mask.sum()
    assert abs(float(got) - want) <= ATOL + RTOL * abs(want)
    none = loss.score(torch.from_numpy(labels), torch.from_numpy(preout),
                      A.Softmax(), torch.zeros(len(mask)))
    assert float(none) == 0.0   # no live row: divides by 1, not 0


@pytest.mark.parametrize("name,kw", [("adam", {"learning_rate": 1e-2}),
                                     ("sgd", {"learning_rate": 0.1})])
def test_updater_three_steps_match_jax(name, kw):
    rs = np.random.RandomState(3)
    params = {"W": rs.randn(4, 3).astype(np.float32),
              "b": rs.randn(3).astype(np.float32)}
    grads = [{n: rs.randn(*p.shape).astype(np.float32) * 10 ** -s
              for n, p in params.items()} for s in range(3)]
    ju = JU.get({"@class": name, **kw})
    tu = U.get({"@class": name, **kw})
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    tp = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    jst, tst = ju.init_state(jp), tu.init_state(tp)
    for step, g in enumerate(grads):
        jst, jupd = ju.apply(jst, {n: jnp.asarray(x) for n, x in g.items()},
                             step)
        tst, tupd = tu.apply(tst, {n: torch.from_numpy(x)
                                   for n, x in g.items()}, step)
        for n in params:
            np.testing.assert_allclose(tupd[n].numpy(),
                                       np.asarray(jupd[n]), rtol=1e-5,
                                       atol=1e-9)
            jp[n] = jp[n] - jupd[n]
            tp[n] -= tupd[n]
    for n in params:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-5, atol=1e-7)
    if name == "adam":
        for part in ("m", "v"):
            for n in params:
                np.testing.assert_allclose(tst[part][n].numpy(),
                                           np.asarray(jst[part][n]),
                                           rtol=1e-5, atol=1e-9)


def test_conf_builder_defaults_reach_the_layers():
    def build(mod, Dense, Out):
        return (mod.builder().seed(7).updater({"@class": "adam",
                                               "learning_rate": 3e-3})
                .weight_init("xavier").activation("tanh").l1(1e-4)
                .l2(2e-3).gradient_normalization(max_norm=0.5,
                                                 clip_value=2.0)
                .list().layer(Dense(n_out=6))
                .layer(Dense(n_out=4, activation="relu", l2=0.0))
                .layer(Out(n_out=3, loss="mse", activation="identity"))
                .input_type_feed_forward(5).build())
    from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
    jc = build(JConf, JDense, JOut)
    tc = build(NeuralNetConfiguration, DenseLayer, OutputLayer)
    assert (tc.seed, tc.max_grad_norm, tc.grad_clip_value) == \
        (jc.seed, jc.max_grad_norm, jc.grad_clip_value)
    assert tc.updater.to_json() == jc.updater.to_json()
    assert tc.input_type.shape == jc.input_type.shape == (5,)
    shape_t = shape_j = tc.input_type.shape
    for tl, jl in zip(tc.layers, jc.layers):
        tl.build(shape_t, tc.defaults)
        jl.build(shape_j, jc.defaults)
        assert tl.activation.name == jl.activation.name
        assert (tl.weight_init, tl.l1, tl.l2, tl.l1_bias, tl.l2_bias) == \
            (jl.weight_init, jl.l1, jl.l2, jl.l1_bias, jl.l2_bias)
        assert tl.param_shapes() == jl.param_shapes()
        assert tl.bias_param_names() == jl.bias_param_names()
        shape_t, shape_j = tl.output_shape(shape_t), jl.output_shape(shape_j)
    recurrent = (NeuralNetConfiguration.builder().list()
                 .input_type_recurrent(3, timesteps=9).build())
    assert (recurrent.input_type.kind, recurrent.input_type.shape) == \
        ("rnn", (9, 3))


@pytest.mark.parametrize("kw", [dict(batch=4),
                                dict(batch=4, keep_last=True),
                                dict(batch=3, shuffle=True, seed=5),
                                dict(batch=3, shuffle=True, keep_last=True)])
def test_array_iterator_matches_jax(kw):
    x = np.arange(22, dtype=np.float32).reshape(11, 2)
    y = np.arange(11, dtype=np.float32)
    m = (np.arange(11) % 2).astype(np.float32)
    for masked in (False, True):
        extra = {"labels_mask": m} if masked else {}
        ti = ArrayDataSetIterator(x, y, **kw, **extra)
        ji = JIter(x, y, **kw, **extra)
        for _ in range(2):  # two passes: shuffles draw per pass
            tb, jb = list(ti), list(ji)
            assert len(tb) == len(jb)
            for a, b in zip(tb, jb):
                assert len(a) == len(b) == (3 if masked else 2)
                for u, w in zip(a, b):
                    np.testing.assert_array_equal(u, w)
    assert ti.total_examples() == 11 and ti.batch_size() == kw["batch"]
