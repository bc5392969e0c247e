"""The port's training core against the JAX package (f32, CPU):
every activation, loss, updater, learning-rate schedule and weight-init
scheme of the JAX package, the configuration builder and the array
iterator, on the same numpy-seeded inputs.

Tolerance: 1e-6 absolute and relative for elementwise functions and
losses (the same f32 formulas; a loss sum of ~18 summed in another
order moves by a few ulps, ~2e-6), rtol 1e-5 for updater steps
(Adam's bias correction is computed in f32 on both sides, in another
order) and schedules (``pow`` and ``exp`` of two libraries, a few
ulps). Weight init draws from JAX's key, so each scheme's 40,000
draws are held to JAX's element by element: within 1e-6 relative and
1e-6 of the largest |draw| (``uniform`` is JAX's bit for bit,
``normal`` within a few f32 ulp of JAX's unit draw before its scale).
"""
import jax
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
from deeplearning4j_tpu_torch import random as R
from deeplearning4j_tpu_torch import weightinit as WI
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.precision import compute_dtype
from _torch_threads import one_torch_thread  # noqa: F401,E402

ATOL = RTOL = 1e-6


def _x(seed, *shape, scale=2.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


@pytest.mark.parametrize("name", JA.names())
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


def test_unported_names_raise(tmp_path):
    """Every name the JAX package knows is ported; an unknown name
    raises ValueError, as in JAX, and what is still refused raises
    NotImplementedError citing its ROADMAP item."""
    from deeplearning4j_tpu_torch.nn.layers import from_json
    from deeplearning4j_tpu_torch.optimize import CheckpointListener
    for mod, jmod in ((A, JA), (L, JL), (U, JU)):
        assert mod.names() == jmod.names()
        for m in (mod, jmod):
            with pytest.raises(ValueError, match="nosuch"):
                m.get("nosuch")
    # CheckpointListener is ported (tests/test_torch_serializer.py)
    lst = CheckpointListener(str(tmp_path), save_every_n_iterations=1)
    assert lst.last_checkpoint() is None
    # the zoo builds all sixteen models; a SameDiff layer waits for
    # autodiff/samediff
    with pytest.raises(NotImplementedError, match="item 15"):
        from_json({"@class": "samediff_layer"})
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


UPDATERS = [("adam", {"learning_rate": 1e-2}),
            ("sgd", {"learning_rate": 0.1}),
            ("noop", {}),
            ("nesterovs", {"learning_rate": 0.05, "momentum": 0.8}),
            ("adagrad", {"learning_rate": 0.1}),
            ("rmsprop", {"learning_rate": 0.01}),
            ("adadelta", {}),
            ("adamax", {"learning_rate": 1e-2}),
            ("amsgrad", {"learning_rate": 1e-2}),
            ("nadam", {"learning_rate": 1e-2}),
            ("adam", {"learning_rate": {"@class": "exponential",
                                        "initial_value": 1e-2,
                                        "gamma": 0.5}}),
            ("sgd", {"learning_rate": {"@class": "step",
                                       "initial_value": 0.1,
                                       "decay_rate": 0.5, "step_size": 2}})]


@pytest.mark.parametrize("name,kw", UPDATERS,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(UPDATERS)])
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
    flat_t = jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: t.numpy(), tst))
    flat_j = jax.tree_util.tree_leaves(jst)
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-9)
    assert tu.to_json() == ju.to_json()


SCHEDULES = [
    {"@class": "fixed", "value": 0.3},
    {"@class": "exponential", "initial_value": 0.1, "gamma": 0.97},
    {"@class": "inverse", "initial_value": 0.1, "gamma": 0.1, "power": 0.75},
    {"@class": "poly", "initial_value": 0.1, "power": 2.0, "max_iter": 40},
    {"@class": "sigmoid", "initial_value": 0.1, "gamma": 0.3,
     "step_size": 10},
    {"@class": "step", "initial_value": 0.1, "decay_rate": 0.5,
     "step_size": 7},
    {"@class": "map", "values": {0: 0.1, 5: 0.05, 20: 0.01}},
    {"@class": "warmupcosine", "peak": 0.1, "warmup_steps": 5,
     "total_steps": 30, "floor": 0.001},
]


@pytest.mark.parametrize("spec", SCHEDULES, ids=[s["@class"]
                                                 for s in SCHEDULES])
def test_schedule_matches_jax(spec):
    from deeplearning4j_tpu.learning import schedules as JS
    from deeplearning4j_tpu_torch.learning import schedules as TS
    js, ts = JS.get(dict(spec)), TS.get(dict(spec))
    assert ts.to_json() == js.to_json()
    for step in (0, 1, 4, 5, 6, 13, 20, 29, 40, 77):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-5,
                                   atol=1e-9, err_msg=str(step))


@pytest.mark.parametrize("scheme", WI.SCHEMES)
def test_weight_init_scheme_matches_jax(scheme):
    import jax.random as jr
    from deeplearning4j_tpu.weightinit import SCHEMES as JSCHEMES
    from deeplearning4j_tpu.weightinit import init_weights as jinit
    assert WI.SCHEMES == JSCHEMES
    shape = (200, 200)
    fan_in, fan_out = 90.0, 150.0
    dist = {"type": "truncated_normal", "mean": 0.5, "std": 2.0,
            "value": 0.25}
    want = np.asarray(jinit(jr.PRNGKey(0), shape, fan_in, fan_out, scheme,
                            distribution=dist))
    got = WI.init_weights(R.PRNGKey(0), shape, fan_in, fan_out, scheme,
                          distribution=dist).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


def _every_loss_case(name, rs, n=6, o=4):
    """Labels, pre-activations and an output activation each loss is
    meant for."""
    preout = rs.randn(n, o).astype(np.float32)
    onehot = np.eye(o, dtype=np.float32)[rs.randint(0, o, n)]
    act = {"binaryxent": "sigmoid", "xent": "sigmoid", "kld": "softmax",
           "poisson": "softplus", "fmeasure": "sigmoid",
           "mcxent": "softmax", "negativeloglikelihood": "softmax"
           }.get(name, "identity")
    labels = {"hinge": 2 * onehot - 1, "squaredhinge": 2 * onehot - 1,
              "poisson": rs.poisson(2.0, (n, o)).astype(np.float32),
              "mape": rs.rand(n, o).astype(np.float32) + 0.5,
              "msle": rs.rand(n, o).astype(np.float32),
              "fmeasure": np.eye(2, dtype=np.float32)[rs.randint(0, 2, n)],
              }.get(name, onehot)
    kw = {}
    if name == "fmeasure":
        preout = preout[:, :2]
    if name == "mixturedensity":
        kw = {"mixtures": 2, "labels_width": 3}
        preout = rs.randn(n, 2 * 2 + 2 * 3).astype(np.float32) * 0.5
        labels = rs.randn(n, 3).astype(np.float32)
    return labels, preout, act, kw


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", JL.names())
def test_every_loss_matches_jax(name, masked):
    rs = np.random.RandomState(len(name))
    labels, preout, act, kw = _every_loss_case(name, rs)
    mask = None
    if masked and name != "fmeasure":   # fmeasure scores the whole batch
        mask = (rs.rand(labels.shape[0]) > 0.3).astype(np.float32)
        mask[0] = 1.0
    jl, tl = JL.get({"@class": name, **kw}), L.get({"@class": name, **kw})
    assert tl.to_json() == jl.to_json()
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = jl.score_array(jnp.asarray(labels), jnp.asarray(preout),
                          JA.get(act), jm)
    got = tl.score_array(torch.from_numpy(labels), torch.from_numpy(preout),
                         A.get(act), tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    want = jl.score(jnp.asarray(labels), jnp.asarray(preout), JA.get(act), jm)
    got = tl.score(torch.from_numpy(labels), torch.from_numpy(preout),
                   A.get(act), tm)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)


def test_loss_aliases_and_weights():
    from deeplearning4j_tpu.losses import _ALIASES
    for alias, name in _ALIASES.items():
        assert L.get(alias).name == JL.get(alias).name == name
    w = [0.5, 2.0, 1.0, 0.0]
    labels, preout, _ = _loss_case(4, o=4)
    want = JL.LossMCXENT(weights=w).score(jnp.asarray(labels),
                                          jnp.asarray(preout), JA.Softmax())
    got = L.LossMCXENT(weights=w).score(torch.from_numpy(labels),
                                        torch.from_numpy(preout), A.Softmax())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


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
