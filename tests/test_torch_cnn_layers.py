"""The port's CNN and parameter-free layers against the JAX package's
(f32, CPU): forward, and gradients (``jax.grad`` against autograd) of
``sum(out * cotangent)`` with respect to the input and every param, on
the same numpy-seeded inputs and carried params.

Tolerances, with their reasons:
- convolution, dense and pooling: 1e-5 absolute and relative (f32 on
  both sides; a convolution sums at most 3 x 4 x 4 = 48 products, in
  another order);
- batch norm: 1e-5 (the batch variance sums 2 x 5 x 6 = 60 squares,
  in another order; the gradient of the normalised output runs back
  through the mean and the variance);
- at bf16 input: one bf16 ulp of the output's scale (2^-7); the
  statistics are f32 on both sides;
- max-pool gradients where a window's maxima tie (an all-zero window
  after a ReLU) are held EXACTLY: both send the gradient to the first
  maximum in row-major window order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.conf import InputType
from _torch_threads import one_torch_thread  # noqa: F401,E402

TOL = 1e-5


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def _both(jlayer, tlayer, x, params=None, state=None, train=False,
          seed=0):
    """Forward and gradients of sum(out * ct) on both sides. ``params``
    are numpy; returns (jax_out, port_out, jax_grads, port_grads) with
    the input's gradient under "x"."""
    params = params or {}
    state = state or {}
    jout, _ = jlayer.apply({k: jnp.asarray(v) for k, v in params.items()},
                           jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                            state.items()}, train, None)
    ct = _rand(seed + 100, *jout.shape)

    def jloss(p, xx):
        out, _ = jlayer.apply(p, xx, {k: jnp.asarray(v) for k, v in
                                      state.items()}, train, None)
        return jnp.sum(out * ct)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    tout, _ = tlayer.apply(tp, tx, {k: torch.tensor(v) for k, v in
                                    state.items()}, train, None)
    (tout * torch.from_numpy(ct)).sum().backward()
    jg = {k: np.asarray(v) for k, v in jgp.items()}
    jg["x"] = np.asarray(jgx)
    tg = {k: v.grad.numpy() for k, v in tp.items()}
    tg["x"] = tx.grad.numpy()
    return np.asarray(jout), tout.detach().numpy(), jg, tg


def _close(a, b, tol=TOL, what=""):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


def _built(jlayer, tlayer, shape):
    jlayer.build(shape, {})
    tlayer.build(shape, {})
    assert tlayer.param_shapes() == jlayer.param_shapes()
    assert tlayer.output_shape(shape) == jlayer.output_shape(shape)


def _params_for(layer, seed):
    return {n: _rand(seed + i, *sh, scale=0.5)
            for i, (n, sh) in enumerate(sorted(layer.param_shapes().items()))}


CONV_GRID = [
    dict(kernel=(3, 3)),
    dict(kernel=(2, 2)),                              # even kernel, SAME
    dict(kernel=(4, 3), stride=(2, 2)),               # even, stride 2
    dict(kernel=(3, 3), stride=(2, 1), dilation=(2, 2)),
    dict(kernel=(2, 3), dilation=(1, 2), groups=2),
    dict(kernel=(3, 3), padding="valid", stride=(2, 2)),
    dict(kernel=(3, 2), padding=((1, 0), (2, 1))),
    dict(kernel=(1, 1), has_bias=False, groups=2, stride=(3, 3)),
]


@pytest.mark.parametrize("kw", CONV_GRID, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_convolution_forward_and_gradients(kw):
    shape = (9, 8, 4)
    jl = JL.ConvolutionLayer(n_out=6, activation="tanh", **kw)
    tl = TL.ConvolutionLayer(n_out=6, activation="tanh", **kw)
    _built(jl, tl, shape)
    params = _params_for(jl, 1)
    x = _rand(2, 2, *shape)
    jo, to, jg, tg = _both(jl, tl, x, params)
    assert to.shape == jo.shape == (2,) + jl.output_shape(shape)
    _close(to, jo, what="out")
    for k in jg:
        _close(tg[k], jg[k], what=k)


@pytest.mark.parametrize("size,k,s,d", [(9, 2, 1, 1), (9, 4, 2, 1),
                                         (8, 3, 2, 2), (7, 5, 3, 1),
                                         (5, 1, 3, 1)])
def test_same_padding_is_xla_rule(size, k, s, d):
    """The explicit pads equal lax's SAME padding (low = total // 2,
    the rest high) for the dilated kernel."""
    from jax import lax
    from deeplearning4j_tpu_torch.nn.layers import _same_pads
    want = lax.padtype_to_pads((size,), ((k - 1) * d + 1,), (s,), "SAME")
    assert [tuple(_same_pads(size, k, s, d))] == [tuple(p) for p in want]


POOL_GRID = [(pool, pad, k, s)
             for pool in ("max", "avg", "pnorm")
             for pad, k, s in (("valid", (2, 2), (2, 2)),
                               ("same", (3, 3), (2, 2)),
                               ("same", (2, 2), (1, 1)),
                               ("valid", (3, 2), (1, 2)),
                               (((1, 0), (0, 2)), (2, 3), (2, 1)))]


@pytest.mark.parametrize("pool,pad,k,s", POOL_GRID)
def test_pooling_forward_and_gradients(pool, pad, k, s):
    shape = (7, 9, 3)
    jl = JL.SubsamplingLayer(kernel=k, stride=s, padding=pad, pooling=pool,
                             pnorm=3)
    tl = TL.SubsamplingLayer(kernel=k, stride=s, padding=pad, pooling=pool,
                             pnorm=3)
    _built(jl, tl, shape)
    x = _rand(3, 2, *shape)
    jo, to, jg, tg = _both(jl, tl, x)
    assert to.shape == jo.shape
    _close(to, jo, what="out")
    _close(tg["x"], jg["x"], what="dx")


@pytest.mark.parametrize("pad,k,s", [("valid", (2, 2), (2, 2)),
                                     ("same", (3, 3), (2, 2)),
                                     ("same", (2, 2), (1, 1))])
def test_max_pool_ties_route_to_the_same_element(pad, k, s):
    """ReLU'd input with whole zero windows: every window's maxima tie
    and both frameworks send the gradient to the first maximum."""
    x = np.maximum(_rand(4, 2, 8, 8, 2), 0.0)
    x[:, :4, :4, :] = 0.0                        # all-zero windows
    x[:, 5, :, 0] = 1.0                          # a tied row of ones
    jl = JL.SubsamplingLayer(kernel=k, stride=s, padding=pad)
    tl = TL.SubsamplingLayer(kernel=k, stride=s, padding=pad)
    _built(jl, tl, (8, 8, 2))
    jo, to, jg, tg = _both(jl, tl, x)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tg["x"], jg["x"])


@pytest.mark.parametrize("shape", [(5,), (5, 6, 3), (3, 4, 2)])
def test_dense_flattens_nhwc_like_jax(shape):
    jl = JL.DenseLayer(n_out=7, activation="sigmoid")
    tl = TL.DenseLayer(n_out=7, activation="sigmoid")
    _built(jl, tl, shape)
    params = _params_for(jl, 5)
    jo, to, jg, tg = _both(jl, tl, _rand(6, 3, *shape), params)
    _close(to, jo)
    for k in jg:
        _close(tg[k], jg[k], what=k)


def _bn_state(c, seed):
    rs = np.random.RandomState(seed)
    return {"mean": rs.randn(c).astype(np.float32) * 0.1,
            "var": (rs.rand(c) + 0.5).astype(np.float32)}


@pytest.mark.parametrize("lock", [False, True])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", [(6,), (5, 6, 3)])
def test_batch_norm_matches_jax(shape, train, lock):
    jl = JL.BatchNormalization(decay=0.8, lock_gamma_beta=lock)
    tl = TL.BatchNormalization(decay=0.8, lock_gamma_beta=lock)
    _built(jl, tl, shape)
    params = _params_for(jl, 7)
    state = _bn_state(shape[-1], 8)
    x = _rand(9, 2, *shape, scale=3.0) + 1.0
    jo, to, jg, tg = _both(jl, tl, x, params, state, train)
    _close(to, jo, what="out")
    for k in jg:
        _close(tg[k], jg[k], what=k)
    _, jst = jl.apply({k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(x), {k: jnp.asarray(v)
                                       for k, v in state.items()}, train,
                      None)
    _, tst = tl.apply({k: torch.from_numpy(v) for k, v in params.items()},
                      torch.from_numpy(x), {k: torch.from_numpy(v)
                                            for k, v in state.items()},
                      train, None)
    for n in ("mean", "var"):
        assert tst[n].dtype == torch.float32
        _close(tst[n].numpy(), np.asarray(jst[n]), what=n)


def test_batch_norm_running_var_is_biased():
    """decay * old + (1 - decay) * biased batch variance, where
    torch.nn.BatchNorm2d (momentum = 1 - decay) folds in the unbiased
    one."""
    x = _rand(10, 4, 3, 3, 2) * 2.0
    tl = TL.BatchNormalization(decay=0.9)
    tl.build((3, 3, 2), {})
    st = {"mean": torch.zeros(2), "var": torch.ones(2)}
    _, new = tl.apply({"gamma": torch.ones(2), "beta": torch.zeros(2)},
                      torch.from_numpy(x), st, True, None)
    flat = x.reshape(-1, 2).astype(np.float64)
    _close(new["var"].numpy(), 0.9 + 0.1 * flat.var(0))
    _close(new["mean"].numpy(), 0.1 * flat.mean(0))
    ref = torch.nn.BatchNorm2d(2, momentum=0.1)
    ref(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(ref.running_var.numpy(), new["var"].numpy(),
                           rtol=1e-4)
    _close(ref.running_mean.numpy(), new["mean"].numpy())


def test_batch_norm_bf16_input_keeps_f32_statistics():
    shape = (4, 5, 3)
    jl, tl = JL.BatchNormalization(), TL.BatchNormalization()
    _built(jl, tl, shape)
    params = _params_for(jl, 11)
    state = _bn_state(3, 12)
    x = _rand(13, 2, *shape, scale=4.0)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jo, jst = jl.apply({k: jnp.asarray(v) for k, v in params.items()}, xb,
                       {k: jnp.asarray(v) for k, v in state.items()}, True,
                       None)
    to, tst = tl.apply({k: torch.from_numpy(v) for k, v in params.items()},
                       torch.from_numpy(x).bfloat16(),
                       {k: torch.from_numpy(v) for k, v in state.items()},
                       True, None)
    assert to.dtype == torch.bfloat16 and jo.dtype == jnp.bfloat16
    scale = float(np.abs(np.asarray(jo, np.float32)).max())
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                               rtol=0, atol=scale * 2 ** -7)
    for n in ("mean", "var"):
        assert tst[n].dtype == torch.float32
        _close(tst[n].numpy(), np.asarray(jst[n]), what=n)


PARAM_FREE = [
    ("lrn", lambda M: M.LocalResponseNormalization(n=3, alpha=0.1),
     (5, 4, 6)),
    ("zeropad", lambda M: M.ZeroPaddingLayer(((1, 2), (0, 3))), (4, 5, 2)),
    ("upsampling", lambda M: M.Upsampling2D((2, 3)), (3, 2, 2)),
    ("activation", lambda M: M.ActivationLayer(activation="elu"), (4, 3)),
    ("dropout_eval", lambda M: M.DropoutLayer(0.5), (6,)),
] + [(f"globalpool_{p}_{kd}",
      lambda M, p=p, kd=kd: M.GlobalPoolingLayer(pooling=p, keep_dims=kd,
                                                 pnorm=3),
      (4, 5, 3)) for p in ("max", "avg", "sum", "pnorm")
     for kd in (False, True)]


@pytest.mark.parametrize("name,make,shape", PARAM_FREE,
                         ids=[p[0] for p in PARAM_FREE])
def test_parameter_free_layers(name, make, shape):
    jl, tl = make(JL), make(TL)
    _built(jl, tl, shape)
    jo, to, jg, tg = _both(jl, tl, _rand(14, 2, *shape))
    _close(to, jo)
    _close(tg["x"], jg["x"], what="dx")


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_with_a_sequence_mask(pooling):
    jl = JL.GlobalPoolingLayer(pooling=pooling)
    tl = TL.GlobalPoolingLayer(pooling=pooling)
    x = _rand(15, 3, 6, 4)
    m = np.ones((3, 6), np.float32)
    m[1, 4:] = 0.0
    m[2] = 0.0                                   # a fully masked row
    jo, _ = jl.apply_with_mask({}, jnp.asarray(x), {}, False, None,
                               jnp.asarray(m))
    to, _ = tl.apply_with_mask({}, torch.from_numpy(x), {}, False, None,
                               torch.from_numpy(m))
    _close(to.numpy(), np.asarray(jo))


def test_embedding_and_loss_layers():
    jl, tl = JL.EmbeddingLayer(n_in=9, n_out=4), \
        TL.EmbeddingLayer(n_in=9, n_out=4, )
    _built(jl, tl, (1,))
    params = _params_for(jl, 16)
    idx = np.array([[3], [0], [8], [3]])
    jo, _ = jl.apply({k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(idx), {}, False, None)
    to, _ = tl.apply({k: torch.from_numpy(v) for k, v in params.items()},
                     torch.from_numpy(idx), {}, False, None)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    for loss, act in (("mcxent", "softmax"), ("mse", "identity")):
        jll = JL.LossLayer(loss=loss, activation=act)
        tll = TL.LossLayer(loss=loss, activation=act)
        x = _rand(17, 5, 4)
        y = np.eye(4, dtype=np.float32)[[0, 3, 1, 1, 2]]
        _close(float(tll.compute_loss({}, torch.from_numpy(x),
                                      torch.from_numpy(y))),
               float(jll.compute_loss({}, jnp.asarray(x), jnp.asarray(y))))


def test_conv_input_types_and_builder():
    for mod in (JConf, NeuralNetConfiguration):
        c = (mod.builder().dropout(0.25).list()
             .layer((JL if mod is JConf else TL).DenseLayer(n_out=2))
             .input_type_convolutional(28, 28, 1).build())
        assert (c.input_type.kind, c.input_type.shape) == ("cnn", (28, 28, 1))
        assert c.defaults["dropout"] == 0.25
    flat = InputType.convolutional_flat(4, 5, 2)
    assert (flat.kind, flat.shape) == ("cnnflat", (4, 5, 2))
    # weight noise and constraints are ported
    # (tests/test_torch_remat_tbptt.py): the builder and the layers take
    # them in JAX's JSON form
    wn = {"@class": "dropconnect", "keep_prob": 0.9}
    con = {"@class": "max_norm", "max_norm": 2.0}
    c = (NeuralNetConfiguration.builder().weight_noise(wn)
         .constrain_weights(con).list().layer(TL.DenseLayer(n_out=2))
         .input_type_feed_forward(3).build())
    assert c.defaults["weight_noise"].to_json() == wn
    assert [x.to_json() for x in c.defaults["constraints"]] == [
        dict(con, apply_to_weights=True, apply_to_biases=False)]
    layer = TL.DenseLayer(n_out=2, constraints=[con])
    assert layer.to_json() == JL.DenseLayer(n_out=2,
                                            constraints=[con]).to_json()
