"""The port's dropout and noise schemes against the JAX package's, under
the same ``jax.random`` key (f32, CPU).

- Bernoulli masks (``Dropout``, ``AlphaDropout``, ``SpatialDropout``,
  and the layer and builder float shorthand) are held BIT FOR BIT, and
  so is ``Dropout``'s output (``x / keep`` or 0).
- ``AlphaDropout``'s affine output: 1e-6 relative (XLA's CPU backend
  fuses ``a * y + b`` into one rounding, PyTorch rounds twice).
- The Gaussian schemes draw JAX's uniforms bit for bit; the normal
  under them is within 3 f32 ulp of JAX's (XLA's log1p inside
  ``erf_inv`` is its own approximation), so their outputs are held at
  1e-6 relative.
- Networks trained with dropout from carried weights and JAX's key
  chain: losses and params within 1e-4 after 3 Adam steps (the same
  masks; f32 sums in another order, as in
  ``tests/test_torch_multilayer.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import dropout as JD
from deeplearning4j_tpu_torch import random as R
from deeplearning4j_tpu_torch.convert import network_params_from_jax
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.conf import dropout as TD
from _torch_threads import one_torch_thread  # noqa: F401,E402

SHAPES = [(7,), (4, 9), (3, 5, 6, 4)]
SEEDS = [0, 3, 2 ** 31 + 5]


def _keys(seed):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 17)
    tk = R.fold_in(R.PRNGKey(seed), 17)
    return jk, tk


def _x(shape, seed=1):
    return (np.random.RandomState(seed).randn(*shape) * 2).astype(np.float32)


def _apply(scheme_j, scheme_t, x, seed):
    jk, tk = _keys(seed)
    jo = np.asarray(scheme_j.apply(jnp.asarray(x), jk, True))
    to = scheme_t.apply(torch.from_numpy(x), tk, True).numpy()
    return jo, to


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_dropout_bit_identical(p, shape, seed):
    x = _x(shape)
    jo, to = _apply(JD.Dropout(p), TD.Dropout(p), x, seed)
    assert to.dtype == np.float32
    np.testing.assert_array_equal(to.view(np.uint32), jo.view(np.uint32))
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(
        R.bernoulli(tk, 1.0 - p, shape).numpy(),
        np.asarray(jax.random.bernoulli(jk, 1.0 - p, shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_spatial_dropout_bit_identical(shape, seed):
    x = _x(shape)
    jo, to = _apply(JD.SpatialDropout(0.4), TD.SpatialDropout(0.4), x, seed)
    np.testing.assert_array_equal(to.view(np.uint32), jo.view(np.uint32))
    if len(shape) > 2:   # whole channels drop: one mask entry a (b, c)
        dropped = (to == 0).reshape(shape[0], -1, shape[-1])
        assert (dropped.all(1) | ~dropped.any(1)).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_alpha_dropout_mask_bit_identical(shape, seed):
    x = _x(shape)
    jo, to = _apply(JD.AlphaDropout(0.3), TD.AlphaDropout(0.3), x, seed)
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-6)
    alpha_prime = -TD.AlphaDropout.LAMBDA * TD.AlphaDropout.ALPHA
    jk, tk = _keys(seed)
    mask = R.bernoulli(tk, 0.7, shape).numpy()
    np.testing.assert_array_equal(
        mask, np.asarray(jax.random.bernoulli(jk, 0.7, shape)))
    a = (0.7 + alpha_prime ** 2 * 0.7 * 0.3) ** -0.5
    dropped = np.float32(a * alpha_prime - a * alpha_prime * 0.3)
    np.testing.assert_allclose(to[~mask], dropped, rtol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scheme", ["gaussian_dropout", "gaussian_noise"])
def test_gaussian_schemes_match_jax(scheme, seed):
    shape = (6, 5, 4, 3)
    x = _x(shape)
    kw = {"rate": 0.3} if scheme == "gaussian_dropout" else {"stddev": 0.2}
    jo, to = _apply(JD.get({"@class": scheme, **kw}),
                    TD.get({"@class": scheme, **kw}), x, seed)
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-6)


def test_schemes_pass_through_outside_training():
    x = torch.from_numpy(_x((3, 4)))
    _, tk = _keys(0)
    for s in (TD.Dropout(0.5), TD.GaussianDropout(0.5), TD.GaussianNoise(1.),
              TD.AlphaDropout(0.5), TD.SpatialDropout(0.5)):
        assert s.apply(x, tk, False) is x
        assert s.apply(x, None, True) is x
        assert TD.get(s.to_json()) == s
    assert TD.get(0.0) is None and TD.get(0.25) == TD.Dropout(0.25)


def _net_conf(Conf, L, Opt, D, kind):
    b = Conf.builder().seed(11).updater(Opt(1e-2)).weight_init("relu")
    if kind == "builder":
        b = b.dropout(0.3)          # every layer's default, output included
    b = b.list()
    if kind == "spatial":
        b = b.layer(L.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                       activation="relu"))
        b = b.layer(L.ConvolutionLayer(
            n_out=4, kernel=(3, 3), activation="relu",
            dropout=D.SpatialDropout(0.5)))
    elif kind == "alpha":
        b = b.layer(L.DenseLayer(n_out=12, activation="selu",
                                 dropout=D.AlphaDropout(0.2)))
    elif kind == "gaussian":
        b = b.layer(L.DenseLayer(n_out=12, activation="tanh",
                                 dropout=D.GaussianNoise(0.3)))
        b = b.layer(L.DenseLayer(n_out=12, activation="tanh",
                                 dropout=D.GaussianDropout(0.2)))
    else:
        b = b.layer(L.DenseLayer(n_out=12, activation="relu"))
        b = b.layer(L.DropoutLayer(0.5))
    b = b.layer(L.DenseLayer(n_out=8, activation="relu", dropout=0.25))
    b = b.layer(L.OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
    if kind == "spatial":
        return b.input_type_convolutional(6, 6, 2).build()
    return b.input_type_feed_forward(5).build()


@pytest.mark.parametrize("kind", ["layer", "builder", "spatial", "alpha",
                                  "gaussian"])
def test_network_with_dropout_follows_jax(kind):
    jn = JNet(_net_conf(JConf, JL, JAdam, JD, kind)).init()
    tn = MultiLayerNetwork(_net_conf(NeuralNetConfiguration, TL, Adam, TD,
                                     kind), device="cpu").init()
    tn.set_params(network_params_from_jax(
        jax.tree.map(np.asarray, jn.params())))
    assert [int(v) for v in tn._rng] == \
        [int(v) for v in np.asarray(jn._rng)]
    rs = np.random.RandomState(5)
    shape = (16, 6, 6, 2) if kind == "spatial" else (16, 5)
    x = rs.randn(*shape).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 16)]
    for _ in range(3):
        jn.fit(x, y)
        tn.fit(x, y)
        np.testing.assert_allclose(tn.score_, float(jn._last_loss),
                                   rtol=0, atol=1e-4)
    for key, p in tn.params().items():
        for name, t in p.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(jn.params()[key][name]),
                                       rtol=0, atol=1e-4, err_msg=key + name)
    assert [int(v) for v in tn._rng] == \
        [int(v) for v in np.asarray(jn._rng)]
    # inference applies no dropout on either side
    np.testing.assert_allclose(tn.output(x).numpy(),
                               np.asarray(jn.output(x)), rtol=1e-5,
                               atol=1e-5)


def test_transformer_block_dropout_follows_jax():
    """The encoder block's input and MLP dropout (its MLP key folded
    from the layer's, as in JAX) through two fit steps."""
    from deeplearning4j_tpu.nn.layers.attention import \
        TransformerEncoderLayer as JEnc
    from deeplearning4j_tpu.nn.layers.recurrent import (
        EmbeddingSequenceLayer as JEmb, RnnOutputLayer as JOut)
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        TransformerEncoderLayer as TEnc
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        EmbeddingSequenceLayer as TEmb, RnnOutputLayer as TOut)

    def conf(Conf, Emb, Enc, Out, Opt):
        return (Conf.builder().seed(0).updater(Opt(1e-3))
                .weight_init("xavier").list()
                .layer(Emb(n_in=32, n_out=16))
                .layer(Enc(n_heads=2, d_ff=32, causal=True, dropout=0.2,
                           implementation="plain"))
                .layer(Out(n_out=32, loss="mcxent", activation="softmax"))
                .input_type_recurrent(1, timesteps=8).build())
    jn = JNet(conf(JConf, JEmb, JEnc, JOut, JAdam)).init()
    tn = MultiLayerNetwork(conf(NeuralNetConfiguration, TEmb, TEnc, TOut,
                                Adam), device="cpu").init()
    tn.set_params(network_params_from_jax(
        jax.tree.map(np.asarray, jn.params())))
    rs = np.random.RandomState(0)
    x = rs.randint(0, 32, (4, 8))
    y = np.eye(32, dtype=np.float32)[(3 * x + 1) % 32]
    for _ in range(2):
        jn.fit(x, y)
        tn.fit(x, y)
        np.testing.assert_allclose(tn.score_, float(jn._last_loss),
                                   rtol=0, atol=1e-4)
    for key, p in tn.params().items():
        for name, t in p.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(jn.params()[key][name]),
                                       rtol=0, atol=1e-4, err_msg=key + name)
