"""The rest of ``nn/layers`` but SameDiff in the port against the JAX
package (CPU): the AutoEncoder, reshape, mask and per-pixel loss layers
(``misc.py``), the VAE (``variational.py``), the center-loss and OCNN
heads (``specialized_outputs.py``), the YOLOv2 head and NMS
(``objdetect.py``), layerwise pretraining on both network kinds,
archives of every new leaf read by each package, and the AutoEncoder
golden file written by the JAX package.

The same numpy inputs from a seed go through both packages. Tolerances,
each with its reason:

- ``init`` from one key: uniform draws bit for bit, normal ones within
  8 f32 ulp (``random.normal`` is within 3 ulp of JAX's unit draw, and
  the scale rounds each side once more);
- forward, loss and every gradient: within 1e-5 of the larger of the
  two's largest |value| (f32 products and sums in another order);
- pretraining and the fit after it (JAX's params carried across, so
  only the arithmetic differs): params and Adam's m and v within 1e-5
  of the leaf's largest |value|, the last loss within 1e-5 relative,
  the key bit for bit (the VAE's noise is ``random.normal``, within 3
  ulp of JAX's);
- a tie in ``maximum``/``clip``: the gradient equal to JAX's half share
  within the same 1e-5 (and ``|x|`` at 0 differentiated to +1, as
  ``jnp.abs`` is: ``torch.abs`` gives 0);
- the golden file: its own tolerances (``tests/test_integration_golden
  .py``: losses rtol 1e-5, predictions and params rtol 1e-4).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.learning as JU
import deeplearning4j_tpu.nn as JN
import deeplearning4j_tpu.nn.conf as JC
import deeplearning4j_tpu.nn.layers as JL
import deeplearning4j_tpu.nn.layers.misc as JM
import deeplearning4j_tpu.nn.layers.objdetect as JO
import deeplearning4j_tpu.nn.layers.recurrent as JR
import deeplearning4j_tpu_torch.learning as TU
import deeplearning4j_tpu_torch.nn as TN
import deeplearning4j_tpu_torch.nn.conf as TC
import deeplearning4j_tpu_torch.nn.layers as TL
import deeplearning4j_tpu_torch.nn.layers.misc as TM
import deeplearning4j_tpu_torch.nn.layers.objdetect as TO
import deeplearning4j_tpu_torch.nn.layers.recurrent as TR
from deeplearning4j_tpu_torch import random as R
from deeplearning4j_tpu_torch.convert import (network_params_from_jax,
                                              updater_state_from_jax)
from _torch_threads import one_torch_thread  # noqa: F401,E402

TOL = 1e-5
INIT_ULP = 8
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "integration",
                      "autoencoder.npz")


class _Side:
    def __init__(self, U, N, C, L, M, O, R_):
        self.U, self.N, self.C, self.L = U, N, C, L
        self.M, self.O, self.R = M, O, R_


J = _Side(JU, JN, JC, JL, JM, JO, JR)
T = _Side(TU, TN, TC, TL, TM, TO, TR)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().double().cpu().numpy()
    return np.asarray(t, np.float64)


def _close(got, want, tol=TOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(got).max(initial=0), np.abs(want).max(initial=0),
                1e-30)
    err = np.abs(got - want).max(initial=0) / scale
    assert err <= tol, (what, err)


def _same_init(tp, jp):
    assert set(tp) == set(jp)
    for n, v in jp.items():
        a, b = np.asarray(v), _np(tp[n]).astype(np.float32)
        assert a.shape == b.shape, n
        assert np.all(np.abs(a - b) <= INIT_ULP * np.spacing(np.abs(a))), n


def _tparams(jp):
    return {n: torch.tensor(np.asarray(v)).requires_grad_(True)
            for n, v in jp.items()}


# -- the layers, one configuration each, built in both packages -----------

def _layers(S):
    """name -> (layer, feature shape)."""
    return {
        "autoencoder": (S.M.AutoEncoder(n_out=6, corruption_level=0.25,
                                        sparsity=0.3, sparsity_target=0.1),
                        (12,)),
        "reshapelayer": (S.M.ReshapeLayer(target_shape=(-1, 4)), (3, 8)),
        "masklayer": (S.M.MaskLayer(), (5, 3)),
        "masking": (S.M.MaskingLayer(mask_value=-1.0), (5, 3)),
        "cnnloss": (S.M.CnnLossLayer(loss="mcxent", activation="softmax"),
                    (4, 5, 3)),
        "cnn3dloss": (S.M.Cnn3DLossLayer(loss="mse"), (2, 3, 4, 3)),
        "vae": (S.L.VariationalAutoencoder(
            n_out=3, encoder_layer_sizes=(7, 5), decoder_layer_sizes=(6,),
            reconstruction_distribution="bernoulli", num_samples=2,
            pzx_activation="tanh", activation="relu"), (9,)),
        "centerloss_output": (S.L.CenterLossOutputLayer(
            n_out=4, alpha=0.3, lambda_=0.5), (6,)),
        "ocnn_output": (S.L.OCNNOutputLayer(hidden_size=5, nu=0.2,
                                            initial_r=0.3), (7,)),
        "yolo2output": (S.O.Yolo2OutputLayer(anchors=((1.0, 1.5), (2.0, 0.5)),
                                             lambda_coord=4.0,
                                             lambda_noobj=0.25),
                        (3, 3, 2 * (5 + 3))),
        "frozen_backprop": (S.M.FrozenLayerWithBackprop(
            S.L.DenseLayer(n_out=3, activation="tanh")), (5,)),
    }


KINDS = list(_layers(T))


@pytest.mark.parametrize("kind", KINDS)
def test_kind_json_both_ways(kind):
    """Each kind registers under JAX's name, and each package reads the
    other's JSON back to the same dict, key for key."""
    tl, shape = _layers(T)[kind]
    jl, _ = _layers(J)[kind]
    assert tl.kind == jl.kind == kind and TL.REGISTRY[kind] is type(tl)
    for layer in (tl, jl):
        layer.build(shape, {})
    jd, td = jl.to_json(), tl.to_json()
    assert td == jd
    assert TL.from_json(jd).to_json() == jd
    assert JL.from_json(td).to_json() == jd


def test_samediff_kind_raises_not_implemented():
    for kind in ("samediff", "samediff_lambda", "samediff_output"):
        with pytest.raises(NotImplementedError, match="item 15"):
            TL.from_json({"@class": kind, "name": "x"})


@pytest.mark.parametrize("kind", ["autoencoder", "vae", "centerloss_output",
                                  "ocnn_output"])
def test_init_is_jax_init(kind):
    tl, shape = _layers(T)[kind]
    jl, _ = _layers(J)[kind]
    tl.build(shape, {"weight_init": "xavier"})
    jl.build(shape, {"weight_init": "xavier"})
    assert tl.param_shapes() == jl.param_shapes()
    assert tl.bias_param_names() == jl.bias_param_names()
    _same_init(tl.init_params(R.PRNGKey(11)),
               jl.init_params(jax.random.PRNGKey(11)))


def test_vae_draws_its_keys_over_the_sorted_names():
    """The key of ``d0_W`` is row 0 of the split, before ``e0_W``'s."""
    tl, shape = _layers(T)["vae"]
    tl.build(shape, {"weight_init": "uniform"})
    p = tl.init_params(R.PRNGKey(5))
    names = sorted(tl.param_shapes())
    keys = R.split(R.PRNGKey(5), len(names))
    i = names.index("d0_W")
    assert i == 0 and names.index("e0_W") > i
    fan_in = tl.param_shapes()["d0_W"][0]
    a = 1.0 / np.sqrt(fan_in)
    want = R.uniform(R.key_at(keys, 0), (3, 6), torch.float32, -a, a)
    assert torch.equal(p["d0_W"], want)


def _apply_pair(kind, seed=0, batch=4, train=False):
    """Both layers built, JAX's params carried across, one input: the
    layers, the params (JAX, port) and x."""
    tl, shape = _layers(T)[kind]
    jl, _ = _layers(J)[kind]
    tl.build(shape, {"weight_init": "xavier"})
    jl.build(shape, {"weight_init": "xavier"})
    jp = jl.init_params(jax.random.PRNGKey(seed))
    x = np.random.RandomState(seed).randn(batch, *shape).astype(np.float32)
    return tl, jl, jp, x


@pytest.mark.parametrize("kind", ["autoencoder", "reshapelayer", "masklayer",
                                  "masking", "vae", "ocnn_output",
                                  "yolo2output", "frozen_backprop"])
def test_forward_and_gradients_match_jax(kind):
    """``apply`` and the gradients of sum(out * c) for the input and
    every param."""
    tl, jl, jp, x = _apply_pair(kind)
    tp = _tparams(jp)
    tx = torch.tensor(x, requires_grad=True)
    out, _ = tl.apply(tp, tx, {}, False, None)
    c = np.random.RandomState(7).randn(*out.shape).astype(np.float32)

    def jf(p, xx):
        o, _ = jl.apply(p, xx, {}, False, None)
        return jnp.sum(o * c), o
    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    _close(out, jout, what="out")
    names = list(tp)
    gs = torch.autograd.grad((out * torch.tensor(c)).sum(),
                             [tx] + [tp[n] for n in names],
                             allow_unused=True)
    _close(gs[0], jgx, what="dx")
    for n, g in zip(names, gs[1:]):
        _close(torch.zeros_like(tp[n]) if g is None else g, jgp[n], what=n)


def test_reshape_infers_and_refuses():
    tl = TM.ReshapeLayer(target_shape=(-1, 4))
    jl = JM.ReshapeLayer(target_shape=(-1, 4))
    assert tl.output_shape((3, 8)) == jl.output_shape((3, 8)) == (6, 4)
    assert TM.ReshapeLayer(target_shape=(2, 12)).output_shape((3, 8)) == \
        (2, 12)
    for layer in (tl, jl):
        with pytest.raises(ValueError, match="cannot reshape"):
            layer.output_shape((3, 5))


def _loss_labels(kind, out_shape, rs):
    if kind in ("cnnloss", "centerloss_output"):
        n = out_shape[-1]
        idx = rs.randint(0, n, out_shape[:-1])
        return np.eye(n, dtype=np.float32)[idx]
    if kind == "yolo2output":
        return _yolo_labels(rs, out_shape, 2, 3)
    return rs.rand(*out_shape).astype(np.float32)


def _yolo_labels(rs, shape, A, C, objects=3):
    """YOLO labels: a few objects, each in one cell and one anchor, xy in
    (0, 1), wh > 0, a one-hot class and confidence 1."""
    y = np.zeros(shape, np.float32)
    B, H, W = shape[:3]
    for b in range(B):
        for _ in range(objects):
            i, j, a = rs.randint(H), rs.randint(W), rs.randint(A)
            s = a * (5 + C)
            y[b, i, j, s:s + 2] = rs.uniform(0.05, 0.95, 2)
            y[b, i, j, s + 2:s + 4] = rs.uniform(0.2, 3.0, 2)
            y[b, i, j, s + 4] = 1.0
            y[b, i, j, s + 5 + rs.randint(C)] = 1.0
    return y


MASKS = {
    "none": None,
    "bhw": lambda rs, s: (rs.rand(*s[:-1]) > 0.3).astype(np.float32),
    "bhw1": lambda rs, s: (rs.rand(*s[:-1], 1) > 0.3).astype(np.float32),
    "b11": lambda rs, s: (rs.rand(s[0], *([1] * (len(s) - 2))) > 0.3
                          ).astype(np.float32),
}


@pytest.mark.parametrize("kind,mask", [
    ("cnnloss", "none"), ("cnnloss", "bhw"), ("cnnloss", "bhw1"),
    ("cnnloss", "b11"), ("cnn3dloss", "none"), ("cnn3dloss", "bhw"),
    ("cnn3dloss", "bhw1"), ("cnn3dloss", "b11"),
    ("centerloss_output", "none"), ("centerloss_output", "rows"),
    ("ocnn_output", "none"), ("ocnn_output", "rows"),
    ("yolo2output", "none")])
def test_loss_and_gradients_match_jax(kind, mask):
    """``compute_loss`` and its gradients for the input and every param,
    with each mask form the layer takes."""
    tl, jl, jp, x = _apply_pair(kind, seed=3)
    rs = np.random.RandomState(4)
    out_shape = x.shape if kind != "centerloss_output" else (x.shape[0], 4)
    y = _loss_labels(kind, out_shape, rs)
    if mask == "rows":
        m = np.array([1, 0, 1, 1], np.float32)
    else:
        m = None if MASKS[mask] is None else MASKS[mask](rs, x.shape)
    tp = _tparams(jp)
    tx = torch.tensor(x, requires_grad=True)
    tm = None if m is None else torch.tensor(m)
    loss = tl.compute_loss(tp, tx, torch.tensor(y), tm)

    def jf(p, xx):
        return jl.compute_loss(p, xx, jnp.asarray(y),
                               None if m is None else jnp.asarray(m))
    jloss, (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1))(
        jp, jnp.asarray(x))
    _close(loss, jloss, what="loss")
    names = list(tp)
    gs = torch.autograd.grad(loss, [tx] + [tp[n] for n in names],
                             allow_unused=True)
    _close(gs[0], jgx, what="dx")
    for n, g in zip(names, gs[1:]):
        _close(torch.zeros_like(tp[n]) if g is None else g, jgp[n], what=n)


def test_center_loss_scales_only_the_centers_gradient():
    """The centers' gradient is alpha times what it is at alpha 1; the
    features' pull is the same at any alpha."""
    grads = {}
    for alpha in (1.0, 0.3):
        layer = TL.CenterLossOutputLayer(n_out=3, alpha=alpha, lambda_=2.0)
        layer.build((4,), {"weight_init": "xavier"})
        p = {n: t.requires_grad_(True)
             for n, t in layer.init_params(R.PRNGKey(2)).items()}
        with torch.no_grad():
            p["centers"].copy_(torch.randn(3, 4, generator=torch.Generator()
                                           .manual_seed(1)))
        x = torch.randn(5, 4, generator=torch.Generator().manual_seed(2),
                        requires_grad=True)
        y = torch.eye(3)[torch.tensor([0, 1, 2, 1, 0])]
        g = torch.autograd.grad(layer.compute_loss(p, x, y),
                                [p["centers"], x])
        grads[alpha] = g
    assert torch.allclose(grads[0.3][0], 0.3 * grads[1.0][0], rtol=1e-6,
                          atol=1e-7)
    assert torch.allclose(grads[0.3][1], grads[1.0][1], rtol=1e-6, atol=1e-7)


# -- ties in maximum and clip: half the gradient to each side, as JAX ------

def _tie_grad(tl, jl, jp, x, y, name):
    tp = _tparams(jp)
    loss = tl.compute_loss(tp, torch.tensor(x), torch.tensor(y))
    g = torch.autograd.grad(loss, [tp[name]])[0]
    jg = jax.grad(lambda p: jl.compute_loss(p, jnp.asarray(x),
                                            jnp.asarray(y)))(jp)[name]
    return g, jg


def test_ocnn_hinge_tie_gives_r_jax_gradient():
    """r set to one sample's score. The score is exact in both packages
    (an identity activation over small dyadic weights and inputs), so
    the tie is a tie on both sides."""
    def ocnn(S):
        return S.L.OCNNOutputLayer(hidden_size=3, nu=0.2, initial_r=0.0,
                                   activation="identity")
    tl, jl = ocnn(T), ocnn(J)
    for layer in (tl, jl):
        layer.build((4,), {"weight_init": "xavier"})
    rs = np.random.RandomState(5)
    jp = {"V": jnp.asarray(rs.randint(-4, 5, (4, 3)) / 4.0, jnp.float32),
          "w": jnp.asarray(rs.randint(-4, 5, (3, 1)) / 4.0, jnp.float32)}
    x = rs.randint(-3, 4, (4, 4)).astype(np.float32)
    s = np.asarray(jl._score(dict(jp, r_b=jnp.zeros(1)), jnp.asarray(x)))
    jp["r_b"] = jnp.asarray(s[1], jnp.float32)   # r equal to sample 1's
    y = np.zeros((4, 1), np.float32)
    ts = tl._score(_tparams(jp), torch.tensor(x))
    assert np.array_equal(_np(ts), s.astype(np.float64))
    g, jg = _tie_grad(tl, jl, jp, x, y, "r_b")
    _close(g, jg, what="r_b")
    # the tied sample adds half its 1/(nu B), as jnp.maximum does
    below = float(np.sum(s[1, 0] - s[:, 0] > 0))
    assert abs(float(jg[0]) - ((below + 0.5) / (0.2 * 4) - 1.0)) <= 1e-6


def test_vae_bernoulli_tie_at_zero_logits():
    tl, shape = _layers(T)["vae"]
    jl, _ = _layers(J)["vae"]
    for layer in (tl, jl):
        layer.build(shape, {"weight_init": "xavier"})
    jp = jl.init_params(jax.random.PRNGKey(1))
    jp = dict(jp, xr_W=jnp.zeros_like(jp["xr_W"]),
              xr_b=jnp.zeros_like(jp["xr_b"]))   # every logit exactly 0
    x = (np.random.RandomState(2).rand(4, 9) > 0.5).astype(np.float32)
    tp = _tparams(jp)
    loss = tl.pretrain_loss(tp, torch.tensor(x), R.PRNGKey(3))
    g = torch.autograd.grad(loss, [tp["xr_b"]])[0]
    jloss, jg = jax.value_and_grad(lambda p: jl.pretrain_loss(
        p, jnp.asarray(x), jax.random.PRNGKey(3)))(jp)
    _close(loss, jloss, what="loss")
    _close(g, jg["xr_b"], what="xr_b")
    # maximum(out, 0) passes half at 0 and |out| passes +1 (JAX's
    # derivatives): d/dout = 0.5 - x - 0.5 per example, averaged
    _close(g, (-x).mean(0), what="tie")


def test_yolo_sqrt_floor_tie():
    """An anchor of 1e-8 with a zero wh logit puts p_wh exactly on the
    1e-8 floor."""
    tl = TO.Yolo2OutputLayer(anchors=((1e-8, 2.0),))
    jl = JO.Yolo2OutputLayer(anchors=((1e-8, 2.0),))
    x = np.random.RandomState(3).randn(2, 2, 2, 7).astype(np.float32)
    x[..., 2] = 0.0
    y = _yolo_labels(np.random.RandomState(4), (2, 2, 2, 7), 1, 2, 2)
    tx = torch.tensor(x, requires_grad=True)
    g = torch.autograd.grad(tl.compute_loss({}, tx, torch.tensor(y)), tx)[0]
    jg = jax.grad(lambda xx: jl.compute_loss({}, xx, jnp.asarray(y)))(
        jnp.asarray(x))
    _close(g, jg, what="dx")


def test_autoencoder_clip_tie_at_the_sparsity_floor():
    """The mean code exactly at eps = 1e-7 (identity encoder, zero W, a
    bias of 1e-7 over four rows): the clip's half gradient, as JAX's."""
    def ae(S):
        return S.M.AutoEncoder(n_out=3, corruption_level=0.0, sparsity=0.5,
                               sparsity_target=0.2, activation="identity")
    tl, jl = ae(T), ae(J)
    for layer in (tl, jl):
        layer.build((5,), {"weight_init": "xavier"})
    jp = jl.init_params(jax.random.PRNGKey(0))
    jp = dict(jp, W=jnp.zeros_like(jp["W"]),
              b=jnp.full_like(jp["b"], 1e-7))
    x = np.random.RandomState(5).rand(4, 5).astype(np.float32)
    tp = _tparams(jp)
    loss = tl.pretrain_loss(tp, torch.tensor(x), None)
    g = torch.autograd.grad(loss, [tp["b"]])[0]
    jg = jax.grad(lambda p: jl.pretrain_loss(p, jnp.asarray(x), None))(jp)
    _close(g, jg["b"], what="b")


@pytest.mark.parametrize("kind,extra", [
    ("autoencoder", {}), ("vae", {}),
    ("vae", dict(reconstruction_distribution="gaussian", num_samples=1)),
    ("vae", dict(reconstruction_distribution="gaussian", num_samples=3))])
def test_pretrain_loss_and_gradients_match_jax(kind, extra):
    """The unsupervised loss from one key: JAX's corruption bits and
    noise draws, its loss and every gradient."""
    def make(S):
        layer, shape = _layers(S)[kind]
        if extra:
            d = layer.to_json()
            d.update(extra)
            layer = S.L.from_json(d)
        return layer, shape
    (tl, shape), (jl, _) = make(T), make(J)
    for layer in (tl, jl):
        layer.build(shape, {"weight_init": "xavier"})
    jp = jl.init_params(jax.random.PRNGKey(8))
    x = np.random.RandomState(9).rand(6, *shape).astype(np.float32)
    tp = _tparams(jp)
    loss = tl.pretrain_loss(tp, torch.tensor(x), R.PRNGKey(21))
    jloss, jg = jax.value_and_grad(lambda p: jl.pretrain_loss(
        p, jnp.asarray(x), jax.random.PRNGKey(21)))(jp)
    _close(loss, jloss, what="loss")
    names = list(tp)
    for n, g in zip(names, torch.autograd.grad(loss, [tp[n] for n in names])):
        _close(g, jg[n], what=n)
    if kind == "vae":
        _close(tl.reconstruct(tp, torch.tensor(x)),
               jl.reconstruct(jp, jnp.asarray(x)), what="reconstruct")


# -- layerwise pretraining on both network kinds -------------------------

def _stack(S, vae_kw, seed=3):
    return (S.N.NeuralNetConfiguration.builder().seed(seed)
            .updater(S.U.Adam(5e-3)).weight_init("xavier").list()
            .layer(S.M.AutoEncoder(n_out=10, corruption_level=0.2,
                                   sparsity=0.05, sparsity_target=0.1))
            .layer(S.L.VariationalAutoencoder(
                n_out=4, encoder_layer_sizes=(8,), decoder_layer_sizes=(8,),
                activation="tanh", **vae_kw))
            .layer(S.L.OutputLayer(n_out=3, loss="mcxent"))
            .input_type_feed_forward(14).build())


def _graph(S, vae_kw, on_input: bool):
    g = (S.N.NeuralNetConfiguration.builder().seed(4)
         .updater(S.U.Adam(5e-3)).weight_init("xavier").graph_builder()
         .add_inputs("in")
         .set_input_types(S.C.InputType.feed_forward(14)))
    if on_input:
        g.add_layer("vae", S.L.VariationalAutoencoder(
            n_out=4, encoder_layer_sizes=(8,), decoder_layer_sizes=(8,),
            **vae_kw), "in")
        g.add_layer("ae", S.M.AutoEncoder(n_out=5, corruption_level=0.3),
                    "vae")
        last = "ae"
    else:
        g.add_layer("d", S.L.DenseLayer(n_out=9, activation="sigmoid"), "in")
        g.add_layer("vae", S.L.VariationalAutoencoder(
            n_out=4, encoder_layer_sizes=(8,), decoder_layer_sizes=(8,),
            **vae_kw), "d")
        last = "vae"
    return (g.add_layer("out", S.L.OutputLayer(n_out=3, loss="mcxent"), last)
            .set_outputs("out").build())


def _batches(n=3, rows=8, seed=12):
    rs = np.random.RandomState(seed)
    return [(rs.rand(rows, 14).astype(np.float32),
             np.eye(3, dtype=np.float32)[rs.randint(0, 3, rows)])
            for _ in range(n)]


def _pair_nets(kind, vae_kw, on_input=True):
    if kind == "mln":
        jn = JN.MultiLayerNetwork(_stack(J, vae_kw)).init()
        tn = TN.MultiLayerNetwork(_stack(T, vae_kw), device="cpu").init()
    else:
        from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
        jn = JGraph(_graph(J, vae_kw, on_input)).init()
        tn = TN.ComputationGraph(_graph(T, vae_kw, on_input),
                                 device="cpu").init()
    tn.set_params(network_params_from_jax(jax.tree.map(np.asarray,
                                                       jn.params())))
    return jn, tn


def _same_state(jn, tn):
    jp = jax.tree.map(np.asarray, jn.params())
    for k, p in jp.items():
        for n, v in p.items():
            _close(tn.params()[k][n], v, what=f"{k}.{n}")
    jo = jax.tree.map(np.asarray, jn._opt_state)
    for k, st in jo.items():
        for part in ("m", "v"):
            for n, v in st[part].items():
                _close(tn.get_updater_state()[k][part][n], v,
                       what=f"{k}.{part}.{n}")
    assert tuple(np.asarray(jn._rng).tolist()) == tuple(tn._rng)
    assert tn._step == jn._step
    assert abs(tn.score_ - float(jn.score_)) <= TOL * abs(float(jn.score_))


VAE_KW = {
    "bernoulli1": dict(reconstruction_distribution="bernoulli",
                       num_samples=1),
    "bernoulli3": dict(reconstruction_distribution="bernoulli",
                       num_samples=3),
    "gaussian1": dict(reconstruction_distribution="gaussian", num_samples=1),
    "gaussian3": dict(reconstruction_distribution="gaussian", num_samples=3),
}


@pytest.mark.parametrize("vae", list(VAE_KW))
def test_multilayer_pretrain_then_fit_matches_jax(vae):
    """AutoEncoder (sparsity on) then the VAE pretrained for two epochs,
    each on the layers below it: params, Adam state, key and score equal
    JAX's; then one fit continues the same Adam state."""
    jn, tn = _pair_nets("mln", VAE_KW[vae])
    data = _batches()
    jn.pretrain(data, epochs=2)
    tn.pretrain(data, epochs=2)
    assert tn._step == jn._step == 0     # a local counter, not _step
    _same_state(jn, tn)
    x, y = _batches(1, seed=40)[0]
    jn.fit(x, y)
    tn.fit(x, y)
    _same_state(jn, tn)


@pytest.mark.parametrize("vae,on_input", [("bernoulli3", True),
                                          ("gaussian1", False)])
def test_graph_pretrain_then_fit_matches_jax(vae, on_input):
    """``ComputationGraph.pretrain`` over a VAE on the input and an
    AutoEncoder above it, or a VAE above a dense node, then one fit."""
    jn, tn = _pair_nets("graph", VAE_KW[vae], on_input)
    data = _batches(seed=13)
    jn.pretrain(data, epochs=2)
    tn.pretrain(data, epochs=2)
    _same_state(jn, tn)
    x, y = _batches(1, seed=41)[0]
    jn.fit(x, y)
    tn.fit(x, y)
    _same_state(jn, tn)


def test_pretrain_single_layer_and_node_match_jax():
    """``pretrain_layer`` and ``pretrain_node`` alone: only that layer
    moves."""
    jn, tn = _pair_nets("mln", VAE_KW["gaussian1"])
    data = _batches(seed=14)
    before = {k: {n: t.detach().clone() for n, t in p.items()}
              for k, p in tn.params().items()}
    jn.pretrain_layer(1, data)
    tn.pretrain_layer(1, data)
    _same_state(jn, tn)
    moved = {k for k, p in tn.params().items()
             if any(not torch.equal(t, before[k][n]) for n, t in p.items())}
    assert moved == {tn._layer_keys[1]}
    jg, tg = _pair_nets("graph", VAE_KW["bernoulli1"], on_input=False)
    jg.pretrain_node("vae", data)
    tg.pretrain_node("vae", data)
    _same_state(jg, tg)


def test_pretrain_materialises_a_generator_once():
    """A generator feeds both pretrainable layers, as JAX's list() of it
    does."""
    jn, tn = _pair_nets("mln", VAE_KW["bernoulli1"])
    data = _batches(seed=15)
    jn.pretrain((b for b in data))
    tn.pretrain((b for b in data))
    _same_state(jn, tn)
    fresh = TN.MultiLayerNetwork(_stack(T, VAE_KW["bernoulli1"]),
                                 device="cpu").init()
    fresh.set_params(network_params_from_jax(jax.tree.map(np.asarray,
                                                          jn.params())))
    for i in (0, 1):
        key = tn._layer_keys[i]
        assert tn.get_updater_state()[key]["m"]["W" if i == 0 else "zm_W"] \
            .abs().sum() > 0


def test_non_pretrainable_layer_or_node_raises():
    jn, tn = _pair_nets("mln", VAE_KW["bernoulli1"])
    for net in (jn, tn):
        with pytest.raises(ValueError, match="not pretrainable"):
            net.pretrain_layer(2, _batches(1))
    jg, tg = _pair_nets("graph", VAE_KW["bernoulli1"], on_input=False)
    for g in (jg, tg):
        with pytest.raises(ValueError, match="not pretrainable"):
            g.pretrain_node("d", _batches(1))


# -- the mask layers in a network ----------------------------------------

def _masked_net(S):
    return (S.N.NeuralNetConfiguration.builder().seed(6)
            .updater(S.U.Adam(1e-2)).weight_init("xavier").list()
            .layer(S.M.MaskingLayer(mask_value=0.0))
            .layer(S.R.LSTM(n_out=5))
            .layer(S.L.DenseLayer(n_out=4, activation="tanh"))
            .layer(S.M.MaskLayer())
            .layer(S.L.GlobalPoolingLayer(pooling="avg"))
            .layer(S.L.OutputLayer(n_out=2, loss="mcxent"))
            .input_type_recurrent(3, 7).build())


def test_masking_and_mask_layers_in_a_network_match_jax():
    """MaskingLayer's mask from the data reaches the LSTM, MaskLayer and
    the pooling (padded steps all zero); then two Adam steps."""
    jn = JN.MultiLayerNetwork(_masked_net(J)).init()
    tn = TN.MultiLayerNetwork(_masked_net(T), device="cpu").init()
    tn.set_params(network_params_from_jax(jax.tree.map(np.asarray,
                                                       jn.params())))
    rs = np.random.RandomState(7)
    x = rs.randn(4, 7, 3).astype(np.float32)
    for b, pad in enumerate((0, 2, 3, 5)):
        if pad:
            x[b, -pad:] = 0.0
    y = np.eye(2, dtype=np.float32)[[0, 1, 1, 0]]
    _close(tn.output(x), jn.output(x), what="output")
    unmasked = tn.output(np.where(x == 0.0, 0.5, x).astype(np.float32))
    assert not torch.allclose(unmasked, tn.output(x))
    for _ in range(2):
        jn.fit(x, y)
        tn.fit(x, y)
    _same_params(jn, tn)


def _same_params(jn, tn):
    for k, p in jax.tree.map(np.asarray, jn.params()).items():
        for n, v in p.items():
            _close(tn.params()[k][n], v, what=f"{k}.{n}")


def test_mask_layer_takes_the_feature_mask():
    def net(S):
        return (S.N.NeuralNetConfiguration.builder().seed(2).list()
                .layer(S.R.SimpleRnn(n_out=4))
                .layer(S.M.MaskLayer())
                .layer(S.R.RnnOutputLayer(n_out=2, loss="mse",
                                          activation="identity"))
                .input_type_recurrent(3, 5).build())
    jn = JN.MultiLayerNetwork(net(J)).init()
    tn = TN.MultiLayerNetwork(net(T), device="cpu").init()
    tn.set_params(network_params_from_jax(jax.tree.map(np.asarray,
                                                       jn.params())))
    x = np.random.RandomState(3).randn(2, 5, 3).astype(np.float32)
    m = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    feats_t = tn._forward(tn.params(), torch.tensor(x), False, upto=2,
                          fmask=torch.tensor(m))
    feats_j = jn._forward(jn.params(), jn._net_state, jnp.asarray(x), False,
                          None, upto=2, fmask=jnp.asarray(m))[0]
    _close(feats_t, feats_j, what="masked features")
    assert float(feats_t[0, 3:].detach().abs().max()) == 0.0
    _close(tn.output(x, mask=m), jn.output(x, mask=m), what="output")


# -- host NMS -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_matches_jax(seed):
    rs = np.random.RandomState(seed)
    n = 60
    boxes = np.concatenate([rs.uniform(0, 10, (n, 2)),
                            rs.uniform(0.5, 4, (n, 2))], 1)
    scores = rs.rand(n)
    for iou, thr in ((0.45, 0.5), (0.2, 0.1), (0.7, 0.0)):
        tb, ts = TO.non_max_suppression(boxes, scores, iou, thr)
        jb, js = JO.non_max_suppression(boxes, scores, iou, thr)
        assert np.array_equal(tb, jb) and np.array_equal(ts, js)
        assert len(ts) >= 1


# -- the AutoEncoder golden file, written by the JAX package --------------

def test_autoencoder_golden_file():
    """``case_autoencoder`` of ``tests/integration_cases.py`` built in the
    port: pretrain two epochs, then a fit a batch, held to the committed
    JAX baseline (``autoencoder.npz``) at the golden runner's
    tolerances."""
    from integration_cases import N_STEPS, _batches as golden_batches
    conf = (TN.NeuralNetConfiguration.builder().seed(31)
            .updater(TU.Adam(2e-3)).weight_init("xavier").list()
            .layer(TM.AutoEncoder(n_out=8, corruption_level=0.2,
                                  activation="sigmoid"))
            .layer(TL.OutputLayer(n_out=3, loss="mcxent",
                                  activation="softmax"))
            .input_type_feed_forward(12).build())
    model = TN.MultiLayerNetwork(conf, device="cpu").init()
    batches = golden_batches((16, 12), 3, seed=6)
    model.pretrain(batches, epochs=2)
    losses = []
    for x, y in batches:
        model.fit(x, y)
        losses.append(model.score_)
    probe = np.random.RandomState(95).rand(4, 12).astype(np.float32)
    preds = model.output(probe).numpy()
    data = np.load(GOLDEN)
    want = {k[2:]: data[k] for k in data.files if k.startswith("p:")}
    got = {f"{k}/{n}": t.detach().numpy()
           for k, p in sorted(model.params().items())
           for n, t in sorted(p.items())}
    assert len(losses) == N_STEPS and set(got) == set(want)
    np.testing.assert_allclose(np.asarray(losses, np.float64),
                               data["__losses__"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(preds, data["__preds__"], rtol=1e-4,
                               atol=1e-5)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_updater_state_after_pretraining_carries_across():
    """JAX's updater state after pretraining, carried into the port,
    continues the same fit."""
    jn, tn = _pair_nets("mln", VAE_KW["gaussian3"])
    jn.pretrain(_batches(seed=16))
    tn.set_params(network_params_from_jax(jax.tree.map(np.asarray,
                                                       jn.params())))
    tn.set_updater_state(updater_state_from_jax(
        jax.tree.map(np.asarray, jn._opt_state)))
    tn._rng = tuple(int(v) for v in np.asarray(jn._rng))
    x, y = _batches(1, seed=42)[0]
    jn.fit(x, y)
    tn.fit(x, y)
    _same_params(jn, tn)


# -- archives and serving with the new leaves ----------------------------

def _leaf_net(S, head):
    """An AutoEncoder (``vb``) and a VAE (``e0_W`` ... ``xr_b``) under a
    CenterLoss (``centers``) or OCNN (``V``, ``w``, ``r_b``) head."""
    out = (S.L.CenterLossOutputLayer(n_out=3, alpha=0.4, lambda_=0.3)
           if head == "centerloss" else
           S.L.OCNNOutputLayer(hidden_size=4, nu=0.3))
    return (S.N.NeuralNetConfiguration.builder().seed(9)
            .updater(S.U.Adam(1e-2)).weight_init("xavier").list()
            .layer(S.M.AutoEncoder(n_out=10, corruption_level=0.1))
            .layer(S.L.VariationalAutoencoder(
                n_out=5, encoder_layer_sizes=(8,), decoder_layer_sizes=(7,)))
            .layer(out)
            .input_type_feed_forward(14).build())


@pytest.mark.parametrize("head", ["centerloss", "ocnn"])
def test_archive_of_every_new_leaf_cross_restores(head, tmp_path):
    """Each package restores the other's archive of a pretrained and
    fitted network holding every new leaf (params and Adam state, bit
    for bit), and InferenceEngine serves the restored port network."""
    from deeplearning4j_tpu.util.serializer import ModelSerializer as JSer
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
    from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
    jn = JN.MultiLayerNetwork(_leaf_net(J, head)).init()
    tn = TN.MultiLayerNetwork(_leaf_net(T, head), device="cpu").init()
    tn.set_params(network_params_from_jax(jax.tree.map(np.asarray,
                                                       jn.params())))
    data = _batches(2, seed=17)
    for net in (jn, tn):
        net.pretrain(data)
        net.fit(*data[0])
    pj, pt = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    JSer.write_model(jn, pj)
    ModelSerializer.write_model(tn, pt)
    jr = JSer.restore(pt)
    tr = ModelSerializer.restore(pj, device="cpu")
    leaves = {n for p in tn.params().values() for n in p}
    want = {"vb", "e0_W", "zm_W", "zv_b", "d0_W", "xr_W"} | (
        {"centers"} if head == "centerloss" else {"V", "w", "r_b"})
    assert want <= leaves
    for k, p in tn.params().items():
        for n, t in p.items():
            assert np.array_equal(np.asarray(jr.params()[k][n]), _np(t))
            assert np.array_equal(_np(tr.params()[k][n]),
                                  np.asarray(jn.params()[k][n]))
    for k, st in tn.get_updater_state().items():
        for part in ("m", "v"):
            for n, t in st[part].items():
                assert np.array_equal(
                    np.asarray(jr._opt_state[k][part][n]), _np(t))
    x = _batches(1, seed=18)[0][0]
    eng = InferenceEngine(tr, max_batch_size=8)
    _close(eng.predict(x), tr.output(x), what="served")
    _close(tr.output(x), jn.output(x), what="restored output")
