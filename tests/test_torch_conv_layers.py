"""The port's conv-family layers (``nn/layers/convolutional.py``) against
the JAX package's, on the CPU: every class, forward and gradients
(``jax.grad`` against autograd) of ``sum(out * cotangent)`` with respect
to the input and every param, on the same numpy-seeded inputs and
params; ``init`` from the same key; ``output_shape``; JSON key for key
and rebuilt by each package; and the cases of
``tests/test_convolutional.py`` on the port.

Tolerances, with their reasons:
- f32: 1e-5 absolute and relative (f32 on both sides; a window sums at
  most 3 x 3 x 3 x 3 = 81 products, in another order);
- ``init``: within 8 f32 ulp of each weight (``random.normal`` is within
  3 ulp of JAX's unit draw, and the fan scale rounds each side once
  more), as ``tests/test_torch_zoo_graph.py`` holds the zoo;
- bf16 operands: the output and each gradient within 2^-6 of its
  largest |value| (each side rounds its products' f32 sum to bf16 once,
  one ulp 2^-8 of a value, and the backward's bf16 cotangents add two
  more roundings); a bias's gradient is held to the f32 sum over the
  positions of the bf16 cotangent reaching it, within 2^-8 of its
  largest |value|: XLA reduces that leaf in bf16 (ROADMAP §C), so JAX's
  own value is not the reference for it;
- max pooling where a window's maxima tie (ReLU'd zeros) is held
  exactly: both send the gradient to the first maximum.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.layers import convolutional as JC
from deeplearning4j_tpu_torch import random as R
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.conf import InputType
from deeplearning4j_tpu_torch.nn.layers import convolutional as TC
from _torch_threads import one_torch_thread  # noqa: F401,E402

TOL = 1e-5
BF16_TOL = 2 ** -6
BF16_BIAS_TOL = 2 ** -8
INIT_ULP = 8


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


def _close(a, b, tol=TOL, what=""):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


def _near(got, want, tol, what=""):
    """Max |got - want| within ``tol`` of max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, what


#: (id, factory of a layer from either package's module, feature shape)
CASES = [
    ("conv1d_same_s2", lambda M: M.Convolution1D(
        n_out=5, kernel=3, stride=2, activation="tanh"), (11, 4)),
    ("conv1d_valid_d2", lambda M: M.Convolution1D(
        n_out=3, kernel=2, dilation=2, padding="valid"), (9, 3)),
    ("conv1d_int_pad", lambda M: M.Convolution1D(
        n_out=4, kernel=4, padding=2, stride=3), (10, 2)),
    ("conv1d_pairs_nobias", lambda M: M.Convolution1D(
        n_out=4, kernel=3, padding=(2, 0), has_bias=False), (7, 3)),
    ("conv3d_valid", lambda M: M.Convolution3D(
        n_out=5, kernel=(2, 2, 2), padding="valid"), (5, 6, 4, 3)),
    ("conv3d_same_s212", lambda M: M.Convolution3D(
        n_out=4, kernel=(3, 2, 3), stride=(2, 1, 2), activation="relu"),
     (5, 4, 6, 2)),
    ("conv3d_pairs_d2", lambda M: M.Convolution3D(
        n_out=3, kernel=(2, 2, 2), dilation=(1, 2, 1),
        padding=((1, 0), (0, 1), (1, 1))), (4, 5, 3, 2)),
    ("deconv_k2s2_valid", lambda M: M.Deconvolution2D(
        n_out=4, kernel=(2, 2), stride=(2, 2), activation="relu"),
     (4, 5, 3)),
    ("deconv_k3s2_same", lambda M: M.Deconvolution2D(
        n_out=3, kernel=(3, 3), stride=(2, 2), padding="same"), (4, 3, 2)),
    ("deconv_k3s1_valid", lambda M: M.Deconvolution2D(
        n_out=3, kernel=(3, 3), stride=(1, 1), padding="valid"), (4, 5, 2)),
    ("deconv_k4s2_same", lambda M: M.Deconvolution2D(
        n_out=2, kernel=(4, 4), stride=(2, 2), padding="same"), (3, 4, 3)),
    ("deconv_k32s21_same", lambda M: M.Deconvolution2D(
        n_out=3, kernel=(3, 2), stride=(2, 1), padding="same",
        has_bias=False), (4, 4, 2)),
    ("deconv_k2s3_valid", lambda M: M.Deconvolution2D(
        n_out=2, kernel=(2, 2), stride=(3, 3)), (3, 3, 2)),
    ("deconv_pairs", lambda M: M.Deconvolution2D(
        n_out=3, kernel=(3, 3), stride=(2, 2),
        padding=((1, 0), (2, 1))), (4, 3, 2)),
    ("deconv_pairs_wide", lambda M: M.Deconvolution2D(
        n_out=2, kernel=(2, 3), stride=(2, 2),
        padding=((3, 0), (0, 4))), (3, 3, 2)),
    ("depthwise_m1_same", lambda M: M.DepthwiseConvolution2D(
        kernel=(3, 3)), (6, 5, 4)),
    ("depthwise_m3_s2_valid", lambda M: M.DepthwiseConvolution2D(
        depth_multiplier=3, kernel=(3, 2), stride=(2, 2), padding="valid",
        activation="tanh"), (7, 6, 3)),
    ("depthwise_pairs_d21", lambda M: M.DepthwiseConvolution2D(
        depth_multiplier=2, kernel=(2, 3), dilation=(2, 1),
        padding=((1, 1), (0, 2)), has_bias=False), (5, 5, 2)),
    ("sepconv_same", lambda M: M.SeparableConvolution2D(
        n_out=5, kernel=(3, 3)), (6, 6, 3)),
    ("sepconv_k5s2_m2", lambda M: M.SeparableConvolution2D(
        n_out=4, kernel=(5, 5), stride=(2, 2), depth_multiplier=2,
        activation="relu"), (7, 8, 3)),
    ("sepconv_valid_d2_nobias", lambda M: M.SeparableConvolution2D(
        n_out=3, kernel=(3, 3), padding="valid", dilation=(2, 2),
        has_bias=False), (8, 7, 2)),
    ("sepconv_pairs", lambda M: M.SeparableConvolution2D(
        n_out=3, kernel=(2, 2), padding=((0, 1), (1, 0))), (4, 5, 2)),
    ("pool1d_max_valid", lambda M: M.Subsampling1DLayer(
        kernel=2, stride=2), (10, 3)),
    ("pool1d_avg_same", lambda M: M.Subsampling1DLayer(
        kernel=3, stride=2, padding="same", pooling="avg"), (9, 3)),
    ("pool1d_max_same", lambda M: M.Subsampling1DLayer(
        kernel=4, stride=1, padding="same"), (7, 2)),
    ("pool1d_avg_pairs", lambda M: M.Subsampling1DLayer(
        kernel=2, stride=1, padding=(1, 0), pooling="avg"), (6, 2)),
    ("pool3d_max_valid", lambda M: M.Subsampling3DLayer(
        kernel=(2, 2, 2)), (4, 4, 5, 3)),
    ("pool3d_avg_same", lambda M: M.Subsampling3DLayer(
        kernel=(3, 3, 3), stride=(2, 2, 2), padding="same",
        pooling="avg"), (5, 4, 5, 2)),
    ("pool3d_max_same", lambda M: M.Subsampling3DLayer(
        kernel=(2, 3, 2), stride=(1, 2, 2), padding="same"), (3, 5, 4, 2)),
    ("pool3d_avg_pairs", lambda M: M.Subsampling3DLayer(
        kernel=(2, 2, 2), stride=(1, 1, 2), pooling="avg",
        padding=((1, 0), (0, 1), (1, 1))), (3, 3, 4, 2)),
    ("upsampling1d", lambda M: M.Upsampling1D(size=3), (4, 3)),
    ("upsampling3d", lambda M: M.Upsampling3D(size=(2, 1, 3)), (2, 3, 2, 2)),
    ("cropping1d", lambda M: M.Cropping1D(cropping=(1, 2)), (7, 3)),
    ("cropping1d_end0", lambda M: M.Cropping1D(cropping=(2, 0)), (5, 2)),
    ("cropping2d", lambda M: M.Cropping2D(cropping=((1, 0), (2, 1))),
     (5, 6, 3)),
    ("cropping3d", lambda M: M.Cropping3D(cropping=1), (4, 4, 5, 2)),
    ("zeropad1d", lambda M: M.ZeroPadding1DLayer(padding=(1, 2)), (4, 3)),
    ("zeropad3d", lambda M: M.ZeroPadding3DLayer(
        padding=((1, 0), (0, 2), (1, 1))), (2, 3, 2, 2)),
    ("spacetodepth", lambda M: M.SpaceToDepthLayer(block_size=2),
     (4, 6, 3)),
    ("depthtospace", lambda M: M.DepthToSpaceLayer(block_size=2),
     (3, 2, 8)),
    ("spacetobatch", lambda M: M.SpaceToBatchLayer(
        blocks=(2, 2), padding=((1, 1), (0, 2))), (6, 6, 3)),
    ("prelu_ff", lambda M: M.PReLULayer(alpha_init=0.25), (5,)),
    ("prelu_shared_hw", lambda M: M.PReLULayer(shared_axes=[1, 2]),
     (4, 5, 3)),
    ("elementwisemult", lambda M: M.ElementWiseMultiplicationLayer(
        activation="tanh"), (4, 5, 3)),
    ("lc2d_k32_s2", lambda M: M.LocallyConnected2D(
        n_out=4, kernel=(3, 2), stride=(2, 2), activation="tanh"),
     (7, 6, 3)),
    ("lc2d_nobias", lambda M: M.LocallyConnected2D(
        n_out=2, kernel=(2, 2), has_bias=False), (4, 4, 2)),
    ("lc1d_k3_s2", lambda M: M.LocallyConnected1D(
        n_out=4, kernel=3, stride=2), (9, 3)),
]
IDS = [c[0] for c in CASES]
#: 1D layers whose JSON padding is a flat [low, high] list
JAX_FLAT_PADDING = {"conv1d_pairs_nobias", "pool1d_avg_pairs", "zeropad1d"}

#: every class of JAX's module but FrozenLayer, which the port defines in
#: nn/layers/__init__.py
CLASSES = ["Convolution1D", "Convolution3D", "Deconvolution2D",
           "DepthwiseConvolution2D", "SeparableConvolution2D",
           "Subsampling1DLayer", "Subsampling3DLayer", "Upsampling1D",
           "Upsampling3D", "Cropping1D", "Cropping2D", "Cropping3D",
           "ZeroPadding1DLayer", "ZeroPadding3DLayer", "SpaceToDepthLayer",
           "DepthToSpaceLayer", "SpaceToBatchLayer", "PReLULayer",
           "ElementWiseMultiplicationLayer", "LocallyConnected2D",
           "LocallyConnected1D"]


def _built(make, shape):
    jl, tl = make(JC), make(TC)
    jl.build(shape, {})
    tl.build(shape, {})
    return jl, tl


def _params_for(layer, seed):
    return {n: _rand(seed + i, *sh, scale=0.5)
            for i, (n, sh) in enumerate(sorted(layer.param_shapes().items()))}


def _input(name, shape, seed):
    x = _rand(seed, 2, *shape)
    if name.startswith(("prelu", "pool")):
        x[0].reshape(-1)[::3] = 0.0        # exact zeros (ties, PReLU at 0)
    return x


def _jax_side(jl, params, x, dtype):
    """JAX's output and gradients, each through one compiled program
    (cheaper on the CPU than dispatching the ops one by one)."""
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in params.items()}
    jx = jnp.asarray(x).astype(dtype)
    jout = jax.jit(lambda p, xx: jl.apply(p, xx, {}, False, None)[0])(jp, jx)
    ct = _rand(99, *jout.shape)

    def loss(p, xx):
        out, _ = jl.apply(p, xx, {}, False, None)
        return jnp.sum(out.astype(jnp.float32) * ct)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jx)
    g = {k: np.asarray(v.astype(jnp.float32)) for k, v in gp.items()}
    g["x"] = np.asarray(gx.astype(jnp.float32))
    return np.asarray(jout.astype(jnp.float32)), g, ct


def _port_side(tl, params, x, dtype, ct):
    tp = {k: torch.tensor(v).to(dtype).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.tensor(x).to(dtype).requires_grad_(True)
    tout, _ = tl.apply(tp, tx, {}, False, None)
    (tout.float() * torch.from_numpy(ct)).sum().backward()
    g = {k: _np(v.grad) for k, v in tp.items()}
    g["x"] = _np(tx.grad)
    return tout, g


@pytest.mark.parametrize("name,make,shape", CASES, ids=IDS)
def test_forward_and_gradients_f32(name, make, shape):
    jl, tl = _built(make, shape)
    params = _params_for(jl, 1)
    x = _input(name, shape, 2)
    jo, jg, ct = _jax_side(jl, params, x, jnp.float32)
    to, tg = _port_side(tl, params, x, torch.float32, ct)
    assert to.dtype == torch.float32 and to.shape == jo.shape
    _close(_np(to), jo, what="out")
    assert set(tg) == set(jg)
    for k in jg:
        _close(tg[k], jg[k], what=k)


@pytest.mark.parametrize("name,make,shape", CASES, ids=IDS)
def test_forward_and_gradients_bf16(name, make, shape):
    """bf16 input and params (the bf16 policy's operands) on both sides;
    a bias's gradient against the f32 sum of its bf16 cotangent."""
    jl, tl = _built(make, shape)
    params = _params_for(jl, 3)
    x = _input(name, shape, 4)
    jo, jg, ct = _jax_side(jl, params, x, jnp.bfloat16)
    to, tg = _port_side(tl, params, x, torch.bfloat16, ct)
    assert to.dtype == torch.bfloat16
    _near(_np(to), jo, BF16_TOL, "out")
    for k in jg:
        if k != "b":
            _near(tg[k], jg[k], BF16_TOL, k)
    if "b" in jg and getattr(tl, "activation", None) is not None \
            and tl.activation.name == "identity":
        # the cotangent reaching the bias is bf16(ct), broadcast over
        # every axis the bias lacks
        up = ct.astype(jnp.bfloat16).astype(np.float32)
        want = up.reshape(-1, *params["b"].shape).sum(0) \
            if up.ndim - 1 == params["b"].ndim \
            else up.reshape(-1, params["b"].shape[-1]).sum(0)
        _near(tg["b"], want, BF16_BIAS_TOL, "b")


MIXED = ("lc", "prelu", "elementwise")


@pytest.mark.parametrize("name,make,shape",
                         [c for c in CASES if c[0].startswith(MIXED)],
                         ids=[c for c in IDS if c.startswith(MIXED)])
def test_mixed_operands_promote_like_jax(name, make, shape):
    """f32 input with bf16 params (an f32 mask promoted the input under
    the bf16 policy): both compute in f32 where JAX promotes (einsum and
    elementwise ops; ``lax``'s convolutions refuse mixed operands)."""
    jl, tl = _built(make, shape)
    params = _params_for(jl, 5)
    x = _rand(6, 2, *shape)
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in params.items()}
    jo = jax.jit(lambda p, xx: jl.apply(p, xx, {}, False, None)[0])(
        jp, jnp.asarray(x))
    to, _ = tl.apply({k: torch.tensor(v).bfloat16()
                      for k, v in params.items()}, torch.tensor(x), {},
                     False, None)
    assert jo.dtype == jnp.float32 and to.dtype == torch.float32
    _close(_np(to), np.asarray(jo), what="out")


@pytest.mark.parametrize("name,make,shape", CASES, ids=IDS)
def test_shapes_and_json_match_jax(name, make, shape):
    jl, tl = _built(make, shape)
    assert type(tl).__name__ == type(jl).__name__ and tl.kind == jl.kind
    assert TL.REGISTRY[tl.kind] is type(tl)
    assert tl.param_shapes() == jl.param_shapes()
    assert tl.output_shape(shape) == jl.output_shape(shape)
    # the applied size, which for explicit deconvolution pads is not
    # output_shape's (JAX's formula, mirrored)
    x = _rand(7, 2, *shape)
    params = _params_for(jl, 8)
    jo = jax.eval_shape(lambda p, xx: jl.apply(p, xx, {}, False, None)[0],
                        {k: jnp.asarray(v) for k, v in params.items()},
                        jnp.asarray(x))
    to, _ = tl.apply({k: torch.tensor(v) for k, v in params.items()},
                     torch.tensor(x), {}, False, None)
    assert tuple(to.shape) == tuple(jo.shape)
    d = tl.to_json()
    assert d == jl.to_json()
    text = json.loads(json.dumps(d))      # through JSON text: lists
    for back in (TL.from_json(jl.to_json()), TL.from_json(text)):
        assert type(back) is type(tl)
        back.build(shape, {})
        assert back.to_json() == d
    if name in JAX_FLAT_PADDING:
        # the reference's from_json makes pairs of every padding list's
        # items, so a 1D layer's flat (low, high) does not come back
        with pytest.raises(TypeError):
            JL.from_json(text)
        return
    again = JL.from_json(text)
    again.build(shape, {})
    assert again.to_json() == jl.to_json()


#: one case a class with params, the one whose fans and key split vary
#: most (a depth multiplier, a non-square kernel, shared axes)
INIT_CASES = ("conv1d_same_s2", "conv3d_same_s212", "deconv_k32s21_same",
              "depthwise_m3_s2_valid", "sepconv_k5s2_m2", "prelu_shared_hw",
              "elementwisemult", "lc2d_k32_s2", "lc1d_k3_s2")


@pytest.mark.parametrize("name,make,shape",
                         [c for c in CASES if c[0] in INIT_CASES],
                         ids=[c for c in IDS if c in INIT_CASES])
def test_init_is_jax_init(name, make, shape):
    jl, tl = _built(make, shape)
    jp = jl.init_params(jax.random.PRNGKey(23))
    tp = tl.init_params(R.PRNGKey(23))
    assert set(tp) == set(jp)
    for n, v in jp.items():
        a, b = np.asarray(v), _np(tp[n])
        assert a.shape == b.shape and tp[n].dtype == torch.float32
        assert np.all(np.abs(a - b) <= INIT_ULP * np.spacing(np.abs(a))), n


def test_every_jax_class_is_ported_under_its_kind():
    jax_classes = sorted(n for n, c in vars(JC).items()
                         if isinstance(c, type) and issubclass(c, JL.Layer)
                         and c.__module__ == JC.__name__)
    assert jax_classes == sorted(CLASSES + ["FrozenLayer"])
    for n in CLASSES:
        t, j = getattr(TC, n), getattr(JC, n)
        assert t.__module__ == TC.__name__ and t.kind == j.kind
        assert TL.REGISTRY[t.kind] is t
    # FrozenLayer: the one class defined once, in nn/layers/__init__.py
    assert TC.FrozenLayer is TL.FrozenLayer
    assert TL.REGISTRY["frozen"] is TL.FrozenLayer
    assert TC.FrozenLayer.kind == JC.FrozenLayer.kind == "frozen"
    assert not any(c.__module__ == TC.__name__ and c.kind == "frozen"
                   for c in TL.REGISTRY.values())


@pytest.mark.parametrize("k,s,pad", [(2, 2, "VALID"), (3, 2, "SAME"),
                                     (3, 1, "VALID"), (4, 2, "SAME"),
                                     (2, 3, "VALID"), (3, 1, "SAME"),
                                     (1, 2, "SAME"), (5, 3, "VALID")])
def test_deconvolution_pads_are_lax_rule(k, s, pad):
    from jax._src.lax.convolution import _conv_transpose_padding
    assert TC._transpose_pads(k, s, pad) == tuple(
        _conv_transpose_padding(k, s, pad))


def test_deconvolution_is_not_conv_transpose_as_it_stands():
    """JAX's transposed convolution does not flip the kernel: the port
    matches it, and ``F.conv_transpose2d`` of the unflipped kernel does
    not (k=3, s=2, "same": lax pads (2, 1))."""
    jl, tl = _built(lambda M: M.Deconvolution2D(
        n_out=2, kernel=(3, 3), stride=(2, 2), padding="same"), (3, 3, 2))
    params = _params_for(jl, 9)
    x = _rand(10, 1, 3, 3, 2)
    jo, _ = jl.apply({k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(x), {}, False, None)
    to, _ = tl.apply({k: torch.tensor(v) for k, v in params.items()},
                     torch.tensor(x), {}, False, None)
    _close(_np(to), np.asarray(jo))
    w = torch.tensor(params["W"]).permute(2, 3, 0, 1)
    naive = torch.nn.functional.conv_transpose2d(
        torch.tensor(x).permute(0, 3, 1, 2), w, torch.tensor(params["b"]),
        stride=2, padding=1, output_padding=1).permute(0, 2, 3, 1)
    assert naive.shape == to.shape
    assert float((naive - to).abs().max()) > 0.1


def test_locally_connected_patch_order_is_channel_major():
    """Non-square kernel, stride 2, C=3: weights that read only channel
    1 at kernel row 2, column 0 pick exactly that pixel, so a
    (kh, kw, C) order fails."""
    layer = TC.LocallyConnected2D(n_out=1, kernel=(3, 2), stride=(2, 2),
                                  has_bias=False)
    layer.build((7, 6, 3), {})
    W = torch.zeros(layer.param_shapes()["W"])
    W[:, 1 * 6 + 2 * 2 + 0, 0] = 1.0          # (c=1, i=2, j=0)
    x = torch.tensor(_rand(11, 2, 7, 6, 3))
    out, _ = layer.apply({"W": W}, x, {}, False, None)
    assert torch.equal(out[..., 0], x[:, 2::2, 0:5:2, 1])


def test_space_to_batch_orders_the_batch_blocks_first():
    layer = TC.SpaceToBatchLayer(blocks=(2, 2))
    layer.build((4, 4, 1), {})
    x = torch.arange(2 * 16, dtype=torch.float32).reshape(2, 4, 4, 1)
    out, _ = layer.apply({}, x, {}, False, None)
    assert out.shape == (8, 2, 2, 1)
    # batch index (bh, bw, b): row offset bh, column offset bw of image b
    for bh in range(2):
        for bw in range(2):
            for b in range(2):
                assert torch.equal(out[(bh * 2 + bw) * 2 + b],
                                   x[b, bh::2, bw::2])


def test_prelu_gradient_at_zero_goes_to_x():
    layer = TC.PReLULayer(alpha_init=0.25)
    layer.build((3,), {})
    a = torch.full((3,), 0.25, requires_grad=True)
    x = torch.tensor([[-1.0, 0.0, 2.0]], requires_grad=True)
    out, _ = layer.apply({"alpha": a}, x, {}, False, None)
    out.sum().backward()
    assert x.grad.tolist() == [[0.25, 1.0, 1.0]]
    assert a.grad.tolist() == [-1.0, 0.0, 0.0]


@pytest.mark.parametrize("which", ["1d", "3d"])
def test_max_pool_ties_route_to_the_same_element(which):
    if which == "1d":
        make, shape = (lambda M: M.Subsampling1DLayer(kernel=3, stride=2,
                                                      padding="same"),
                       (12, 2))
    else:
        make, shape = (lambda M: M.Subsampling3DLayer(
            kernel=(2, 2, 2), stride=(2, 1, 2)), (4, 4, 4, 2))
    x = np.maximum(_rand(12, 2, *shape), 0.0)
    x[:, :3] = 0.0                               # all-zero windows
    jl, tl = _built(make, shape)
    jo, jg, ct = _jax_side(jl, {}, x, jnp.float32)
    to, tg = _port_side(tl, {}, x, torch.float32, ct)
    np.testing.assert_array_equal(_np(to), jo)
    np.testing.assert_array_equal(tg["x"], jg["x"])


def test_input_type_convolutional3d_builds_a_conv3d_stack():
    from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.conf import InputType as JInputType
    from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                             NeuralNetConfiguration)
    it = InputType.convolutional3d(4, 6, 6, 2)
    assert (it.kind, it.shape) == ("cnn3d", (4, 6, 6, 2))
    assert it.to_json() == JInputType.convolutional3d(4, 6, 6, 2).to_json()

    def conf(N, L, C, I):
        return (N.builder().seed(3).list()
                .layer(C.Convolution3D(n_out=3, kernel=(2, 2, 2),
                                       activation="relu"))
                .layer(C.Subsampling3DLayer(kernel=(2, 2, 2)))
                .layer(L.OutputLayer(n_out=4))
                .input_type(I.convolutional3d(4, 6, 6, 2)).build())
    tc = conf(NeuralNetConfiguration, TL, TC, InputType)
    jc = conf(JConf, JL, JC, JInputType)
    assert tc.to_json() == jc.to_json()
    net = MultiLayerNetwork(tc, device="cpu").init()
    out = net.output(_rand(13, 2, 4, 6, 6, 2))
    assert out.shape == (2, 4) and torch.isfinite(out).all()


# -- tests/test_convolutional.py's cases, on the port ---------------------

def _run(layer, shape, seed=0):
    layer.build(shape[1:], {"weight_init": "xavier", "activation": None})
    params = layer.init_params(R.PRNGKey(seed))
    x = torch.tensor(_rand(seed + 1, *shape))
    out, _ = layer.apply(params, x, {}, False, None)
    expected = layer.output_shape(shape[1:])
    assert tuple(out.shape) == (shape[0],) + tuple(expected)
    assert torch.isfinite(out).all()
    return out, params, x


def test_conv1d():
    out, _, _ = _run(TC.Convolution1D(n_out=6, kernel=3, stride=2),
                     (2, 11, 4))
    assert out.shape == (2, 6, 6)


def test_conv3d():
    out, _, _ = _run(TC.Convolution3D(n_out=5, kernel=(2, 2, 2),
                                      padding="valid"), (2, 5, 6, 7, 3))
    assert out.shape == (2, 4, 5, 6, 5)


def test_deconv2d_inverts_stride():
    out, _, _ = _run(TC.Deconvolution2D(n_out=4, kernel=(2, 2),
                                        stride=(2, 2)), (2, 5, 5, 3))
    assert out.shape == (2, 10, 10, 4)


def test_depthwise_multiplier():
    out, _, _ = _run(TC.DepthwiseConvolution2D(depth_multiplier=3),
                     (2, 8, 8, 4))
    assert out.shape[-1] == 12


def test_separable_equals_depthwise_then_pointwise():
    layer = TC.SeparableConvolution2D(n_out=6, kernel=(3, 3))
    out, params, x = _run(layer, (2, 8, 8, 4))
    assert out.shape == (2, 8, 8, 6)
    assert set(params) == {"dW", "pW", "b"}
    dw = TC.DepthwiseConvolution2D(kernel=(3, 3), has_bias=False)
    dw.build((8, 8, 4), {"activation": None})
    mid, _ = dw.apply({"W": params["dW"]}, x, {}, False, None)
    pw = TL.ConvolutionLayer(n_out=6, kernel=(1, 1))
    pw.build((8, 8, 4), {"activation": None})
    want, _ = pw.apply({"W": params["pW"], "b": params["b"]}, mid, {}, False,
                       None)
    _close(_np(out), _np(want))


def test_pooling_1d_3d():
    _run(TC.Subsampling1DLayer(kernel=2, stride=2), (2, 10, 3))
    _run(TC.Subsampling3DLayer(kernel=(2, 2, 2), pooling="avg"),
         (2, 4, 4, 4, 3))


def test_upsampling_1d_3d():
    out, _, _ = _run(TC.Upsampling1D(size=3), (2, 4, 3))
    assert out.shape == (2, 12, 3)
    out, _, _ = _run(TC.Upsampling3D(size=(2, 2, 2)), (1, 2, 3, 4, 2))
    assert out.shape == (1, 4, 6, 8, 2)


def test_crop_pad_roundtrip():
    pad = TC.ZeroPadding1DLayer(padding=(1, 2))
    pad.build((6, 3), {})
    crop = TC.Cropping1D(cropping=(1, 2))
    crop.build((9, 3), {})
    x1 = torch.tensor(_rand(1, 2, 6, 3))
    padded, _ = pad.apply({}, x1, {}, False, None)
    cropped, _ = crop.apply({}, padded, {}, False, None)
    assert torch.equal(cropped, x1)
    c2 = TC.Cropping2D(cropping=((1, 1), (2, 2)))
    c2.build((6, 8, 3), {})
    out, _ = c2.apply({}, torch.tensor(_rand(0, 2, 6, 8, 3)), {}, False,
                      None)
    assert out.shape == (2, 4, 4, 3)
    _run(TC.Cropping3D(cropping=1), (1, 4, 4, 4, 2))
    _run(TC.ZeroPadding3DLayer(padding=1), (1, 2, 2, 2, 2))


def test_space_depth_inverse():
    x = torch.tensor(_rand(0, 2, 4, 4, 3))
    s2d = TC.SpaceToDepthLayer(block_size=2)
    s2d.build((4, 4, 3), {})
    d2s = TC.DepthToSpaceLayer(block_size=2)
    d2s.build((2, 2, 12), {})
    mid, _ = s2d.apply({}, x, {}, False, None)
    assert mid.shape == (2, 2, 2, 12)
    back, _ = d2s.apply({}, mid, {}, False, None)
    assert torch.equal(back, x)


def test_space_to_batch():
    layer = TC.SpaceToBatchLayer(blocks=(2, 2))
    layer.build((4, 4, 3), {})
    out, _ = layer.apply({}, torch.tensor(_rand(0, 2, 4, 4, 3)), {}, False,
                         None)
    assert out.shape == (8, 2, 2, 3)


def test_prelu_negative_slope():
    layer = TC.PReLULayer(alpha_init=0.25)
    layer.build((5,), {})
    p = layer.init_params(R.PRNGKey(0))
    x = torch.tensor([[-2.0, -1.0, 0.0, 1.0, 2.0]])
    out, _ = layer.apply(p, x, {}, False, None)
    assert out.tolist() == [[-0.5, -0.25, 0.0, 1.0, 2.0]]


def test_elementwise_mult_identity_at_init():
    layer = TC.ElementWiseMultiplicationLayer()
    layer.build((4,), {"activation": None})
    p = layer.init_params(R.PRNGKey(0))
    x = torch.tensor(_rand(1, 3, 4))
    out, _ = layer.apply(p, x, {}, False, None)
    assert torch.equal(out, x)


def test_locally_connected_2d_vs_conv_when_tied():
    """With identical weights at every position, LC == conv (valid)."""
    lc = TC.LocallyConnected2D(n_out=3, kernel=(2, 2), has_bias=False)
    out, params, x = _run(lc, (2, 5, 5, 4))
    assert out.shape == (2, 4, 4, 3)
    W = params["W"].clone()
    W[:] = W[0]
    tied, _ = lc.apply({"W": W}, x, {}, False, None)
    # patch features are channel-major (C, kh, kw)
    conv = TL.ConvolutionLayer(n_out=3, kernel=(2, 2), padding="valid",
                               has_bias=False)
    conv.build((5, 5, 4), {"activation": None})
    ref, _ = conv.apply({"W": W[0].reshape(4, 2, 2, 3).permute(1, 2, 0, 3)},
                        x, {}, False, None)
    _close(_np(tied), _np(ref))


def test_locally_connected_1d():
    out, _, _ = _run(TC.LocallyConnected1D(n_out=3, kernel=2), (2, 6, 4))
    assert out.shape == (2, 5, 3)


def test_frozen_layer_blocks_gradients():
    layer = TC.FrozenLayer(TC.Deconvolution2D(n_out=3))
    layer.build((3, 3, 4), {"weight_init": "xavier", "activation": None})
    params = {n: t.requires_grad_(True) for n, t in
              layer.init_params(R.PRNGKey(0)).items()}
    x = torch.tensor(_rand(1, 2, 3, 3, 4), requires_grad=True)
    out, _ = layer.apply(params, x, {}, True, None)
    (out ** 2).sum().backward()
    assert all(p.grad is None for p in params.values())
    assert x.grad is not None and float(x.grad.abs().sum()) > 0
    back = TL.from_json(layer.to_json())
    assert type(back) is TL.FrozenLayer and type(back.layer) is \
        TC.Deconvolution2D


@pytest.mark.parametrize("layer_fn,shape", [
    (lambda: TC.Convolution1D(n_out=4, kernel=3), (2, 8, 3)),
    (lambda: TC.Convolution3D(n_out=4), (1, 4, 4, 4, 2)),
    (lambda: TC.Deconvolution2D(n_out=4), (1, 4, 4, 2)),
    (lambda: TC.SeparableConvolution2D(n_out=4), (1, 6, 6, 3)),
    (lambda: TC.DepthwiseConvolution2D(depth_multiplier=2), (1, 6, 6, 3)),
    (lambda: TC.PReLULayer(), (2, 5)),
    (lambda: TC.LocallyConnected2D(n_out=2, kernel=(2, 2)), (1, 4, 4, 2)),
])
def test_json_roundtrip(layer_fn, shape):
    layer = layer_fn()
    layer.build(shape[1:], {"weight_init": "xavier", "activation": None})
    layer2 = TL.from_json(layer.to_json())
    layer2.build(shape[1:], {"weight_init": "xavier", "activation": None})
    assert layer2.output_shape(shape[1:]) == layer.output_shape(shape[1:])


def test_numeric_gradient_sepconv():
    layer = TC.SeparableConvolution2D(n_out=2, kernel=(2, 2), has_bias=True)
    layer.build((4, 4, 2), {"weight_init": "xavier", "activation": None})
    params = {n: t.double() for n, t in
              layer.init_params(R.PRNGKey(0)).items()}
    x = torch.tensor(_rand(1, 1, 4, 4, 2)).double()

    def loss(p):
        out, _ = layer.apply(p, x, {}, False, None)
        return (out ** 2).sum()
    p = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    loss(p).backward()
    eps = 1e-4
    for k in ("dW", "pW"):
        for idx in (0, params[k].numel() // 2):
            up = {n: t.clone() for n, t in params.items()}
            up[k].view(-1)[idx] += eps
            dn = {n: t.clone() for n, t in params.items()}
            dn[k].view(-1)[idx] -= eps
            num = float(loss(up) - loss(dn)) / (2 * eps)
            assert abs(num - float(p[k].grad.view(-1)[idx])) < \
                1e-6 * max(1.0, abs(num))
