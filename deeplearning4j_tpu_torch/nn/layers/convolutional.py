"""The conv family beyond 2D convolution and pooling (counterpart of
``deeplearning4j_tpu/nn/layers/convolutional.py``): 1D and 3D
convolutions, transposed, depthwise and separable 2D convolutions, 1D
and 3D pooling, upsampling, cropping and zero padding, space to depth
and to batch, locally connected layers, PReLU and the elementwise
multiplication layer. ``FrozenLayer`` lives in ``nn/layers/__init__.py``
and is re-exported here, where the JAX package defines it.

Layouts are JAX's: sequences [B, T, C], images NHWC, volumes NDHWC,
weights spatial-major (WIO, HWIO, DHWIO), so JAX's params carry over as
plain copies. Convolutions run ``F.conv{1,2,3}d`` (cuDNN on the card)
on the channels-first views after an explicit pad of XLA's SAME rule
(``_conv``). Pools pad explicitly (max with -inf) and average pools
divide each window's sum by its count of real elements, as JAX pools a
tensor of ones; ``F.avg_pool*``'s own padding is not used.

``Deconvolution2D`` is ``lax.conv_transpose`` with JAX's default
``transpose_kernel=False``: a stride-1 convolution of the stride-dilated
input with the HWIO kernel as given (no spatial flip), padded by
``lax``'s transpose rule. ``F.conv_transpose2d`` flips its kernel and
pads the dilated input by k-1 a side, so the layer hands it the flipped
kernel and crops or zero-pads its output to ``lax``'s pads.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...weightinit import init_weights, subkeys
from ..functional import matmul
from . import FrozenLayer  # noqa: F401  (defined there, exported here)
from . import (Layer, _conv, _nchw, _nhwc, _pad_nchw, _pair, _promote,
               _spatial_pads, register)


def _tri(v) -> Tuple[int, int, int]:
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def _one(v) -> int:
    return int(v[0] if isinstance(v, (tuple, list)) else v)


def _conv_out(size, k, s, d, padding):
    ek = (k - 1) * d + 1
    if isinstance(padding, str) and padding.lower() == "same":
        return -(-size // s)
    return (size - ek) // s + 1


def _bias(z, params, has_bias):
    return z + params["b"] if has_bias else z


def _window_sum(x, kernel, stride):
    """Each window's sum over channels-first input of 2 or 3 spatial
    axes (no padding: the caller pads). Volumes sum in f32 and round
    once to the input's dtype (``avg_pool3d`` has no bf16 CPU kernel),
    on the card as on the CPU."""
    if x.ndim == 4:
        return F.avg_pool2d(x, kernel, stride, divisor_override=1)
    return F.avg_pool3d(x.float(), kernel, stride,
                        divisor_override=1).to(x.dtype)


def _pool(x, kernel, stride, padding, pooling):
    """Max or average pooling of channels-first input of 2 or 3 spatial
    axes under XLA's padding: max pads with -inf, average divides each
    window's sum by its count of real elements."""
    pads = _spatial_pads(padding, x.shape[2:], kernel, stride)
    if pooling == "max":
        pool = F.max_pool2d if x.ndim == 4 else F.max_pool3d
        return pool(_pad_nchw(x, pads, float("-inf")), kernel, stride)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return _window_sum(_pad_nchw(x, pads), kernel, stride) / \
        _window_sum(_pad_nchw(ones, pads), kernel, stride)


@register
class Convolution1D(Layer):
    """1D convolution over [B, T, C] with a [k, C, n_out] weight."""

    kind = "conv1d"

    def __init__(self, n_out: int = None, kernel: int = 3, stride: int = 1,
                 padding="same", dilation: int = 1, n_in: Optional[int] = None,
                 has_bias: bool = True, **kw):
        super().__init__(**kw)
        self.n_out = int(n_out)
        self.kernel = _one(kernel)
        self.stride = _one(stride)
        self.dilation = _one(dilation)
        self.padding = padding
        self.n_in = n_in
        self.has_bias = bool(has_bias)

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        if self.n_in is None:
            self.n_in = int(input_shape[-1])

    def param_shapes(self):
        sh = {"W": (self.kernel, self.n_in, self.n_out)}
        if self.has_bias:
            sh["b"] = (self.n_out,)
        return sh

    def init_params(self, key, dtype=torch.float32):
        p = {"W": init_weights(key, (self.kernel, self.n_in, self.n_out),
                               self.kernel * self.n_in,
                               self.kernel * self.n_out, self.weight_init,
                               dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype)
        return p

    def _pad(self):
        if isinstance(self.padding, str):
            return self.padding
        if isinstance(self.padding, int):
            return ((self.padding, self.padding),)
        return (tuple(int(v) for v in self.padding),)

    def apply(self, params, x, state, train, rng):
        x = self._maybe_dropout(x, train, rng)
        z = _conv(x, params["W"], (self.stride,), self._pad(),
                  (self.dilation,))
        return self.activation(_bias(z, params, self.has_bias)), state

    def output_shape(self, input_shape):
        t = input_shape[0]
        if t is None or t < 0:
            return (t, self.n_out)
        if isinstance(self.padding, str):
            ot = _conv_out(t, self.kernel, self.stride, self.dilation,
                           self.padding)
        else:
            p = self.padding if isinstance(self.padding, int) \
                else sum(self.padding)
            tot = 2 * p if isinstance(self.padding, int) else p
            ek = (self.kernel - 1) * self.dilation + 1
            ot = (t + tot - ek) // self.stride + 1
        return (ot, self.n_out)

    def _extra_json(self):
        return {"n_out": self.n_out, "n_in": self.n_in, "kernel": self.kernel,
                "stride": self.stride, "padding": self.padding,
                "dilation": self.dilation, "has_bias": self.has_bias}


@register
class Convolution3D(Layer):
    """3D convolution over NDHWC volumes with a DHWIO weight, XLA's SAME
    rule on each axis."""

    kind = "conv3d"

    def __init__(self, n_out: int = None, kernel=(3, 3, 3), stride=(1, 1, 1),
                 padding="same", dilation=(1, 1, 1),
                 n_in: Optional[int] = None, has_bias: bool = True, **kw):
        super().__init__(**kw)
        self.n_out = int(n_out)
        self.kernel = _tri(kernel)
        self.stride = _tri(stride)
        self.dilation = _tri(dilation)
        self.padding = padding
        self.n_in = n_in
        self.has_bias = bool(has_bias)

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        if self.n_in is None:
            self.n_in = int(input_shape[-1])

    def param_shapes(self):
        sh = {"W": self.kernel + (self.n_in, self.n_out)}
        if self.has_bias:
            sh["b"] = (self.n_out,)
        return sh

    def init_params(self, key, dtype=torch.float32):
        k = math.prod(self.kernel)
        p = {"W": init_weights(key, self.kernel + (self.n_in, self.n_out),
                               k * self.n_in, k * self.n_out,
                               self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype)
        return p

    def apply(self, params, x, state, train, rng):
        x = self._maybe_dropout(x, train, rng)
        z = _conv(x, params["W"], self.stride, self.padding,
                  self.dilation)
        return self.activation(_bias(z, params, self.has_bias)), state

    def output_shape(self, input_shape):
        dims = list(input_shape[:3])
        if not isinstance(self.padding, str):
            dims = [d + sum(p) for d, p in zip(dims, self.padding)]
        pad = self.padding if isinstance(self.padding, str) else "valid"
        return tuple(_conv_out(dims[i], self.kernel[i], self.stride[i],
                               self.dilation[i], pad)
                     for i in range(3)) + (self.n_out,)

    def _extra_json(self):
        return {"n_out": self.n_out, "n_in": self.n_in,
                "kernel": list(self.kernel), "stride": list(self.stride),
                "padding": self.padding, "dilation": list(self.dilation),
                "has_bias": self.has_bias}


def _transpose_pads(k: int, s: int, padding: str) -> Tuple[int, int]:
    """``lax``'s (low, high) padding of the stride-dilated input of a
    transposed convolution (``jax._src.lax.convolution.
    _conv_transpose_padding``)."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"unknown padding {padding!r}")
    return pad_a, pad_len - pad_a


@register
class Deconvolution2D(Layer):
    """Transposed 2D convolution (``lax.conv_transpose``, NHWC, HWIO with
    I the input's channels). ``F.conv_transpose2d`` of the spatially
    flipped kernel is the full transposed convolution (the dilated input
    padded by k-1 a side); its output is then cropped, or zero-padded,
    to ``lax``'s pads: "same" and "valid" by ``lax``'s transpose rule
    (k=3, s=2 "same" pads (2, 1)), explicit ((top, bottom), (left,
    right)) as given."""

    kind = "deconv2d"

    def __init__(self, n_out: int = None, kernel=(2, 2), stride=(2, 2),
                 padding="valid", n_in: Optional[int] = None,
                 has_bias: bool = True, **kw):
        super().__init__(**kw)
        self.n_out = int(n_out)
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.padding = padding
        self.n_in = n_in
        self.has_bias = bool(has_bias)

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        if self.n_in is None:
            self.n_in = int(input_shape[-1])

    def param_shapes(self):
        sh = {"W": self.kernel + (self.n_in, self.n_out)}
        if self.has_bias:
            sh["b"] = (self.n_out,)
        return sh

    def init_params(self, key, dtype=torch.float32):
        kh, kw_ = self.kernel
        p = {"W": init_weights(key, (kh, kw_, self.n_in, self.n_out),
                               kh * kw_ * self.n_in, kh * kw_ * self.n_out,
                               self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype)
        return p

    def _pads(self):
        if isinstance(self.padding, str):
            return tuple(_transpose_pads(k, s, self.padding.upper())
                         for k, s in zip(self.kernel, self.stride))
        return tuple(tuple(int(v) for v in p) for p in self.padding)

    def apply(self, params, x, state, train, rng):
        x = self._maybe_dropout(x, train, rng)
        kh, kw_ = self.kernel
        (pt, pb), (pl, pr) = self._pads()
        xc, w = _promote(_nchw(x), params["W"].flip(0, 1).permute(2, 3, 0, 1))
        z = F.conv_transpose2d(xc, w, None, self.stride)
        # F.pad crops where a pad is negative
        z = _pad_nchw(z, ((pt - kh + 1, pb - kh + 1),
                          (pl - kw_ + 1, pr - kw_ + 1)))
        return self.activation(_bias(_nhwc(z), params, self.has_bias)), state

    def output_shape(self, input_shape):
        # JAX's formula, which for explicit pads need not be apply's size
        h, w, _ = input_shape
        kh, kw_ = self.kernel
        sh, sw = self.stride
        if isinstance(self.padding, str) and self.padding.lower() == "same":
            return (h * sh, w * sw, self.n_out)
        return ((h - 1) * sh + kh, (w - 1) * sw + kw_, self.n_out)

    def _extra_json(self):
        return {"n_out": self.n_out, "n_in": self.n_in,
                "kernel": list(self.kernel), "stride": list(self.stride),
                "padding": self.padding, "has_bias": self.has_bias}


def _grouped_out(input_shape, kernel, stride, dilation, padding, n_out):
    h, w, _ = input_shape
    if not isinstance(padding, str):
        h += sum(padding[0])
        w += sum(padding[1])
    pad = padding if isinstance(padding, str) else "valid"
    return (_conv_out(h, kernel[0], stride[0], dilation[0], pad),
            _conv_out(w, kernel[1], stride[1], dilation[1], pad), n_out)


@register
class DepthwiseConvolution2D(Layer):
    """Per-channel 2D convolution with a depth multiplier m: a
    [kh, kw, 1, C*m] weight, output channel c*m + j from input channel
    c (``groups=C``, which orders its outputs so)."""

    kind = "depthwiseconv2d"

    def __init__(self, depth_multiplier: int = 1, kernel=(3, 3), stride=(1, 1),
                 padding="same", dilation=(1, 1), n_in: Optional[int] = None,
                 has_bias: bool = True, **kw):
        super().__init__(**kw)
        self.depth_multiplier = int(depth_multiplier)
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.dilation = _pair(dilation)
        self.padding = padding
        self.n_in = n_in
        self.has_bias = bool(has_bias)

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        if self.n_in is None:
            self.n_in = int(input_shape[-1])
        self.n_out = self.n_in * self.depth_multiplier

    def param_shapes(self):
        sh = {"W": self.kernel + (1, self.n_out)}
        if self.has_bias:
            sh["b"] = (self.n_out,)
        return sh

    def init_params(self, key, dtype=torch.float32):
        kh, kw_ = self.kernel
        p = {"W": init_weights(key, (kh, kw_, 1, self.n_out), kh * kw_,
                               kh * kw_ * self.depth_multiplier,
                               self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype)
        return p

    def apply(self, params, x, state, train, rng):
        x = self._maybe_dropout(x, train, rng)
        z = _conv(x, params["W"], self.stride, self.padding,
                  self.dilation, self.n_in)
        return self.activation(_bias(z, params, self.has_bias)), state

    def output_shape(self, input_shape):
        return _grouped_out(input_shape, self.kernel, self.stride,
                            self.dilation, self.padding, self.n_out)

    def _extra_json(self):
        return {"depth_multiplier": self.depth_multiplier, "n_in": self.n_in,
                "kernel": list(self.kernel), "stride": list(self.stride),
                "padding": self.padding, "dilation": list(self.dilation),
                "has_bias": self.has_bias}


@register
class SeparableConvolution2D(Layer):
    """A depthwise convolution (``dW``, [kh, kw, 1, C*m]) then a
    pointwise one (``pW``, [1, 1, C*m, n_out]), the latter a matmul over
    the channels-last output."""

    kind = "sepconv2d"

    def __init__(self, n_out: int = None, kernel=(3, 3), stride=(1, 1),
                 padding="same", dilation=(1, 1), depth_multiplier: int = 1,
                 n_in: Optional[int] = None, has_bias: bool = True, **kw):
        super().__init__(**kw)
        self.n_out = int(n_out)
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.dilation = _pair(dilation)
        self.padding = padding
        self.depth_multiplier = int(depth_multiplier)
        self.n_in = n_in
        self.has_bias = bool(has_bias)

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        if self.n_in is None:
            self.n_in = int(input_shape[-1])

    def param_shapes(self):
        mid = self.n_in * self.depth_multiplier
        sh = {"dW": self.kernel + (1, mid), "pW": (1, 1, mid, self.n_out)}
        if self.has_bias:
            sh["b"] = (self.n_out,)
        return sh

    def init_params(self, key, dtype=torch.float32):
        kd, kp = subkeys(key, 2)
        kh, kw_ = self.kernel
        mid = self.n_in * self.depth_multiplier
        p = {"dW": init_weights(kd, (kh, kw_, 1, mid), kh * kw_,
                                kh * kw_ * self.depth_multiplier,
                                self.weight_init, dtype),
             "pW": init_weights(kp, (1, 1, mid, self.n_out), mid, self.n_out,
                                self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype)
        return p

    def apply(self, params, x, state, train, rng):
        x = self._maybe_dropout(x, train, rng)
        z = _conv(x, params["dW"], self.stride, self.padding,
                  self.dilation, self.n_in)
        z = matmul(z, params["pW"][0, 0])
        return self.activation(_bias(z, params, self.has_bias)), state

    def output_shape(self, input_shape):
        return _grouped_out(input_shape, self.kernel, self.stride,
                            self.dilation, self.padding, self.n_out)

    def _extra_json(self):
        return {"n_out": self.n_out, "n_in": self.n_in,
                "kernel": list(self.kernel), "stride": list(self.stride),
                "padding": self.padding, "dilation": list(self.dilation),
                "depth_multiplier": self.depth_multiplier,
                "has_bias": self.has_bias}


@register
class Subsampling1DLayer(Layer):
    """Max or average pooling over [B, T, C] (as 2D pooling of a
    [B, C, 1, T] view)."""

    kind = "subsampling1d"

    def __init__(self, kernel: int = 2, stride: int = 2, padding="valid",
                 pooling: str = "max", **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.kernel = int(kernel)
        self.stride = int(stride)
        self.padding = padding
        self.pooling = pooling

    def apply(self, params, x, state, train, rng):
        pad = self.padding if isinstance(self.padding, str) else \
            ((0, 0), tuple(self.padding))
        z = _pool(_nchw(x).unsqueeze(2), (1, self.kernel), (1, self.stride),
                  pad, self.pooling)
        return _nhwc(z.squeeze(2)), state

    def output_shape(self, input_shape):
        t, c = input_shape
        if isinstance(self.padding, str) and self.padding.lower() == "same":
            return (-(-t // self.stride), c)
        return ((t - self.kernel) // self.stride + 1, c)

    def _extra_json(self):
        return {"kernel": self.kernel, "stride": self.stride,
                "padding": self.padding, "pooling": self.pooling}


@register
class Subsampling3DLayer(Layer):
    """Max or average pooling over NDHWC volumes."""

    kind = "subsampling3d"

    def __init__(self, kernel=(2, 2, 2), stride=(2, 2, 2), padding="valid",
                 pooling: str = "max", **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.kernel = _tri(kernel)
        self.stride = _tri(stride)
        self.padding = padding
        self.pooling = pooling

    def apply(self, params, x, state, train, rng):
        z = _pool(_nchw(x), self.kernel, self.stride,
                  self.padding, self.pooling)
        return _nhwc(z), state

    def output_shape(self, input_shape):
        d, h, w, c = input_shape
        if isinstance(self.padding, str) and self.padding.lower() == "same":
            return tuple(-(-v // s) for v, s in zip((d, h, w), self.stride)) \
                + (c,)
        return tuple((v - k) // s + 1 for v, k, s in
                     zip((d, h, w), self.kernel, self.stride)) + (c,)

    def _extra_json(self):
        return {"kernel": list(self.kernel), "stride": list(self.stride),
                "padding": self.padding, "pooling": self.pooling}


@register
class Upsampling1D(Layer):
    """Nearest-neighbour upsampling of [B, T, C] (``jnp.repeat``)."""

    kind = "upsampling1d"

    def __init__(self, size: int = 2, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.size = int(size)

    def apply(self, params, x, state, train, rng):
        return x.repeat_interleave(self.size, dim=1), state

    def output_shape(self, input_shape):
        t, c = input_shape
        return (t * self.size, c)

    def _extra_json(self):
        return {"size": self.size}


@register
class Upsampling3D(Layer):
    """Nearest-neighbour upsampling of NDHWC volumes."""

    kind = "upsampling3d"

    def __init__(self, size=(2, 2, 2), **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.size = _tri(size)

    def apply(self, params, x, state, train, rng):
        for axis, s in zip((1, 2, 3), self.size):
            x = x.repeat_interleave(s, dim=axis)
        return x, state

    def output_shape(self, input_shape):
        d, h, w, c = input_shape
        return (d * self.size[0], h * self.size[1], w * self.size[2], c)

    def _extra_json(self):
        return {"size": list(self.size)}


def _crop(x, cropping):
    """``x`` with (low, high) cropped from each spatial axis."""
    idx = [slice(None)]
    for n, (a, b) in zip(x.shape[1:-1], cropping):
        idx.append(slice(a, n - b))
    return x[tuple(idx)]


@register
class Cropping1D(Layer):
    """Crops (start, end) steps of [B, T, C]."""

    kind = "cropping1d"

    def __init__(self, cropping=(0, 0), **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        if isinstance(cropping, int):
            cropping = (cropping, cropping)
        self.cropping = tuple(int(x) for x in cropping)

    def apply(self, params, x, state, train, rng):
        return _crop(x, (self.cropping,)), state

    def output_shape(self, input_shape):
        t, c = input_shape
        return (t - sum(self.cropping), c)

    def _extra_json(self):
        return {"cropping": list(self.cropping)}


@register
class Cropping2D(Layer):
    """Crops ((top, bottom), (left, right)) of NHWC images."""

    kind = "cropping2d"

    def __init__(self, cropping=((0, 0), (0, 0)), **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        if isinstance(cropping, int):
            cropping = ((cropping, cropping), (cropping, cropping))
        self.cropping = tuple(tuple(int(x) for x in p) for p in cropping)

    def apply(self, params, x, state, train, rng):
        return _crop(x, self.cropping), state

    def output_shape(self, input_shape):
        h, w, c = input_shape
        (t, b), (l, r) = self.cropping
        return (h - t - b, w - l - r, c)

    def _extra_json(self):
        return {"cropping": [list(p) for p in self.cropping]}


@register
class Cropping3D(Layer):
    """Crops a (low, high) pair from each axis of NDHWC volumes."""

    kind = "cropping3d"

    def __init__(self, cropping=((0, 0), (0, 0), (0, 0)), **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        if isinstance(cropping, int):
            cropping = ((cropping,) * 2,) * 3
        self.cropping = tuple(tuple(int(x) for x in p) for p in cropping)

    def apply(self, params, x, state, train, rng):
        return _crop(x, self.cropping), state

    def output_shape(self, input_shape):
        d, h, w, c = input_shape
        (d0, d1), (h0, h1), (w0, w1) = self.cropping
        return (d - d0 - d1, h - h0 - h1, w - w0 - w1, c)

    def _extra_json(self):
        return {"cropping": [list(p) for p in self.cropping]}


@register
class ZeroPadding1DLayer(Layer):
    """Zero padding (start, end) of [B, T, C]."""

    kind = "zeropad1d"

    def __init__(self, padding=(1, 1), **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        if isinstance(padding, int):
            padding = (padding, padding)
        self.padding = tuple(int(x) for x in padding)

    def apply(self, params, x, state, train, rng):
        return _nhwc(_pad_nchw(_nchw(x), (self.padding,))), state

    def output_shape(self, input_shape):
        t, c = input_shape
        return (t + sum(self.padding), c)

    def _extra_json(self):
        return {"padding": list(self.padding)}


@register
class ZeroPadding3DLayer(Layer):
    """Zero padding of a (low, high) pair on each axis of NDHWC
    volumes."""

    kind = "zeropad3d"

    def __init__(self, padding=((1, 1), (1, 1), (1, 1)), **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        if isinstance(padding, int):
            padding = ((padding,) * 2,) * 3
        self.padding = tuple(tuple(int(x) for x in p) for p in padding)

    def apply(self, params, x, state, train, rng):
        return _nhwc(_pad_nchw(_nchw(x), self.padding)), state

    def output_shape(self, input_shape):
        d, h, w, c = input_shape
        (d0, d1), (h0, h1), (w0, w1) = self.padding
        return (d + d0 + d1, h + h0 + h1, w + w0 + w1, c)

    def _extra_json(self):
        return {"padding": [list(p) for p in self.padding]}


@register
class SpaceToDepthLayer(Layer):
    """Each s x s block of NHWC pixels to one pixel of s*s*C channels,
    in (row, column, channel) order."""

    kind = "spacetodepth"

    def __init__(self, block_size: int = 2, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.block_size = int(block_size)

    def apply(self, params, x, state, train, rng):
        B, H, W, C = x.shape
        s = self.block_size
        z = x.reshape(B, H // s, s, W // s, s, C).permute(0, 1, 3, 2, 4, 5)
        return z.reshape(B, H // s, W // s, C * s * s), state

    def output_shape(self, input_shape):
        h, w, c = input_shape
        s = self.block_size
        return (h // s, w // s, c * s * s)

    def _extra_json(self):
        return {"block_size": self.block_size}


@register
class DepthToSpaceLayer(Layer):
    """The inverse of :class:`SpaceToDepthLayer`."""

    kind = "depthtospace"

    def __init__(self, block_size: int = 2, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.block_size = int(block_size)

    def apply(self, params, x, state, train, rng):
        B, H, W, C = x.shape
        s = self.block_size
        z = x.reshape(B, H, W, s, s, C // (s * s)).permute(0, 1, 3, 2, 4, 5)
        return z.reshape(B, H * s, W * s, C // (s * s)), state

    def output_shape(self, input_shape):
        h, w, c = input_shape
        s = self.block_size
        return (h * s, w * s, c // (s * s))

    def _extra_json(self):
        return {"block_size": self.block_size}


@register
class SpaceToBatchLayer(Layer):
    """NHWC images zero-padded, then each (bh, bw) block offset to a
    batch of its own: the output batch is ordered (bh, bw, B)."""

    kind = "spacetobatch"

    def __init__(self, blocks=(2, 2), padding=((0, 0), (0, 0)), **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.blocks = _pair(blocks)
        self.padding = tuple(tuple(int(x) for x in p) for p in padding)

    def apply(self, params, x, state, train, rng):
        x = _nhwc(_pad_nchw(_nchw(x), self.padding))
        B, H, W, C = x.shape
        bh, bw = self.blocks
        z = x.reshape(B, H // bh, bh, W // bw, bw, C).permute(2, 4, 0, 1, 3, 5)
        return z.reshape(B * bh * bw, H // bh, W // bw, C), state

    def output_shape(self, input_shape):
        h, w, c = input_shape
        (pt, pb), (pl, pr) = self.padding
        return ((h + pt + pb) // self.blocks[0],
                (w + pl + pr) // self.blocks[1], c)

    def _extra_json(self):
        return {"blocks": list(self.blocks),
                "padding": [list(p) for p in self.padding]}


@register
class PReLULayer(Layer):
    """``where(x >= 0, x, alpha * x)`` with a learned alpha of the input's
    feature shape, 1 on the ``shared_axes`` (1-based feature axes). The
    gradient at exactly 0 goes to x, as in JAX (``F.prelu`` sends it to
    the slope)."""

    kind = "prelu"

    def __init__(self, alpha_init: float = 0.0, shared_axes=None, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.alpha_init = float(alpha_init)
        self.shared_axes = shared_axes

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        shape = list(input_shape)
        for ax in self.shared_axes or ():
            shape[ax - 1] = 1
        self._alpha_shape = tuple(shape)

    def param_shapes(self):
        return {"alpha": self._alpha_shape}

    def init_params(self, key, dtype=torch.float32):
        return {"alpha": torch.full(self._alpha_shape, self.alpha_init,
                                    dtype=dtype)}

    def apply(self, params, x, state, train, rng):
        return torch.where(x >= 0, x, params["alpha"] * x), state

    def _extra_json(self):
        return {"alpha_init": self.alpha_init, "shared_axes": self.shared_axes}


@register
class ElementWiseMultiplicationLayer(Layer):
    """``activation(x * w + b)`` with a learned w over the last axis (1 at
    init)."""

    kind = "elementwisemult"

    def __init__(self, n_out: Optional[int] = None, **kw):
        super().__init__(**kw)
        self.n_out = n_out

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        self.n_out = int(input_shape[-1])

    def param_shapes(self):
        return {"w": (self.n_out,), "b": (self.n_out,)}

    def init_params(self, key, dtype=torch.float32):
        return {"w": torch.ones((self.n_out,), dtype=dtype),
                "b": torch.full((self.n_out,), self.bias_init, dtype=dtype)}

    def apply(self, params, x, state, train, rng):
        return self.activation(x * params["w"] + params["b"]), state

    def _extra_json(self):
        return {"n_out": self.n_out}


def _local(patches, w):
    """[B, P, K] patches times a [P, K, O] weight, position by position:
    one batched matmul over the positions."""
    patches, w = _promote(patches, w)
    return torch.bmm(patches.transpose(0, 1), w).transpose(0, 1)


@register
class LocallyConnected2D(Layer):
    """A convolution with its own weights at each output position
    ("valid" padding): ``W`` is [oh*ow, C*kh*kw, n_out], each position's
    patch channel-major (C, kh, kw) as ``lax.conv_general_dilated_patches``
    emits it, which is ``F.unfold``'s order on NCHW; ``b`` is
    [oh, ow, n_out]."""

    kind = "locallyconnected2d"

    def __init__(self, n_out: int = None, kernel=(2, 2), stride=(1, 1),
                 n_in: Optional[int] = None, has_bias: bool = True, **kw):
        super().__init__(**kw)
        self.n_out = int(n_out)
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.n_in = n_in
        self.has_bias = bool(has_bias)

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        if self.n_in is None:
            self.n_in = int(input_shape[-1])
        h, w, _ = input_shape
        self._oh = (h - self.kernel[0]) // self.stride[0] + 1
        self._ow = (w - self.kernel[1]) // self.stride[1] + 1

    def param_shapes(self):
        kh, kw_ = self.kernel
        sh = {"W": (self._oh * self._ow, kh * kw_ * self.n_in, self.n_out)}
        if self.has_bias:
            sh["b"] = (self._oh, self._ow, self.n_out)
        return sh

    def init_params(self, key, dtype=torch.float32):
        fan_in = self.kernel[0] * self.kernel[1] * self.n_in
        p = {"W": init_weights(key, (self._oh * self._ow, fan_in, self.n_out),
                               fan_in, self.n_out, self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self._oh, self._ow, self.n_out),
                                self.bias_init, dtype=dtype)
        return p

    def apply(self, params, x, state, train, rng):
        x = self._maybe_dropout(x, train, rng)
        patches = F.unfold(_nchw(x), self.kernel, stride=self.stride)
        z = _local(patches.transpose(1, 2), params["W"])
        z = z.reshape(x.shape[0], self._oh, self._ow, self.n_out)
        return self.activation(_bias(z, params, self.has_bias)), state

    def output_shape(self, input_shape):
        return (self._oh, self._ow, self.n_out)

    def _extra_json(self):
        return {"n_out": self.n_out, "n_in": self.n_in,
                "kernel": list(self.kernel), "stride": list(self.stride),
                "has_bias": self.has_bias}


@register
class LocallyConnected1D(Layer):
    """:class:`LocallyConnected2D` over [B, T, C]: ``W`` is
    [ot, C*k, n_out], ``b`` [ot, n_out]."""

    kind = "locallyconnected1d"

    def __init__(self, n_out: int = None, kernel: int = 2, stride: int = 1,
                 n_in: Optional[int] = None, has_bias: bool = True, **kw):
        super().__init__(**kw)
        self.n_out = int(n_out)
        self.kernel = int(kernel)
        self.stride = int(stride)
        self.n_in = n_in
        self.has_bias = bool(has_bias)

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        if self.n_in is None:
            self.n_in = int(input_shape[-1])
        self._ot = (input_shape[0] - self.kernel) // self.stride + 1

    def param_shapes(self):
        sh = {"W": (self._ot, self.kernel * self.n_in, self.n_out)}
        if self.has_bias:
            sh["b"] = (self._ot, self.n_out)
        return sh

    def init_params(self, key, dtype=torch.float32):
        fan_in = self.kernel * self.n_in
        p = {"W": init_weights(key, (self._ot, fan_in, self.n_out), fan_in,
                               self.n_out, self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self._ot, self.n_out), self.bias_init,
                                dtype=dtype)
        return p

    def apply(self, params, x, state, train, rng):
        x = self._maybe_dropout(x, train, rng)
        patches = F.unfold(_nchw(x).unsqueeze(2), (1, self.kernel),
                           stride=(1, self.stride))
        z = _local(patches.transpose(1, 2), params["W"])
        return self.activation(_bias(z, params, self.has_bias)), state

    def output_shape(self, input_shape):
        return (self._ot, self.n_out)

    def _extra_json(self):
        return {"n_out": self.n_out, "n_in": self.n_in, "kernel": self.kernel,
                "stride": self.stride, "has_bias": self.has_bias}
