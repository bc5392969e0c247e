"""Layer catalog of the port (counterpart of
``deeplearning4j_tpu/nn/layers/__init__.py``: dense and output layers,
the CNN layers, batch norm, the parameter-free layers and global
pooling; the sequence and attention layers live in ``recurrent.py`` and
``attention.py``, the rest of the conv family in ``convolutional.py``,
the AutoEncoder, reshape, mask and per-pixel loss layers in
``misc.py``, the VAE in ``variational.py``, the center-loss and OCNN
heads in ``specialized_outputs.py`` and the YOLOv2 head in
``objdetect.py``; only the SameDiff layers are not ported).

A layer is configuration plus pure functions of an explicit params
dict, as in the JAX package:

- ``build(input_shape, defaults)`` resolves shapes and inherits the
  configuration's defaults (activation, weight init, updater, l1/l2);
- ``init_params(key, dtype)`` draws the params dict from a
  ``random.py`` key: JAX's draws, the key split as the JAX layer
  splits it;
- ``apply(params, x, state, train, rng) -> (out, state)``, and for
  sequence layers (``is_rnn``) ``apply_seq(params, x, state, train,
  rng, carry, mask) -> (out, state, carry)``;
- ``output_shape(input_shape)``.

Shapes exclude the batch axis; sequences are [B, T, C] and images
NHWC [B, H, W, C], as in JAX. Weights keep JAX's layout (dense
``[in, out]`` applied as ``x @ W``, convolutions HWIO ``[kh, kw,
in/groups, out]``), so JAX weights carry over as a plain copy; a
convolution hands ``F.conv2d`` the OIHW view ``W.permute(3, 2, 0, 1)``
and the NCHW view of its NHWC input, which on a contiguous NHWC tensor
is PyTorch's ``channels_last`` layout (no copy). "SAME" padding is
XLA's: ``total = max((ceil(h/s) - 1) s + (k - 1) d + 1 - h, 0)``,
``total // 2`` before and the rest after, applied with ``F.pad``.

A layer computes in the promoted dtype of its input and params, as the
JAX layers do: bf16 under the bf16 policy (``nn/precision.py``), f32
where an f32 mask has promoted the input. Gradients come from autograd.
Dropout (a float rate or a ``conf/dropout.py`` scheme) applies to the
layer input in training, drawn from the layer's ``random.py`` key as
JAX draws it; weight noise (``conf/weightnoise.py``) to its weights,
from keys folded from the same key. ``to_json`` gives JAX's dict for
the same configuration, key for key, and :func:`from_json` rebuilds a
layer from it (the port's or the JAX package's).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ... import activations as A
from ... import learning as U
from ... import losses as L
from ... import random as R
from ...weightinit import init_weights, subkeys
from ..conf import constraint as C
from ..conf import dropout as D
from ..conf import weightnoise as WN
from .. import global_batch as G
from ..functional import matmul

Shape = Tuple[int, ...]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _same_pads(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis (low, high)."""
    total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _spatial_pads(padding, hw, kernel, stride, dilation=None):
    """Per spatial axis (low, high) of "same", "valid" or explicit
    padding: ((top, bottom), (left, right)) over an [H, W] input, one
    pair an axis at any rank."""
    if dilation is None:
        dilation = (1,) * len(hw)
    if isinstance(padding, str):
        if padding.lower() == "same":
            return tuple(_same_pads(n, k, s, d) for n, k, s, d in
                         zip(hw, kernel, stride, dilation))
        if padding.lower() == "valid":
            return ((0, 0),) * len(hw)
        raise ValueError(f"unknown padding {padding!r}")
    return tuple(tuple(int(v) for v in p) for p in padding)


def _nchw(x):
    """The channels-first view of channels-last input (NHWC to NCHW,
    NWC to NCW, NDHWC to NCDHW)."""
    return x.movedim(-1, 1)


def _nhwc(x):
    """The channels-last view of channels-first output."""
    return x.movedim(1, -1)


def _pad_nchw(x, pads, value=0.0):
    """Channels-first input padded by one (low, high) pair a spatial
    axis."""
    if any(v for p in pads for v in p):
        return F.pad(x, [v for p in reversed(pads) for v in p], value=value)
    return x


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv(x, w, stride, padding, dilation, groups=1):
    """XLA's convolution of channels-last input [B, *spatial, C] with a
    spatial-major weight [*kernel, C/groups, O] (``lax``'s NWC/WIO,
    NHWC/HWIO, NDHWC/DHWIO) through ``F.conv{1,2,3}d`` (cuDNN on the
    card) on the channels-first views, after an explicit ``F.pad`` of
    XLA's SAME rule or the given (low, high) pairs; the output is
    channels-last, in the promoted dtype of ``x`` and ``w``."""
    nd = x.ndim - 2
    pads = _spatial_pads(padding, x.shape[1:-1], w.shape[:nd], stride,
                         dilation)
    xc, wc = _promote(_nchw(x), w.permute(nd + 1, nd, *range(nd)))
    return _nhwc(_CONV[nd](_pad_nchw(xc, pads), wc, None, tuple(stride), 0,
                           tuple(dilation), groups))


#: kind -> Layer subclass
REGISTRY: Dict[str, type] = {}


def register(cls: type) -> type:
    """Register a Layer subclass under its ``kind``."""
    REGISTRY[cls.kind] = cls
    return cls


class Layer:
    """Base layer. Unset settings (None) inherit the configuration's
    defaults at :meth:`build`; an explicit 0.0 opts out of a nonzero
    default."""

    kind = "layer"
    is_rnn = False
    wants_mask = False
    derives_mask = False        # MaskingLayer: a mask from the data
    is_pretrain_layer = False   # AutoEncoder, VAE: has ``pretrain_loss``

    def __init__(self, name: Optional[str] = None, dropout=None,
                 activation=None, weight_init: Optional[str] = None,
                 bias_init: float = 0.0, updater=None,
                 l1: Optional[float] = None, l2: Optional[float] = None,
                 l1_bias: Optional[float] = None,
                 l2_bias: Optional[float] = None, weight_noise=None,
                 constraints=None):
        self.name = name
        # a float drop probability, or a conf/dropout.py scheme
        self.dropout = _dropout_spec(dropout)
        self.weight_noise = WN.get(weight_noise)
        # projections applied after each update
        self.constraints = [C.get(c) for c in (constraints or [])]
        self.activation = A.get(activation) if activation is not None \
            else None
        self.weight_init = weight_init
        self.bias_init = float(bias_init)
        self.updater = U.get(updater) if updater is not None else None
        self.l1 = None if l1 is None else float(l1)
        self.l2 = None if l2 is None else float(l2)
        self.l1_bias = None if l1_bias is None else float(l1_bias)
        self.l2_bias = None if l2_bias is None else float(l2_bias)
        self.input_shape: Optional[Shape] = None
        self._built = False

    def build(self, input_shape: Shape, defaults: Optional[dict] = None):
        """Resolve the input shape and inherit unset defaults."""
        defaults = defaults or {}
        if self.activation is None:
            self.activation = A.get(defaults.get("activation") or "identity")
        if self.weight_init is None:
            self.weight_init = defaults.get("weight_init", "xavier")
        if self.updater is None and defaults.get("updater") is not None:
            self.updater = U.get(defaults["updater"])
        for reg in ("l1", "l2", "l1_bias", "l2_bias"):
            if getattr(self, reg) is None:
                setattr(self, reg, float(defaults.get(reg, 0.0)))
        if self.dropout is None:
            self.dropout = _dropout_spec(defaults.get("dropout", 0.0))
        if self.weight_noise is None and \
                defaults.get("weight_noise") is not None:
            self.weight_noise = WN.get(defaults["weight_noise"])
        if not self.constraints and defaults.get("constraints"):
            self.constraints = [C.get(c) for c in defaults["constraints"]]
        self.input_shape = tuple(input_shape)
        self._built = True

    def init_params(self, key,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self) -> Dict[str, torch.Tensor]:
        return {}

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        """Per-sequence recurrent state; attention layers carry none."""
        return ()

    def apply(self, params, x, state, train: bool, rng):
        raise NotImplementedError

    def output_shape(self, input_shape: Shape) -> Shape:
        return tuple(input_shape)

    def _maybe_dropout(self, x, train: bool, rng):
        """Dropout or noise on the layer INPUT in training, with the
        layer's key: a float is inverted Bernoulli dropout, a scheme
        applies itself."""
        d = self.dropout
        if not train or d is None or rng is None:
            return x
        if isinstance(d, (int, float)):
            if not d:
                return x
            d = D.Dropout(float(d))
        return d.apply(x, rng, train)

    def _maybe_weight_noise(self, params, train: bool, rng):
        """The layer's params with its weight noise for one training
        forward pass: every param but the biases and norm gains, param
        ``i`` of the sorted names under ``fold_in(fold_in(rng, 0x5EED),
        i)``, as JAX draws them."""
        wn = self.weight_noise
        if wn is None or not train or rng is None or not params:
            return params
        bias = self.bias_param_names()
        base = R.fold_in(rng, 0x5EED)
        out = dict(params)
        for i, n in enumerate(sorted(params)):
            if n not in bias:
                out[n] = wn.apply(params[n], R.fold_in(base, i), train)
        return out

    @property
    def has_params(self) -> bool:
        return bool(self.param_shapes())

    def param_shapes(self) -> Dict[str, Shape]:
        return {}

    def n_params(self) -> int:
        return sum(int(math.prod(s)) for s in self.param_shapes().values())

    def bias_param_names(self) -> set:
        """Params regularized with the *_bias coefficients: 'b', 'beta',
        'b1', 'b2', 'gamma', any '*_b' offset and any '*_g' norm gain,
        also behind an 'attn_' prefix."""
        names = set()
        for n in self.param_shapes():
            base = n[5:] if n.startswith("attn_") else n
            if (base in ("b", "beta", "b1", "b2", "gamma")
                    or base.endswith("_b") or base.endswith("_g")):
                names.add(n)
        return names

    # -- JSON ------------------------------------------------------------
    _JSON_FIELDS = ("name", "dropout", "weight_init", "bias_init", "l1", "l2",
                    "l1_bias", "l2_bias")

    def to_json(self) -> dict:
        """JAX's dict of this configuration: the kind as ``@class``, the
        set common fields, then the layer's own (``_extra_json``)."""
        d: Dict[str, Any] = {"@class": self.kind}
        for f in self._JSON_FIELDS:
            v = getattr(self, f, None)
            if f == "dropout" and v is not None and \
                    not isinstance(v, (int, float)):
                v = v.to_json()
            if v is not None:
                d[f] = v
        if self.activation is not None:
            d["activation"] = self.activation.to_json()
        if self.updater is not None:
            d["updater"] = self.updater.to_json()
        if self.weight_noise is not None:
            d["weight_noise"] = self.weight_noise.to_json()
        if self.constraints:
            d["constraints"] = [c.to_json() for c in self.constraints]
        d.update(self._extra_json())
        return d

    def _extra_json(self) -> dict:
        return {}

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name})"


def from_json(d: dict) -> Layer:
    """A layer from its ``to_json`` dict (a wrapper's inner layer too).
    A SameDiff kind raises: those layers need ``autodiff/samediff``."""
    from . import attention, convolutional, recurrent  # noqa: F401
    d = dict(d)
    kind = d.pop("@class")
    if kind.startswith("samediff"):
        raise NotImplementedError(
            f"layer kind {kind!r} (a SameDiff layer) is not ported yet "
            f"(ROADMAP.md queue A, item 15: it needs autodiff/samediff)")
    cls = REGISTRY[kind]
    if isinstance(d.get("activation"), dict):
        d["activation"] = A.get(d["activation"])
    if isinstance(d.get("updater"), dict):
        d["updater"] = U.get(d["updater"])
    if isinstance(d.get("loss"), dict):
        d["loss"] = L.get(d["loss"])
    for k in ("kernel", "stride", "dilation", "size"):
        if isinstance(d.get(k), list):
            d[k] = tuple(d[k])
    if isinstance(d.get("padding"), list):
        # (low, high) pairs an axis, or one flat pair (the 1D layers)
        d["padding"] = tuple(tuple(p) if isinstance(p, list) else p
                             for p in d["padding"])
    return cls(**d)


def _dropout_spec(d):
    """None, a float drop probability, or a scheme (from a scheme or
    its ``to_json`` dict)."""
    if d is None or isinstance(d, (int, float)):
        return None if d is None else float(d)
    return D.get(d)


@register
class DenseLayer(Layer):
    """Fully connected: z = x W + b over the last axis (per timestep
    on [T, C] sequence input). Image input ([H, W, C] or deeper)
    flattens in NHWC order first, as JAX's does, so carried dense
    weights see the same pixels."""

    kind = "dense"

    def __init__(self, n_out: int = None, n_in: Optional[int] = None,
                 has_bias: bool = True, **kw):
        super().__init__(**kw)
        self.n_in = n_in
        self.n_out = int(n_out)
        self.has_bias = bool(has_bias)

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        self._flatten_input = len(input_shape) >= 3
        if self.n_in is None:
            self.n_in = int(math.prod(input_shape)) if self._flatten_input \
                else int(input_shape[-1])

    def param_shapes(self):
        sh = {"W": (self.n_in, self.n_out)}
        if self.has_bias:
            sh["b"] = (self.n_out,)
        return sh

    def init_params(self, key, dtype=torch.float32):
        kW, = subkeys(key, 1)
        p = {"W": init_weights(kW, (self.n_in, self.n_out), self.n_in,
                               self.n_out, self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype)
        return p

    def pre_output(self, params, x, train: bool = False, rng=None):
        """The pre-activation both ``apply`` and the output layers'
        ``compute_loss`` go through."""
        if getattr(self, "_flatten_input", False) and x.ndim > 2:
            x = x.reshape(x.shape[0], -1)
        x = self._maybe_dropout(x, train, rng)
        z = matmul(x, params["W"])
        if self.has_bias:
            z = z + params["b"]
        return z

    def apply(self, params, x, state, train, rng):
        return self.activation(self.pre_output(params, x, train, rng)), state

    def output_shape(self, input_shape):
        if len(input_shape) >= 3:
            return (self.n_out,)
        return tuple(input_shape[:-1]) + (self.n_out,)

    def _extra_json(self):
        return {"n_out": self.n_out, "n_in": self.n_in,
                "has_bias": self.has_bias}


@register
class OutputLayer(DenseLayer):
    """Dense layer with a loss head."""

    kind = "output"

    def __init__(self, n_out: int = None, loss="mcxent", **kw):
        kw.setdefault("activation", "softmax")
        super().__init__(n_out=n_out, **kw)
        self.loss = L.get(loss)

    def compute_loss(self, params, x, labels, mask=None, train: bool = False,
                     rng=None):
        return self.loss.score(labels, self.pre_output(params, x, train, rng),
                               self.activation, mask)

    def _extra_json(self):
        d = super()._extra_json()
        d["loss"] = self.loss.to_json()
        return d


@register
class LossLayer(Layer):
    """A loss on the raw input, no params."""

    kind = "loss"

    def __init__(self, loss="mcxent", **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.loss = L.get(loss)

    def apply(self, params, x, state, train, rng):
        return self.activation(x), state

    def compute_loss(self, params, x, labels, mask=None, train: bool = False,
                     rng=None):
        x = self._maybe_dropout(x, train, rng)
        return self.loss.score(labels, x, self.activation, mask)

    def _extra_json(self):
        return {"loss": self.loss.to_json()}


@register
class ActivationLayer(Layer):
    kind = "activation"

    def apply(self, params, x, state, train, rng):
        return self.activation(x), state


@register
class DropoutLayer(Layer):
    """Dropout (or a noise scheme) on its input, no params."""

    kind = "dropoutlayer"

    def __init__(self, dropout=0.5, **kw):
        super().__init__(dropout=dropout, **kw)

    def build(self, input_shape, defaults=None):
        d = dict(defaults or {})
        d["activation"] = d.get("activation", "identity")
        super().build(input_shape, d)

    def apply(self, params, x, state, train, rng):
        return self._maybe_dropout(x, train, rng), state


def _promote(x, w):
    """Both operands in their promoted dtype (``jnp`` promotes, PyTorch's
    convolutions raise on mixed dtypes)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt), w.to(dt)
    return x, w


@register
class ConvolutionLayer(Layer):
    """2D convolution over NHWC input with HWIO weights: ``F.conv2d``
    (cuDNN on the card) on the NCHW/OIHW views, after an explicit
    ``F.pad`` (XLA's SAME rule, or ``((top, bottom), (left, right))``),
    with stride, dilation and groups."""

    kind = "conv2d"

    def __init__(self, n_out: int = None, kernel=(3, 3), stride=(1, 1),
                 padding="same", dilation=(1, 1), n_in: Optional[int] = None,
                 has_bias: bool = True, groups: int = 1, **kw):
        super().__init__(**kw)
        self.n_out = int(n_out)
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.dilation = _pair(dilation)
        self.padding = padding
        self.n_in = n_in
        self.has_bias = bool(has_bias)
        self.groups = int(groups)

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        if self.n_in is None:
            self.n_in = int(input_shape[-1])

    def param_shapes(self):
        kh, kw_ = self.kernel
        sh = {"W": (kh, kw_, self.n_in // self.groups, self.n_out)}
        if self.has_bias:
            sh["b"] = (self.n_out,)
        return sh

    def init_params(self, key, dtype=torch.float32):
        kh, kw_ = self.kernel
        cin = self.n_in // self.groups
        p = {"W": init_weights(key, (kh, kw_, cin, self.n_out),
                               kh * kw_ * cin, kh * kw_ * self.n_out,
                               self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype)
        return p

    def apply(self, params, x, state, train, rng):
        x = self._maybe_dropout(x, train, rng)
        z = _conv(x, params["W"], self.stride, self.padding, self.dilation,
                  self.groups)
        if self.has_bias:
            z = z + params["b"]   # after the convolution, as JAX adds it
        return self.activation(z), state

    def output_shape(self, input_shape):
        h, w, _ = input_shape
        kh, kw_ = self.kernel
        sh, sw = self.stride
        dh, dw = self.dilation
        (pt, pb), (pl, pr) = _spatial_pads(self.padding, (h, w), self.kernel,
                                           self.stride, self.dilation)
        return ((h + pt + pb - (kh - 1) * dh - 1) // sh + 1,
                (w + pl + pr - (kw_ - 1) * dw - 1) // sw + 1, self.n_out)

    def _extra_json(self):
        return {"n_out": self.n_out, "n_in": self.n_in,
                "kernel": list(self.kernel), "stride": list(self.stride),
                "padding": self.padding, "dilation": list(self.dilation),
                "has_bias": self.has_bias, "groups": self.groups}


@register
class SubsamplingLayer(Layer):
    """Max, average or p-norm pooling over NHWC input. Max pads with
    -inf; average divides each window's sum by its count of real
    (unpadded) elements, as JAX pools a tensor of ones; p-norm is
    (sum |x|^p)^(1/p). Where a window's maxima tie (an all-zero window
    after a ReLU) the gradient goes to the first in row-major order,
    on the CPU and the card as in XLA's ``select_and_scatter``."""

    kind = "subsampling"

    def __init__(self, kernel=(2, 2), stride=(2, 2), padding="valid",
                 pooling="max", pnorm: int = 2, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.padding = padding
        self.pooling = pooling
        self.pnorm = int(pnorm)

    def _window_sum(self, x, pads):
        return F.avg_pool2d(_pad_nchw(x, pads), self.kernel, self.stride,
                            divisor_override=1)

    def apply(self, params, x, state, train, rng):
        pads = _spatial_pads(self.padding, x.shape[1:3], self.kernel,
                             self.stride)
        xc = _nchw(x)
        if self.pooling == "max":
            z = F.max_pool2d(_pad_nchw(xc, pads, float("-inf")), self.kernel,
                             self.stride)
        elif self.pooling == "avg":
            s = self._window_sum(xc, pads)
            ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                              device=xc.device)
            z = s / self._window_sum(ones, pads)
        elif self.pooling == "pnorm":
            p = float(self.pnorm)
            z = self._window_sum(torch.abs(xc) ** p, pads) ** (1.0 / p)
        else:
            raise ValueError(f"unknown pooling {self.pooling!r}")
        return _nhwc(z), state

    def output_shape(self, input_shape):
        h, w, c = input_shape
        kh, kw_ = self.kernel
        sh, sw = self.stride
        (pt, pb), (pl, pr) = _spatial_pads(self.padding, (h, w), self.kernel,
                                           self.stride)
        return ((h + pt + pb - kh) // sh + 1, (w + pl + pr - kw_) // sw + 1,
                c)

    def _extra_json(self):
        return {"kernel": list(self.kernel), "stride": list(self.stride),
                "padding": self.padding, "pooling": self.pooling,
                "pnorm": self.pnorm}


@register
class BatchNormalization(Layer):
    """Batch norm over the last (channel or feature) axis of [B, C] or
    [B, H, W, C] input, JAX's form: in training the batch mean and the
    biased variance (``jnp.var``), taken in f32 even under the bf16
    policy, normalize ``(x - mean) * rsqrt(var + eps)``, and the
    running stats become ``decay * old + (1 - decay) * batch`` with the
    same biased variance (``torch.nn.BatchNorm2d`` folds in the unbiased
    one, and its ``momentum`` is ``1 - decay``); in inference the
    running stats normalize. In a data-parallel step the statistics are
    the global batch's (``nn/global_batch.py``). The output goes back to
    the input's dtype. ``lock_gamma_beta`` drops gamma and beta."""

    kind = "batchnorm"

    def __init__(self, decay: float = 0.9, eps: float = 1e-5,
                 gamma_init: float = 1.0, beta_init: float = 0.0,
                 lock_gamma_beta: bool = False, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.decay = float(decay)
        self.eps = float(eps)
        self.gamma_init = float(gamma_init)
        self.beta_init = float(beta_init)
        self.lock_gamma_beta = bool(lock_gamma_beta)
        self.n_feat: Optional[int] = None

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        self.n_feat = int(input_shape[-1])

    def param_shapes(self):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": (self.n_feat,), "beta": (self.n_feat,)}

    def init_params(self, key, dtype=torch.float32):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": torch.full((self.n_feat,), self.gamma_init,
                                    dtype=dtype),
                "beta": torch.full((self.n_feat,), self.beta_init,
                                   dtype=dtype)}

    def init_state(self):
        return {"mean": torch.zeros((self.n_feat,), dtype=torch.float32),
                "var": torch.ones((self.n_feat,), dtype=torch.float32)}

    def apply(self, params, x, state, train, rng):
        axes = tuple(range(x.ndim - 1))
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        if train and G.active():
            # a data-parallel step: the global batch's statistics
            n = G.rows(xs.numel() // xs.shape[-1])
            mean = G.sum_(xs.sum(dim=axes)) / n
            var = G.sum_(torch.square(xs - mean).sum(dim=axes)) / n
        elif train:
            var, mean = torch.var_mean(xs, dim=axes, correction=0)
        if train:
            d = self.decay
            new_state = {
                "mean": (d * state["mean"] + (1 - d) * mean.detach()
                         ).to(state["mean"].dtype),
                "var": (d * state["var"] + (1 - d) * var.detach()
                        ).to(state["var"].dtype)}
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        xn = (xs - mean) * torch.rsqrt(var + self.eps)
        if not self.lock_gamma_beta:
            xn = xn * params["gamma"].to(xs.dtype) + \
                params["beta"].to(xs.dtype)
        return self.activation(xn).to(x.dtype), new_state

    def _extra_json(self):
        return {"decay": self.decay, "eps": self.eps,
                "gamma_init": self.gamma_init, "beta_init": self.beta_init,
                "lock_gamma_beta": self.lock_gamma_beta}


@register
class EmbeddingLayer(Layer):
    """Index to vector lookup over [B] or [B, 1] integer input."""

    kind = "embedding"

    def __init__(self, n_in: int = None, n_out: int = None,
                 has_bias: bool = False, **kw):
        super().__init__(**kw)
        self.n_in = int(n_in)
        self.n_out = int(n_out)
        self.has_bias = bool(has_bias)

    def param_shapes(self):
        sh = {"W": (self.n_in, self.n_out)}
        if self.has_bias:
            sh["b"] = (self.n_out,)
        return sh

    def init_params(self, key, dtype=torch.float32):
        p = {"W": init_weights(key, (self.n_in, self.n_out), self.n_in,
                               self.n_out, self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype)
        return p

    def apply(self, params, x, state, train, rng):
        idx = x.long()
        if idx.ndim > 1 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        z = params["W"][idx]
        if self.has_bias:
            z = z + params["b"]
        return self.activation(z), state

    def output_shape(self, input_shape):
        if input_shape and input_shape[-1] == 1:
            return tuple(input_shape[:-1]) + (self.n_out,)
        return tuple(input_shape) + (self.n_out,)

    def _extra_json(self):
        return {"n_in": self.n_in, "n_out": self.n_out,
                "has_bias": self.has_bias}


@register
class GlobalPoolingLayer(Layer):
    """Max, average, sum or p-norm pooling over every axis but batch
    and channel. With a [B, T] mask on sequence input the padded
    timesteps are excluded: average divides by the true length, max
    ignores them (a fully masked row pools to 0)."""

    kind = "globalpool"
    wants_mask = True

    def __init__(self, pooling: str = "avg", pnorm: int = 2,
                 keep_dims: bool = False, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.pooling = pooling
        self.pnorm = int(pnorm)
        self.keep_dims = bool(keep_dims)

    def apply(self, params, x, state, train, rng):
        return self.apply_with_mask(params, x, state, train, rng, None)

    def apply_with_mask(self, params, x, state, train, rng, mask):
        axes = tuple(range(1, x.ndim - 1))  # all but batch and channel
        kd = self.keep_dims
        p = float(self.pnorm)
        if mask is not None and x.ndim == 3:
            m = mask[:, :, None].to(x.dtype)
            if self.pooling == "max":
                z = torch.where(m > 0, x, float("-inf")).amax(axes,
                                                              keepdim=kd)
                any_valid = m.sum(axes, keepdim=kd) > 0
                z = torch.where(any_valid, z, torch.zeros_like(z))
            elif self.pooling == "avg":
                z = (x * m).sum(axes, keepdim=kd) / torch.clamp_min(
                    m.sum(axes, keepdim=kd), 1.0)
            elif self.pooling == "sum":
                z = (x * m).sum(axes, keepdim=kd)
            elif self.pooling == "pnorm":
                z = (torch.abs(x * m) ** p).sum(axes, keepdim=kd) ** (1.0 / p)
            else:
                raise ValueError(self.pooling)
            return z, state
        if self.pooling == "max":
            z = x.amax(axes, keepdim=kd)
        elif self.pooling == "avg":
            z = x.mean(axes, keepdim=kd)
        elif self.pooling == "sum":
            z = x.sum(axes, keepdim=kd)
        elif self.pooling == "pnorm":
            z = (torch.abs(x) ** p).sum(axes, keepdim=kd) ** (1.0 / p)
        else:
            raise ValueError(self.pooling)
        return z, state

    def output_shape(self, input_shape):
        if self.keep_dims:
            return (1,) * (len(input_shape) - 1) + (input_shape[-1],)
        return (input_shape[-1],)

    def _extra_json(self):
        return {"pooling": self.pooling, "pnorm": self.pnorm,
                "keep_dims": self.keep_dims}


@register
class LocalResponseNormalization(Layer):
    """x / (k + alpha * sum of squares over n neighbouring channels)^beta
    (k=2, n=5, alpha=1e-4, beta=0.75)."""

    kind = "lrn"

    def __init__(self, k: float = 2.0, n: int = 5, alpha: float = 1e-4,
                 beta: float = 0.75, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.k = float(k)
        self.n = int(n)
        self.alpha = float(alpha)
        self.beta = float(beta)

    def apply(self, params, x, state, train, rng):
        half = self.n // 2
        padded = F.pad(x * x, (half, half))
        c = x.shape[-1]
        ssum = sum(padded[..., i:i + c] for i in range(self.n))
        return x / torch.pow(self.k + self.alpha * ssum, self.beta), state

    def _extra_json(self):
        return {"k": self.k, "n": self.n, "alpha": self.alpha,
                "beta": self.beta}


@register
class ZeroPaddingLayer(Layer):
    """Zero padding of NHWC images, ((top, bottom), (left, right))."""

    kind = "zeropad"

    def __init__(self, padding=((1, 1), (1, 1)), **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        if isinstance(padding, int):
            padding = ((padding, padding), (padding, padding))
        self.padding = tuple(tuple(int(v) for v in p) for p in padding)

    def apply(self, params, x, state, train, rng):
        (pt, pb), (pl, pr) = self.padding
        return F.pad(x, (0, 0, pl, pr, pt, pb)), state

    def output_shape(self, input_shape):
        h, w, c = input_shape
        (pt, pb), (pl, pr) = self.padding
        return (h + pt + pb, w + pl + pr, c)

    def _extra_json(self):
        return {"padding": [list(p) for p in self.padding]}


@register
class Upsampling2D(Layer):
    """Nearest-neighbour upsampling of NHWC images."""

    kind = "upsampling2d"

    def __init__(self, size=(2, 2), **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.size = _pair(size)

    def apply(self, params, x, state, train, rng):
        sh, sw = self.size
        return x.repeat_interleave(sh, dim=1).repeat_interleave(sw, dim=2), \
            state

    def output_shape(self, input_shape):
        h, w, c = input_shape
        return (h * self.size[0], w * self.size[1], c)

    def _extra_json(self):
        return {"size": list(self.size)}


def _frozen(params):
    """The params cut from autograd (JAX's ``stop_gradient``)."""
    return {n: t.detach() for n, t in params.items()}


@register
class FrozenLayer(Layer):
    """A wrapper whose inner layer's params get no gradient (JAX's
    ``stop_gradient``; counterpart of
    ``deeplearning4j_tpu/nn/layers/convolutional.py::FrozenLayer``).
    The inner layer always runs in inference mode (no dropout, batch
    norm on its running stats, its state unchanged), and its L1/L2
    terms are zeroed at ``build`` so weight decay cannot move it.
    Gradients still flow through its activations to the layers below;
    where nothing below needs them (a frozen prefix over token ids),
    autograd builds no backward there at all."""

    kind = "frozen"

    def __init__(self, layer=None, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        if isinstance(layer, dict):
            layer = from_json(layer)
        self.layer = layer

    @property
    def is_rnn(self):
        return getattr(self.layer, "is_rnn", False)

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        self.layer.build(input_shape, defaults)
        # the network's L1/L2 terms read the wrapper's coefficients
        self.l1 = self.l2 = self.l1_bias = self.l2_bias = 0.0

    def param_shapes(self):
        return self.layer.param_shapes()

    def init_params(self, key, dtype=torch.float32):
        return self.layer.init_params(key, dtype)

    def init_state(self):
        return self.layer.init_state()

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        return self.layer.init_carry(batch, dtype, device)

    def _train(self, train: bool) -> bool:
        return False

    def apply(self, params, x, state, train, rng):
        return self.layer.apply(_frozen(params), x, state,
                                self._train(train), rng)

    def apply_seq(self, params, x, state, train, rng, carry, mask):
        return self.layer.apply_seq(_frozen(params), x, state,
                                    self._train(train), rng, carry, mask)

    def compute_loss(self, params, x, labels, mask=None, train: bool = False,
                     rng=None):
        # a frozen output layer still scores; its params do not move
        return self.layer.compute_loss(_frozen(params), x, labels, mask,
                                       train=self._train(train), rng=rng)

    def output_shape(self, input_shape):
        return self.layer.output_shape(input_shape)

    def _extra_json(self):
        return {"layer": self.layer.to_json()}


@register
class FrozenLayerWithBackprop(FrozenLayer):
    """FrozenLayer that keeps the inner layer's training-mode forward
    (dropout stays on); only the param update is blocked (counterpart
    of ``deeplearning4j_tpu/nn/layers/misc.py::FrozenLayerWithBackprop``)."""

    kind = "frozen_backprop"

    def _train(self, train: bool) -> bool:
        return train


# the layers of the submodules the JAX package exports from here (their
# import registers their kinds for from_json)
from .variational import VariationalAutoencoder  # noqa: E402,F401
from .specialized_outputs import (CenterLossOutputLayer,  # noqa: E402,F401
                                  OCNNOutputLayer)
from .misc import (AutoEncoder, Cnn3DLossLayer,  # noqa: E402,F401
                   CnnLossLayer, MaskLayer, MaskingLayer, ReshapeLayer)
from .objdetect import Yolo2OutputLayer  # noqa: E402,F401
