"""Layer catalog of the port (counterpart of
``deeplearning4j_tpu/nn/layers/__init__.py``; the layers a transformer
trained through ``MultiLayerNetwork`` needs).

A layer is configuration plus pure functions of an explicit params
dict, as in the JAX package:

- ``build(input_shape, defaults)`` resolves shapes and inherits the
  configuration's defaults (activation, weight init, updater, l1/l2);
- ``init_params(generator, dtype)`` draws the params dict;
- ``apply(params, x, state, train, rng) -> (out, state)``, and for
  sequence layers (``is_rnn``) ``apply_seq(params, x, state, train,
  rng, carry, mask) -> (out, state, carry)``;
- ``output_shape(input_shape)``.

Shapes exclude the batch axis; sequences are [B, T, C]. Weights are
``[in, out]`` and applied as ``x @ W``, so JAX weights carry over as a
plain copy. A layer computes in the promoted dtype of its input and
params, as the JAX layers do: bf16 under the bf16 policy
(``nn/precision.py``), f32 where an f32 mask has promoted the input.
Gradients come from autograd. Dropout is not ported yet: a nonzero
rate raises when a training pass would apply it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ... import activations as A
from ... import learning as U
from ... import losses as L
from ...weightinit import init_weights
from ..functional import matmul

Shape = Tuple[int, ...]

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

    def __init__(self, name: Optional[str] = None,
                 dropout: Optional[float] = None, activation=None,
                 weight_init: Optional[str] = None, bias_init: float = 0.0,
                 updater=None, l1: Optional[float] = None,
                 l2: Optional[float] = None, l1_bias: Optional[float] = None,
                 l2_bias: Optional[float] = None):
        self.name = name
        self.dropout = None if dropout is None else float(dropout)
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
            self.dropout = float(defaults.get("dropout", 0.0))
        self.input_shape = tuple(input_shape)
        self._built = True

    def init_params(self, generator: torch.Generator,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self) -> Dict[str, torch.Tensor]:
        return {}

    def init_carry(self, batch: int, dtype=torch.float32):
        """Per-sequence recurrent state; attention layers carry none."""
        return ()

    def apply(self, params, x, state, train: bool, rng):
        raise NotImplementedError

    def output_shape(self, input_shape: Shape) -> Shape:
        return tuple(input_shape)

    def _maybe_dropout(self, x, train: bool, rng):
        """Dropout on the layer input in training. Not ported: a
        nonzero rate raises rather than training without it."""
        if train and self.dropout:
            raise NotImplementedError(
                f"dropout {self.dropout} on {type(self).__name__}: dropout "
                f"is not ported yet (ROADMAP.md queue A, item 11)")
        return x

    def param_shapes(self) -> Dict[str, Shape]:
        return {}

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

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name})"


@register
class DenseLayer(Layer):
    """Fully connected: z = x W + b over the last axis (per timestep
    on [T, C] sequence input)."""

    kind = "dense"

    def __init__(self, n_out: int = None, n_in: Optional[int] = None,
                 has_bias: bool = True, **kw):
        super().__init__(**kw)
        self.n_in = n_in
        self.n_out = int(n_out)
        self.has_bias = bool(has_bias)

    def build(self, input_shape, defaults=None):
        if len(input_shape) >= 3:
            raise NotImplementedError(
                "dense layers over image input are not ported yet "
                "(ROADMAP.md queue A, item 11)")
        super().build(input_shape, defaults)
        if self.n_in is None:
            self.n_in = int(input_shape[-1])

    def param_shapes(self):
        sh = {"W": (self.n_in, self.n_out)}
        if self.has_bias:
            sh["b"] = (self.n_out,)
        return sh

    def init_params(self, generator, dtype=torch.float32):
        p = {"W": init_weights(generator, (self.n_in, self.n_out), self.n_in,
                               self.n_out, self.weight_init, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype)
        return p

    def pre_output(self, params, x, train: bool = False, rng=None):
        """The pre-activation both ``apply`` and the output layers'
        ``compute_loss`` go through."""
        x = self._maybe_dropout(x, train, rng)
        z = matmul(x, params["W"])
        if self.has_bias:
            z = z + params["b"]
        return z

    def apply(self, params, x, state, train, rng):
        return self.activation(self.pre_output(params, x, train, rng)), state

    def output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.n_out,)


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


@register
class GlobalPoolingLayer(Layer):
    """Pool over time (average pooling is ported). With a [B, T] mask
    padded timesteps are excluded, so the average divides by the true
    length."""

    kind = "globalpool"
    wants_mask = True

    def __init__(self, pooling: str = "avg", keep_dims: bool = False, **kw):
        if pooling != "avg":
            raise NotImplementedError(
                f"{pooling!r} pooling is not ported yet (ROADMAP.md queue A,"
                f" item 11)")
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.pooling = pooling
        self.keep_dims = bool(keep_dims)

    def apply(self, params, x, state, train, rng):
        return self.apply_with_mask(params, x, state, train, rng, None)

    def apply_with_mask(self, params, x, state, train, rng, mask):
        axes = tuple(range(1, x.ndim - 1))  # all but batch and channel
        kd = self.keep_dims
        if mask is not None and x.ndim == 3:
            m = mask[:, :, None].to(x.dtype)
            return (x * m).sum(axes, keepdim=kd) / torch.clamp_min(
                m.sum(axes, keepdim=kd), 1.0), state
        return x.mean(axes, keepdim=kd), state

    def output_shape(self, input_shape):
        if self.keep_dims:
            return (1,) * (len(input_shape) - 1) + (input_shape[-1],)
        return (input_shape[-1],)
