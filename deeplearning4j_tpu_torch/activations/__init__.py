"""Activations (counterpart of ``deeplearning4j_tpu/activations``: the
reference's 21 and mish).

Each is a stateless callable named as in the reference ``Activation``
enum; :func:`get` resolves an instance, a name or a ``to_json`` dict.
The ``gelu`` activation is the exact erf form (``precise=True``) as in
the JAX package; the transformer block's MLP uses the tanh form
directly, as ``jax.nn.gelu`` does there.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


class Activation:
    """Base activation: stateless, comparable, named."""

    name: str = "identity"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self).__name__,
                     tuple(sorted(self.__dict__.items()))))

    def to_json(self) -> dict:
        return {"@class": self.name, **self.__dict__}

    def __repr__(self):
        return f"Activation({self.name})"


class Identity(Activation):
    name = "identity"

    def __call__(self, x):
        return x


class Sigmoid(Activation):
    name = "sigmoid"

    def __call__(self, x):
        return torch.sigmoid(x)


class Tanh(Activation):
    name = "tanh"

    def __call__(self, x):
        return torch.tanh(x)


class ReLU(Activation):
    name = "relu"

    def __call__(self, x):
        return torch.relu(x)


class GELU(Activation):
    """Exact erf GELU by default (``precise=True``); ``precise=False``
    is the tanh approximation."""

    name = "gelu"

    def __init__(self, precise: bool = True):
        self.precise = bool(precise)

    def __call__(self, x):
        return F.gelu(x, approximate="none" if self.precise else "tanh")


class Softmax(Activation):
    """Softmax over the last (feature) axis."""

    name = "softmax"

    def __call__(self, x):
        return torch.softmax(x, dim=-1)


class ReLU6(Activation):
    name = "relu6"

    def __call__(self, x):
        return torch.clamp(x, 0.0, 6.0)


class LeakyReLU(Activation):
    """Default alpha 0.01."""

    name = "leakyrelu"

    def __init__(self, alpha: float = 0.01):
        self.alpha = float(alpha)

    def __call__(self, x):
        return F.leaky_relu(x, self.alpha)


class ELU(Activation):
    name = "elu"

    def __init__(self, alpha: float = 1.0):
        self.alpha = float(alpha)

    def __call__(self, x):
        return F.elu(x, self.alpha)


class SELU(Activation):
    name = "selu"

    def __call__(self, x):
        return F.selu(x)


class Swish(Activation):
    name = "swish"

    def __call__(self, x):
        return F.silu(x)


class SoftPlus(Activation):
    name = "softplus"

    def __call__(self, x):
        return F.softplus(x)


class SoftSign(Activation):
    name = "softsign"

    def __call__(self, x):
        return F.softsign(x)


class HardSigmoid(Activation):
    """clip(0.2 x + 0.5, 0, 1)."""

    name = "hardsigmoid"

    def __call__(self, x):
        return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


class HardTanh(Activation):
    name = "hardtanh"

    def __call__(self, x):
        return torch.clamp(x, -1.0, 1.0)


class Cube(Activation):
    name = "cube"

    def __call__(self, x):
        return x * x * x


class RationalTanh(Activation):
    """clip(1.7159 * sgn(y) (1 - 1 / (1 + |y| + y^2 + 1.41645 y^4)),
    -1, 1) with y = 2x/3."""

    name = "rationaltanh"

    def __call__(self, x):
        y = x * (2.0 / 3.0)
        a = torch.abs(y)
        approx = torch.sign(y) * (1.0 - 1.0 / (1.0 + a + y * y
                                               + 1.41645 * (y ** 4)))
        return torch.clamp(1.7159 * approx, -1.0, 1.0)


class RectifiedTanh(Activation):
    """max(0, tanh(x))."""

    name = "rectifiedtanh"

    def __call__(self, x):
        return torch.clamp_min(torch.tanh(x), 0.0)


class ThresholdedReLU(Activation):
    """x where x > theta, else 0."""

    name = "thresholdedrelu"

    def __init__(self, theta: float = 1.0):
        self.theta = float(theta)

    def __call__(self, x):
        return torch.where(x > self.theta, x, torch.zeros_like(x))


class PReLU(Activation):
    """Parametric ReLU; alone it is a leaky ReLU at 0.01, and a layer
    that owns the learnable alpha calls :meth:`apply_with_alpha`."""

    name = "prelu"

    def __call__(self, x):
        return F.leaky_relu(x, 0.01)

    @staticmethod
    def apply_with_alpha(x, alpha):
        return torch.where(x >= 0, x, alpha * x)


class RReLU(Activation):
    """Randomized leaky ReLU (l = 1/8, u = 1/3): in training alpha is
    drawn from U(l, u) with a ``random.py`` key (JAX's uniform), else
    the mean (l + u) / 2."""

    name = "rrelu"

    def __init__(self, l: float = 1.0 / 8.0, u: float = 1.0 / 3.0):
        self.l = float(l)
        self.u = float(u)

    def __call__(self, x, rng=None, train: bool = False):
        if train and rng is not None:
            from .. import random as R
            alpha = R.uniform(rng, x.shape, x.dtype, self.l, self.u,
                              x.device)
        else:
            alpha = (self.l + self.u) / 2.0
        return torch.where(x >= 0, x, alpha * x)


class Mish(Activation):
    """x tanh(softplus(x))."""

    name = "mish"

    def __call__(self, x):
        return x * torch.tanh(F.softplus(x))


_REGISTRY: Dict[str, type] = {
    c.name: c for c in (Identity, Sigmoid, Tanh, ReLU, GELU, Softmax, ReLU6,
                        LeakyReLU, ELU, SELU, Swish, SoftPlus, SoftSign,
                        HardSigmoid, HardTanh, Cube, RationalTanh,
                        RectifiedTanh, ThresholdedReLU, PReLU, RReLU, Mish)}


def get(spec) -> Activation:
    """An Activation from an instance, a callable, a name
    (case-insensitive, underscores ignored; "lrelu" is "leakyrelu") or
    a ``{"@class": name, **kwargs}`` dict."""
    if isinstance(spec, Activation):
        return spec
    if callable(spec) and not isinstance(spec, str):
        fn = spec

        class _Wrapped(Activation):
            name = getattr(spec, "__name__", "custom")

            def __call__(self, x):
                return fn(x)

        return _Wrapped()
    if isinstance(spec, dict):
        d = dict(spec)
        return _lookup(d.pop("@class"))(**d)
    name = str(spec).lower().replace("_", "")
    return _lookup("leakyrelu" if name == "lrelu" else name)()


def _lookup(name: str) -> type:
    if name not in _REGISTRY:
        raise ValueError(f"Unknown activation: {name!r}. Known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names():
    return sorted(_REGISTRY)
