"""Activations (counterpart of ``deeplearning4j_tpu/activations``; the
subset the ported layers use: identity, softmax, gelu, relu, tanh,
sigmoid).

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


_REGISTRY: Dict[str, type] = {c.name: c for c in
                              (Identity, Sigmoid, Tanh, ReLU, GELU, Softmax)}


def get(spec) -> Activation:
    """An Activation from an instance, a name (case-insensitive,
    underscores ignored) or a ``{"@class": name, **kwargs}`` dict. A name the JAX package
    knows but the port does not raises ``NotImplementedError``."""
    if isinstance(spec, Activation):
        return spec
    if isinstance(spec, dict):
        d = dict(spec)
        return _lookup(d.pop("@class"))(**d)
    return _lookup(str(spec).lower().replace("_", ""))()


def _lookup(name: str) -> type:
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"activation {name!r} is not ported (ported: "
            f"{sorted(_REGISTRY)}; ROADMAP.md queue A, item 11)")
    return _REGISTRY[name]
