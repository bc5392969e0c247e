"""Dropout and noise schemes (counterpart of
``deeplearning4j_tpu/nn/conf/dropout.py``).

Each scheme is a function of (x, key, train), the key one of
``random.py``'s threefry keys. The masks and the noise are drawn with
``jax.random``'s counter layout, so under the same key a Bernoulli
mask (``Dropout``, ``AlphaDropout``, ``SpatialDropout``) equals JAX's
bit for bit, on the CPU and on the card alike. The Gaussian schemes
draw JAX's uniforms too; their normals are within a few f32 ulp of
JAX's (``random.normal``).

In a data-parallel step each rank takes its rows of the draw for the
global batch (``nn/global_batch.py``), as JAX draws one mask for the
whole sharded batch.

As in the JAX package, ``p`` is the DROP probability and a float
``dropout=p`` on a layer is shorthand for ``Dropout(p)``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ... import random as R
from .. import global_batch as G


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


class IDropout:
    """Base scheme."""

    kind = "dropout"

    def apply(self, x, rng, train: bool):
        raise NotImplementedError

    def to_json(self) -> Dict[str, Any]:
        d = {"@class": self.kind}
        d.update(self._extra_json())
        return d

    def _extra_json(self) -> Dict[str, Any]:
        return {}

    def __eq__(self, other):
        return type(self) is type(other) and self.to_json() == other.to_json()

    def __repr__(self):
        return f"{type(self).__name__}({self._extra_json()})"


class Dropout(IDropout):
    """Inverted Bernoulli dropout: zero with probability p, survivors
    scaled by 1/(1-p)."""

    kind = "dropout"

    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def apply(self, x, rng, train):
        if not train or not self.p or rng is None:
            return x
        keep = 1.0 - self.p
        mask = G.draw(lambda s: R.bernoulli(rng, keep, s, x.device), x.shape)
        return torch.where(mask, x / keep, _zero(x))

    def _extra_json(self):
        return {"p": self.p}


class GaussianDropout(IDropout):
    """Multiplicative unit-mean Gaussian noise: x * N(1, rate/(1-rate))."""

    kind = "gaussian_dropout"

    def __init__(self, rate: float = 0.5):
        self.rate = float(rate)

    def apply(self, x, rng, train):
        if not train or not self.rate or rng is None:
            return x
        stddev = math.sqrt(self.rate / (1.0 - self.rate))
        noise = 1.0 + stddev * G.draw(
            lambda s: R.normal(rng, s, x.dtype, x.device), x.shape)
        return x * noise

    def _extra_json(self):
        return {"rate": self.rate}


class GaussianNoise(IDropout):
    """Additive zero-mean Gaussian noise."""

    kind = "gaussian_noise"

    def __init__(self, stddev: float = 0.1):
        self.stddev = float(stddev)

    def apply(self, x, rng, train):
        if not train or not self.stddev or rng is None:
            return x
        return x + self.stddev * G.draw(
            lambda s: R.normal(rng, s, x.dtype, x.device), x.shape)

    def _extra_json(self):
        return {"stddev": self.stddev}


class AlphaDropout(IDropout):
    """SELU-preserving dropout: dropped units are set to
    alpha' = -lambda * alpha, then the affine (a, b) correction restores
    zero mean and unit variance."""

    kind = "alpha_dropout"

    ALPHA = 1.6732632423543772
    LAMBDA = 1.0507009873554805

    def __init__(self, p: float = 0.05):
        self.p = float(p)

    def apply(self, x, rng, train):
        if not train or not self.p or rng is None:
            return x
        keep = 1.0 - self.p
        alpha_prime = -self.LAMBDA * self.ALPHA
        a = (keep + alpha_prime ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * alpha_prime * (1 - keep)
        mask = G.draw(lambda s: R.bernoulli(rng, keep, s, x.device), x.shape)
        return a * torch.where(mask, x, torch.full((), alpha_prime,
                                                   dtype=x.dtype,
                                                   device=x.device)) + b

    def _extra_json(self):
        return {"p": self.p}


class SpatialDropout(IDropout):
    """Drops whole channels: for NHWC images one mask entry per (batch,
    channel), for [B, T, C] sequences per (batch, channel) across time;
    plain dropout on 2D input."""

    kind = "spatial_dropout"

    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def apply(self, x, rng, train):
        if not train or not self.p or rng is None:
            return x
        keep = 1.0 - self.p
        if x.ndim <= 2:
            shape = tuple(x.shape)
        else:
            shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        mask = G.draw(lambda s: R.bernoulli(rng, keep, s, x.device), shape)
        return torch.where(mask, x / keep, _zero(x))

    def _extra_json(self):
        return {"p": self.p}


_REGISTRY = {c.kind: c for c in
             (Dropout, GaussianDropout, GaussianNoise, AlphaDropout,
              SpatialDropout)}


def get(spec) -> Optional[IDropout]:
    """A layer's dropout spec (None, a float, a scheme or its
    ``to_json`` dict) as a scheme, or None."""
    if spec is None:
        return None
    if isinstance(spec, IDropout):
        return spec
    if isinstance(spec, dict):
        d = dict(spec)
        return _REGISTRY[d.pop("@class")](**d)
    p = float(spec)
    return Dropout(p) if p else None
