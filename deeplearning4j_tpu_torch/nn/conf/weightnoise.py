"""Weight noise schemes (counterpart of
``deeplearning4j_tpu/nn/conf/weightnoise.py``): ``DropConnect`` and
``WeightNoise`` perturb a layer's WEIGHTS for one training forward
pass, where dropout perturbs its input activations.

A scheme is a function of (w, key, train), the key one of
``random.py``'s threefry keys, drawn as JAX draws it: a DropConnect
mask equals JAX's bit for bit, a Gaussian noise is JAX's uniform
through ``random.normal`` (within a few f32 ulp of JAX's normal). The
network applies a scheme to every param but the biases and norm gains
(``Layer._maybe_weight_noise``), each under its own key folded from
the layer's, as JAX does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ... import random as R


class IWeightNoise:
    """Base scheme."""

    kind = "weightnoise"

    def apply(self, w, rng, train: bool):
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


class DropConnect(IWeightNoise):
    """Each weight is zeroed with probability 1 - keep_prob in training,
    and the survivors are NOT rescaled (as in JAX and DL4J)."""

    kind = "dropconnect"

    def __init__(self, keep_prob: float = 0.5):
        self.keep_prob = float(keep_prob)

    def apply(self, w, rng, train):
        if not train or self.keep_prob >= 1.0 or rng is None:
            return w
        mask = R.bernoulli(rng, self.keep_prob, w.shape, w.device)
        return torch.where(mask, w, torch.zeros((), dtype=w.dtype,
                                                device=w.device))

    def _extra_json(self):
        return {"keep_prob": self.keep_prob}


class WeightNoise(IWeightNoise):
    """Additive (w + N(mean, stddev)) or multiplicative
    (w * N(mean, stddev)) Gaussian weight noise in training."""

    kind = "weight_gaussian_noise"

    def __init__(self, stddev: float = 0.1, mean: float = 0.0,
                 additive: bool = True):
        self.stddev = float(stddev)
        self.mean = float(mean)
        self.additive = bool(additive)

    def apply(self, w, rng, train):
        if not train or rng is None:
            return w
        noise = self.mean + self.stddev * R.normal(rng, w.shape, w.dtype,
                                                   w.device)
        return w + noise if self.additive else w * noise

    def _extra_json(self):
        return {"stddev": self.stddev, "mean": self.mean,
                "additive": self.additive}


_REGISTRY = {c.kind: c for c in (DropConnect, WeightNoise)}


def get(spec) -> Optional[IWeightNoise]:
    """A scheme from None, a scheme or its ``to_json`` dict."""
    if spec is None or isinstance(spec, IWeightNoise):
        return spec
    d = dict(spec)
    return _REGISTRY[d.pop("@class")](**d)


def from_json(d: dict) -> IWeightNoise:
    return get(d)
