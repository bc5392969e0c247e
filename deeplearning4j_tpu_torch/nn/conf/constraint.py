"""Param constraints (counterpart of
``deeplearning4j_tpu/nn/conf/constraint.py``): projections applied to
a layer's params right AFTER each update, as JAX's train step applies
them (``MultiLayerNetwork.apply_gradients``).

Norms are taken per output unit, over every axis but the last (dense
``[in, out]`` per column, convolution HWIO per output channel). A
constraint applies to the weights by default and to the biases (the
layer's ``bias_param_names``) only when asked, except
``NonNegativeConstraint``, which applies to both.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch


class LayerConstraint:
    """Base constraint."""

    kind = "constraint"

    def __init__(self, apply_to_weights: bool = True,
                 apply_to_biases: bool = False):
        self.apply_to_weights = bool(apply_to_weights)
        self.apply_to_biases = bool(apply_to_biases)

    def project(self, w):
        raise NotImplementedError

    def applies_to(self, param_name: str, bias_names) -> bool:
        is_bias = param_name in bias_names
        return self.apply_to_biases if is_bias else self.apply_to_weights

    @staticmethod
    def _norm(w, eps: float = 1e-8):
        """L2 norm per output unit (over every axis but the last)."""
        axes = tuple(range(w.ndim - 1)) or (0,)
        return torch.sqrt(torch.sum(w * w, dim=axes, keepdim=True)) + eps

    def to_json(self) -> Dict[str, Any]:
        d = {"@class": self.kind,
             "apply_to_weights": self.apply_to_weights,
             "apply_to_biases": self.apply_to_biases}
        d.update(self._extra_json())
        return d

    def _extra_json(self) -> Dict[str, Any]:
        return {}

    def __eq__(self, other):
        return type(self) is type(other) and self.to_json() == other.to_json()

    def __repr__(self):
        return f"{type(self).__name__}({self.to_json()})"


class MaxNormConstraint(LayerConstraint):
    """Units whose norm exceeds ``max_norm`` are scaled down to it."""

    kind = "max_norm"

    def __init__(self, max_norm: float = 1.0, **kw):
        super().__init__(**kw)
        self.max_norm = float(max_norm)

    def project(self, w):
        return w * torch.clamp(self.max_norm / self._norm(w), max=1.0)

    def _extra_json(self):
        return {"max_norm": self.max_norm}


class MinMaxNormConstraint(LayerConstraint):
    """Unit norms pulled into [min_norm, max_norm] at ``rate``:
    ``w * (rate * clip(n, min, max) / n + 1 - rate)``."""

    kind = "min_max_norm"

    def __init__(self, min_norm: float = 0.0, max_norm: float = 1.0,
                 rate: float = 1.0, **kw):
        super().__init__(**kw)
        self.min_norm = float(min_norm)
        self.max_norm = float(max_norm)
        self.rate = float(rate)

    def project(self, w):
        n = self._norm(w)
        clipped = torch.clamp(n, self.min_norm, self.max_norm)
        return w * (self.rate * clipped / n + (1.0 - self.rate))

    def _extra_json(self):
        return {"min_norm": self.min_norm, "max_norm": self.max_norm,
                "rate": self.rate}


class UnitNormConstraint(LayerConstraint):
    """Every unit scaled to norm 1."""

    kind = "unit_norm"

    def project(self, w):
        return w / self._norm(w)


class NonNegativeConstraint(LayerConstraint):
    """Negative values clamped to 0, weights and biases alike."""

    kind = "non_negative"

    def __init__(self, **kw):
        kw.setdefault("apply_to_biases", True)
        super().__init__(**kw)

    def project(self, w):
        return torch.clamp(w, min=0.0)


_REGISTRY = {c.kind: c for c in
             (MaxNormConstraint, MinMaxNormConstraint, UnitNormConstraint,
              NonNegativeConstraint)}


def get(spec) -> Optional[LayerConstraint]:
    """A constraint from None, a constraint or its ``to_json`` dict."""
    if spec is None or isinstance(spec, LayerConstraint):
        return spec
    d = dict(spec)
    return _REGISTRY[d.pop("@class")](**d)


def from_json(d: dict) -> LayerConstraint:
    return get(d)


def apply_constraints(constraints: Sequence[LayerConstraint],
                      params: Dict[str, Any], bias_names) -> Dict[str, Any]:
    """A layer's params after its constraints, in order (new tensors;
    the inputs are not changed)."""
    if not constraints:
        return params
    out = dict(params)
    for name, w in params.items():
        for c in constraints:
            if c.applies_to(name, bias_names):
                w = c.project(w)
        out[name] = w
    return out
