"""The center-loss and one-class output layers (counterpart of
``deeplearning4j_tpu/nn/layers/specialized_outputs.py``).

CenterLoss adds (lambda / 2) * mean ||x - c_y||^2 to the softmax
cross-entropy. Its centers are a param (a bias: no L1/L2, no weight
noise), and the center term reads them through ``alpha * c + (1 -
alpha) * c.detach()``: the same value, with the centers' gradient
scaled by ``alpha`` and the features' pull not.

OCNN scores ``g(x V) w`` and takes the loss 0.5||V||^2 + 0.5||w||^2 +
mean(max(0, r - s)) / nu - r, with the bias ``r`` a param. The hinge is
``torch.maximum``, which gives each side half the gradient at a tie as
``jnp.maximum`` does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ... import random as R
from ...weightinit import init_weights
from .. import global_batch as G
from ..functional import matmul
from . import Layer, OutputLayer, register


@register
class CenterLossOutputLayer(OutputLayer):
    """Softmax head plus the center loss (``alpha`` the centers' rate,
    ``lambda_`` the term's weight)."""

    kind = "centerloss_output"

    def __init__(self, n_out: int = None, alpha: float = 0.05,
                 lambda_: float = 2e-4, **kw):
        super().__init__(n_out=n_out, **kw)
        self.alpha = float(alpha)
        self.lambda_ = float(lambda_)

    def param_shapes(self):
        sh = dict(super().param_shapes())
        sh["centers"] = (self.n_out, self.n_in)
        return sh

    def init_params(self, key, dtype=torch.float32):
        p = super().init_params(key, dtype)
        p["centers"] = torch.zeros((self.n_out, self.n_in), dtype=dtype)
        return p

    def bias_param_names(self) -> set:
        return super().bias_param_names() | {"centers"}

    def compute_loss(self, params, x, labels, mask=None, train: bool = False,
                     rng=None):
        if getattr(self, "_flatten_input", False) and x.ndim > 2:
            x = x.reshape(x.shape[0], -1)
        ce = self.loss.score(labels, self.pre_output(params, x, train, rng),
                             self.activation, mask)
        assigned = matmul(labels, params["centers"])      # [B, n_in]
        assigned = self.alpha * assigned + \
            (1.0 - self.alpha) * assigned.detach()
        d2 = torch.sum(torch.square(x - assigned), dim=-1)
        if mask is not None and mask.ndim == 1:
            d2 = d2 * mask
            denom = torch.clamp_min(G.count(torch.sum(mask)), 1.0)
        else:
            denom = G.rows(d2.shape[0])
        return ce + 0.5 * self.lambda_ * torch.sum(d2) / denom

    def _extra_json(self):
        d = super()._extra_json()
        d.update(alpha=self.alpha, lambda_=self.lambda_)
        return d


@register
class OCNNOutputLayer(Layer):
    """One-class output layer: ``apply`` gives the decision score
    ``s - r`` ([B, 1], >= 0 an inlier at the nu working point); the
    loss ignores the labels."""

    kind = "ocnn_output"

    def __init__(self, hidden_size: int = 100, nu: float = 0.04,
                 initial_r: float = 0.1, window_size: int = 10000, **kw):
        kw.setdefault("activation", "sigmoid")
        super().__init__(**kw)
        self.hidden_size = int(hidden_size)
        self.nu = float(nu)
        self.initial_r = float(initial_r)
        self.window_size = int(window_size)   # kept for the JSON
        self.n_in: Optional[int] = None

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        self._flatten_input = len(input_shape) == 3
        self.n_in = int(math.prod(input_shape)) if self._flatten_input \
            else int(input_shape[-1])

    def param_shapes(self):
        return {"V": (self.n_in, self.hidden_size),
                "w": (self.hidden_size, 1),
                "r_b": (1,)}

    def bias_param_names(self) -> set:
        return {"r_b"}

    def init_params(self, key, dtype=torch.float32):
        keys = R.split(key)
        return {"V": init_weights(R.key_at(keys, 0),
                                  (self.n_in, self.hidden_size), self.n_in,
                                  self.hidden_size, self.weight_init, dtype),
                "w": init_weights(R.key_at(keys, 1), (self.hidden_size, 1),
                                  self.hidden_size, 1, self.weight_init,
                                  dtype),
                "r_b": torch.full((1,), self.initial_r, dtype=dtype)}

    def _score(self, params, x, train=False, rng=None):
        if getattr(self, "_flatten_input", False) and x.ndim > 2:
            x = x.reshape(x.shape[0], -1)
        if x.ndim != 2:
            raise ValueError(
                "OCNNOutputLayer expects flat [B, F] features; reduce "
                "sequences first (LastTimeStep / GlobalPoolingLayer), "
                f"got rank-{x.ndim} input")
        x = self._maybe_dropout(x, train, rng)
        return matmul(self.activation(matmul(x, params["V"])), params["w"])

    def apply(self, params, x, state, train, rng):
        return self._score(params, x, train, rng) - params["r_b"], state

    def output_shape(self, input_shape) -> Tuple[int, ...]:
        return (1,)

    def compute_loss(self, params, x, labels=None, mask=None,
                     train: bool = False, rng=None):
        s = self._score(params, x, train, rng)[:, 0]
        r = params["r_b"][0]
        d = r - s
        hinge = torch.maximum(torch.zeros_like(d), d)
        if mask is not None and mask.ndim == 1:
            mean_h = torch.sum(hinge * mask) / torch.clamp_min(
                G.count(torch.sum(mask)), 1.0)
        elif G.active():
            mean_h = torch.sum(hinge) / G.rows(hinge.shape[0])
        else:
            mean_h = torch.mean(hinge)
        reg = 0.5 * torch.sum(torch.square(params["V"])) \
            + 0.5 * torch.sum(torch.square(params["w"]))
        # in a data-parallel step each rank carries its share of the
        # batch-independent terms (nn/global_batch.py)
        return G.share(reg) + mean_h / self.nu - G.share(r)

    def _extra_json(self):
        return {"hidden_size": self.hidden_size, "nu": self.nu,
                "initial_r": self.initial_r,
                "window_size": self.window_size}
