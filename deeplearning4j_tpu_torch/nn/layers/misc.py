"""The denoising AutoEncoder (pretrainable), the reshape and mask
layers and the per-pixel loss layers (counterpart of
``deeplearning4j_tpu/nn/layers/misc.py``). ``FrozenLayerWithBackprop``
lives in ``nn/layers/__init__.py`` and is re-exported here, where the
JAX package defines it.

The AutoEncoder has tied weights: its forward is the encoder (a dense
layer), and its pretraining loss decodes with ``W.T`` and the visible
bias ``vb``. The corruption mask is JAX's ``bernoulli(rng, 1 - p)``
draw, bit for bit (``random.py``). The sparsity term clips the mean
code with ``torch.minimum(torch.maximum(...))``: ``jnp.clip`` is that
pair, and at a bound each side of a tie gets half the gradient, where
``torch.clamp`` gives it all to the input.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ... import losses as L
from ... import random as R
from ..functional import matmul
from . import DenseLayer, Layer, LossLayer, register
from . import FrozenLayerWithBackprop  # noqa: F401  (defined there)


@register
class AutoEncoder(DenseLayer):
    """Denoising autoencoder with tied weights: the supervised forward
    is the encoder; layerwise pretraining minimises the reconstruction
    loss of decode(encode(corrupt(x))) against the clean x, plus
    ``sparsity`` times KL(rho || mean code) when it is set."""

    kind = "autoencoder"
    is_pretrain_layer = True

    def __init__(self, n_out: int = None, corruption_level: float = 0.3,
                 sparsity: float = 0.0, sparsity_target: float = 0.05,
                 loss="mse", **kw):
        kw.setdefault("activation", "sigmoid")
        super().__init__(n_out=n_out, **kw)
        self.corruption_level = float(corruption_level)
        self.sparsity = float(sparsity)
        self.sparsity_target = float(sparsity_target)
        self.recon_loss = L.get(loss)

    def param_shapes(self):
        sh = super().param_shapes()
        sh["vb"] = (self.n_in,)      # the decoder's visible bias
        return sh

    def init_params(self, key, dtype=torch.float32):
        p = super().init_params(key, dtype)
        p["vb"] = torch.zeros((self.n_in,), dtype=dtype)
        return p

    def bias_param_names(self):
        return super().bias_param_names() | {"vb"}

    def encode(self, params, x):
        z = matmul(x, params["W"])
        if self.has_bias:
            z = z + params["b"]
        return self.activation(z)

    def decode(self, params, y):
        return self.activation(matmul(y, params["W"].T) + params["vb"])

    def pretrain_loss(self, params, x, rng):
        """The reconstruction loss of one batch: corruption from
        ``rng``, scored against the clean input."""
        if x.ndim > 2:
            x = x.reshape(x.shape[0], -1)
        xc = x
        if self.corruption_level > 0.0 and rng is not None:
            keep = R.bernoulli(rng, 1.0 - self.corruption_level,
                               tuple(x.shape), device=x.device)
            xc = x * keep.to(x.dtype)
        y = self.encode(params, xc)
        z = self.decode(params, y)
        loss = self.recon_loss.score(x, z, lambda a: a, None)
        if self.sparsity > 0.0:
            rho, eps = self.sparsity_target, 1e-7
            mean = torch.mean(y, dim=0)
            rho_hat = torch.minimum(
                torch.maximum(mean, torch.full_like(mean, eps)),
                torch.full_like(mean, 1.0 - eps))
            kl = rho * torch.log(rho / rho_hat) + \
                (1.0 - rho) * torch.log((1.0 - rho) / (1.0 - rho_hat))
            loss = loss + self.sparsity * torch.sum(kl)
        return loss

    def _extra_json(self):
        d = super()._extra_json()
        d.update(corruption_level=self.corruption_level,
                 sparsity=self.sparsity,
                 sparsity_target=self.sparsity_target,
                 loss=self.recon_loss.to_json())
        return d


@register
class ReshapeLayer(Layer):
    """Reshape of the per-example axes (the batch kept); one -1 entry
    is inferred."""

    kind = "reshapelayer"

    def __init__(self, target_shape=(), **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.target_shape = tuple(int(s) for s in target_shape)

    def apply(self, params, x, state, train, rng):
        return x.reshape((x.shape[0],) + self.target_shape), state

    def output_shape(self, input_shape):
        if -1 in self.target_shape:
            known = -math.prod(self.target_shape)
            total = math.prod(int(s) for s in input_shape)
            if total % known:
                raise ValueError(
                    f"cannot reshape {input_shape} ({total} elements) "
                    f"into {self.target_shape}")
            return tuple(total // known if s == -1 else s
                         for s in self.target_shape)
        return self.target_shape

    def _extra_json(self):
        return {"target_shape": list(self.target_shape)}


@register
class MaskLayer(Layer):
    """Zeroes the activations at masked-out steps with the network's
    feature mask (broadcast over the trailing axes); identity without
    one."""

    kind = "masklayer"
    wants_mask = True

    def __init__(self, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)

    def apply(self, params, x, state, train, rng):
        return x, state

    def apply_with_mask(self, params, x, state, train, rng,
                        mask: Optional[torch.Tensor]):
        if mask is None:
            return x, state
        m = mask
        while m.ndim < x.ndim:
            m = m[..., None]
        return x * m.to(x.dtype), state


@register
class MaskingLayer(Layer):
    """Derives a [B, T] feature mask from the data (a step whose every
    feature equals ``mask_value`` is padding) for the layers after it;
    the activations pass through unchanged."""

    kind = "masking"
    derives_mask = True

    def __init__(self, mask_value: float = 0.0, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.mask_value = float(mask_value)

    def derive_mask(self, x):
        if x.ndim != 3:
            return None
        return torch.any(x != self.mask_value, dim=-1).to(x.dtype)

    def apply(self, params, x, state, train, rng):
        return x, state

    def _extra_json(self):
        return {"mask_value": self.mask_value}


@register
class CnnLossLayer(LossLayer):
    """Per-pixel loss on [B, H, W, C] input, no params: positions
    flatten into the batch, and a [B, H, W], [B, H, W, 1] or
    broadcastable (a per-example [B, 1, 1]) mask weights them."""

    kind = "cnnloss"

    def compute_loss(self, params, x, labels, mask=None, train: bool = False,
                     rng=None):
        x = self._maybe_dropout(x, train, rng)
        c = x.shape[-1]
        m2 = None
        if mask is not None:
            m = mask
            if m.ndim == x.ndim and m.shape[-1] == 1:
                m = m[..., 0]
            while m.ndim < x.ndim - 1:
                m = m[..., None]
            m2 = torch.broadcast_to(m, tuple(x.shape[:-1])).reshape(-1)
        return self.loss.score(labels.reshape(-1, c), x.reshape(-1, c),
                               self.activation, m2)


@register
class Cnn3DLossLayer(CnnLossLayer):
    """Per-voxel loss on [B, D, H, W, C] input."""

    kind = "cnn3dloss"
