"""Sequence input and output layers (counterpart of
``EmbeddingSequenceLayer`` and ``RnnOutputLayer`` in
``deeplearning4j_tpu/nn/layers/recurrent.py``)."""
from __future__ import annotations

import torch

from ... import losses as L
from ...weightinit import init_weights
from . import DenseLayer, Layer, register


@register
class EmbeddingSequenceLayer(Layer):
    """[B, T] (or [B, T, 1]) integer indices -> [B, T, n_out]."""

    kind = "embeddingseq"

    def __init__(self, n_in: int = None, n_out: int = None,
                 has_bias: bool = False, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.n_in = int(n_in)
        self.n_out = int(n_out)
        self.has_bias = bool(has_bias)

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

    def apply(self, params, x, state, train, rng):
        idx = x.long()
        if idx.ndim == 3 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        z = params["W"][idx]
        if self.has_bias:
            z = z + params["b"]
        return self.activation(z), state

    def output_shape(self, input_shape):
        t = input_shape[0] if input_shape else -1
        return (t, self.n_out)


@register
class RnnOutputLayer(DenseLayer):
    """Per-timestep dense layer and loss over [B, T, O], with an
    optional [B, T] label mask. The loss sees [B*T, O] rows, so its mean
    is per token (per live token under a mask)."""

    kind = "rnnoutput"

    def __init__(self, n_out: int = None, loss="mcxent", **kw):
        kw.setdefault("activation", "softmax")
        super().__init__(n_out=n_out, **kw)
        self.loss = L.get(loss)

    def compute_loss(self, params, x, labels, mask=None, train: bool = False,
                     rng=None):
        z = self.pre_output(params, x, train, rng)      # [B, T, O]
        B, T, O = z.shape
        m2 = None if mask is None else mask.reshape(B * T)
        return self.loss.score(labels.reshape(B * T, O), z.reshape(B * T, O),
                               self.activation, m2)

    def output_shape(self, input_shape):
        return (input_shape[0], self.n_out)
