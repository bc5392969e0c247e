"""The variational autoencoder layer (counterpart of
``deeplearning4j_tpu/nn/layers/variational.py``): pretrained on the
negative evidence lower bound, its supervised forward the mean of
q(z|x).

``init_params`` splits the layer's key once a param over the *sorted*
param names, as JAX's does (the key of ``d0_W`` comes before that of
``e0_W``). ``pretrain_loss`` splits its key ``num_samples`` ways (also
at one sample) and draws each sample's noise with ``random.normal``,
within a few f32 ulp of JAX's draw. The bernoulli log-likelihood takes
``torch.maximum(out, 0)``, which splits the gradient at a tie as
``jnp.maximum`` does (``relu`` would give it none), and ``|out|`` with
JAX's derivative of +1 at 0 (``torch.abs`` gives 0 there).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ... import activations as A
from ... import random as R
from ...weightinit import init_weights
from ..functional import matmul
from . import Layer, register


@register
class VariationalAutoencoder(Layer):
    """VAE as a pretrainable layer: encoder widths, a latent of
    ``n_out``, decoder widths and a gaussian (mean and log-variance) or
    bernoulli (logits) reconstruction."""

    kind = "vae"
    is_pretrain_layer = True

    def __init__(self, n_out: int, encoder_layer_sizes: Sequence[int] = (100,),
                 decoder_layer_sizes: Sequence[int] = (100,),
                 reconstruction_distribution: str = "gaussian",
                 pzx_activation: str = "identity", num_samples: int = 1,
                 **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.n_out = int(n_out)
        self.encoder_layer_sizes = tuple(int(s) for s in encoder_layer_sizes)
        self.decoder_layer_sizes = tuple(int(s) for s in decoder_layer_sizes)
        if reconstruction_distribution not in ("gaussian", "bernoulli"):
            raise ValueError(
                f"unknown reconstruction {reconstruction_distribution!r}")
        self.reconstruction_distribution = reconstruction_distribution
        self.pzx_activation = pzx_activation
        self.num_samples = int(num_samples)
        self.n_in: Optional[int] = None

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        self.n_in = int(input_shape[-1])

    def output_shape(self, input_shape) -> Tuple[int, ...]:
        return (self.n_out,)

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        shapes: Dict[str, Tuple[int, ...]] = {}
        d = self.n_in
        for i, h in enumerate(self.encoder_layer_sizes):
            shapes[f"e{i}_W"], shapes[f"e{i}_b"] = (d, h), (h,)
            d = h
        shapes["zm_W"], shapes["zm_b"] = (d, self.n_out), (self.n_out,)
        shapes["zv_W"], shapes["zv_b"] = (d, self.n_out), (self.n_out,)
        d = self.n_out
        for i, h in enumerate(self.decoder_layer_sizes):
            shapes[f"d{i}_W"], shapes[f"d{i}_b"] = (d, h), (h,)
            d = h
        out = 2 * self.n_in if self.reconstruction_distribution == "gaussian" \
            else self.n_in
        shapes["xr_W"], shapes["xr_b"] = (d, out), (out,)
        return shapes

    def init_params(self, key, dtype=torch.float32):
        shapes = self.param_shapes()
        keys = R.split(key, len(shapes))
        params = {}
        for i, (name, shape) in enumerate(sorted(shapes.items())):
            if name.endswith("_b"):
                params[name] = torch.full(shape, self.bias_init, dtype=dtype)
            else:
                fan_in, fan_out = shape
                params[name] = init_weights(R.key_at(keys, i), shape, fan_in,
                                            fan_out, self.weight_init, dtype)
        return params

    def _encode(self, params, x):
        """x -> (mean, log-variance) of q(z|x)."""
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = self.activation(matmul(h, params[f"e{i}_W"])
                                + params[f"e{i}_b"])
        mean = A.get(self.pzx_activation)(matmul(h, params["zm_W"])
                                          + params["zm_b"])
        logvar = matmul(h, params["zv_W"]) + params["zv_b"]
        return mean, logvar

    def _decode(self, params, z):
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = self.activation(matmul(h, params[f"d{i}_W"])
                                + params[f"d{i}_b"])
        return matmul(h, params["xr_W"]) + params["xr_b"]

    def apply(self, params, x, state, train, rng):
        x = self._maybe_dropout(x, train, rng)
        mean, _ = self._encode(params, x)
        return mean, state

    def pretrain_loss(self, params, x, rng):
        """The negative ELBO, KL(q(z|x) || N(0, I)) less the mean over
        ``num_samples`` reparameterised samples of log p(x|z), averaged
        over the batch."""
        mean, logvar = self._encode(params, x)
        kl = -0.5 * torch.sum(1.0 + logvar - torch.square(mean)
                              - torch.exp(logvar), dim=-1)
        rec = 0.0
        keys = R.split(rng, self.num_samples)
        for i in range(self.num_samples):
            eps = R.normal(R.key_at(keys, i), tuple(mean.shape), mean.dtype,
                           device=mean.device)
            z = mean + torch.exp(0.5 * logvar) * eps
            out = self._decode(params, z)
            if self.reconstruction_distribution == "gaussian":
                xm, xlv = out[..., :self.n_in], out[..., self.n_in:]
                ll = -0.5 * torch.sum(
                    xlv + math.log(2.0 * math.pi)
                    + torch.square(x - xm) / torch.exp(xlv), dim=-1)
            else:
                # |out| as jnp.abs differentiates it: +1 at 0 (a zero
                # logit, e.g. a dead ReLU row over a zero bias)
                mag = torch.where(out >= 0, out, -out)
                ll = -torch.sum(
                    torch.maximum(out, torch.zeros_like(out)) - out * x
                    + torch.log1p(torch.exp(-mag)), dim=-1)
            rec = rec + ll
        rec = rec / self.num_samples
        return torch.mean(kl - rec)

    def reconstruct(self, params, x, rng=None):
        """The reconstruction through the latent mean: the gaussian's
        mean, or the bernoulli's probabilities."""
        mean, _ = self._encode(params, x)
        out = self._decode(params, mean)
        if self.reconstruction_distribution == "gaussian":
            return out[..., :self.n_in]
        return torch.sigmoid(out)

    def _extra_json(self):
        return {"n_out": self.n_out,
                "encoder_layer_sizes": list(self.encoder_layer_sizes),
                "decoder_layer_sizes": list(self.decoder_layer_sizes),
                "reconstruction_distribution":
                    self.reconstruction_distribution,
                "pzx_activation": self.pzx_activation,
                "num_samples": self.num_samples}
