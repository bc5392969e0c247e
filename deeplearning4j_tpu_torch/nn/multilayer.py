"""MultiLayerNetwork: a sequential layer stack with ``fit``, ``output``
and ``score`` (counterpart of ``deeplearning4j_tpu/nn/multilayer.py``).

The JAX package compiles one pure train step (forward, loss, backward,
regularization, clipping, updater). Here the step runs eagerly: the
loss is differentiated by autograd (attention layers through the flash
kernels' ``autograd.Function``), gradients are clipped per layer, each
layer's updater computes its updates, and the params are updated in
place under ``torch.no_grad``. Params, gradients and updater state
live on the network's device: the GPU unless ``device="cpu"`` is
asked for.

A configuration with a half dtype (``data_type("bfloat16")``) trains
under the bf16 mixed-precision policy of ``precision.py``, as in JAX:
the loss casts every layer's params but the output layer's, and the
input, to bf16, runs the stack up to the output layer in bf16 (the
attention layers through the flash kernels' bf16 legs on the card),
promotes the features back to f32 and takes the output layer's loss
and the L1/L2 terms on the f32 masters. Autograd carries the gradients
back through the casts, so gradients, the updater state and the
updates stay f32. ``output()`` runs uncast, in f32.

Not ported yet, and refused: TBPTT, remat, layerwise pretraining,
stateful ``rnn_time_step``, the anomaly guard and listeners.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..device import resolve_device
from .conf import MultiLayerConfiguration
from .layers import Layer
from .precision import (cast_feats_to_f32, cast_input_for_compute,
                        cast_params_for_compute, compute_dtype)

Params = Dict[str, Dict[str, torch.Tensor]]


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue "
                              f"A, item 11)")


def _clip_grads(grads: Params, max_norm, clip_value) -> Params:
    """Elementwise clip, then each layer's gradient scaled to at most
    ``max_norm`` in L2 over all its leaves (in place)."""
    if clip_value:
        for g in grads.values():
            for leaf in g.values():
                leaf.clamp_(-clip_value, clip_value)
    if max_norm:
        for g in grads.values():
            norm = torch.sqrt(sum(torch.sum(leaf * leaf)
                                  for leaf in g.values()) + 1e-12)
            scale = torch.clamp(max_norm / norm, max=1.0)
            for leaf in g.values():
                leaf.mul_(scale)
    return grads


def _regularization_penalty(params: Params, layers_meta) -> torch.Tensor:
    """0.5 * l2 * sum(w^2) + l1 * sum(|w|) over each layer's params;
    biases and norm params take the *_bias coefficients."""
    reg = 0.0
    for key, meta in layers_meta.items():
        if key not in params:
            continue
        for pname, w in params[key].items():
            is_bias = pname in meta["bias_params"]
            l1 = meta["l1_bias"] if is_bias else meta["l1"]
            l2 = meta["l2_bias"] if is_bias else meta["l2"]
            if l2:
                reg = reg + 0.5 * l2 * torch.sum(w * w)
            if l1:
                reg = reg + l1 * torch.sum(torch.abs(w))
    return reg


class MultiLayerNetwork:
    """Sequential network; the public surface mirrors the JAX class."""

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        if conf.tbptt_fwd_length:
            _not_ported("truncated BPTT")
        if conf.remat:
            _not_ported("remat")
        self.conf = conf
        self.device = resolve_device(device)
        self.layers: List[Layer] = conf.layers
        self._params: Optional[Params] = None
        self._net_state: Params = {}
        self._opt_state: Optional[Dict[str, Any]] = None
        self._updaters = None
        self._step = 0
        self._epoch = 0
        self._last_loss: Optional[torch.Tensor] = None
        self._input_shape = conf.input_type.shape if conf.input_type else None

    # -- init ----------------------------------------------------------
    def init(self, dtype=torch.float32) -> "MultiLayerNetwork":
        """Build every layer's shapes and draw its params from the
        configuration's seed (a ``torch.Generator`` on the CPU; the
        draws differ from ``jax.random``, see
        :func:`~..convert.network_params_from_jax`)."""
        if self._input_shape is None:
            raise ValueError("Configuration needs an input_type to init()")
        if dtype != torch.float32:
            raise NotImplementedError(
                "only f32 master params are ported; a half data_type trains "
                "them under the bf16 policy (pure-bf16 params: ROADMAP.md "
                "queue A, item 11)")
        shape = tuple(self._input_shape)
        gen = torch.Generator().manual_seed(self.conf.seed)
        params: Params = {}
        self._layer_keys = []
        for i, layer in enumerate(self.layers):
            layer.build(shape, self.conf.defaults)
            key = f"layer_{i}" + (f"_{layer.name}" if layer.name else "")
            self._layer_keys.append(key)
            p = layer.init_params(gen, dtype)
            if p:
                params[key] = p
            if layer.init_state():
                _not_ported(f"layer state ({type(layer).__name__})")
            shape = layer.output_shape(shape)
        self._updaters = [l.updater if l.updater is not None
                          else self.conf.updater for l in self.layers]
        self._layers_meta = {
            self._layer_keys[i]: {
                "l1": l.l1, "l2": l.l2, "l1_bias": l.l1_bias,
                "l2_bias": l.l2_bias,
                "bias_params": frozenset(l.bias_param_names())}
            for i, l in enumerate(self.layers)}
        self.set_params(params)
        self._step = 0
        return self

    # -- forward -------------------------------------------------------
    def _forward(self, params: Params, x, train: bool,
                 upto: Optional[int] = None, fmask=None):
        """Run layers [0, upto). ``fmask`` is the [B, T] feature mask,
        applied while the activation is a sequence."""
        upto = len(self.layers) if upto is None else upto
        act = x
        for i in range(upto):
            layer = self.layers[i]
            p = params.get(self._layer_keys[i], {})
            m = fmask if act.ndim == 3 else None
            if layer.is_rnn:
                act, _, _ = layer.apply_seq(p, act, {}, train, None,
                                            layer.init_carry(x.shape[0]), m)
            elif layer.wants_mask:
                act, _ = layer.apply_with_mask(p, act, {}, train, None, m)
            else:
                act, _ = layer.apply(p, act, {}, train, None)
        return act

    def _loss_fn(self, params: Params, x, y, mask, train: bool):
        """Data loss plus the L1/L2 terms. ``mask`` is both the feature
        and the label mask of a sequence model. Under the bf16 policy
        the layers before the output layer compute in bf16 from cast
        params and input; the output layer, the loss and the L1/L2
        terms use the f32 masters."""
        cdt = compute_dtype(self.conf.dtype)
        params_c = cast_params_for_compute(params, {self._layer_keys[-1]},
                                           cdt)
        xc = cast_input_for_compute(x, cdt)
        feats = self._forward(params_c, xc, train,
                              upto=len(self.layers) - 1, fmask=mask)
        feats = cast_feats_to_f32(feats)
        lmask = mask
        if mask is not None and feats.ndim == 2 and x.ndim == 3:
            # a sequence pooled to [B, C]: the [B, T] mask was consumed
            lmask = None
        out_key = self._layer_keys[-1]
        data_loss = self.layers[-1].compute_loss(
            params.get(out_key, {}), feats, y, lmask, train=train)
        return data_loss + _regularization_penalty(params,
                                                   self._layers_meta)

    # -- the train step ------------------------------------------------
    def loss_and_gradients(self, x, y, mask=None, train: bool = True
                           ) -> Tuple[torch.Tensor, Params]:
        """The loss (L1/L2 terms included) of one batch and its
        gradient for every param, before clipping. Arrays go to the
        network's device first."""
        if self._params is None:
            self.init()
        x, y, mask = self._to_device(x, y, mask)
        keys = [(k, n) for k, p in self._params.items() for n in p]
        with torch.enable_grad():
            loss = self._loss_fn(self._params, x, y, mask, train)
            leaves = torch.autograd.grad(
                loss, [self._params[k][n] for k, n in keys])
        grads: Params = {k: {} for k in self._params}
        for (k, n), g in zip(keys, leaves):
            grads[k][n] = g
        return loss.detach(), grads

    def _train_step(self, x, y, mask) -> torch.Tensor:
        loss, grads = self.loss_and_gradients(x, y, mask)
        grads = _clip_grads(grads, self.conf.max_grad_norm,
                            self.conf.grad_clip_value)
        with torch.no_grad():
            for i, key in enumerate(self._layer_keys):
                if key not in self._params:
                    continue
                self._opt_state[key], upd = self._updaters[i].apply(
                    self._opt_state[key], grads[key], self._step)
                for n, p in self._params[key].items():
                    p.sub_(upd[n])
        self._step += 1
        return loss

    # -- public API ----------------------------------------------------
    def fit(self, data, labels=None, epochs: int = 1, mask=None):
        """Train on ``(data, labels[, mask])`` arrays, or on an iterator
        (a ``DataSetIterator``, list or generator of ``(x, y[, mask])``
        batches), for ``epochs`` passes. Arrays may be numpy or tensors;
        tensors already on the device are not copied."""
        if self._params is None:
            self.init()
        if labels is not None:
            iterator = [(data, labels, mask)]
        else:
            iterator = data
            if not hasattr(iterator, "reset") and \
                    not isinstance(iterator, (list, tuple)):
                # a generator would yield nothing after the first epoch
                iterator = list(iterator)
        for _ in range(epochs):
            for item in iterator:
                x, y, *rest = item
                self._last_loss = self._train_step(
                    x, y, rest[0] if rest else None)
            self._epoch += 1
        return self

    def _to_device(self, x, y=None, mask=None):
        def conv(a):
            if a is None:
                return None
            t = torch.as_tensor(a)
            if t.dtype == torch.float64:
                t = t.float()
            return t.to(self.device)
        return conv(x), conv(y), conv(mask)

    def output(self, x, train: bool = False, mask=None):
        """Forward pass of the whole stack (``mask``: the [B, T]
        feature mask), without gradients."""
        if self._params is None:
            self.init()
        x, _, mask = self._to_device(x, None, mask)
        with torch.no_grad():
            return self._forward(self._params, x, train, fmask=mask)

    @property
    def score_(self) -> float:
        """Last minibatch loss (synchronizes with the device)."""
        return float("nan") if self._last_loss is None \
            else float(self._last_loss)

    def score(self, x=None, y=None, mask=None) -> float:
        """Loss on a dataset, or the last minibatch's."""
        if x is None:
            return self.score_
        x, y, mask = self._to_device(x, y, mask)
        with torch.no_grad():
            return float(self._loss_fn(self._params, x, y, mask, False))

    def num_params(self) -> int:
        return sum(int(t.numel()) for p in self._params.values()
                   for t in p.values())

    def params(self) -> Params:
        return self._params

    def set_params(self, params: Params):
        """Take a ``{layer_key: {name: tensor}}`` dict: the tensors move
        to the device as f32 leaves that require grad. Updater state
        starts fresh."""
        self._params = {
            k: {n: t.detach().to(self.device, torch.float32)
                .clone().requires_grad_(True) for n, t in p.items()}
            for k, p in params.items()}
        self._opt_state = {
            key: self._updaters[i].init_state(self._params[key])
            for i, key in enumerate(self._layer_keys)
            if key in self._params}

    def get_updater_state(self):
        return self._opt_state

    def set_updater_state(self, state):
        """Take updater state in the layout of
        :meth:`get_updater_state` (tensors move to the device)."""
        def to(x):
            if isinstance(x, dict):
                return {k: to(v) for k, v in x.items()}
            return x.detach().to(self.device, torch.float32).clone()
        self._opt_state = to(state)

    # -- not ported yet ------------------------------------------------
    def pretrain(self, *a, **kw):
        _not_ported("layerwise pretraining")

    def pretrain_layer(self, *a, **kw):
        _not_ported("layerwise pretraining")

    def rnn_time_step(self, *a, **kw):
        _not_ported("stateful rnn_time_step")

    def set_listeners(self, *a, **kw):
        _not_ported("training listeners")

    def add_listeners(self, *a, **kw):
        _not_ported("training listeners")
