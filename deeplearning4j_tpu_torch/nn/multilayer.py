"""MultiLayerNetwork: a sequential layer stack with ``fit``, ``output``,
``score`` and ``evaluate`` (counterpart of
``deeplearning4j_tpu/nn/multilayer.py``).

The JAX package compiles one pure train step (forward, loss, backward,
regularization, clipping, updater). Here the step runs eagerly: the
loss is differentiated by autograd (attention layers through the flash
kernels' ``autograd.Function``), gradients are clipped per layer, each
layer's updater computes its updates, and the params are updated in
place under ``torch.no_grad``. Params, gradients, updater state and
the layers' state (batch norm's running stats, updated in place) live
on the network's device: the GPU unless ``device="cpu"`` is asked for.

Randomness follows JAX's key chain with ``random.py``'s threefry:
``PRNGKey(seed)`` split ``len(layers) + 1`` ways at ``init`` (key 0
kept), ``rng, sub = split(rng)`` every step, ``r_fwd, r_out =
split(sub)`` in the loss, and ``split(r_fwd, n)`` one key a layer. So
a network carried from JAX (same seed) draws JAX's dropout masks bit
for bit. Listeners fire where JAX's do: ``iteration_done`` and
``on_timing`` after each step, ``on_epoch_end`` after each pass.

A configuration with a half dtype (``data_type("bfloat16")``) trains
under the bf16 mixed-precision policy of ``precision.py``, as in JAX:
the loss casts every layer's params but the output layer's, and the
input, to bf16, runs the stack up to the output layer in bf16 (the
attention layers through the flash kernels' bf16 legs on the card),
promotes the features back to f32 and takes the output layer's loss
and the L1/L2 terms on the f32 masters. Autograd carries the gradients
back through the casts, so gradients, the updater state and the
updates stay f32. ``output()`` runs uncast, in f32.

Recurrent layers thread a carry through the stack (``_forward_state``'s
``carries``): truncated BPTT (``conf.tbptt_fwd_length``) trains a long
[B, T, C] sequence in chunks with the carries detached at each
boundary, and ``rnn_time_step`` keeps them between calls. With
``conf.remat`` each layer's forward in training runs under
``torch.utils.checkpoint`` (non-reentrant) and is recomputed in the
backward: the layer's new state comes back as a returned value, and
dropout and weight noise draw from the explicit key, so the recompute
sees the same masks. Weight noise perturbs a layer's weights in the
forward, constraints project its params after the update, and
``_make_step_fn(guard=True)`` is the anomaly-guarded step, all where
the JAX package puts them.

Pure half params (``init(dtype=torch.bfloat16)``) follow JAX's dtype
rules leaf by leaf: params and updater state start in bf16, and the
update promotes as JAX's ``p - u`` does (the updates are f32, from the
f32 learning rate), so after step 1 every param is f32 while Adam's
moments are still bf16, and after step 2 the moments are f32 too. A
leaf whose dtype changes is replaced by a new tensor; every f32 leaf is
updated in place. A param that the loss does not reach (a frozen
layer's, ``FrozenLayer``, ``FrozenLayerWithBackprop``) gets a zero
gradient, which still goes through its updater, as in JAX.

Layerwise pretraining (``pretrain``, ``pretrain_layer``) trains each
pretrainable layer (``AutoEncoder``, ``VariationalAutoencoder``) on its
own ``pretrain_loss`` over the inference-mode activations of the layers
below it, as JAX's does (:func:`pretrain_steps`).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import random as R
from ..device import resolve_device
from .conf import MultiLayerConfiguration
from .conf.constraint import apply_constraints
from .global_batch import LocalShard
from . import global_batch as G
from .layers import Layer
from .precision import (cast_feats_to_f32, cast_input_for_compute,
                        cast_params_for_compute, compute_dtype)

Params = Dict[str, Dict[str, torch.Tensor]]


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue "
                              f"A, item {item})")


def pretrain_steps(net, key: str, layer, updater, iterator, epochs: int,
                   features):
    """JAX's layerwise pretraining loop, for a network and a graph
    alike: for each batch of ``iterator`` (read into a list unless it is
    one; ``epochs`` passes), ``features``
    of its input (the frozen inference-mode forward below the layer),
    one split of the network's key, the gradient of the layer's
    ``pretrain_loss`` and its updater's step at a local counter from 0
    (not the network's ``_step``), on the same updater state ``fit``
    continues; the update is ``p - u``, with no clipping,
    regularisation, weight noise or constraint. Only the layer's params
    (``net._params[key]``, in place) and updater state move; the last
    batch's loss becomes the network's score."""
    data = iterator if isinstance(iterator, (list, tuple)) \
        else list(iterator)
    p = net._params[key]
    names = list(p)
    loss = None
    step = 0
    for _ in range(epochs):
        for item in data:
            with torch.no_grad():
                feats = features(net._unpack(item)[0])
            keys = R.split(net._rng)
            net._rng, sub = R.key_at(keys, 0), R.key_at(keys, 1)
            with torch.enable_grad():
                loss = layer.pretrain_loss(p, feats, sub)
                leaves = torch.autograd.grad(loss, [p[n] for n in names],
                                             allow_unused=True)
            grads = {n: torch.zeros_like(p[n]) if g is None else g
                     for n, g in zip(names, leaves)}
            with torch.no_grad():
                net._opt_state[key], upd = updater.apply(
                    net._opt_state[key], grads, step)
                for n in names:
                    p[n] = _subtract(p[n], upd[n])
            loss = loss.detach()
            step += 1
    net._last_loss = loss


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same layout."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    return [tree]


def _finite_ok(loss, grads) -> torch.Tensor:
    """A 0-d bool on the device: the loss and every gradient leaf
    finite (no host sync)."""
    ok = torch.isfinite(loss).all()
    for g in _tree_leaves(grads):
        ok = ok & torch.isfinite(g).all()
    return ok


def _select_ok(ok, new, old):
    """``where(ok, new, old)`` leaf by leaf: the new values bit for bit
    when ``ok`` holds, the old ones otherwise."""
    return _tree_map(lambda n, o: torch.where(ok, n, o), new, old)


def _clone_tree(tree):
    """A copy of a nested dict with every tensor leaf cloned."""
    return _tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                     else t, tree)


def _as_leaves(params: Params) -> Params:
    """A step's new params as the network's leaves (they require
    grad)."""
    return {k: {n: t.requires_grad_(True) for n, t in p.items()}
            for k, p in params.items()}


def _subtract(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``p - u`` as JAX computes it: in place when the result keeps
    ``p``'s dtype (every f32 param), else a new leaf in the promoted
    dtype (a bf16 param beside an f32 update)."""
    if torch.promote_types(p.dtype, u.dtype) == p.dtype:
        return p.sub_(u)
    return (p.detach() - u).requires_grad_(True)


def _detach(carry):
    """A carry (a tensor or a tuple of them) cut from the graph."""
    if isinstance(carry, (tuple, list)):
        return tuple(_detach(c) for c in carry)
    return carry.detach()


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


def _param_dtype(t) -> torch.dtype:
    """The dtype a param or updater-state leaf is kept in: its own when
    it is a half dtype (pure-half networks), f32 otherwise."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.dtype
    return torch.float32


class MultiLayerNetwork:
    """Sequential network; the public surface mirrors the JAX class."""

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.layers: List[Layer] = conf.layers
        self._params: Optional[Params] = None
        self._net_state: Params = {}
        self._opt_state: Optional[Dict[str, Any]] = None
        self._updaters = None
        self._step = 0
        self._epoch = 0
        self.listeners: List = []
        self._last_loss: Optional[torch.Tensor] = None
        self._stored_carries = None
        #: a ParallelWrapper's step while its fit runs (else None)
        self._jit_step = None
        self._rng = R.PRNGKey(conf.seed)
        self._input_kind = conf.input_type.kind if conf.input_type else "ff"
        self._input_shape = conf.input_type.shape if conf.input_type else None

    # -- init ----------------------------------------------------------
    def init(self, dtype=torch.float32) -> "MultiLayerNetwork":
        """Build every layer's shapes, draw its params in ``dtype`` from
        its key of ``split(rng, len(layers) + 1)`` (JAX's params from the
        same seed) and its state, and start JAX's key chain."""
        return self._init(dtype)

    def _init(self, dtype, params: Optional[Params] = None):
        """:meth:`init`, taking ``params`` in place of the draw when they
        are given. The draws run on the network's device."""
        if self._input_shape is None:
            raise ValueError("Configuration needs an input_type to init()")
        if not dtype.is_floating_point:
            raise ValueError(f"params need a floating dtype, got {dtype}")
        shape = tuple(self._input_shape)
        keys = R.split(self._rng, len(self.layers) + 1)
        self._rng = R.key_at(keys, 0)
        drawn: Params = {}
        state: Params = {}
        self._layer_keys = []
        with torch.device(self.device):
            for i, layer in enumerate(self.layers):
                layer.build(shape, self.conf.defaults)
                key = f"layer_{i}" + (f"_{layer.name}" if layer.name else "")
                self._layer_keys.append(key)
                p = (layer.init_params(R.key_at(keys, i + 1), dtype)
                     if params is None else None)
                if p:
                    drawn[key] = p
                st = layer.init_state()
                if st:
                    state[key] = st
                shape = layer.output_shape(shape)
        self._updaters = [l.updater if l.updater is not None
                          else self.conf.updater for l in self.layers]
        self._layers_meta = {
            self._layer_keys[i]: {
                "l1": l.l1, "l2": l.l2, "l1_bias": l.l1_bias,
                "l2_bias": l.l2_bias,
                "bias_params": frozenset(l.bias_param_names())}
            for i, l in enumerate(self.layers)}
        self.set_params(drawn if params is None else params)
        self.set_net_state(state)
        self._step = 0
        return self

    # -- forward -------------------------------------------------------
    def _reshape_input(self, x):
        if self._input_kind == "cnnflat":
            h, w, c = self._input_shape
            return x.reshape(x.shape[0], h, w, c)
        return x

    def _init_carries(self, batch: int, dtype, device):
        """Zero carries, one a layer (None for a layer without one), in
        the input's dtype when it is floating (token input feeds an
        embedding, whose output is f32)."""
        if not dtype.is_floating_point:
            dtype = torch.float32
        return [l.init_carry(batch, dtype, device) if l.is_rnn else None
                for l in self.layers]

    def _forward_state(self, params: Params, net_state: Params, x,
                       train: bool, rng=None, upto: Optional[int] = None,
                       fmask=None, carries=None):
        """Run layers [0, upto) with layer ``i`` on key ``i`` of
        ``split(rng, upto)``, from ``carries`` (zeros without them).
        Returns (activation, new state, new carries). ``fmask`` is the
        [B, T] feature mask, applied while the activation is a
        sequence."""
        upto = len(self.layers) if upto is None else upto
        new_state = dict(net_state)
        new_carries = list(carries) if carries is not None else \
            self._init_carries(x.shape[0], x.dtype, x.device)
        keys = R.split(rng, max(upto, 1)) if rng is not None else None
        act = x
        for i in range(upto):
            r = R.key_at(keys, i) if keys is not None else None
            if self.layers[i].derives_mask:
                # MaskingLayer: its mask from the data joins the chain
                derived = self.layers[i].derive_mask(act)
                if derived is not None:
                    fmask = derived if fmask is None else fmask * derived
            act, st2, c2 = self._layer_step(i, params, net_state, act, train,
                                            r, fmask, new_carries[i])
            if self.layers[i].is_rnn:
                new_carries[i] = c2
            if net_state.get(self._layer_keys[i]):
                new_state[self._layer_keys[i]] = st2
        return act, new_state, new_carries

    def _layer_step(self, i: int, params: Params, net_state: Params, act,
                    train: bool, rng, fmask=None, carry=None):
        """Layer ``i`` on ``act``: (activation, the layer's new state, its
        new carry). Weight noise first, as JAX applies it; under remat in
        training the layer runs in a non-reentrant checkpoint (a
        recurrent or attention layer always, any other layer when it has
        params), and its state and carry come out as returned values."""
        layer, key = self.layers[i], self._layer_keys[i]
        p, st = params.get(key, {}), net_state.get(key, {})
        if layer.weight_noise is not None:
            p = layer._maybe_weight_noise(p, train, rng)
        remat = self.conf.remat and train
        m = fmask if act.ndim == 3 else None
        if layer.is_rnn:
            if carry is None:
                carry = layer.init_carry(act.shape[0], act.dtype if
                                         act.is_floating_point()
                                         else torch.float32, act.device)

            def seq(p_, a_, s_, c_, m_):
                return layer.apply_seq(p_, a_, s_, train, rng, c_, m_)
            if remat:
                return checkpoint(seq, p, act, st, carry, m,
                                  use_reentrant=False)
            return seq(p, act, st, carry, m)
        if layer.wants_mask:
            return (*layer.apply_with_mask(p, act, st, train, rng, m), None)

        def fwd(p_, a_, s_):
            return layer.apply(p_, a_, s_, train, rng)
        if remat and layer.has_params:
            return (*checkpoint(fwd, p, act, st, use_reentrant=False), None)
        return (*fwd(p, act, st), None)

    def _forward(self, params: Params, x, train: bool,
                 upto: Optional[int] = None, fmask=None):
        """The activation of layers [0, upto) on the network's layer
        state, without dropout."""
        return self._forward_state(params, self._net_state, x, train, None,
                                   upto, fmask)[0]

    def _loss_fn(self, params: Params, net_state: Params, x, y, mask,
                 train: bool, rng=None):
        """Data loss plus the L1/L2 terms, and the layers' new state."""
        return self._loss_carries(params, net_state, x, y, mask, train,
                                  rng)[:2]

    def _loss_carries(self, params: Params, net_state: Params, x, y, mask,
                      train: bool, rng=None, carries=None):
        """Data loss plus the L1/L2 terms, the layers' new state and the
        new carries. ``mask`` is both the feature and the label mask of
        a sequence model. Under the bf16 policy the layers before the
        output layer compute in bf16 from cast params and input; the
        output layer, the loss and the L1/L2 terms use the f32
        masters."""
        r_fwd = r_out = None
        if rng is not None:
            keys = R.split(rng)
            r_fwd, r_out = R.key_at(keys, 0), R.key_at(keys, 1)
        cdt = compute_dtype(self.conf.dtype)
        params_c = cast_params_for_compute(params, {self._layer_keys[-1]},
                                           cdt)
        xc = cast_input_for_compute(x, cdt)
        feats, new_state, new_carries = self._forward_state(
            params_c, net_state, xc, train, r_fwd,
            upto=len(self.layers) - 1, fmask=mask, carries=carries)
        feats = cast_feats_to_f32(feats)
        lmask = mask
        if mask is not None and feats.ndim == 2 and x.ndim == 3:
            # a sequence pooled to [B, C]: the [B, T] mask was consumed
            lmask = None
        out_key = self._layer_keys[-1]
        data_loss = self.layers[-1].compute_loss(
            params.get(out_key, {}), feats, y, lmask, train=train, rng=r_out)
        # a rank of a data-parallel step carries its share of the
        # penalty (nn/global_batch.py)
        return (data_loss + G.share(_regularization_penalty(
            params, self._layers_meta)), new_state, new_carries)

    # -- the train step ------------------------------------------------
    def loss_and_gradients(self, x, y, mask=None, train: bool = True,
                           rng=None) -> Tuple[torch.Tensor, Params]:
        """The loss (L1/L2 terms included) of one batch and its
        gradient for every param, before clipping, with dropout drawn
        from ``rng`` (none without one). Arrays go to the network's
        device first; the network's params and state do not change."""
        if self._params is None:
            self.init()
        return self._step_grads(*self._to_device(x, y, mask), train, rng)[:2]

    def _step_grads(self, x, y, mask, train: bool, rng):
        """Loss, gradients and the layers' new state of one batch
        already on the device."""
        return self._grads(self._params, self._net_state, x, y, mask, train,
                           rng)[:3]

    def _grads(self, params: Params, net_state: Params, x, y, mask,
               train: bool, rng, carries=None):
        """Loss, gradients (leaves of ``params`` that require grad), the
        layers' new state and the new carries of one batch. A param the
        loss does not reach (a frozen layer's, JAX's ``stop_gradient``)
        gets zeros; autograd builds no backward for it."""
        keys = [(k, n) for k, p in params.items() for n in p]
        with torch.enable_grad():
            loss, new_state, new_carries = self._loss_carries(
                params, net_state, x, y, mask, train, rng, carries)
            leaves = torch.autograd.grad(
                loss, [params[k][n] for k, n in keys], allow_unused=True) \
                if keys and loss.requires_grad else [None] * len(keys)
        grads: Params = {k: {} for k in params}
        for (k, n), g in zip(keys, leaves):
            grads[k][n] = torch.zeros_like(params[k][n]) if g is None else g
        return loss.detach(), grads, new_state, new_carries

    def _train_step(self, x, y, mask, rng) -> torch.Tensor:
        """One step on a batch already on the device."""
        loss, grads, new_state = self._step_grads(x, y, mask, True, rng)
        self.apply_gradients(grads, new_state)
        return loss

    def apply_gradients(self, grads: Params, new_state: Params = None,
                        constrain: bool = True):
        """The step's second half: clip ``grads``, let each layer's
        updater turn them into updates, subtract those from the params,
        project them by the layer's constraints (``constrain``), store
        the layers' new state and count the step."""
        grads = _clip_grads(grads, self.conf.max_grad_norm,
                            self.conf.grad_clip_value)
        with torch.no_grad():
            for i, key in enumerate(self._layer_keys):
                if key not in self._params:
                    continue
                self._opt_state[key], upd = self._updaters[i].apply(
                    self._opt_state[key], grads[key], self._step)
                p = self._params[key]
                for n, t in p.items():
                    p[n] = _subtract(t, upd[n])
                layer = self.layers[i]
                if constrain and layer.constraints:
                    for n, t in apply_constraints(
                            layer.constraints, p,
                            layer.bias_param_names()).items():
                        if t is not p[n]:
                            p[n].copy_(t)
            # in place, so a captured graph keeps reading the live stats
            for key, st in (new_state or {}).items():
                for n, t in st.items():
                    self._net_state[key][n].copy_(t)
        self._step += 1

    def _make_step_fn(self, guard: bool = False, grads_fn=None):
        """The pure train step: ``step_fn(params, opt_state, net_state,
        step, x, y, mask, rng) -> (params, opt_state, net_state, loss)``,
        new tensors all, the inputs left as they were (JAX's
        ``_make_step_fn``). With ``guard`` it also returns ``ok`` (a 0-d
        bool on the device: the loss and every gradient finite) and,
        where ``ok`` is False, selects the OLD params, updater state and
        layer state with ``torch.where``: a NaN or Inf batch changes
        nothing, the host never waits, and over clean data the guarded
        step's results are the unguarded ones bit for bit.

        ``grads_fn(leaves, net_state, x, y, mask, rng) -> (loss, grads,
        new_net_state)`` replaces the step's first half (the network's
        own loss and gradients by default): the data-parallel dense step
        (``parallel.jit_sharded_step``) passes its own, which sums the
        ranks' gradients before the update half runs."""
        if grads_fn is None:
            def grads_fn(leaves, net_state, x, y, mask, rng):
                return self._grads(leaves, net_state, x, y, mask, True,
                                   rng)[:3]

        def step_fn(params, opt_state, net_state, step, x, y, mask, rng):
            leaves = _tree_map(lambda t: t.detach().requires_grad_(True),
                               params)
            loss, grads, new_net_state = grads_fn(leaves, net_state, x, y,
                                                  mask, rng)
            if guard:
                ok = _finite_ok(loss, grads)
            grads = _clip_grads(grads, self.conf.max_grad_norm,
                                self.conf.grad_clip_value)
            new_opt, new_params = {}, {}
            with torch.no_grad():
                for i, key in enumerate(self._layer_keys):
                    if key not in params:
                        continue
                    st, upd = self._updaters[i].apply(
                        _clone_tree(opt_state[key]), grads[key], step)
                    new_opt[key] = st
                    new_p = {n: t.detach() - upd[n]
                             for n, t in params[key].items()}
                    layer = self.layers[i]
                    if layer.constraints:
                        new_p = apply_constraints(layer.constraints, new_p,
                                                  layer.bias_param_names())
                    new_params[key] = new_p
                new_net_state = {k: {n: t.detach() for n, t in st.items()}
                                 for k, st in new_net_state.items()}
                if guard:
                    detached = _tree_map(torch.Tensor.detach, params)
                    return (_select_ok(ok, new_params, detached),
                            _select_ok(ok, new_opt, opt_state),
                            _select_ok(ok, new_net_state, net_state),
                            loss, ok)
            return new_params, new_opt, new_net_state, loss

        return step_fn

    def _fit_tbptt(self, x, y, m, tbptt: int):
        """Truncated BPTT over one [B, T, C] batch: chunks of ``tbptt``
        steps, each one train step from the carries the last chunk left
        (detached at the boundary), a ragged tail padded to the chunk
        length with mask 0, a key split off the chain for every chunk,
        every chunk's updater at the batch's step, and no constraints
        (JAX's ``_fit_tbptt`` and its chunk step). Returns the last
        chunk's loss."""
        T = x.shape[1]
        m = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device) \
            if m is None else m
        carries = self._init_carries(x.shape[0], x.dtype, x.device)
        loss = None
        for t0 in range(0, T, tbptt):
            xc = x[:, t0:t0 + tbptt]
            yc = y[:, t0:t0 + tbptt] if y.ndim == 3 else y
            mc = m[:, t0:t0 + tbptt]
            pad = tbptt - xc.shape[1]
            if pad:
                xc = torch.nn.functional.pad(xc, (0, 0, 0, pad))
                if yc.ndim == 3:
                    yc = torch.nn.functional.pad(yc, (0, 0, 0, pad))
                mc = torch.nn.functional.pad(mc, (0, pad))
            keys = R.split(self._rng)
            self._rng, sub = R.key_at(keys, 0), R.key_at(keys, 1)
            carries = [None if c is None else _detach(c) for c in carries]
            loss, grads, new_state, carries = self._grads(
                self._params, self._net_state, xc, yc, mc, True, sub,
                carries)
            step = self._step
            self.apply_gradients(grads, new_state, constrain=False)
            self._step = step
        return loss

    # -- public API ----------------------------------------------------
    @staticmethod
    def _unpack(item):
        if isinstance(item, (tuple, list)):
            return (item[0], item[1], item[2] if len(item) > 2 else None)
        return (item.features, item.labels,
                getattr(item, "labels_mask", None))

    def fit(self, data, labels=None, epochs: int = 1, mask=None):
        """Train on ``(data, labels[, mask])`` arrays, or on an iterator
        (a ``DataSetIterator``, list or generator of ``(x, y[, mask])``
        batches or ``DataSet``s), for ``epochs`` passes. Arrays may be
        numpy or tensors; tensors already on the device are not
        copied."""
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
        tbptt = self.conf.tbptt_fwd_length
        for _ in range(epochs):
            for item in iterator:
                x, y, m = self._unpack(item)
                t0 = time.perf_counter()
                keys = R.split(self._rng)
                self._rng, sub = R.key_at(keys, 0), R.key_at(keys, 1)
                xd, yd, md = self._to_device(x, y, m)
                if tbptt and xd.ndim == 3 and xd.shape[1] > tbptt:
                    # JAX's condition: only 3-D input longer than a chunk
                    self._last_loss = self._fit_tbptt(xd, yd, md, tbptt)
                    self._step += 1
                elif self._jit_step is not None:
                    # a ParallelWrapper's step installed for its fit
                    # (JAX's seam): the pure step's signature
                    params, self._opt_state, self._net_state, loss = \
                        self._jit_step(self._params, self._opt_state,
                                       self._net_state, self._step, xd,
                                       yd, md, sub)
                    self._params = _as_leaves(params)
                    self._step += 1
                    self._last_loss = loss
                else:
                    self._last_loss = self._train_step(xd, yd, md, sub)
                dur = time.perf_counter() - t0
                for lst in self.listeners:
                    lst.iteration_done(self, self._step, self._epoch)
                    if hasattr(lst, "on_timing"):
                        lst.on_timing(self, dur, len(x))
            self._epoch += 1
            for lst in self.listeners:
                if hasattr(lst, "on_epoch_end"):
                    lst.on_epoch_end(self)
        return self

    def _to_device(self, x, y=None, mask=None):
        """The arrays as tensors on the network's device (a
        ``LocalShard``, a rank's rows of a global array, keeps its
        wrapper around its moved rows)."""
        def conv(a):
            if a is None:
                return None
            if isinstance(a, LocalShard):
                return a.map(conv)
            t = torch.as_tensor(a)
            if t.dtype == torch.float64:
                t = t.float()
            return t.to(self.device)
        x = conv(x)
        x = x.map(self._reshape_input) if isinstance(x, LocalShard) \
            else self._reshape_input(x)
        return x, conv(y), conv(mask)

    def output(self, x, train: bool = False, mask=None):
        """Forward pass of the whole stack (``mask``: the [B, T]
        feature mask), without gradients or dropout; ``train=True``
        normalizes with batch statistics."""
        if self._params is None:
            self.init()
        x, _, mask = self._to_device(x, None, mask)
        with torch.no_grad():
            return self._forward(self._params, x, train, fmask=mask)

    def feed_forward(self, x, train: bool = False) -> List[torch.Tensor]:
        """The input and every layer's activation, in order."""
        if self._params is None:
            self.init()
        x, _, _ = self._to_device(x)
        acts = [x]
        with torch.no_grad():
            for i in range(len(self.layers)):
                acts.append(self._layer_step(i, self._params,
                                             self._net_state, acts[-1],
                                             train, None)[0])
        return acts

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
            return float(self._loss_fn(self._params, self._net_state, x, y,
                                       mask, False)[0])

    def evaluate(self, iterator):
        """Classification evaluation over an iterator of ``(x, y[,
        mask])`` batches or ``DataSet``s: an ``eval.Evaluation``."""
        from ..eval import Evaluation
        ev = Evaluation()
        for item in iterator:
            x, y, m = self._unpack(item)
            out = self.output(x)
            ev.eval(np.asarray(y), out.float().cpu().numpy(),
                    None if m is None else np.asarray(m))
        return ev

    # -- introspection -------------------------------------------------
    def num_params(self) -> int:
        return sum(int(t.numel()) for p in self._params.values()
                   for t in p.values())

    def params(self) -> Params:
        return self._params

    def set_params(self, params: Params):
        """Take a ``{layer_key: {name: tensor}}`` dict: the tensors move
        to the device as leaves that require grad, f32 unless they are
        half (bf16 or fp16) tensors, which keep their dtype. Updater
        state starts fresh, in the params' dtypes."""
        self._params = {
            k: {n: t.detach().to(self.device, _param_dtype(t))
                .clone().requires_grad_(True) for n, t in p.items()}
            for k, p in params.items()}
        self._opt_state = {
            key: self._updaters[i].init_state(self._params[key])
            for i, key in enumerate(self._layer_keys)
            if key in self._params}

    def get_net_state(self) -> Params:
        """The layers' state (batch norm's running ``mean``/``var``)."""
        return self._net_state

    def set_net_state(self, state: Params):
        """Take layer state in the layout of :meth:`get_net_state`
        (tensors move to the device as f32 copies)."""
        self._net_state = {
            k: {n: t.detach().to(self.device, torch.float32).clone()
                for n, t in st.items()} for k, st in state.items()}

    def get_updater_state(self):
        return self._opt_state

    def set_updater_state(self, state):
        """Take updater state in the layout of
        :meth:`get_updater_state` (tensors move to the device, f32 but
        for half leaves, which keep their dtype)."""
        def to(x):
            if isinstance(x, dict):
                return {k: to(v) for k, v in x.items()}
            return x.detach().to(self.device, _param_dtype(x)).clone()
        self._opt_state = to(state)

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)
        return self

    def summary(self) -> str:
        """The JAX package's table: each layer's output shape and param
        count, then the total."""
        if self._params is None:
            self.init()
        lines = ["=" * 70,
                 f"{'idx':<4}{'layer':<22}{'out shape':<20}{'params':<10}",
                 "-" * 70]
        shape = tuple(self._input_shape)
        for i, l in enumerate(self.layers):
            out = l.output_shape(shape) if l._built else "?"
            lines.append(f"{i:<4}{type(l).__name__:<22}{str(out):<20}"
                         f"{l.n_params():<10}")
            shape = out if isinstance(out, tuple) else shape
        lines.append("-" * 70)
        lines.append(f"Total params: {self.num_params()}")
        lines.append("=" * 70)
        return "\n".join(lines)

    def clone(self, device=None) -> "MultiLayerNetwork":
        """A copy on ``device`` (this network's by default) built from
        the configuration's JSON, with a copy of the params and the
        layer state and, as in JAX, a fresh updater state and key
        chain."""
        m = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(self.conf.to_json()),
            device=self.device if device is None else device)
        if self._params is not None:
            m._init(torch.float32, self._params)
            m.set_net_state(self._net_state)
        return m

    # -- stateful recurrent inference -----------------------------------
    def rnn_time_step(self, x):
        """Run a [B, T, C] segment (a [B, C] float array is one step;
        [B, T] integers are tokens for an embedding front-end) from the
        carries the last call left, and keep the new ones. Returns the
        output, [B, O] for a single step."""
        if self._params is None:
            self.init()
        x, _, _ = self._to_device(x)
        squeeze = x.ndim == 2 and x.is_floating_point()
        if squeeze:
            x = x[:, None, :]
        if self._stored_carries is None:
            self._stored_carries = self._init_carries(x.shape[0], x.dtype,
                                                      x.device)
        with torch.no_grad():
            out, _, self._stored_carries = self._forward_state(
                self._params, self._net_state, x, False,
                carries=self._stored_carries)
        return out[:, 0] if squeeze and out.ndim == 3 else out

    def rnn_clear_previous_state(self):
        """Forget the carries ``rnn_time_step`` keeps."""
        self._stored_carries = None

    # -- layerwise pretraining -----------------------------------------
    def pretrain(self, iterator, epochs: int = 1):
        """Pretrain every pretrainable layer in stack order on the
        activations of the layers below it. A generator is read once
        into a list, so the second layer still sees its batches."""
        if self._params is None:
            self.init()
        if not hasattr(iterator, "reset") and \
                not isinstance(iterator, (list, tuple)):
            iterator = list(iterator)
        for i, layer in enumerate(self.layers):
            if layer.is_pretrain_layer:
                self.pretrain_layer(i, iterator, epochs=epochs)
        return self

    def pretrain_layer(self, i: int, iterator, epochs: int = 1):
        """Pretrain layer ``i`` on its unsupervised loss over the
        inference-mode activations of layers [0, i); only its params
        and updater state move (:func:`pretrain_steps`)."""
        if self._params is None:
            self.init()
        layer = self.layers[i]
        if not layer.is_pretrain_layer:
            raise ValueError(f"layer {i} ({type(layer).__name__}) is not "
                             "pretrainable")

        def features(x):
            return self._forward(self._params, self._to_device(x)[0], False,
                                 upto=i)
        pretrain_steps(self, self._layer_keys[i], layer, self._updaters[i],
                       iterator, epochs, features)
        return self
