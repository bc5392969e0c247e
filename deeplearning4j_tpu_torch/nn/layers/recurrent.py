"""Recurrent layers (counterpart of
``deeplearning4j_tpu/nn/layers/recurrent.py``): LSTM, GravesLSTM
(peepholes), GRU, SimpleRnn, the Bidirectional wrapper and
GravesBidirectionalLSTM, LastTimeStep, MaskZeroLayer, the sequence
embedding, RnnOutputLayer, RnnLossLayer and RepeatVector.

Sequences are [B, T, C], as in JAX. The input projection of every
timestep is hoisted out of the recurrence as one [B*T, C] x [C, G*H]
product; time then runs as a Python loop whose step is the small
recurrent product ``h @ U`` (``torch.matmul``) and the gate math, where
JAX runs the same step in ``lax.scan``. Autograd carries the gradient
back through the loop. The gate layouts are JAX's: ``[i|f|g|o]`` for
the LSTMs (forget-gate bias 1.0), ``[z|r|h]`` for the GRU, so carried
weights need no reordering. cuDNN's fused LSTM is not used: its gate
layout, peepholes and masking differ.

A [B, T] mask (1 for a real step) holds the carried state at masked
steps and zeroes their output, as JAX's ``_mask_step`` does. Every
recurrent layer has the carry protocol: ``init_carry(batch, dtype,
device)`` and ``apply_seq(params, x, state, train, rng, carry, mask) ->
(out, state, carry)``, which TBPTT and ``rnn_time_step`` thread
through the network.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch

from ... import activations as A
from ... import losses as L
from ... import random as R
from ...weightinit import init_weights, subkeys
from ..functional import matmul
from . import DenseLayer, Layer, LossLayer, register


def _mask_step(mask_t, new_val, old_val):
    """Hold the carried state where the step's mask is 0."""
    return torch.where(mask_t[:, None] > 0, new_val, old_val)


def _scan(step, carry, xz, mask):
    """Run ``step(carry, z_t) -> (carry, h_t)`` over the time axis of
    ``xz`` [B, T, G]; with a mask, masked steps hold every carried
    tensor and emit zeros. Returns (out [B, T, H], carry)."""
    outs = []
    m = None if mask is None else mask.to(xz.dtype)
    for t in range(xz.shape[1]):
        new, h = step(carry, xz[:, t])
        if m is not None:
            m_t = m[:, t]
            new = tuple(_mask_step(m_t, n, o) for n, o in zip(new, carry))
            h = _mask_step(m_t, h, carry[0]) * m_t[:, None]
        carry = new
        outs.append(h)
    return torch.stack(outs, 1), carry


class BaseRecurrentLayer(Layer):
    """A recurrent layer over [B, T, n_in] with n_out units."""

    is_rnn = True

    def __init__(self, n_out: int = None, n_in: Optional[int] = None, **kw):
        super().__init__(**kw)
        self.n_in = n_in
        self.n_out = int(n_out)

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        if self.n_in is None:
            self.n_in = int(input_shape[-1])

    def output_shape(self, input_shape):
        return (input_shape[0], self.n_out)

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        """h [B, n_out] (an LSTM's is (h, c))."""
        return torch.zeros((batch, self.n_out), dtype=dtype, device=device)

    def _project(self, params, x):
        """The hoisted input projection of every timestep, [B, T, G]."""
        B, T, _ = x.shape
        return (matmul(x.reshape(B * T, -1), params["W"]).reshape(B, T, -1)
                + params["b"])

    def apply_seq(self, params, x, state, train, rng, carry, mask):
        """x [B, T, C], the layer's carry and an optional [B, T] mask:
        (out [B, T, n_out], state, new carry)."""
        raise NotImplementedError

    def apply(self, params, x, state, train, rng):
        out, st, _ = self.apply_seq(
            params, x, state, train, rng,
            self.init_carry(x.shape[0], x.dtype, x.device), None)
        return out, st

    def _extra_json(self):
        return {"n_out": self.n_out, "n_in": self.n_in}


@register
class LSTM(BaseRecurrentLayer):
    """LSTM without peepholes: gates ``[i|f|g|o]`` of ``x W + h U + b``,
    ``c = f c' + i g``, ``h = o act(c)``; the carry is (h, c)."""

    kind = "lstm"

    def __init__(self, n_out: int = None, forget_gate_bias_init: float = 1.0,
                 gate_activation="sigmoid", **kw):
        kw.setdefault("activation", "tanh")
        super().__init__(n_out=n_out, **kw)
        self.forget_gate_bias_init = float(forget_gate_bias_init)
        self.gate_activation = A.get(gate_activation)

    def param_shapes(self):
        H = self.n_out
        return {"W": (self.n_in, 4 * H), "U": (H, 4 * H), "b": (4 * H,)}

    def init_params(self, key, dtype=torch.float32):
        H = self.n_out
        kW, kU = subkeys(key, 2)
        b = torch.zeros((4 * H,), dtype=dtype)
        b[H:2 * H] = self.forget_gate_bias_init
        return {"W": init_weights(kW, (self.n_in, 4 * H), self.n_in,
                                  4 * H, self.weight_init, dtype),
                "U": init_weights(kU, (H, 4 * H), H, 4 * H,
                                  self.weight_init, dtype),
                "b": b}

    def init_carry(self, batch, dtype=torch.float32, device=None):
        z = torch.zeros((batch, self.n_out), dtype=dtype, device=device)
        return (z, z.clone())

    def _cell(self, params):
        H, U = self.n_out, params["U"]
        ga, act = self.gate_activation, self.activation

        def step(carry, z_t):
            h_prev, c_prev = carry
            z = z_t + matmul(h_prev, U)
            i, f = ga(z[:, :H]), ga(z[:, H:2 * H])
            g, o = act(z[:, 2 * H:3 * H]), ga(z[:, 3 * H:])
            c = f * c_prev + i * g
            h = o * act(c)
            return (h, c), h
        return step

    def apply_seq(self, params, x, state, train, rng, carry, mask):
        x = self._maybe_dropout(x, train, rng)
        out, carry = _scan(self._cell(params), tuple(carry),
                           self._project(params, x), mask)
        return out, state, carry

    def _extra_json(self):
        d = super()._extra_json()
        d["forget_gate_bias_init"] = self.forget_gate_bias_init
        d["gate_activation"] = self.gate_activation.to_json()
        return d


@register
class GravesLSTM(LSTM):
    """Peephole LSTM: ``p = [p_i|p_f|p_o]`` feeds c' into the input and
    forget gates and c into the output gate."""

    kind = "graveslstm"

    def param_shapes(self):
        sh = super().param_shapes()
        sh["p"] = (3 * self.n_out,)
        return sh

    def init_params(self, key, dtype=torch.float32):
        p = super().init_params(key, dtype)
        p["p"] = torch.zeros((3 * self.n_out,), dtype=dtype)
        return p

    def _cell(self, params):
        H, U, peep = self.n_out, params["U"], params["p"]
        p_i, p_f, p_o = peep[:H], peep[H:2 * H], peep[2 * H:]
        ga, act = self.gate_activation, self.activation

        def step(carry, z_t):
            h_prev, c_prev = carry
            z = z_t + matmul(h_prev, U)
            i = ga(z[:, :H] + c_prev * p_i)
            f = ga(z[:, H:2 * H] + c_prev * p_f)
            g = act(z[:, 2 * H:3 * H])
            c = f * c_prev + i * g
            o = ga(z[:, 3 * H:] + c * p_o)
            h = o * act(c)
            return (h, c), h
        return step


@register
class GRU(BaseRecurrentLayer):
    """Gated recurrent unit, gates ``[z|r|h]`` over 3H columns;
    ``h = z h' + (1 - z) hh``. ``reset_after=False`` is Cho et al.'s
    form (the reset gate scales h' before its product with U's h
    columns); ``reset_after=True`` Keras's (a recurrent bias ``b_rec``,
    the reset gate applied after the product). The carry is h."""

    kind = "gru"

    def __init__(self, n_out: int = None, gate_activation="sigmoid",
                 reset_after: bool = False, **kw):
        kw.setdefault("activation", "tanh")
        super().__init__(n_out=n_out, **kw)
        self.gate_activation = A.get(gate_activation)
        self.reset_after = bool(reset_after)

    def param_shapes(self):
        H = self.n_out
        sh = {"W": (self.n_in, 3 * H), "U": (H, 3 * H), "b": (3 * H,)}
        if self.reset_after:
            sh["b_rec"] = (3 * H,)
        return sh

    def init_params(self, key, dtype=torch.float32):
        H = self.n_out
        kW, kU = subkeys(key, 2)
        p = {"W": init_weights(kW, (self.n_in, 3 * H), self.n_in,
                               3 * H, self.weight_init, dtype),
             "U": init_weights(kU, (H, 3 * H), H, 3 * H,
                               self.weight_init, dtype),
             "b": torch.zeros((3 * H,), dtype=dtype)}
        if self.reset_after:
            p["b_rec"] = torch.zeros((3 * H,), dtype=dtype)
        return p

    def _cell(self, params):
        H, U = self.n_out, params["U"]
        ga, act = self.gate_activation, self.activation

        def step(carry, xz):
            h_prev, = carry
            if self.reset_after:
                rz = matmul(h_prev, U) + params["b_rec"]
                z = ga(xz[:, :H] + rz[:, :H])
                r = ga(xz[:, H:2 * H] + rz[:, H:2 * H])
                hh = act(xz[:, 2 * H:] + r * rz[:, 2 * H:])
            else:
                zr = matmul(h_prev, U[:, :2 * H])
                z = ga(xz[:, :H] + zr[:, :H])
                r = ga(xz[:, H:2 * H] + zr[:, H:])
                hh = act(xz[:, 2 * H:] + matmul(r * h_prev, U[:, 2 * H:]))
            h = z * h_prev + (1.0 - z) * hh
            return (h,), h
        return step

    def apply_seq(self, params, x, state, train, rng, carry, mask):
        x = self._maybe_dropout(x, train, rng)
        out, (h,) = _scan(self._cell(params), (carry,),
                          self._project(params, x), mask)
        return out, state, h

    def _extra_json(self):
        d = super()._extra_json()
        d["gate_activation"] = self.gate_activation.to_json()
        d["reset_after"] = self.reset_after
        return d


@register
class SimpleRnn(BaseRecurrentLayer):
    """``h_t = act(x_t W + h_{t-1} U + b)``; the carry is h."""

    kind = "simplernn"

    def __init__(self, n_out: int = None, **kw):
        kw.setdefault("activation", "tanh")
        super().__init__(n_out=n_out, **kw)

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "U": (self.n_out, self.n_out),
                "b": (self.n_out,)}

    def init_params(self, key, dtype=torch.float32):
        kW, kU = subkeys(key, 2)
        return {"W": init_weights(kW, (self.n_in, self.n_out),
                                  self.n_in, self.n_out, self.weight_init,
                                  dtype),
                "U": init_weights(kU, (self.n_out, self.n_out),
                                  self.n_out, self.n_out, self.weight_init,
                                  dtype),
                "b": torch.full((self.n_out,), self.bias_init, dtype=dtype)}

    def apply_seq(self, params, x, state, train, rng, carry, mask):
        x = self._maybe_dropout(x, train, rng)
        U, act = params["U"], self.activation

        def step(c, z_t):
            h = act(z_t + matmul(c[0], U))
            return (h,), h
        out, (h,) = _scan(step, (carry,), self._project(params, x), mask)
        return out, state, h


class _Wrapper(Layer):
    """A layer around a recurrent layer (``layer``, or its JSON dict)."""

    is_rnn = True

    def __init__(self, layer=None, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        if isinstance(layer, dict):
            from . import from_json
            layer = from_json(layer)
        self.layer = layer

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        self.layer.build(input_shape, defaults)

    def param_shapes(self):
        return self.layer.param_shapes()

    def init_params(self, key, dtype=torch.float32):
        return self.layer.init_params(key, dtype)

    def init_carry(self, batch, dtype=torch.float32, device=None):
        return self.layer.init_carry(batch, dtype, device)

    def apply(self, params, x, state, train, rng):
        out, st, _ = self.apply_seq(
            params, x, state, train, rng,
            self.init_carry(x.shape[0], x.dtype, x.device), None)
        return out, st

    def _extra_json(self):
        return {"layer": self.layer.to_json()}


@register
class Bidirectional(_Wrapper):
    """The wrapped layer forward in time and a copy of it backward (each
    sequence reversed within its mask's length), merged by ``concat``,
    ``add``, ``mul`` or ``average``. Params are the two layers' with
    ``f_`` and ``b_`` prefixes; the carry is (forward's, backward's)."""

    kind = "bidirectional"

    MODES = ("concat", "add", "mul", "average")

    def __init__(self, layer=None, mode: str = "concat", **kw):
        super().__init__(layer=layer, **kw)
        mode = mode.lower()
        if mode not in self.MODES:
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.layer_bwd = copy.deepcopy(self.layer)

    @property
    def n_out(self):
        return self.layer.n_out * (2 if self.mode == "concat" else 1)

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        self.layer_bwd.build(input_shape, defaults)

    def param_shapes(self):
        fwd = self.layer.param_shapes()
        return {**{f"f_{k}": v for k, v in fwd.items()},
                **{f"b_{k}": v for k, v in fwd.items()}}

    def init_params(self, key, dtype=torch.float32):
        kf, kb = subkeys(key, 2)
        pf = self.layer.init_params(kf, dtype)
        pb = self.layer_bwd.init_params(kb, dtype)
        return {**{f"f_{k}": v for k, v in pf.items()},
                **{f"b_{k}": v for k, v in pb.items()}}

    def init_carry(self, batch, dtype=torch.float32, device=None):
        return (self.layer.init_carry(batch, dtype, device),
                self.layer_bwd.init_carry(batch, dtype, device))

    @staticmethod
    def _reverse_seq(x, mask):
        """Reverse along time; with a mask, each sequence within its
        length (the padding stays in place)."""
        if mask is None:
            return torch.flip(x, (1,))
        T = x.shape[1]
        lengths = (mask > 0).sum(1)                          # [B]
        idx = torch.arange(T, device=x.device)[None, :]
        src = lengths[:, None] - 1 - idx
        src = torch.where(src >= 0, src, idx)
        if x.ndim == 3:
            src = src[:, :, None].expand(-1, -1, x.shape[2])
        return torch.gather(x, 1, src)

    def apply_seq(self, params, x, state, train, rng, carry, mask):
        pf = {k[2:]: v for k, v in params.items() if k.startswith("f_")}
        pb = {k[2:]: v for k, v in params.items() if k.startswith("b_")}
        cf, cb = carry
        rf = rb = None
        if rng is not None:
            keys = R.split(rng)
            rf, rb = R.key_at(keys, 0), R.key_at(keys, 1)
        out_f, st, cf2 = self.layer.apply_seq(pf, x, state, train, rf, cf,
                                              mask)
        out_b, _, cb2 = self.layer_bwd.apply_seq(
            pb, self._reverse_seq(x, mask), state, train, rb, cb, mask)
        out_b = self._reverse_seq(out_b, mask)
        if self.mode == "concat":
            out = torch.cat([out_f, out_b], -1)
        elif self.mode == "add":
            out = out_f + out_b
        elif self.mode == "mul":
            out = out_f * out_b
        else:
            out = 0.5 * (out_f + out_b)
        return out, st, (cf2, cb2)

    def output_shape(self, input_shape):
        return (input_shape[0], self.n_out)

    def _extra_json(self):
        return {"layer": self.layer.to_json(), "mode": self.mode}


@register
class GravesBidirectionalLSTM(Bidirectional):
    """A Bidirectional GravesLSTM, merged by ``add`` by default."""

    kind = "gravesbidirectionallstm"

    def __init__(self, n_out: int = None, mode: str = "add", layer=None,
                 **kw):
        if layer is None:
            wrapped = {k: kw.pop(k) for k in ("activation", "weight_init")
                       if k in kw}
            layer = GravesLSTM(n_out=n_out, **wrapped)
        super().__init__(layer=layer, mode=mode, **kw)


@register
class LastTimeStep(_Wrapper):
    """The wrapped layer's output at each sequence's last real step
    (the mask's length, or T): [B, T, C] -> [B, C]."""

    kind = "lasttimestep"

    def apply_seq(self, params, x, state, train, rng, carry, mask):
        out, st, c = self.layer.apply_seq(params, x, state, train, rng,
                                          carry, mask)
        if mask is None:
            return out[:, -1, :], st, c
        idx = torch.clamp((mask > 0).sum(1) - 1, min=0)
        last = torch.gather(out, 1, idx[:, None, None].expand(
            -1, 1, out.shape[-1]))[:, 0, :]
        return last, st, c

    def output_shape(self, input_shape):
        return (self.layer.output_shape(input_shape)[-1],)


@register
class MaskZeroLayer(_Wrapper):
    """Derives a mask from the data, 0 at the timesteps whose every
    feature equals ``mask_value``, and runs the wrapped layer under it
    (times the incoming mask)."""

    kind = "maskzero"

    def __init__(self, layer=None, mask_value: float = 0.0, **kw):
        super().__init__(layer=layer, **kw)
        self.mask_value = float(mask_value)

    def apply_seq(self, params, x, state, train, rng, carry, mask):
        derived = (x != self.mask_value).any(-1).to(x.dtype)
        mask = derived if mask is None else mask * derived
        return self.layer.apply_seq(params, x, state, train, rng, carry, mask)

    def output_shape(self, input_shape):
        return self.layer.output_shape(input_shape)

    def _extra_json(self):
        return {"layer": self.layer.to_json(), "mask_value": self.mask_value}


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

    def init_params(self, key, dtype=torch.float32):
        p = {"W": init_weights(key, (self.n_in, self.n_out), self.n_in,
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

    def _extra_json(self):
        return {"n_in": self.n_in, "n_out": self.n_out,
                "has_bias": self.has_bias}


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

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        self._flatten_input = False   # [T, C] applies per timestep

    def compute_loss(self, params, x, labels, mask=None, train: bool = False,
                     rng=None):
        z = self.pre_output(params, x, train, rng)      # [B, T, O]
        B, T, O = z.shape
        m2 = None if mask is None else mask.reshape(B * T)
        return self.loss.score(labels.reshape(B * T, O), z.reshape(B * T, O),
                               self.activation, m2)

    def output_shape(self, input_shape):
        return (input_shape[0], self.n_out)

    def _extra_json(self):
        d = super()._extra_json()
        d["loss"] = self.loss.to_json()
        return d


@register
class RnnLossLayer(LossLayer):
    """Per-timestep loss on the raw [B, T, O] input, no params."""

    kind = "rnnloss"

    def compute_loss(self, params, x, labels, mask=None, train: bool = False,
                     rng=None):
        B, T, O = x.shape
        m2 = None if mask is None else mask.reshape(B * T)
        return self.loss.score(labels.reshape(B * T, O), x.reshape(B * T, O),
                               self.activation, m2)


@register
class RepeatVector(Layer):
    """[B, C] -> [B, n, C]."""

    kind = "repeatvector"

    def __init__(self, n: int = 1, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.n = int(n)

    def apply(self, params, x, state, train, rng):
        return x[:, None, :].expand(-1, self.n, -1), state

    def output_shape(self, input_shape):
        return (self.n, input_shape[-1])

    def _extra_json(self):
        return {"n": self.n}
