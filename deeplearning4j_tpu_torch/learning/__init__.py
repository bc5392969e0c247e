"""Updaters (counterpart of ``deeplearning4j_tpu/learning``: Sgd, NoOp,
Nesterovs, AdaGrad, RmsProp, AdaDelta, Adam, AdaMax, AMSGrad and
Nadam, with the learning-rate schedules of ``schedules.py``).

An updater is a config object with ``init_state(params)`` and
``apply(state, grads, step) -> (state, updates)``, the updates being
SUBTRACTED from the params, as in the JAX package; the state has the
JAX package's layout. ``step`` counts from 0 and ``lr(step)`` is the
(scheduled) learning rate. The state tensors are updated in place (the
JAX package returned new ones); the port keeps its own optimizers
rather than ``torch.optim`` so that every formula and step counter
matches the reference exactly.

A half gradient or state leaf (a network built with
``init(dtype=torch.bfloat16)``) follows JAX's dtype rules instead: the
arithmetic runs in f32 on upcast operands, a new state leaf takes the
promotion of its old dtype and its gradient's (bf16 while both are),
and an update scaled by the f32 learning rate comes out f32. Such a
leaf is replaced in the state dict, never updated in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import schedules
from .schedules import Schedule


def _zeros(params):
    return {n: torch.zeros_like(p) for n, p in params.items()}


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


def _weak(c: float, t: torch.Tensor) -> float:
    """A Python constant as JAX's weak typing applies it to ``t``:
    rounded to ``t``'s dtype when that is a half dtype."""
    if t.dtype == torch.float32:
        return c
    return float(torch.tensor(c, dtype=t.dtype))


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """An f32 intermediate that JAX's step keeps in ``dtype``, rounded
    to it (and back to f32 for the arithmetic after it)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


class Updater:
    """Base updater config. A subclass writes its f32 formula, in place,
    as ``_apply``; ``slots`` names its state's layout (None: one leaf a
    param, ``{param: leaf}``; a tuple: ``{slot: {param: leaf}}``),
    ``lr_scaled`` whether its updates are products with the learning
    rate, which makes them f32 in JAX whatever the gradient's dtype, and
    ``state_lr_scaled`` the same of its new state."""

    name = "updater"
    slots: Optional[Tuple[str, ...]] = None
    lr_scaled = True
    state_lr_scaled = False

    def __init__(self, learning_rate=1e-3):
        self.learning_rate = schedules.get(learning_rate) if isinstance(
            learning_rate, (dict, Schedule)) else float(learning_rate)

    def init_state(self, params: Dict[str, torch.Tensor]):
        return {}

    def apply(self, state, grads: Dict[str, torch.Tensor], step: int):
        """Returns (new_state, updates); updates are subtracted. Leaves
        whose gradient and state are all f32 update in place; the others
        follow JAX's dtype rules (``_apply_half``)."""
        slots = self._slot_dicts(state)
        half = {n: g for n, g in grads.items()
                if g.dtype != torch.float32
                or any(d[n].dtype != torch.float32 for d in slots)}
        if not half:
            return self._apply(state, grads, step)
        full = {n: g for n, g in grads.items() if n not in half}
        updates = self._apply(state, full, step)[1] if full else {}
        updates.update(self._apply_half(state, half, step))
        return state, updates

    def _apply(self, state, grads, step: int):
        raise NotImplementedError

    def _slot_dicts(self, state) -> list:
        if self.slots is None:
            return [state]
        return [state[s] for s in self.slots]

    def _apply_half(self, state, grads, step: int) -> dict:
        """The f32 formula on f32 copies of the gradients and of their
        state leaves; each new state leaf is stored in the promotion of
        its old dtype and its gradient's (f32 when ``state_lr_scaled``),
        each update f32 when ``lr_scaled`` and in the promotion of the
        gradient's and the state's dtypes otherwise: the dtypes JAX's
        arithmetic gives them. Adam overrides this with JAX's own order
        of roundings; for the other updaters the values agree with
        JAX's to a bf16 rounding of the update. Returns the updates."""
        slots = self._slot_dicts(state)
        sub = {n: g.float() for n, g in grads.items()}
        copies = [{n: d[n].float() for n in grads} for d in slots]
        sub_state = (copies[0] if self.slots is None
                     else dict(zip(self.slots, copies)))
        updates = self._apply(sub_state, sub, step)[1]
        out = {}
        for n, g in grads.items():
            dt = g.dtype
            for d, c in zip(slots, self._slot_dicts(sub_state)):
                dt = torch.promote_types(dt, d[n].dtype)
                new = torch.promote_types(d[n].dtype, g.dtype)
                d[n] = c[n].to(torch.promote_types(new, torch.float32)
                               if self.state_lr_scaled else new)
            out[n] = updates[n].to(
                torch.promote_types(dt, torch.float32) if self.lr_scaled
                else dt)
        return out

    def lr(self, step: int) -> float:
        """The learning rate at ``step`` (a float of its f32 value)."""
        if isinstance(self.learning_rate, Schedule):
            return self.learning_rate(step)
        return float(_f32(self.learning_rate))

    def to_json(self) -> dict:
        d = {"@class": self.name}
        for k, v in self.__dict__.items():
            d[k] = v.to_json() if isinstance(v, Schedule) else v
        return d

    def __eq__(self, other):
        return type(self) is type(other) and self.to_json() == other.to_json()

    def __hash__(self):
        return hash(type(self).__name__)

    def __repr__(self):
        return f"{type(self).__name__}({self.__dict__})"


class Sgd(Updater):
    """update = lr * g."""

    name = "sgd"
    slots = ()

    def __init__(self, learning_rate=0.1):
        super().__init__(learning_rate)

    def _apply(self, state, grads, step):
        lr = self.lr(step)
        return state, {n: lr * g for n, g in grads.items()}


class NoOp(Updater):
    """The gradient itself is the update."""

    name = "noop"
    slots = ()
    lr_scaled = False

    def __init__(self):
        super().__init__(0.0)

    def to_json(self):
        return {"@class": self.name}

    def _apply(self, state, grads, step):
        return state, {n: g.clone() for n, g in grads.items()}


class Nesterovs(Updater):
    """v' = mu v - lr g; update = mu v - (1 + mu) v'."""

    name = "nesterovs"
    state_lr_scaled = True

    def __init__(self, learning_rate=0.1, momentum=0.9):
        super().__init__(learning_rate)
        self.momentum = float(momentum)

    def init_state(self, params):
        return _zeros(params)

    def _apply(self, state, grads, step):
        lr, mu = self.lr(step), self.momentum
        updates = {}
        for n, g in grads.items():
            v = state[n]
            v_new = mu * v - lr * g
            updates[n] = mu * v - (1 + mu) * v_new
            v.copy_(v_new)
        return state, updates


class AdaGrad(Updater):
    """h += g^2; update = lr g / (sqrt(h) + eps)."""

    name = "adagrad"

    def __init__(self, learning_rate=0.1, epsilon=1e-6):
        super().__init__(learning_rate)
        self.epsilon = float(epsilon)

    def init_state(self, params):
        return _zeros(params)

    def _apply(self, state, grads, step):
        lr = self.lr(step)
        updates = {}
        for n, g in grads.items():
            h = state[n]
            h.add_(g * g)
            updates[n] = lr * g / (torch.sqrt(h) + self.epsilon)
        return state, updates


class RmsProp(Updater):
    """r = d r + (1 - d) g^2 (r starts at eps); update = lr g /
    (sqrt(r) + eps)."""

    name = "rmsprop"

    def __init__(self, learning_rate=0.1, rms_decay=0.95, epsilon=1e-8):
        super().__init__(learning_rate)
        self.rms_decay = float(rms_decay)
        self.epsilon = float(epsilon)

    def init_state(self, params):
        return {n: torch.full_like(p, self.epsilon)
                for n, p in params.items()}

    def _apply(self, state, grads, step):
        lr, d = self.lr(step), self.rms_decay
        updates = {}
        for n, g in grads.items():
            r = state[n]
            r.copy_(d * r + (1 - d) * (g * g))
            updates[n] = lr * g / (torch.sqrt(r) + self.epsilon)
        return state, updates


class AdaDelta(Updater):
    """No learning rate: rho-averaged squared gradients and squared
    updates."""

    name = "adadelta"
    slots = ("msg", "msdx")
    lr_scaled = False

    def __init__(self, rho=0.95, epsilon=1e-6):
        super().__init__(0.0)
        self.rho = float(rho)
        self.epsilon = float(epsilon)

    def to_json(self):
        return {"@class": self.name, "rho": self.rho, "epsilon": self.epsilon}

    def init_state(self, params):
        return {"msg": _zeros(params), "msdx": _zeros(params)}

    def _apply(self, state, grads, step):
        rho, eps = self.rho, self.epsilon
        updates = {}
        for n, g in grads.items():
            msg, msdx = state["msg"][n], state["msdx"][n]
            msg.copy_(rho * msg + (1 - rho) * (g * g))
            dx = torch.sqrt(msdx + eps) / torch.sqrt(msg + eps) * g
            msdx.copy_(rho * msdx + (1 - rho) * (dx * dx))
            updates[n] = dx
        return state, updates


def _bias_terms(step: int, b1: float, b2: float):
    """(1 - b1^t, sqrt(1 - b2^t)) at t = step + 1, in f32 as the JAX
    package computes them from an f32 step counter."""
    t = _f32(step + 1)
    return (1.0 - torch.pow(_f32(b1), t),
            torch.sqrt(1.0 - torch.pow(_f32(b2), t)))


class _AdamFamily(Updater):
    def __init__(self, learning_rate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        super().__init__(learning_rate)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.epsilon = float(epsilon)


class Adam(_AdamFamily):
    """Bias-corrected moments, the JAX package's form:
    ``t = step + 1``, ``bc = sqrt(1 - b2^t) / (1 - b1^t)``,
    ``update = lr * bc * m / (sqrt(v) + eps)``."""

    name = "adam"
    slots = ("m", "v")

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def _apply(self, state, grads, step):
        b1, b2 = self.beta1, self.beta2
        c1, c2 = _bias_terms(step, b1, b2)
        lr_bc = float(_f32(self.lr(step)) * (c2 / c1))
        updates = {}
        for n, g in grads.items():
            m, v = state["m"][n], state["v"][n]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            updates[n] = (lr_bc * m) / (v.sqrt() + self.epsilon)
        return state, updates

    def _apply_half(self, state, grads, step):
        """JAX's formula with its dtypes, in the order its compiled CPU
        step evaluates it: the constants that multiply a bf16 leaf are
        rounded to bf16 (weak typing), the sums run in f32 and round once
        where the new moment is stored, ``g * g`` of a bf16 gradient and
        ``sqrt(v)`` of a bf16 ``v`` round to bf16, and the update is the
        f32 product with ``lr * bc`` over ``sqrt(v) + eps`` in f32."""
        b1, b2 = self.beta1, self.beta2
        c1, c2 = _bias_terms(step, b1, b2)
        lr_bc = float(_f32(self.lr(step)) * (c2 / c1))
        updates = {}
        for n, g in grads.items():
            m, v = state["m"][n], state["v"][n]
            g32 = g.float()
            m_new = (_weak(b1, m) * m.float() + _weak(1 - b1, g) * g32).to(
                torch.promote_types(m.dtype, g.dtype))
            v_new = (_weak(b2, v) * v.float() + _weak(1 - b2, g)
                     * _rounded(g32 * g32, g.dtype)).to(
                torch.promote_types(v.dtype, g.dtype))
            den = _rounded(v_new.float().sqrt(), v_new.dtype) + self.epsilon
            updates[n] = lr_bc * m_new.float() / den
            state["m"][n], state["v"][n] = m_new, v_new
        return updates


class AdaMax(_AdamFamily):
    """u = max(b2 u, |g|); update = lr / (1 - b1^t) * m / (u + eps)."""

    name = "adamax"
    slots = ("m", "u")

    def init_state(self, params):
        return {"m": _zeros(params), "u": _zeros(params)}

    def _apply(self, state, grads, step):
        b1, b2 = self.beta1, self.beta2
        c1, _ = _bias_terms(step, b1, b2)
        lr_bc = float(_f32(self.lr(step)) * (1.0 / c1))
        updates = {}
        for n, g in grads.items():
            m, u = state["m"][n], state["u"][n]
            m.mul_(b1).add_(g, alpha=1 - b1)
            u.copy_(torch.maximum(b2 * u, torch.abs(g)))
            updates[n] = lr_bc * m / (u + self.epsilon)
        return state, updates


class AMSGrad(_AdamFamily):
    """Adam with the running maximum of v in the denominator."""

    name = "amsgrad"
    slots = ("m", "v", "vhat")

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params),
                "vhat": _zeros(params)}

    def _apply(self, state, grads, step):
        b1, b2 = self.beta1, self.beta2
        c1, c2 = _bias_terms(step, b1, b2)
        lr_bc = float(_f32(self.lr(step)) * (c2 / c1))
        updates = {}
        for n, g in grads.items():
            m, v, vh = state["m"][n], state["v"][n], state["vhat"][n]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            torch.maximum(vh, v, out=vh)
            updates[n] = lr_bc * m / (torch.sqrt(vh) + self.epsilon)
        return state, updates


class Nadam(_AdamFamily):
    """Adam with Nesterov momentum: m_bar = (b1 m + (1 - b1) g) /
    (1 - b1^t); the denominator is sqrt of the raw v plus eps."""

    name = "nadam"
    slots = ("m", "v")

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def _apply(self, state, grads, step):
        b1, b2 = self.beta1, self.beta2
        c1 = float(_bias_terms(step, b1, b2)[0])
        lr = self.lr(step)
        updates = {}
        for n, g in grads.items():
            m, v = state["m"][n], state["v"][n]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_bar = b1 * m / c1 + (1 - b1) * g / c1
            updates[n] = lr * m_bar / (torch.sqrt(v) + self.epsilon)
        return state, updates


_REGISTRY = {c.name: c for c in (Sgd, NoOp, Nesterovs, AdaGrad, RmsProp,
                                 AdaDelta, Adam, AdaMax, AMSGrad, Nadam)}


def get(spec) -> Updater:
    """An updater from an instance, a name or a ``to_json`` dict (a
    dict learning rate is a schedule)."""
    if isinstance(spec, Updater):
        return spec
    d = dict(spec) if isinstance(spec, dict) else {"@class": str(spec)}
    name = str(d.pop("@class")).lower()
    if name not in _REGISTRY:
        raise ValueError(f"Unknown updater: {name!r}. Known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**d)


def names():
    return sorted(_REGISTRY)
