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
"""
from __future__ import annotations

from typing import Dict

import torch

from . import schedules
from .schedules import Schedule


def _zeros(params):
    return {n: torch.zeros_like(p) for n, p in params.items()}


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


class Updater:
    """Base updater config."""

    name = "updater"

    def __init__(self, learning_rate=1e-3):
        self.learning_rate = schedules.get(learning_rate) if isinstance(
            learning_rate, (dict, Schedule)) else float(learning_rate)

    def init_state(self, params: Dict[str, torch.Tensor]):
        return {}

    def apply(self, state, grads: Dict[str, torch.Tensor], step: int):
        """Returns (new_state, updates); updates are subtracted."""
        raise NotImplementedError

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

    def __init__(self, learning_rate=0.1):
        super().__init__(learning_rate)

    def apply(self, state, grads, step):
        lr = self.lr(step)
        return state, {n: lr * g for n, g in grads.items()}


class NoOp(Updater):
    """The gradient itself is the update."""

    name = "noop"

    def __init__(self):
        super().__init__(0.0)

    def to_json(self):
        return {"@class": self.name}

    def apply(self, state, grads, step):
        return state, {n: g.clone() for n, g in grads.items()}


class Nesterovs(Updater):
    """v' = mu v - lr g; update = mu v - (1 + mu) v'."""

    name = "nesterovs"

    def __init__(self, learning_rate=0.1, momentum=0.9):
        super().__init__(learning_rate)
        self.momentum = float(momentum)

    def init_state(self, params):
        return _zeros(params)

    def apply(self, state, grads, step):
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

    def apply(self, state, grads, step):
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

    def apply(self, state, grads, step):
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

    def __init__(self, rho=0.95, epsilon=1e-6):
        super().__init__(0.0)
        self.rho = float(rho)
        self.epsilon = float(epsilon)

    def to_json(self):
        return {"@class": self.name, "rho": self.rho, "epsilon": self.epsilon}

    def init_state(self, params):
        return {"msg": _zeros(params), "msdx": _zeros(params)}

    def apply(self, state, grads, step):
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

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def apply(self, state, grads, step):
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


class AdaMax(_AdamFamily):
    """u = max(b2 u, |g|); update = lr / (1 - b1^t) * m / (u + eps)."""

    name = "adamax"

    def init_state(self, params):
        return {"m": _zeros(params), "u": _zeros(params)}

    def apply(self, state, grads, step):
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

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params),
                "vhat": _zeros(params)}

    def apply(self, state, grads, step):
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

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def apply(self, state, grads, step):
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
