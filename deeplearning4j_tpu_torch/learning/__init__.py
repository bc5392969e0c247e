"""Updaters (counterpart of ``deeplearning4j_tpu/learning``; Sgd and
Adam so far).

An updater is a config object with ``init_state(params)`` and
``apply(state, grads, step) -> (state, updates)``, the updates being
SUBTRACTED from the params, as in the JAX package. ``step`` counts from
0 and ``lr(step)`` is the hook for a schedule. The state tensors are
updated in place (the JAX package returned new ones); the port keeps
its own optimizer rather than ``torch.optim`` so that Adam's formula
and step counter match the reference exactly.
"""
from __future__ import annotations

from typing import Dict

import torch


class Updater:
    """Base updater config."""

    name = "updater"

    def __init__(self, learning_rate=1e-3):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedules are not ported yet (ROADMAP.md "
                "queue A, item 11)")
        self.learning_rate = float(learning_rate)

    def init_state(self, params: Dict[str, torch.Tensor]):
        return {}

    def apply(self, state, grads: Dict[str, torch.Tensor], step: int):
        """Returns (new_state, updates); updates are subtracted."""
        raise NotImplementedError

    def lr(self, step: int) -> float:
        return self.learning_rate

    def to_json(self) -> dict:
        return {"@class": self.name, **self.__dict__}

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


class Adam(Updater):
    """Bias-corrected moments, the JAX package's form:
    ``t = step + 1``, ``bc = sqrt(1 - b2^t) / (1 - b1^t)``,
    ``update = lr * bc * m / (sqrt(v) + eps)``."""

    name = "adam"

    def __init__(self, learning_rate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        super().__init__(learning_rate)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.epsilon = float(epsilon)

    def init_state(self, params):
        return {"m": {n: torch.zeros_like(p) for n, p in params.items()},
                "v": {n: torch.zeros_like(p) for n, p in params.items()}}

    def apply(self, state, grads, step):
        b1, b2 = self.beta1, self.beta2
        # f32, as the reference computes it from an f32 step counter
        t = torch.tensor(float(step) + 1.0, dtype=torch.float32)
        lr = torch.tensor(self.lr(step), dtype=torch.float32)
        bc = torch.sqrt(1.0 - torch.pow(torch.tensor(b2), t)) \
            / (1.0 - torch.pow(torch.tensor(b1), t))
        lr_bc = float(lr * bc)
        updates = {}
        for n, g in grads.items():
            m, v = state["m"][n], state["v"][n]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            updates[n] = (lr_bc * m) / (v.sqrt() + self.epsilon)
        return state, updates


_REGISTRY = {c.name: c for c in (Sgd, Adam)}


def get(spec) -> Updater:
    """An updater from an instance, a name or a ``to_json`` dict. A
    name the JAX package knows but the port does not raises
    ``NotImplementedError``."""
    if isinstance(spec, Updater):
        return spec
    d = dict(spec) if isinstance(spec, dict) else {"@class": str(spec)}
    name = str(d.pop("@class")).lower()
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"updater {name!r} is not ported (ported: {sorted(_REGISTRY)}; "
            f"ROADMAP.md queue A, item 11)")
    return _REGISTRY[name](**d)

