"""Learning-rate schedules (counterpart of
``deeplearning4j_tpu/learning/schedules.py``).

A schedule maps the step (an iteration count) to a learning rate. It
is evaluated on the host once a step, in f32 as the JAX package traces
it, and returns a Python float.
"""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=_F32)


class Schedule:
    name = "schedule"

    def value(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate at ``step`` (an f32 scalar tensor)."""
        raise NotImplementedError

    def __call__(self, step) -> float:
        return float(self.value(_f32(step)))

    def to_json(self):
        d = {"@class": self.name}
        d.update({k: v for k, v in self.__dict__.items()
                  if not k.startswith("_")})
        return d

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self).__name__,
                     tuple(sorted(self.__dict__.items(), key=lambda kv: kv[0]))))


class FixedSchedule(Schedule):
    name = "fixed"

    def __init__(self, value: float):
        self.value_ = float(value)

    def value(self, step):
        return _f32(self.value_)

    def to_json(self):
        return {"@class": self.name, "value": self.value_}


class ExponentialSchedule(Schedule):
    """lr = initial * gamma^step."""

    name = "exponential"

    def __init__(self, initial_value: float, gamma: float):
        self.initial_value = float(initial_value)
        self.gamma = float(gamma)

    def value(self, step):
        return self.initial_value * torch.pow(_f32(self.gamma), step)


class InverseSchedule(Schedule):
    """lr = initial / (1 + gamma * step)^power."""

    name = "inverse"

    def __init__(self, initial_value: float, gamma: float, power: float):
        self.initial_value = float(initial_value)
        self.gamma = float(gamma)
        self.power = float(power)

    def value(self, step):
        return self.initial_value / torch.pow(1.0 + self.gamma * step,
                                              self.power)


class PolySchedule(Schedule):
    """lr = initial * (1 - step / max_iter)^power."""

    name = "poly"

    def __init__(self, initial_value: float, power: float, max_iter: int):
        self.initial_value = float(initial_value)
        self.power = float(power)
        self.max_iter = int(max_iter)

    def value(self, step):
        frac = torch.clamp(step / self.max_iter, 0.0, 1.0)
        return self.initial_value * torch.pow(1.0 - frac, self.power)


class SigmoidSchedule(Schedule):
    """lr = initial / (1 + exp(gamma * (step - step_size)))."""

    name = "sigmoid"

    def __init__(self, initial_value: float, gamma: float, step_size: int):
        self.initial_value = float(initial_value)
        self.gamma = float(gamma)
        self.step_size = int(step_size)

    def value(self, step):
        return self.initial_value / (
            1.0 + torch.exp(self.gamma * (step - self.step_size)))


class StepSchedule(Schedule):
    """lr = initial * decay^floor(step / step_size)."""

    name = "step"

    def __init__(self, initial_value: float, decay_rate: float,
                 step_size: int):
        self.initial_value = float(initial_value)
        self.decay_rate = float(decay_rate)
        self.step_size = int(step_size)

    def value(self, step):
        return self.initial_value * torch.pow(
            _f32(self.decay_rate), torch.floor(step / self.step_size))


class MapSchedule(Schedule):
    """Piecewise constant: the value of the largest key <= step."""

    name = "map"

    def __init__(self, values: dict):
        self.values = {int(k): float(v) for k, v in values.items()}
        if 0 not in self.values:
            raise ValueError("MapSchedule must define a value for step 0")

    def value(self, step):
        s = float(step)
        return _f32(self.values[max(k for k in self.values if k <= s)])

    def __hash__(self):
        return hash(tuple(sorted(self.values.items())))


class WarmupCosineSchedule(Schedule):
    """Linear warmup to ``peak``, then cosine decay to ``floor``."""

    name = "warmupcosine"

    def __init__(self, peak: float, warmup_steps: int, total_steps: int,
                 floor: float = 0.0):
        self.peak = float(peak)
        self.warmup_steps = int(warmup_steps)
        self.total_steps = int(total_steps)
        self.floor = float(floor)

    def value(self, step):
        warm = self.peak * step / max(self.warmup_steps, 1)
        frac = torch.clamp((step - self.warmup_steps)
                           / max(self.total_steps - self.warmup_steps, 1),
                           0.0, 1.0)
        cos = self.floor + (self.peak - self.floor) * 0.5 * (
            1.0 + torch.cos(math.pi * frac))
        return torch.where(step < self.warmup_steps, warm, cos)


_REGISTRY = {c.name: c for c in
             [FixedSchedule, ExponentialSchedule, InverseSchedule,
              PolySchedule, SigmoidSchedule, StepSchedule, MapSchedule,
              WarmupCosineSchedule]}


def get(spec):
    """A schedule from an instance, a number (fixed) or a ``to_json``
    dict."""
    if isinstance(spec, Schedule):
        return spec
    if isinstance(spec, (int, float)):
        return FixedSchedule(spec)
    if isinstance(spec, dict):
        d = dict(spec)
        return _REGISTRY[d.pop("@class")](**d)
    raise ValueError(f"Unknown schedule spec: {spec!r}")
