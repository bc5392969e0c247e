"""Weight initialization (counterpart of
``deeplearning4j_tpu/weightinit/__init__.py``): every scheme of the
JAX package, with the same scale from fan-in and fan-out.

Draws come from a ``random.py`` key, so an initialization is
reproducible from its seed and is JAX's: ``uniform`` bit for bit,
``normal`` and ``truncated_normal`` within a few f32 ulp. A layer splits
its key into one key a weight with :func:`subkeys` exactly where the
JAX layer splits its key.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from .. import random as R

SCHEMES = [
    "zero", "ones", "constant", "normal", "lecun_normal", "uniform", "xavier",
    "xavier_uniform", "xavier_fan_in", "xavier_legacy", "relu", "relu_uniform",
    "sigmoid_uniform", "lecun_uniform", "identity", "distribution",
    "var_scaling_normal_fan_in", "var_scaling_normal_fan_out",
    "var_scaling_normal_fan_avg", "var_scaling_uniform_fan_in",
    "var_scaling_uniform_fan_out", "var_scaling_uniform_fan_avg",
]


def subkeys(key, n: int) -> list:
    """The ``n`` rows of ``split(key, n)``, as a JAX layer splits its
    init key."""
    keys = R.split(key, n)
    return [R.key_at(keys, i) for i in range(n)]


def init_weights(key, shape: Sequence[int],
                 fan_in: float, fan_out: float, scheme: str = "xavier",
                 dtype=torch.float32,
                 distribution: Optional[dict] = None) -> torch.Tensor:
    """A weight tensor drawn from ``key`` per the named scheme (names as
    the reference's WeightInit enum, lowercased); ``distribution``
    parametrizes the ``distribution`` scheme: {"type": "normal" |
    "uniform" | "truncated_normal" | "constant", ...}."""
    shape = tuple(int(d) for d in shape)
    s = scheme.lower()
    if s == "zero":
        return torch.zeros(shape, dtype=dtype)
    if s == "ones":
        return torch.ones(shape, dtype=dtype)
    if s == "constant":
        return torch.full(shape, (distribution or {}).get("value", 0.0),
                          dtype=dtype)
    if s in ("normal", "lecun_normal"):
        return R.normal(key, shape, dtype) / math.sqrt(max(fan_in, 1.0))
    if s == "uniform":
        a = 1.0 / math.sqrt(max(fan_in, 1.0))
        return R.uniform(key, shape, dtype, -a, a)
    if s == "xavier":
        return math.sqrt(2.0 / max(fan_in + fan_out, 1.0)) * \
            R.normal(key, shape, dtype)
    if s == "xavier_uniform":
        a = math.sqrt(6.0 / max(fan_in + fan_out, 1.0))
        return R.uniform(key, shape, dtype, -a, a)
    if s == "xavier_fan_in":
        return math.sqrt(1.0 / max(fan_in, 1.0)) * \
            R.normal(key, shape, dtype)
    if s == "xavier_legacy":
        return math.sqrt(1.0 / max(fan_in + fan_out, 1.0)) * \
            R.normal(key, shape, dtype)
    if s == "relu":
        # He: N(0, 2 / fan_in)
        return math.sqrt(2.0 / max(fan_in, 1.0)) * \
            R.normal(key, shape, dtype)
    if s == "relu_uniform":
        a = math.sqrt(6.0 / max(fan_in, 1.0))
        return R.uniform(key, shape, dtype, -a, a)
    if s == "sigmoid_uniform":
        a = 4.0 * math.sqrt(6.0 / max(fan_in + fan_out, 1.0))
        return R.uniform(key, shape, dtype, -a, a)
    if s == "lecun_uniform":
        a = math.sqrt(3.0 / max(fan_in, 1.0))
        return R.uniform(key, shape, dtype, -a, a)
    if s.startswith("var_scaling_") and s in SCHEMES:
        fan = {"in": fan_in, "out": fan_out,
               "avg": (fan_in + fan_out) / 2.0}[s.rsplit("_", 1)[-1]]
        if "normal" in s:
            return math.sqrt(1.0 / max(fan, 1.0)) * \
                R.truncated_normal(key, -2.0, 2.0, shape, dtype)
        a = math.sqrt(3.0 / max(fan, 1.0))
        return R.uniform(key, shape, dtype, -a, a)
    if s == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("identity init requires square 2d shape")
        return torch.eye(shape[0], dtype=dtype)
    if s == "distribution":
        d = distribution or {}
        t = d.get("type", "normal")
        if t in ("normal", "gaussian"):
            return d.get("mean", 0.0) + d.get("std", 1.0) * \
                R.normal(key, shape, dtype)
        if t == "uniform":
            return R.uniform(key, shape, dtype, d.get("lower", -1.0),
                             d.get("upper", 1.0))
        if t == "truncated_normal":
            return d.get("mean", 0.0) + d.get("std", 1.0) * \
                R.truncated_normal(key, -2.0, 2.0, shape, dtype)
        if t == "constant":
            return torch.full(shape, d.get("value", 0.0), dtype=dtype)
        raise ValueError(f"Unknown distribution type {t!r}")
    raise ValueError(f"Unknown weight init scheme: {scheme!r}")
