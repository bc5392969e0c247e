"""Shared stateless NN math (counterpart of
``deeplearning4j_tpu/nn/functional.py``)."""
from __future__ import annotations

import torch


def layer_norm(x, gain, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with the biased variance:
    (x - mean) / sqrt(var + eps) * g + b, each step in the promoted
    dtype of its operands as in JAX (bf16 under the bf16 policy; the
    means accumulate in f32 and round to bf16 on both sides)."""
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) / torch.sqrt(v + eps) * gain + bias


def matmul(x, w):
    """``x @ w`` in the promoted dtype of the two, as ``jnp``'s matmul
    promotes (PyTorch's raises on mixed dtypes): under the bf16 policy a
    masked layer's output is f32 (bf16 times the f32 mask), and the next
    layer's bf16 weights then multiply in f32, as in JAX."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w
