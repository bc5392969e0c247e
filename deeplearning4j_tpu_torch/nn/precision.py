"""Mixed-precision policy (counterpart of
``deeplearning4j_tpu/nn/precision.py``).

A configuration whose dtype is one of the half names turns on bf16
mixed precision: the forward and backward compute in bf16 while the
master params, the updater state, the output layer and the loss stay
f32. bf16 keeps f32's exponent range, so no loss scaling is needed.
"half" and the fp16 names map to bf16 too, as in the JAX package.

The casts are plain ``.to(dtype)`` calls under autograd, so the
gradients of the f32 masters come back f32 through them.
"""
from __future__ import annotations

from typing import Dict, Optional, Set

import torch

_HALF_NAMES = ("bfloat16", "bf16", "half", "float16", "fp16")


def compute_dtype(conf_dtype: Optional[str]):
    """The compute dtype of a configuration dtype string: bf16 for the
    half names, None (pure f32) otherwise."""
    if (conf_dtype or "float").lower() in _HALF_NAMES:
        return torch.bfloat16
    return None


def cast_params_for_compute(params: Dict, exempt_keys: Set[str], cdt):
    """Every f32 param leaf cast to ``cdt``, except the layers in
    ``exempt_keys`` (the output layer: logits, softmax and loss stay
    f32)."""
    if cdt is None:
        return params
    return {k: (p if k in exempt_keys else
                {n: t.to(cdt) if t.dtype == torch.float32 else t
                 for n, t in p.items()})
            for k, p in params.items()}


def cast_input_for_compute(x, cdt):
    """A floating input cast to ``cdt``; token ids stay as they are."""
    if cdt is None or not x.is_floating_point():
        return x
    return x.to(cdt)


def cast_feats_to_f32(feats):
    """The pre-output activations promoted back to f32 for the loss."""
    if feats.is_floating_point() and feats.dtype != torch.float32:
        return feats.float()
    return feats
