"""Precision policy (counterpart of ``deeplearning4j_tpu/nn/precision.py``).

Only the f32 policy is ported: params, activations, gradients and
updater state are f32, as are the flash kernels (B3, B6, B7). The JAX
package's bf16 mixed-precision policy is not ported yet, and a
configuration asking for it raises rather than running f32 quietly.
"""
from __future__ import annotations

from typing import Optional

_HALF_NAMES = ("bfloat16", "bf16", "half", "float16", "fp16")


def compute_dtype(conf_dtype: Optional[str]):
    """None (pure f32) for an f32 configuration; a half-precision one
    raises ``NotImplementedError``."""
    if (conf_dtype or "float").lower() in _HALF_NAMES:
        raise NotImplementedError(
            f"dtype {conf_dtype!r}: the bf16 mixed-precision policy is not "
            f"ported yet (ROADMAP.md queue A, item 11); the flash kernels "
            f"take f32 only")
    return None
