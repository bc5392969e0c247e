"""PyTorch/CUDA port of ``deeplearning4j_tpu`` for an NVIDIA H100.

Module paths mirror the JAX package so each counterpart is easy to
find (``zoo/transformer_lm.py``, ``serving/generation.py``,
``kernels/decode_attention.py`` ...). The port imports neither JAX nor
the JAX package. Every TPU kernel on a ported path has a hand-written
Hopper kernel under ``csrc/`` with a plain PyTorch version beside it;
the plain version runs only for tensors on the CPU.

The causal transformer LM is served through ``GenerationEngine``'s
slot backend and its paged backend (block pool, prefix sharing,
sessions); ``nn.MultiLayerNetwork`` trains transformer stacks and CNNs
(convolution, pooling, batch norm, dropout) through ``fit`` and
scores them through ``evaluate``. What is still to port is listed
in ``ROADMAP.md``.
"""
from .device import resolve_device  # noqa: F401  (also pins TF32 off)

__all__ = ["resolve_device"]
