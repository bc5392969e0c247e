"""Device resolution for the PyTorch port.

Entry points (``CausalTransformerLM``, ``GenerationEngine``) run on the
GPU unless the caller asks for the CPU. With no card and no explicit
CPU request they raise instead of quietly running on the CPU: a
serving process that silently lost its accelerator would answer every
request, only a hundred times slower.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

# The JAX reference and the TPU kernels compute the f32 path in f32.
# TF32 tensor cores keep ~10 mantissa bits, which would move logits by
# ~1e-3 and break greedy-token parity with the reference, so both
# switches are pinned off (matmul's default is already off; cuDNN's is
# on).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# Under the bf16 policy XLA accumulates a bf16 dot in f32. cuBLAS may
# reduce the partial sums of a split-K bf16 GEMM in bf16 unless told not
# to, which would round inside the sum; pinned off so bf16 GEMMs sum in
# f32 throughout.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the GPU. Raises when that GPU is missing; a CPU
    device is returned only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
