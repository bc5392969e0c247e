"""KV-cache storage helpers: f32, bf16 and int8 pools, and the int8
weight-only matmul.

Counterpart of ``deeplearning4j_tpu/kernels/kv_quant.py``. The JAX
helpers return updated arrays (the executables donate the caches);
here :func:`kv_set`, :func:`kv_update_slice` and :func:`kv_copy_row`
write into the cache tensors in place and return the cache.

An int8 pool is a :class:`QuantArray`: int8 values and one f32 scale
per row over the trailing axis (head_dim), ``scale.shape ==
q.shape[:-1]``. Writes quantize, the attention kernels dequantize
inside their loops. ``scale = where(amax == 0, 1, amax / 127)`` keeps
NaN transparent: a non-finite row gets a non-finite scale, so every
reader dequantizes the poison back and the engine's finite-logits
guard still fires.

The block-run helpers of the host KV tier (``kv_gather_rows``,
``kv_scatter_rows``, ``kv_pack_host``, ``kv_unpack_host``) come with
the offload slice (ROADMAP.md queue A, item 8).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

KV_DTYPES = ("f32", "bf16", "int8")

_STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}


def canonical_kv_dtype(kv_dtype: str) -> str:
    d = {"float32": "f32", "bfloat16": "bf16"}.get(str(kv_dtype),
                                                   str(kv_dtype))
    if d not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    return d


class QuantArray:
    """int8 values ``q`` plus f32 per-row scales ``scale``
    (``scale.shape == q.shape[:-1]``): one int8 cache or pool."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def device(self):
        return self.q.device

    def to(self, device) -> "QuantArray":
        return QuantArray(self.q.to(device), self.scale.to(device))

    def __repr__(self):
        return (f"QuantArray(q={tuple(self.q.shape)}, "
                f"scale={tuple(self.scale.shape)})")


def is_quantized(x) -> bool:
    return isinstance(x, QuantArray)


def quantize_rows(x: torch.Tensor) -> QuantArray:
    """Symmetric per-row int8 over the trailing axis. The division by
    the scale (not a multiply by its reciprocal) and round-half-to-even
    give JAX's int8 values on finite rows; a non-finite row gets a
    non-finite scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return QuantArray(q.to(torch.int8), scale)


def dequantize(x: QuantArray) -> torch.Tensor:
    return x.q.float() * x.scale[..., None]


def _storage(kv_dtype: str) -> torch.dtype:
    return _STORAGE[canonical_kv_dtype(kv_dtype)]


def kv_zeros(shape: Sequence[int], kv_dtype: str, device=None):
    """Allocate one pool of ``shape`` for ``kv_dtype``: a tensor for
    f32/bf16, a :class:`QuantArray` for int8."""
    shape = tuple(int(s) for s in shape)
    if canonical_kv_dtype(kv_dtype) == "int8":
        return QuantArray(torch.zeros(shape, dtype=torch.int8, device=device),
                          torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device))
    return torch.zeros(shape, dtype=_storage(kv_dtype), device=device)


def kv_zero_(pool):
    """Zero one pool in place, an int8 pool's scale rows with its values:
    the storage, and so every address a captured CUDA graph holds, stays
    the same."""
    _check_pool(pool)
    if is_quantized(pool):
        pool.q.zero_()
        pool.scale.zero_()
    else:
        pool.zero_()
    return pool


def kv_nbytes(shape: Sequence[int], kv_dtype: str) -> int:
    """Device bytes one pool of ``shape`` pins, scales included."""
    n = int(np.prod(shape))
    if canonical_kv_dtype(kv_dtype) == "int8":
        return n + kv_scale_nbytes(shape, kv_dtype)
    return n * _storage(kv_dtype).itemsize


def kv_scale_nbytes(shape: Sequence[int], kv_dtype: str) -> int:
    """Bytes of the f32 scales of one pool of ``shape`` (0 unless
    int8)."""
    if canonical_kv_dtype(kv_dtype) == "int8":
        return int(np.prod(shape[:-1])) * 4
    return 0


def kv_bytes_per_token(layer_shapes, kv_dtype: str) -> int:
    """K+V bytes one token position costs across all layers."""
    if canonical_kv_dtype(kv_dtype) == "int8":
        return sum(2 * (h * dh + h * 4) for h, _, dh in layer_shapes)
    item = _storage(kv_dtype).itemsize
    return sum(2 * h * dh * item for h, _, dh in layer_shapes)


def _check_pool(pool) -> None:
    if not is_quantized(pool) and pool.dtype not in _STORAGE.values():
        raise TypeError(f"a {pool.dtype} pool is not a KV pool: int8 pools "
                        f"are QuantArrays that carry their scales")


def kv_set(cache, idx, values):
    """Write ``values`` (trailing axis = head_dim) into ``cache`` at the
    index tuple ``idx`` (over the non-trailing axes), in place,
    quantizing on write for int8. The same ``idx`` addresses the
    scales, which drop only the trailing axis."""
    _check_pool(cache)
    if is_quantized(cache):
        qv = quantize_rows(values)
        cache.q[idx] = qv.q
        cache.scale[idx] = qv.scale
        return cache
    cache[idx] = values.to(cache.dtype)
    return cache


def kv_copy_row(pool, src: int, dst: int):
    """Copy leading-axis row ``src`` of ``pool`` into row ``dst`` in
    place (a copy-on-write block duplicate) and return the pool. An
    int8 pool copies the scale row with the values."""
    _check_pool(pool)
    if is_quantized(pool):
        pool.q[int(dst)].copy_(pool.q[int(src)])
        pool.scale[int(dst)].copy_(pool.scale[int(src)])
        return pool
    pool[int(dst)].copy_(pool[int(src)])
    return pool


def kv_update_slice(cache, slab, start: Sequence[int]):
    """Write ``slab`` into ``cache`` at ``start`` (one index per cache
    axis), in place, quantizing on write for int8: the counterpart of
    ``dynamic_update_slice``, whose start JAX clamps so the slab fits;
    a slab that does not fit raises here instead."""
    _check_pool(cache)
    region = tuple(slice(int(s), int(s) + n)
                   for s, n in zip(start, slab.shape))
    if is_quantized(cache):
        qv = quantize_rows(slab)
        cache.q[region].copy_(qv.q)
        cache.scale[region[:-1]].copy_(qv.scale)
        return cache
    cache[region].copy_(slab)
    return cache


def kv_dequant_f32(cache) -> torch.Tensor:
    """Full f32 view of a pool (plain paths and tests; the kernels never
    dequantize a whole pool)."""
    if is_quantized(cache):
        return dequantize(cache)
    return cache.float()


def kv_operands(cache) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(bf16 values, f32 scale or None): the operands of the
    scale-folded paths. int8 values are exact in bf16; the scale is
    applied outside the product (after it for K, folded into the
    probabilities for V). ``None`` means the values already have their
    magnitude (a bf16 pool)."""
    if is_quantized(cache):
        return cache.q.to(torch.bfloat16), cache.scale
    return cache.to(torch.bfloat16), None


# ------------------------------------------------- weight-only matmul

class QuantWeight:
    """int8 weight-only matrix for the MLP: ``q[in, out]`` int8 with one
    f32 scale per output channel."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    def to(self, device) -> "QuantWeight":
        return QuantWeight(self.q.to(device), self.scale.to(device))

    def __repr__(self):
        return f"QuantWeight(q={tuple(self.q.shape)})"


def quantize_weight(w: torch.Tensor) -> QuantWeight:
    """Per-output-channel symmetric int8 (division by the scale, as in
    :func:`quantize_rows`)."""
    wf = w.float()
    amax = wf.abs().amax(dim=0)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127)
    return QuantWeight(q.to(torch.int8), scale)


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w``; a :class:`QuantWeight` takes bf16 operands with f32
    accumulation and its per-output-channel scale after the product.
    bf16 times int8 is exact in f32, so an f32 product over the
    bf16-rounded operands is that bf16 dot with f32 accumulation, on
    either device, and the result is never rounded to bf16."""
    if isinstance(w, QuantWeight):
        y = x.to(torch.bfloat16).float() @ w.q.float()
        return y * w.scale
    return x @ w
