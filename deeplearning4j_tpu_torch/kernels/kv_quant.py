"""KV-cache storage helpers: the f32/bf16 subset the slot cache and
the paged pool use.

Counterpart of ``deeplearning4j_tpu/kernels/kv_quant.py``. The JAX
helpers return updated arrays (the executables donate the caches);
here :func:`kv_set`, :func:`kv_update_slice` and :func:`kv_copy_row`
write into the cache tensor in place and return it.

The int8 cache (``QuantArray`` values with f32 scale sidecars) and the
int8 weight-only matmul (``QuantWeight``, ``mm``) come with the int8
slice: ROADMAP.md queue A, item 4.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

KV_DTYPES = ("f32", "bf16", "int8")

_STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}

_INT8_TODO = ("kv_dtype='int8' is not ported yet (ROADMAP.md queue A, "
              "item 4: kv_quant QuantArray/QuantWeight)")


def canonical_kv_dtype(kv_dtype: str) -> str:
    d = {"float32": "f32", "bfloat16": "bf16"}.get(str(kv_dtype),
                                                   str(kv_dtype))
    if d not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    return d


def _storage(kv_dtype: str) -> torch.dtype:
    kv_dtype = canonical_kv_dtype(kv_dtype)
    if kv_dtype == "int8":
        raise NotImplementedError(_INT8_TODO)
    return _STORAGE[kv_dtype]


def kv_zeros(shape: Sequence[int], kv_dtype: str, device=None):
    """Allocate one pool tensor of ``shape`` for ``kv_dtype``."""
    return torch.zeros(tuple(shape), dtype=_storage(kv_dtype),
                       device=device)


def kv_nbytes(shape: Sequence[int], kv_dtype: str) -> int:
    """Device bytes one pool tensor of ``shape`` pins."""
    return int(np.prod(shape)) * _storage(kv_dtype).itemsize


def kv_bytes_per_token(layer_shapes, kv_dtype: str) -> int:
    """K+V bytes one token position costs across all layers."""
    item = _storage(kv_dtype).itemsize
    return sum(2 * h * dh * item for h, _, dh in layer_shapes)


def kv_set(cache, idx, values):
    """Write ``values`` (trailing axis = head_dim) into ``cache`` at the
    index tuple ``idx``, in place."""
    cache[idx] = values.to(cache.dtype)
    return cache


def kv_copy_row(pool, src: int, dst: int):
    """Copy leading-axis row ``src`` of ``pool`` into row ``dst`` in
    place (a copy-on-write block duplicate) and return the pool. The
    int8 leg, which must copy the scale row too, comes with ROADMAP.md
    queue A, item 4."""
    if pool.dtype not in _STORAGE.values():
        raise NotImplementedError(_INT8_TODO)
    pool[int(dst)].copy_(pool[int(src)])
    return pool


def kv_update_slice(cache, slab, start: Sequence[int]):
    """Write ``slab`` into ``cache`` at ``start`` (one index per cache
    axis), in place: the counterpart of ``dynamic_update_slice``, whose
    start JAX clamps so the slab fits; a slab that does not fit raises
    here instead."""
    region = tuple(slice(int(s), int(s) + n)
                   for s, n in zip(start, slab.shape))
    cache[region].copy_(slab)
    return cache
