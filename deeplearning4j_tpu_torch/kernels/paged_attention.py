"""Paged KV-cache decode attention: the Hopper kernels and their plain
PyTorch version.

Counterpart of ``deeplearning4j_tpu/kernels/paged_attention.py``. One
query row per sequence attends over a prefix whose K/V lives in pool
blocks addressed through a per-sequence block table. Layout: q
[S, H, D]; pools [N, H, Bs, D]; block_tables [S, B] int32 pool indices
(NULL_BLOCK-padded); lengths [S]. Key position ``j`` of sequence ``s``
lives at ``pool[block_tables[s, j // Bs], :, j % Bs]``; positions
>= lengths[s] are masked, and a sequence of length 0 gives exactly 0.
An int8 pool is a :class:`~.kv_quant.QuantArray` whose [N, H, Bs]
scale rows ride the same table entries as the values.

:func:`paged_attention` launches ``csrc/paged_attention.cu`` for CUDA
tensors (f32, bf16 or int8 pools) and runs :func:`paged_attention_torch`
for CPU tensors. Nothing falls back: a CUDA tensor the kernels do not
take raises. The plain version gathers the blocks into the slot-cache
layout and reuses the slot math, as ``paged_attention_xla`` does, so
it is bit-identical to :func:`~.decode_attention.decode_attention_torch`
on the gathered panel. The kernels' design and what bounds them are
written at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, count_launch
from .decode_attention import (check_int8_operands, check_operands,
                               decode_attention_torch)
from .kv_quant import QuantArray, is_quantized

#: launches of the f32/bf16 kernel and of the int8 kernel since the
#: last reset (the paged engine's decode steps move them; chip_smoke.py
#: reads them to show the served path used the kernels)
launches = 0
launches_int8 = 0

#: the kernels stage a sequence's live table entries in shared memory
MAX_TABLE_BLOCKS = 8192

_SIG = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                     ctypes.c_void_p]
_SIG_INT8 = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                          ctypes.c_void_p]
_SIGNATURES = {"paged_attention_f32": _SIG, "paged_attention_bf16": _SIG,
               "paged_attention_int8": _SIG_INT8,
               "paged_attention_int8_info": [ctypes.c_int, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int)]}


def gather_blocks(pool, block_tables):
    """[N, H, Bs, D] pool + [S, B] tables -> [S, H, B*Bs, D] dense
    per-sequence panels (the slot-cache layout). An int8 pool gathers
    its scale rows through the same table: the panel is a QuantArray
    with [S, H, B*Bs] scales."""
    S, B = block_tables.shape
    idx = block_tables.reshape(-1).long()
    if is_quantized(pool):
        N, H, Bs = pool.scale.shape
        gs = pool.scale[idx].reshape(S, B, H, Bs).permute(0, 2, 1, 3)
        return QuantArray(gather_blocks(pool.q, block_tables),
                          gs.reshape(S, H, B * Bs))
    N, H, Bs, D = pool.shape
    g = pool[idx]                                         # [S*B,H,Bs,D]
    g = g.reshape(S, B, H, Bs, D).permute(0, 2, 1, 3, 4)
    return g.reshape(S, H, B * Bs, D)


def paged_attention_torch(q, k_pool, v_pool, block_tables, lengths):
    """Plain PyTorch paged decode attention (counterpart of
    ``paged_attention_xla``): gather the table's blocks, then the slot
    math of :func:`decode_attention_torch`."""
    return decode_attention_torch(q, gather_blocks(k_pool, block_tables),
                                  gather_blocks(v_pool, block_tables),
                                  lengths)


def _check_table(block_tables) -> None:
    if block_tables.dtype != torch.int32:
        raise TypeError(f"block_tables must be int32, got "
                        f"{block_tables.dtype}")
    if not 1 <= block_tables.shape[1] <= MAX_TABLE_BLOCKS:
        raise ValueError(f"table width {block_tables.shape[1]} outside the "
                         f"kernel's 1..{MAX_TABLE_BLOCKS}")


def _paged_attention_cuda(q, k_pool, v_pool, block_tables, lengths):
    N, H, Bs, D = k_pool.shape
    S, B = block_tables.shape
    if k_pool.dtype not in (torch.float32, torch.bfloat16) \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged attention kernel takes f32 or bf16 pools "
                        f"of one type, got {k_pool.dtype}/{v_pool.dtype}")
    _check_table(block_tables)
    check_operands("paged attention", q,
                   (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)),
                   ((S, H, D), (N, H, Bs, D), (N, H, Bs, D), (S, B), (S,)),
                   lengths)
    if not 1 <= D <= 128:
        raise ValueError(f"head dim {D} outside the kernel's 1..128")
    lib = _build.load("paged_attention", _SIGNATURES)
    fn = (lib.paged_attention_f32 if k_pool.dtype == torch.float32
          else lib.paged_attention_bf16)
    out = torch.empty((S, H, D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                S, H, N, Bs, D, B, 1.0 / math.sqrt(D), stream)
    _build.check(rc, "paged_attention")
    count_launch("paged_attention.launches")
    return out


def _paged_attention_int8_cuda(q, k_pool, v_pool, block_tables, lengths):
    N, H, Bs, D = k_pool.shape
    S, B = block_tables.shape
    _check_table(block_tables)
    check_operands("int8 paged attention", q,
                   (("q", q), ("k_pool", k_pool.q), ("v_pool", v_pool.q),
                    ("k scales", k_pool.scale), ("v scales", v_pool.scale),
                    ("block_tables", block_tables), ("lengths", lengths)),
                   ((S, H, D), (N, H, Bs, D), (N, H, Bs, D), (N, H, Bs),
                    (N, H, Bs), (S, B), (S,)), lengths)
    check_int8_operands("paged attention", k_pool, v_pool, D)
    lib = _build.load("paged_attention", _SIGNATURES)
    out = torch.empty((S, H, D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.paged_attention_int8(
            q.data_ptr(), k_pool.q.data_ptr(), v_pool.q.data_ptr(),
            k_pool.scale.data_ptr(), v_pool.scale.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            S, H, N, Bs, D, B, 1.0 / math.sqrt(D), stream)
    _build.check(rc, "paged_attention_int8")
    count_launch("paged_attention.launches_int8")
    return out


def int8_kernel_info(D: int, table_blocks: int = 64) -> dict:
    """Registers a thread, local (spill) bytes, resident blocks per SM
    and load width (bytes) of the int8 kernel at head dim ``D`` with
    16-byte-aligned pools and tables of ``table_blocks`` entries, as the
    card reports them."""
    lib = _build.load("paged_attention", _SIGNATURES)
    out = (ctypes.c_int * 4)()
    _build.check(lib.paged_attention_int8_info(D, table_blocks, out),
                 "paged_attention_int8_info")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2],
                load_bytes=out[3])


def paged_attention(q, k_pool, v_pool, block_tables, lengths,
                    impl: str = "auto"):
    """Paged decode attention. ``impl="auto"`` (the only choice)
    launches a Hopper kernel for CUDA tensors (int8 pools take the int8
    kernel) and runs the plain version for CPU tensors. K and V pools
    must be quantized together."""
    if impl != "auto":
        raise ValueError(f"unknown paged attention impl {impl!r}")
    if is_quantized(k_pool) != is_quantized(v_pool):
        raise ValueError("K and V pools must be quantized together")
    if q.is_cuda:
        if is_quantized(k_pool):
            return _paged_attention_int8_cuda(q, k_pool, v_pool,
                                              block_tables, lengths)
        return _paged_attention_cuda(q, k_pool, v_pool, block_tables,
                                     lengths)
    return paged_attention_torch(q, k_pool, v_pool, block_tables, lengths)
