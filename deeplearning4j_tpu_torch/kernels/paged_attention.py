"""Paged KV-cache decode attention: the Hopper kernel and its plain
PyTorch version.

Counterpart of ``deeplearning4j_tpu/kernels/paged_attention.py``. One
query row per sequence attends over a prefix whose K/V lives in pool
blocks addressed through a per-sequence block table. Layout: q
[S, H, D]; pools [N, H, Bs, D]; block_tables [S, B] int32 pool indices
(NULL_BLOCK-padded); lengths [S]. Key position ``j`` of sequence ``s``
lives at ``pool[block_tables[s, j // Bs], :, j % Bs]``; positions
>= lengths[s] are masked, and a sequence of length 0 gives exactly 0.

:func:`paged_attention` launches ``csrc/paged_attention.cu`` for CUDA
tensors (f32 or bf16 pools) and runs :func:`paged_attention_torch` for
CPU tensors. Nothing falls back: a CUDA tensor the kernel does not take
raises. The plain version gathers the blocks into the slot-cache
layout and reuses the slot math, as ``paged_attention_xla`` does, so
it is bit-identical to :func:`~.decode_attention.decode_attention_torch`
on the gathered panel. The kernel's design and what bounds it are
written at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .decode_attention import decode_attention_torch

#: kernel launches since the last reset (the paged engine's decode
#: steps move it; chip_smoke.py reads it to show the served path used
#: the kernel)
launches = 0

#: the kernel stages a sequence's live table entries in shared memory
MAX_TABLE_BLOCKS = 8192

_SIG = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                     ctypes.c_void_p]
_SIGNATURES = {"paged_attention_f32": _SIG, "paged_attention_bf16": _SIG}


def gather_blocks(pool, block_tables):
    """[N, H, Bs, D] pool + [S, B] tables -> [S, H, B*Bs, D] dense
    per-sequence panels (the slot-cache layout)."""
    S, B = block_tables.shape
    N, H, Bs, D = pool.shape
    g = pool[block_tables.reshape(-1).long()]            # [S*B,H,Bs,D]
    g = g.reshape(S, B, H, Bs, D).permute(0, 2, 1, 3, 4)
    return g.reshape(S, H, B * Bs, D)


def paged_attention_torch(q, k_pool, v_pool, block_tables, lengths):
    """Plain PyTorch paged decode attention (counterpart of
    ``paged_attention_xla``): gather the table's blocks, then the slot
    math of :func:`decode_attention_torch`."""
    return decode_attention_torch(q, gather_blocks(k_pool, block_tables),
                                  gather_blocks(v_pool, block_tables),
                                  lengths)


def _paged_attention_cuda(q, k_pool, v_pool, block_tables, lengths):
    global launches
    N, H, Bs, D = k_pool.shape
    S, B = block_tables.shape
    if q.dtype != torch.float32:
        raise TypeError(f"paged attention kernel takes f32 queries, "
                        f"got {q.dtype}")
    if k_pool.dtype not in (torch.float32, torch.bfloat16) \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged attention kernel takes f32 or bf16 pools "
                        f"of one type, got {k_pool.dtype}/{v_pool.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"block_tables and lengths must be int32, got "
                        f"{block_tables.dtype}/{lengths.dtype}")
    if tuple(q.shape) != (S, H, D) or tuple(v_pool.shape) != (N, H, Bs, D) \
            or tuple(lengths.shape) != (S,):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, "
                         f"tables {tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if not 1 <= D <= 128:
        raise ValueError(f"head dim {D} outside the kernel's 1..128")
    if not 1 <= B <= MAX_TABLE_BLOCKS:
        raise ValueError(f"table width {B} outside the kernel's "
                         f"1..{MAX_TABLE_BLOCKS}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
    launches += 1
    return out


def paged_attention(q, k_pool, v_pool, block_tables, lengths,
                    impl: str = "auto"):
    """Paged decode attention. ``impl="auto"`` (the only choice)
    launches the Hopper kernel for CUDA tensors and runs the plain
    version for CPU tensors."""
    if impl != "auto":
        raise ValueError(f"unknown paged attention impl {impl!r}")
    if q.is_cuda:
        return _paged_attention_cuda(q, k_pool, v_pool, block_tables,
                                     lengths)
    return paged_attention_torch(q, k_pool, v_pool, block_tables, lengths)
