"""Single-token KV-cache decode attention: the Hopper kernels and their
plain PyTorch version.

Counterpart of ``deeplearning4j_tpu/kernels/decode_attention.py``. One
query row per slot attends over that slot's cached K/V prefix. Layout:
q [S, H, D], k/v caches [S, H, T, D] (T contiguous per head), lengths
[S] (valid prefix per slot). Keys at positions >= lengths[s] are
masked; a slot with length 0 gives exactly 0. An int8 cache is a
:class:`~.kv_quant.QuantArray` with [S, H, T] scales.

:func:`decode_attention` launches ``csrc/decode_attention.cu`` for
CUDA tensors (f32, bf16 or int8 caches) and runs
:func:`decode_attention_torch` for CPU tensors. Nothing falls back: a
CUDA tensor the kernels do not take raises. The kernels' design and
what bounds them are written at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, count_launch
from .kv_quant import is_quantized, kv_operands

_NEG_INF = -1e30

#: launches of the f32/bf16 kernel and of the int8 kernel since the
#: last reset (the engine's decode steps move them; chip_smoke.py reads
#: them to show the served path used the kernels)
launches = 0
launches_int8 = 0

#: keys a chunk of the f32/bf16 kernel (``kChunk`` in
#: ``csrc/decode_attention.cu``; :func:`decode_kernel_info` reports the
#: built kernel's)
CHUNK_KEYS = 128

_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                     ctypes.c_void_p]
_SIG_INT8 = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                          ctypes.c_void_p]
_SIGNATURES = {"decode_attention_f32": _SIG, "decode_attention_bf16": _SIG,
               "decode_attention_int8": _SIG_INT8,
               "decode_attention_info": [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p],
               "decode_attention_int8_info": [ctypes.c_int,
                                              ctypes.c_void_p]}


def decode_attention_torch(q, k, v, lengths):
    """Plain PyTorch decode attention (counterpart of
    ``decode_attention_xla``). f32 caches compute in f32. bf16 and int8
    caches run bf16-operand products with f32 accumulation; int8 scales
    apply after the QK product for K and fold into p for V."""
    S, H, T, D = k.shape
    scale = 1.0 / math.sqrt(D)
    valid = (torch.arange(T, device=k.device)[None, None, :]
             < lengths.to(k.device)[:, None, None])
    if is_quantized(k) or is_quantized(v) or k.dtype == torch.bfloat16:
        kb, kscale = kv_operands(k)
        vb, vscale = kv_operands(v)
        # bf16 (and int8) values are exact in f32 and so are their
        # pairwise products, so an f32 einsum over bf16-rounded operands
        # is the bf16-operand dot with f32 accumulation
        s = torch.einsum("shd,shtd->sht",
                         q.to(torch.bfloat16).float(), kb.float()) * scale
        if kscale is not None:
            s = s * kscale
        s = torch.where(valid, s, _NEG_INF)
        p = torch.where(valid, torch.softmax(s, dim=-1), 0.0)
        if vscale is not None:
            # where-guarded: a stale tail's scale may be NaN, 0 * NaN = NaN
            p = torch.where(valid, p * vscale, 0.0)
        vb = torch.where(valid[..., None], vb.float(), 0.0)
        out = torch.einsum("sht,shtd->shd",
                           p.to(torch.bfloat16).float(), vb)
        return out.to(q.dtype)
    s = torch.einsum("shd,shtd->sht", q.float(), k.float()) * scale
    s = torch.where(valid, s, _NEG_INF)
    # fully masked rows (length 0) would softmax to uniform: zero them
    p = torch.where(valid, torch.softmax(s, dim=-1), 0.0)
    # V is masked too: p is 0 past the length but 0 * NaN = NaN, and a
    # recycled slot's stale tail may hold non-finite values
    vv = torch.where(valid[..., None], v.float(), 0.0)
    return torch.einsum("sht,shtd->shd", p, vv).to(q.dtype)


def check_operands(what: str, q, named, shapes, lengths) -> None:
    """The wrappers' common checks: f32 queries, int32 lengths, every
    tensor of ``named`` ((name, tensor) pairs) of the shape ``shapes``
    gives it, on q's device and contiguous."""
    if q.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes f32 queries, got {q.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    got = tuple(tuple(t.shape) for _, t in named)
    if got != tuple(shapes):
        raise ValueError(f"{what}: shapes {got} of "
                         f"{[n for n, _ in named]}, expected {shapes}")
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_int8_operands(what: str, k, v, D: int) -> None:
    """The int8 kernels' extra checks: int8 values with f32 scales, a
    head dim they take (4..128, a multiple of 4: rows load as vectors
    of 4, 8 or 16 bytes) and 4-byte aligned value rows."""
    if k.q.dtype != torch.int8 or v.q.dtype != torch.int8 \
            or k.scale.dtype != torch.float32 \
            or v.scale.dtype != torch.float32:
        raise TypeError(f"{what} int8 kernel takes int8 values with f32 "
                        f"scales, got {k.q.dtype}/{v.q.dtype} values and "
                        f"{k.scale.dtype}/{v.scale.dtype} scales")
    if not (4 <= D <= 128 and D % 4 == 0):
        raise ValueError(f"head dim {D}: the int8 kernel takes multiples "
                         f"of 4 in 4..128")
    for name, t in (("k", k.q), ("v", v.q)):
        if t.data_ptr() % 4:
            raise ValueError(f"{name} values must be 4-byte aligned")


def _decode_attention_cuda(q, k, v, lengths):
    S, H, T, D = k.shape
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"decode attention kernel takes f32 or bf16 K/V "
                        f"of one type, got {k.dtype}/{v.dtype}")
    check_operands("decode attention", q,
                   (("q", q), ("k", k), ("v", v), ("lengths", lengths)),
                   ((S, H, D), (S, H, T, D), (S, H, T, D), (S,)), lengths)
    if not 1 <= D <= 256:
        raise ValueError(f"head dim {D} outside the kernel's 1..256")
    lib = _build.load("decode_attention", _SIGNATURES)
    fn = (lib.decode_attention_f32 if k.dtype == torch.float32
          else lib.decode_attention_bf16)
    out = torch.empty((S, H, D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), S, H, T, D,
                1.0 / math.sqrt(D), stream)
    _build.check(rc, "decode_attention")
    count_launch("decode_attention.launches")
    return out


def _decode_attention_int8_cuda(q, k, v, lengths):
    S, H, T, D = k.shape
    check_operands("int8 decode attention", q,
                   (("q", q), ("k", k.q), ("v", v.q), ("k scale", k.scale),
                    ("v scale", v.scale), ("lengths", lengths)),
                   ((S, H, D), (S, H, T, D), (S, H, T, D), (S, H, T),
                    (S, H, T), (S,)), lengths)
    check_int8_operands("decode attention", k, v, D)
    lib = _build.load("decode_attention", _SIGNATURES)
    out = torch.empty((S, H, D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.decode_attention_int8(
            q.data_ptr(), k.q.data_ptr(), v.q.data_ptr(),
            k.scale.data_ptr(), v.scale.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), S, H, T, D, 1.0 / math.sqrt(D), stream)
    _build.check(rc, "decode_attention_int8")
    count_launch("decode_attention.launches_int8")
    return out


def decode_kernel_info(D: int, dtype=torch.float32) -> dict:
    """Registers a thread, local (spill) bytes, resident blocks per SM,
    load width (bytes), keys a chunk and blocks a cluster of the f32 or
    bf16 kernel at head dim ``D`` with 16-byte-aligned caches, as the
    card reports them."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode kernel info takes f32 or bf16, got {dtype}")
    lib = _build.load("decode_attention", _SIGNATURES)
    out = (ctypes.c_int * 6)()
    _build.check(lib.decode_attention_info(D, dtype == torch.bfloat16, out),
                 "decode_attention_info")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2],
                load_bytes=out[3], chunk_keys=out[4], cluster_blocks=out[5])


def int8_kernel_info(D: int) -> dict:
    """Registers a thread, local (spill) bytes, resident blocks per SM
    and load width (bytes) of the int8 kernel at head dim ``D`` with
    16-byte-aligned caches, as the card reports them."""
    lib = _build.load("decode_attention", _SIGNATURES)
    out = (ctypes.c_int * 4)()
    _build.check(lib.decode_attention_int8_info(D, out),
                 "decode_attention_int8_info")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2],
                load_bytes=out[3])


def decode_attention(q, k, v, lengths, impl: str = "auto"):
    """Decode attention. ``impl="auto"`` (the only choice) launches a
    Hopper kernel for CUDA tensors (int8 caches take the int8 kernel)
    and runs the plain version for CPU tensors. K and V must be
    quantized together."""
    if impl != "auto":
        raise ValueError(f"unknown decode attention impl {impl!r}")
    if is_quantized(k) != is_quantized(v):
        raise ValueError("K and V caches must be quantized together")
    if q.is_cuda:
        if is_quantized(k):
            return _decode_attention_int8_cuda(q, k, v, lengths)
        return _decode_attention_cuda(q, k, v, lengths)
    return decode_attention_torch(q, k, v, lengths)
