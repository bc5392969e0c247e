"""FlashAttention forward and backward: the Hopper kernels and their
plain PyTorch versions.

Counterpart of ``deeplearning4j_tpu/kernels/flash_attention.py``
(``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel`` and the
``custom_vjp`` that ties them together). Same ``[B, T, H, D]`` layout
as the JAX ``flash_attention``; the optional ``key_mask`` [B, T]
(1 = attend, 0 = padding) is shared by all heads of a batch element.
The forward returns the output and the per-row log-sum-exp
``[B, H, T]``; the backward recomputes the probabilities from it.

:func:`flash_attention` (B3), :func:`flash_attention_bwd_dq` (B6) and
:func:`flash_attention_bwd_dkv` (B7) launch ``csrc/flash_attention.cu``
for CUDA tensors and run their ``*_torch`` plain versions for CPU
tensors; :func:`flash_attention_bwd` runs both backward kernels.
:func:`flash_attention_autograd` is the differentiable form the
training path calls. Nothing falls back: a CUDA tensor the
kernels do not take raises.

Each kernel has an f32 leg (3xTF32 on the tensor cores) and a bf16 leg
(bf16 products with f32 accumulation on ``wgmma``, fed by TMA through a
warp-specialised ring, ``csrc/sm90.cuh``), picked by the operands'
dtype, which must be one and the same for q, k, v (and dO). As in the
JAX kernels, both compute in f32 from the operands' values and return
O, dQ, dK and dV in the operands' dtype; the LSE and delta are f32.
fp16 operands are not ported (ROADMAP.md queue B, item B8).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, count_launch

_NEG_INF = -1e30

#: forward kernel launches since the last reset (every prefill layer
#: and every training forward of an attention layer moves it)
launches = 0
#: dQ (``launches_dq``) and dK/dV (``launches_dkv``) kernel launches
#: since the last reset: one each per attention layer and backward pass
launches_dq = 0
launches_dkv = 0
#: the bf16 legs' launches, counted apart from the f32 legs' above
launches_bf16 = 0
launches_dq_bf16 = 0
launches_dkv_bf16 = 0

_SIGNATURES = {
    "flash_attention_fwd_f32":
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "flash_attention_fwd_info": [ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int)],
    "flash_attention_bwd_dq_f32":
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p],
    "flash_attention_bwd_dkv_f32":
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p],
    "flash_attention_bwd_info": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
    "flash_attention_fwd_bf16":
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p],
    "flash_attention_bwd_dq_bf16":
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p],
    "flash_attention_bwd_dkv_bf16":
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p],
    "flash_attention_bf16_info": [ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int)],
}

#: the dtypes the kernels take; fp16 is not ported (ROADMAP.md queue B,
#: item B8)
_LEGS = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _same_dtype(named):
    """The one dtype of the named operands; mixed dtypes raise
    ``TypeError`` (the JAX kernels would cast each to f32 and write the
    outputs in each operand's own dtype, which no caller relies on)."""
    dtypes = {name: t.dtype for name, t in named}
    if len(set(dtypes.values())) != 1:
        raise TypeError(f"flash attention operands must share one dtype, "
                        f"got {dtypes}")
    return named[0][1].dtype


def _mask(B, T, causal, key_mask, device):
    """[B, 1, T, T] True where query row q may attend key k."""
    mask = torch.ones((B, 1, T, T), dtype=torch.bool, device=device)
    if key_mask is not None:
        mask = mask & (key_mask > 0)[:, None, None, :]
    if causal:
        mask = mask & torch.ones((T, T), dtype=torch.bool,
                                 device=device).tril()
    return mask


def flash_attention_torch(q, k, v, causal: bool = False, key_mask=None):
    """Plain PyTorch version of the flash forward, in f32 from the
    operands' values, with the kernel's masking rules: masked scores
    are -1e30, probabilities are forced to 0 where masked (a fully
    masked row gives 0), and ``lse = m + log(max(l, 1e-30))``. O comes
    back in the operands' dtype (rounded once), the LSE in f32."""
    _same_dtype((("q", q), ("k", k), ("v", v)))
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(B, T, causal, key_mask, q.device)
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    lc = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)        # [B,H,T,1]
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / lc.permute(0, 2, 1, 3)
    lse = (m + torch.log(lc))[..., 0]
    return out.to(q.dtype), lse


def _bwd_probs(q, k, v, key_mask, lse, g, delta, causal):
    """f32 q, k, v, g and the recomputed p and ds [B, H, T, T] of the
    backward: p from the saved ``lse`` [B, H, T], where-guarded (a
    fully masked row's lse is -1e30, so ``exp(s - lse)`` alone would be
    1 there), ``ds = p * (g V^T - delta)``."""
    _same_dtype((("q", q), ("k", k), ("v", v), ("g", g)))
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    q, k, v, g = (x.float() for x in (q, k, v, g))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = _mask(B, T, causal, key_mask, q.device)
    s = torch.where(mask, s, _NEG_INF)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v)
    return q, k, g, p, p * (dp - delta[..., None]), scale


def backward_delta(g, out):
    """rowsum(dO * O) as [B, H, T] in f32 from the operands' values:
    O(T), outside the kernels as in JAX."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_dq_torch(q, k, v, key_mask, g, lse, delta,
                                 causal: bool = False):
    """Plain version of the dQ kernel: ``dq = ds K * scale``, in f32,
    returned in q's dtype."""
    _, kf, _, _, ds, scale = _bwd_probs(q, k, v, key_mask, lse, g, delta,
                                        causal)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale).to(q.dtype)


def flash_attention_bwd_dkv_torch(q, k, v, key_mask, g, lse, delta,
                                  causal: bool = False):
    """Plain version of the dK/dV kernel: ``dk = ds^T Q * scale``,
    ``dv = p^T dO``, in f32, returned in k's and v's dtype."""
    qf, _, gf, p, ds, scale = _bwd_probs(q, k, v, key_mask, lse, g, delta,
                                         causal)
    return ((torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale).to(k.dtype),
            torch.einsum("bhqk,bqhd->bkhd", p, gf).to(v.dtype))


def flash_attention_bwd_torch(q, k, v, key_mask, out, lse, g,
                              causal: bool = False):
    """Plain version of the flash backward, in f32 from the operands'
    values: (dq, dk, dv), each [B, T, H, D] in the operands' dtype, of
    the forward's ``out`` given its gradient ``g`` and the forward's
    ``lse``."""
    delta = backward_delta(g, out)
    return (flash_attention_bwd_dq_torch(q, k, v, key_mask, g, lse, delta,
                                         causal),
            *flash_attention_bwd_dkv_torch(q, k, v, key_mask, g, lse, delta,
                                           causal))


def _check_operands(named, q, key_mask):
    """Every named tensor f32 or bf16, all of one dtype, contiguous, on
    q's device and shaped like q; D within the kernels' 1..128;
    key_mask [B, T] or None. Returns the leg (``"f32"`` or ``"bf16"``)
    and the mask as a contiguous f32 tensor (or None)."""
    B, T, H, D = q.shape
    dtype = _same_dtype(named)
    if dtype not in _LEGS:
        raise TypeError(f"flash kernels take f32 or bf16 operands, not "
                        f"{dtype} (fp16 legs: ROADMAP.md queue B, item B8)")
    for name, t in named:
        if tuple(t.shape) != (B, T, H, D):
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                             f"{(B, T, H, D)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if not 1 <= D <= 128:
        raise ValueError(f"head dim {D} outside the kernel's 1..128")
    if key_mask is None:
        return _LEGS[dtype], None
    if tuple(key_mask.shape) != (B, T) or key_mask.device != q.device:
        raise ValueError(f"key_mask must be [B, T] = {(B, T)} on "
                         f"{q.device}, got {tuple(key_mask.shape)} on "
                         f"{key_mask.device}")
    return _LEGS[dtype], key_mask.to(torch.float32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def key_groups_for(B: int, T: int, H: int, device) -> int:
    """Groups of 4 warps that split each f32 forward block's key tiles:
    2 while the grid of 64-row query tiles is at most 2.5 blocks per SM
    (every served prefill at B=1; there the longest block's chain of
    key tiles sets the time), else 1, where the work rather than the
    chain does (measured crossover on the H100, see the forward design
    at the top of ``csrc/flash_attention.cu``). The choice, and with it
    the rounding of every output row, depends on the batch and the card,
    not only on the row's own inputs. The bf16 leg has no groups: its
    blocks of 128 query rows split their rows, not their keys, between
    two warpgroups."""
    blocks = B * H * -(-T // 64)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 2 if 2 * blocks <= 5 * sms else 1


def _flash_attention_cuda(q, k, v, causal, key_mask, key_groups=None):
    B, T, H, D = q.shape
    leg, key_mask = _check_operands((("q", q), ("k", k), ("v", v)), q,
                                    key_mask)
    lib = _build.load("flash_attention", _SIGNATURES)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
            out.data_ptr(), lse.data_ptr(), B, T, H, D, int(bool(causal)),
            1.0 / math.sqrt(D))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if leg == "bf16":
            if key_groups not in (None, 1):
                raise ValueError("the bf16 forward has one key group")
            rc = lib.flash_attention_fwd_bf16(*args, stream)
        else:
            if key_groups is None:
                key_groups = key_groups_for(B, T, H, q.device)
            rc = lib.flash_attention_fwd_f32(*args, int(key_groups), stream)
    _build.check(rc, f"flash_attention ({leg})")
    if leg == "bf16":
        count_launch("flash_attention.launches_bf16")
    else:
        count_launch("flash_attention.launches")
    return out, lse


def _check_bwd_operands(q, k, v, key_mask, g, lse, delta):
    """The backward kernels' operands; returns the leg and the mask as
    for the forward."""
    B, T, H, _ = q.shape
    leg, key_mask = _check_operands(
        (("q", q), ("k", k), ("v", v), ("g", g)), q, key_mask)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, T) \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 [B, H, T] = "
                             f"{(B, H, T)} on {q.device}")
    return leg, key_mask


def flash_attention_bwd_dq(q, k, v, key_mask, g, lse, delta,
                           causal: bool = False):
    """dQ kernel (B6) on CUDA tensors, its plain version on CPU ones.
    ``delta = rowsum(g * out)`` [B, H, T]."""
    if not q.is_cuda:
        return flash_attention_bwd_dq_torch(q, k, v, key_mask, g, lse, delta,
                                            causal)
    B, T, H, D = q.shape
    leg, key_mask = _check_bwd_operands(q, k, v, key_mask, g, lse, delta)
    lib = _build.load("flash_attention", _SIGNATURES)
    fn = lib.flash_attention_bwd_dq_bf16 if leg == "bf16" \
        else lib.flash_attention_bwd_dq_f32
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
                g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                B, T, H, D, int(bool(causal)), 1.0 / math.sqrt(D),
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"flash_attention_bwd_dq ({leg})")
    if leg == "bf16":
        count_launch("flash_attention.launches_dq_bf16")
    else:
        count_launch("flash_attention.launches_dq")
    return dq


def flash_attention_bwd_dkv(q, k, v, key_mask, g, lse, delta,
                            causal: bool = False):
    """dK/dV kernel (B7) on CUDA tensors, its plain version on CPU
    ones. Returns (dk, dv)."""
    if not q.is_cuda:
        return flash_attention_bwd_dkv_torch(q, k, v, key_mask, g, lse,
                                             delta, causal)
    B, T, H, D = q.shape
    leg, key_mask = _check_bwd_operands(q, k, v, key_mask, g, lse, delta)
    lib = _build.load("flash_attention", _SIGNATURES)
    fn = lib.flash_attention_bwd_dkv_bf16 if leg == "bf16" \
        else lib.flash_attention_bwd_dkv_f32
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
                g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), B, T, H, D, int(bool(causal)),
                1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"flash_attention_bwd_dkv ({leg})")
    if leg == "bf16":
        count_launch("flash_attention.launches_dkv_bf16")
    else:
        count_launch("flash_attention.launches_dkv")
    return dk, dv


def fwd_kernel_info(D: int, key_groups: int) -> dict:
    """Registers a thread, local (spill) bytes, dynamic shared memory
    (bytes), resident blocks per SM and threads a block of the f32
    forward kernel at head dim ``D``, as the card reports them."""
    lib = _build.load("flash_attention", _SIGNATURES)
    out = (ctypes.c_int * 5)()
    _build.check(lib.flash_attention_fwd_info(D, key_groups, out),
                 "flash_attention_fwd_info")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                blocks_per_sm=out[3], threads=out[4])


def bwd_kernel_info(D: int) -> dict:
    """Dynamic shared memory (bytes) and resident blocks per SM of the
    f32 dQ and dK/dV kernels at head dim ``D``, as the card reports
    them."""
    lib = _build.load("flash_attention", _SIGNATURES)
    out = (ctypes.c_int * 4)()
    _build.check(lib.flash_attention_bwd_info(D, out),
                 "flash_attention_bwd_info")
    return {"dq": {"smem_bytes": out[0], "blocks_per_sm": out[1]},
            "dkv": {"smem_bytes": out[2], "blocks_per_sm": out[3]}}


def bf16_kernel_info(D: int) -> dict:
    """Registers a thread (at launch: each leg then moves registers from
    its producer warpgroup to its two consumer warpgroups), local
    (spill) bytes, dynamic shared memory (bytes),
    resident blocks per SM and threads a block of each bf16 leg
    (``fwd``, ``dq``, ``dkv``) at head dim ``D``, as the card reports
    them for the block each leg launches."""
    lib = _build.load("flash_attention", _SIGNATURES)
    res = {}
    for which, name in enumerate(("fwd", "dq", "dkv")):
        out = (ctypes.c_int * 5)()
        _build.check(lib.flash_attention_bf16_info(which, D, out),
                     "flash_attention_bf16_info")
        res[name] = dict(registers=out[0], local_bytes=out[1],
                         smem_bytes=out[2], blocks_per_sm=out[3],
                         threads=out[4])
    return res


def flash_attention(q, k, v, causal: bool = False, key_mask=None):
    """Fused attention forward over q/k/v ``[B, T, H, D]``. Returns
    ``(out [B, T, H, D], lse [B, H, T])``."""
    if q.is_cuda:
        return _flash_attention_cuda(q, k, v, causal, key_mask)
    return flash_attention_torch(q, k, v, causal, key_mask)


def flash_attention_bwd(q, k, v, key_mask, out, lse, g,
                        causal: bool = False):
    """Flash backward: (dq, dk, dv) of the forward's output ``out``
    given its gradient ``g`` and the forward's ``lse``: the dQ and
    dK/dV kernels for CUDA tensors, their plain versions for CPU
    ones."""
    if q.is_cuda and (out.shape != q.shape or out.dtype != q.dtype):
        raise ValueError(f"out must be {q.dtype} {tuple(q.shape)}")
    delta = backward_delta(g, out)
    return (flash_attention_bwd_dq(q, k, v, key_mask, g, lse, delta, causal),
            *flash_attention_bwd_dkv(q, k, v, key_mask, g, lse, delta,
                                     causal))


class FlashAttentionFunction(torch.autograd.Function):
    """The ``jax.custom_vjp`` of the JAX module: the forward kernel
    (B3) saves q, k, v, the mask, the output and the LSE; the backward
    runs the dQ and dK/dV kernels. f32 and bf16 operands take their own
    legs, and bf16 leaves get bf16 gradients. The mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal):
        out, lse = flash_attention(q, k, v, causal, key_mask)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, key_mask, out, lse,
                                         g.contiguous(), ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_autograd(q, k, v, causal: bool = False, key_mask=None):
    """Differentiable flash attention over q/k/v ``[B, T, H, D]``:
    returns the output; gradients flow to q, k and v through the
    backward kernels (their plain versions for CPU tensors)."""
    return FlashAttentionFunction.apply(q, k, v, key_mask, bool(causal))
