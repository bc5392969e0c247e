"""Evidence on the CPU for the 3xTF32 flash forward (B3).

The forward kernel (``csrc/flash_attention.cu`` ``flash_fwd_kernel``)
computes S = Q K^T and O = P V on the tensor cores in TF32 with an
error-compensating split (a product is lo*hi + hi*lo + hi*hi, lo*lo
dropped). Its split is the cheap one of ``split_tf32_fast``: hi =
rna_tf32(x), and lo = x - hi goes to the tensor cores as it is, which
read only a TF32 operand's top 19 bits, so lo is truncated. It runs
the online softmax on log2(e)-scaled scores with exp2 over key tiles
of 32, forms P in place and feeds it, split, to P V.
With two key groups each group walks every other key tile and the two
(m, l, O) are merged at the end, group 0's first. The card cannot be
asked here, so this file rounds to TF32 as ``cvt.rna.tf32.f32`` does
(``tf32_rna`` of ``tests/test_torch_tf32_split.py``), runs that
arithmetic in torch in the kernel's order, and holds the result to the
f32 plain forward (``flash_attention_torch``) and to the JAX package's
flash forward (Pallas in interpret mode, as its own tests run it).

Tolerance: 1e-4 absolute, the card test's ``TOL_F32`` and
chip_smoke.py's ``FLASH_TOL``: O and the LSE are O(1) here and the
split leaves ~2^-20 of each product, so they land within a few 1e-6.
One TF32 pass errs by several times the tolerance, which the last test
shows.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import flash_attention as jax_flash
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from test_torch_tf32_split import tf32_rna
from _torch_threads import one_torch_thread  # noqa: F401,E402

TOL_F32 = 1e-4
NEG_INF = -1e30
BN = 32   # keys per streamed tile at D <= 64


def tf32_trunc(x):
    """x as the tensor cores read a TF32 operand: the 13 low mantissa
    bits ignored (the magnitude truncated)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b as three TF32 products, small terms first (``mma_3xtf32``),
    split as ``split_tf32_fast`` does."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a, b):
    """a @ b in one TF32 pass (what the kernel does not do)."""
    return tf32_rna(a) @ tf32_rna(b)


def forward_with(mm, q, k, v, causal, key_mask, key_groups=1):
    """The kernel's forward over [B, T, H, D] inputs: per key group, the
    online softmax over its key tiles with every product through
    ``mm``; the groups merged in order. Returns (O, LSE [B, H, T])."""
    B, T, H, D = q.shape
    sl2 = D ** -0.5 * math.log2(math.e)
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    live = fa._mask(B, T, causal, key_mask, q.device)     # [B, 1, T, T]
    groups = []
    for kg in range(key_groups):
        m = torch.full((B, H, T, 1), NEG_INF)
        l = torch.zeros((B, H, T, 1))
        acc = torch.zeros((B, H, T, D))
        for k0 in range(kg * BN, T, key_groups * BN):
            ok = live[..., k0:k0 + BN]
            s = mm(qh, kh[:, :, k0:k0 + BN].transpose(-1, -2)) * sl2
            s = torch.where(ok, s, NEG_INF)
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2(m - mx)
            p = torch.where(s > NEG_INF, torch.exp2(s - mx), 0.0)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + mm(p, vh[:, :, k0:k0 + BN])
            m = mx
        groups.append((m, l, acc))
    m, l, acc = groups[0]
    for m1, l1, acc1 in groups[1:]:
        mm_ = torch.maximum(m, m1)
        c0, c1 = torch.exp2(m - mm_), torch.exp2(m1 - mm_)
        m, l, acc = mm_, l * c0 + l1 * c1, acc * c0 + acc1 * c1
    lc = l.clamp_min(1e-30)
    lse = torch.where(m > NEG_INF, m * math.log(2.0) + torch.log(lc),
                      NEG_INF)[..., 0]
    return (acc / lc).permute(0, 2, 1, 3), lse


def _case(T, D, seed):
    """q, k, v [3, T, 2, D] from a seed; batch row 1 masks its last third
    of keys (a padded prompt), row 2 every key."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(3, T, 2, D).astype(np.float32) for _ in range(3))
    km = np.ones((3, T), np.float32)
    km[1, 2 * T // 3:] = 0.0
    km[2] = 0.0
    return q, k, v, km


def _t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("key_groups", [1, 2])
@pytest.mark.parametrize("D", [12, 64])
@pytest.mark.parametrize("T", [8, 100, 257])
def test_3xtf32_forward_matches_the_f32_plain_version(T, D, key_groups):
    q, k, v, km = (_t(x) for x in _case(T, D, 3 * T + D))
    out, lse = forward_with(mm_3xtf32, q, k, v, True, km, key_groups)
    ref, lref = fa.flash_attention_torch(q, k, v, True, km)
    assert (out - ref).abs().max().item() <= TOL_F32
    assert (lse - lref).abs().max().item() <= TOL_F32
    # the fully masked row: O exactly 0, LSE exactly -1e30
    assert out[2].abs().max().item() == 0.0
    assert bool((lse[2] == NEG_INF).all())


@pytest.mark.parametrize("D", [12, 64])
@pytest.mark.parametrize("T", [8, 100, 257])
def test_3xtf32_forward_matches_jax(T, D):
    """The same arithmetic (two key groups, as at B=1 on the card) held
    to the JAX package's flash forward, Pallas in interpret mode, on the
    same numpy inputs."""
    q, k, v, km = _case(T, D, 5 * T + D)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True,
                                key_mask=jnp.asarray(km), block_q=64,
                                block_k=64, interpret=True))
    out, _ = forward_with(mm_3xtf32, *(_t(x) for x in (q, k, v)), True,
                          _t(km), key_groups=2)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=TOL_F32)


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_rows_give_zero_and_the_lse_floor(causal):
    """Rows with no live key (padding, or a fully masked batch row) keep
    m = -1e30 in every group: O is exactly 0 and the LSE exactly -1e30,
    which the backward kernels' where-guards rely on."""
    q, k, v, km = (_t(x) for x in _case(100, 64, 7 + causal))
    out, lse = forward_with(mm_3xtf32, q, k, v, causal, km, key_groups=2)
    ref, lref = fa.flash_attention_torch(q, k, v, causal, km)
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    assert torch.equal(lse[2], lref[2])
    assert (out - ref).abs().max().item() <= TOL_F32


def test_one_tf32_pass_misses_the_tolerance():
    """Why the kernel splits: one TF32 pass errs by several times the
    tolerance at the served head dim."""
    q, k, v, km = (_t(x) for x in _case(257, 64, 11))
    out, lse = forward_with(mm_tf32, q, k, v, True, km)
    ref, lref = fa.flash_attention_torch(q, k, v, True, km)
    worst = max((out - ref).abs().max().item(),
                (lse - lref).abs().max().item())
    assert worst > 3 * TOL_F32
