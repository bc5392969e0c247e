"""Evidence on the CPU for the 3xTF32 split of the flash backward kernels.

The dQ and dK/dV kernels (``csrc/flash_attention.cu``) run every product
on the tensor cores in TF32 with an error-compensating split: each f32
operand x becomes hi = rna_tf32(x) and lo = rna_tf32(x - hi), and a
product is lo*hi + hi*lo + hi*hi accumulated in f32 (lo*lo is dropped).
The card cannot be asked here, so this file rounds to TF32 the way
``cvt.rna.tf32.f32`` does (nearest, ties away from zero, 10 mantissa
bits), in torch integer ops, forms the backward's five products that
way, and holds the result to the f32 plain backward
(``flash_attention_bwd_torch``) and to the JAX package's flash VJP.

Tolerance: 1e-4 absolute, the card test's ``TOL_F32``
(``tests/test_torch_kernels_gpu.py``): gradients here are O(1)-O(5) and
the split leaves ~2^-22 of each product, so the sums land within ~1e-6.
A single TF32 pass errs by ~1e-3 at the same shapes, which the last test
shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import flash_attention as jax_flash
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from _torch_threads import one_torch_thread  # noqa: F401,E402

TOL_F32 = 1e-4
T = 257


def tf32_rna(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does for finite x:
    the magnitude rounded half away from zero at bit 13, the 13 bits
    below it cleared."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & torch.tensor(-2 ** 31, dtype=torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & -0x2000
    return (mag | sign).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b with each product split into three TF32 products, the small
    terms first, as the kernels' ``mma_3xtf32``."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a, b):
    """a @ b in one TF32 pass (what the kernels do not do)."""
    return tf32_rna(a) @ tf32_rna(b)


def bwd_with(mm, q, k, v, key_mask, g, lse, delta, causal):
    """The backward's arithmetic as the kernels order it, every product
    through ``mm``: S = Q K^T, dP = dO V^T, dQ = dS K, dK = dS^T Q,
    dV = P^T dO, with p recomputed from the LSE under the where-guard."""
    B, _, _, D = q.shape
    scale = D ** -0.5
    qh, kh, vh, gh = (x.permute(0, 2, 1, 3) for x in (q, k, v, g))
    s = mm(qh, kh.transpose(-1, -2)) * scale
    mask = fa._mask(B, q.shape[1], causal, key_mask, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (mm(gh, vh.transpose(-1, -2)) - delta[..., None])
    dq = mm(ds, kh) * scale
    dk = mm(ds.transpose(-1, -2), qh) * scale
    dv = mm(p.transpose(-1, -2), gh)
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk, dv))


def _case(D, causal, seed):
    """q, k, v, g [3, T, 2, D] from a seed; batch row 1 masks its last
    third of keys, row 2 every key."""
    rs = np.random.RandomState(seed)
    q, k, v, g = (rs.randn(3, T, 2, D).astype(np.float32) for _ in range(4))
    km = np.ones((3, T), np.float32)
    km[1, 2 * T // 3:] = 0.0
    km[2] = 0.0
    tq, tk, tv, tg, tkm = (torch.from_numpy(x) for x in (q, k, v, g, km))
    out, lse = fa.flash_attention_torch(tq, tk, tv, causal, tkm)
    return (tq, tk, tv, tkm, tg, lse, fa.backward_delta(tg, out)), out


def test_rounding_is_nearest_ties_away_with_ten_mantissa_bits():
    one = 1.0
    half_ulp = 2.0 ** -11   # half a TF32 ulp at 1
    x = torch.tensor([one + half_ulp, -(one + half_ulp),
                      one + half_ulp - 2.0 ** -23, 3.0, 0.0,
                      1.5 * 2.0 ** -130], dtype=torch.float32)
    got = tf32_rna(x)
    want = torch.tensor([one + 2.0 ** -10, -(one + 2.0 ** -10), one, 3.0,
                         0.0, 1.5 * 2.0 ** -130], dtype=torch.float32)
    assert torch.equal(got, want)
    rs = np.random.RandomState(0)
    r = torch.from_numpy(rs.randn(10000).astype(np.float32))
    h = tf32_rna(r)
    assert int((h.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((h - r).abs() / r.abs()).max()) <= 2.0 ** -11


def test_split_keeps_f32_and_its_products_are_exact():
    """hi + lo carries x to ~2^-22, and the product of two TF32 values
    is exact in f32 (11 x 11 significant bits), so the tensor cores'
    f32 accumulation only rounds sums."""
    rs = np.random.RandomState(1)
    a, b = (torch.from_numpy(rs.randn(4096).astype(np.float32))
            for _ in range(2))
    ah, bh = tf32_rna(a), tf32_rna(b)
    al = tf32_rna(a - ah)
    assert float(((ah + al - a).abs() / a.abs()).max()) <= 2.0 ** -21
    exact = ah.double() * bh.double()
    assert torch.equal((ah * bh).double(), exact)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_3xtf32_backward_matches_the_f32_plain_version(D, causal):
    args, out = _case(D, causal, 7 * D + causal)
    q, k, v, km, g, lse, _ = args
    got = bwd_with(mm_3xtf32, *args, causal)
    want = fa.flash_attention_bwd_torch(q, k, v, km, out, lse, g, causal)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= TOL_F32
        assert a[2].abs().max().item() == 0.0   # the fully masked row


def test_3xtf32_backward_matches_jax():
    """The same split held to the JAX package's flash VJP (Pallas in
    interpret mode), on the same numpy inputs."""
    D, causal = 64, True
    args, _ = _case(D, causal, 64)
    q, k, v, km, g, _, _ = args

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal, key_mask=jnp.asarray(km),
                         block_q=64, block_k=64, interpret=True)
    _, vjp = jax.vjp(f, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = vjp(jnp.asarray(g.numpy()))
    got = bwd_with(mm_3xtf32, *args, causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL_F32)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_one_tf32_pass_misses_the_tolerance(D):
    """Why the kernels split: one TF32 pass errs by ~1e-3 here."""
    args, out = _case(D, True, 7 * D + 1)
    q, k, v, km, g, lse, _ = args
    got = bwd_with(mm_tf32, *args, True)
    want = fa.flash_attention_bwd_torch(q, k, v, km, out, lse, g, True)
    worst = max((a - b).abs().max().item() for a, b in zip(got, want))
    assert worst > 5 * TOL_F32
