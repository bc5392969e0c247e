"""The port's flash forward and backward at bf16 against the JAX
package's Pallas kernels in interpret mode (CPU).

The same numpy-seeded inputs, rounded to bf16 once, go through
``jax.vjp`` of the JAX ``flash_attention`` (``_fwd_kernel``,
``_bwd_dq_kernel``, ``_bwd_dkv_kernel`` cast each bf16 block to f32 and
write O, dQ, dK and dV in bf16) and through the port's plain versions
(``flash_attention_torch``, ``flash_attention_bwd_dq_torch``,
``flash_attention_bwd_dkv_torch``, ``backward_delta``), which the
kernels' bf16 legs take on CPU tensors, and through
``FlashAttentionFunction``. Cases: causal and not, several Pallas
blocks, a ragged length, a ragged key mask and a batch row whose keys
are all masked.

Tolerances, with their reasons: both sides compute in f32 from the
same bf16 values and round each output once, so they differ only where
another f32 summation order moves a value across a bf16 rounding
boundary:
- O, dQ, dK and dV: within one bf16 ulp of each element,
  |got - want| <= 2^-7 |want| + 1e-6;
- the LSE (f32 on both sides): within 1e-5.
The backward kernels are fed JAX's own O and LSE, so they see the very
inputs JAX's backward saw; the Function chains the port's own forward
into its backward, as training does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import flash_attention as jax_flash
from deeplearning4j_tpu.kernels.flash_attention import _flash_fwd
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from _torch_threads import one_torch_thread  # noqa: F401,E402

ULP = 2.0 ** -7
ATOL = 1e-6
LSE_TOL = 1e-5

CASES = {
    # name: (B, T, H, D, causal, lengths or None, Pallas block)
    "acausal": (2, 64, 4, 32, False, None, 32),
    "causal": (2, 64, 4, 32, True, None, 32),
    "multiblock_causal": (1, 80, 2, 16, True, None, 32),
    "ragged": (2, 100, 2, 64, True, None, 64),
    "key_padding_acausal": (2, 48, 2, 16, False, [32, 48], 16),
    "key_padding_causal": (3, 48, 2, 16, True, [48, 31, 17], 16),
    "fully_masked_row": (2, 40, 2, 16, True, [0, 29], 16),
}


def _bf16(seed, B, T, H, D):
    """q, k, v (scaled by 0.5) and a cotangent, rounded to bf16 once,
    as f32 numpy arrays holding bf16 values."""
    rs = np.random.RandomState(seed)
    xs = [rs.randn(B, T, H, D).astype(np.float32) * s
          for s in (0.5, 0.5, 0.5, 1.0)]
    return [torch.from_numpy(x).bfloat16().float().numpy() for x in xs]


def _mask(T, lengths):
    if lengths is None:
        return None
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]) \
        .astype(np.float32)


def _jb(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _tb(x):
    return torch.from_numpy(x).bfloat16()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within_ulp(got, want, what):
    got, want = _np(got), _np(want)
    err = np.abs(got - want)
    bound = ULP * np.abs(want) + ATOL
    worst = np.unravel_index(np.argmax(err - bound), err.shape)
    assert (err <= bound).all(), \
        f"{what}: |{got[worst]} - {want[worst]}| at {worst}"


def _jax_side(q, k, v, g, causal, km, block):
    """JAX's O, LSE [B, H, T] and vjp (dq, dk, dv), all from bf16."""
    kmj = None if km is None else jnp.asarray(km)

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal, key_mask=kmj,
                         block_q=block, block_k=block, interpret=True)
    out, vjp = jax.vjp(f, _jb(q), _jb(k), _jb(v))
    grads = vjp(_jb(g))
    # the LSE of the same forward, from the custom_vjp's residuals
    B, T, H, _ = q.shape
    qh, kh, vh = (jnp.swapaxes(_jb(x), 1, 2) for x in (q, k, v))
    kmf = jnp.ones((B, T), jnp.float32) if km is None else kmj
    blk = min(block, max(8, T))
    _, res = _flash_fwd(qh, kh, vh, kmf, causal, blk, blk,
                        jax.lax.Precision.DEFAULT, True)
    lse = np.asarray(res[-1])[:, :T, 0].reshape(B, H, T)
    return out, lse, grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_kernels_match_jax_at_bf16(name):
    B, T, H, D, causal, lengths, block = CASES[name]
    q, k, v, g = _bf16(len(name), B, T, H, D)
    km = _mask(T, lengths)
    jout, jlse, jgrads = _jax_side(q, k, v, g, causal, km, block)
    tq, tk, tv, tg = (_tb(x) for x in (q, k, v, g))
    tkm = None if km is None else torch.from_numpy(km)
    out, lse = fa.flash_attention(tq, tk, tv, causal, tkm)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _within_ulp(out, jout, "O")
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=0, atol=LSE_TOL)
    # the backward on JAX's own O and LSE (delta from them, in f32)
    tout = torch.from_numpy(np.array(_np(jout))).bfloat16()
    tlse = torch.from_numpy(np.array(jlse))
    delta = fa.backward_delta(tg, tout)
    assert delta.dtype == torch.float32
    dq = fa.flash_attention_bwd_dq(tq, tk, tv, tkm, tg, tlse, delta, causal)
    dk, dv = fa.flash_attention_bwd_dkv(tq, tk, tv, tkm, tg, tlse, delta,
                                        causal)
    for what, got, want in zip(("dQ", "dK", "dV"), (dq, dk, dv), jgrads):
        assert got.dtype == torch.bfloat16
        _within_ulp(got, want, what)
    if lengths is not None and 0 in lengths:
        row = list(lengths).index(0)
        assert (lse[row] == -1e30).all()
        for x in (out, dq, dk, dv):
            assert x[row].abs().max().item() == 0.0


@pytest.mark.parametrize("name", ["causal", "key_padding_causal",
                                  "fully_masked_row", "ragged"])
def test_autograd_function_matches_jax_at_bf16(name):
    """bf16 leaves through FlashAttentionFunction get bf16 gradients
    within one bf16 ulp of JAX's vjp."""
    B, T, H, D, causal, lengths, block = CASES[name]
    q, k, v, g = _bf16(len(name) + 1, B, T, H, D)
    km = _mask(T, lengths)
    jout, _, jgrads = _jax_side(q, k, v, g, causal, km, block)
    leaves = [_tb(x).requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention_autograd(
        *leaves, causal=causal,
        key_mask=None if km is None else torch.from_numpy(km))
    assert out.dtype == torch.bfloat16
    _within_ulp(out, jout, "O")
    out.backward(_tb(g))
    for what, t, want in zip(("dQ", "dK", "dV"), leaves, jgrads):
        assert t.grad.dtype == torch.bfloat16
        _within_ulp(t.grad, want, what)


def test_plain_versions_refuse_mixed_dtypes():
    """All operands share one dtype; the CPU path refuses a mix as the
    card's wrappers do."""
    q, k, v, g = (_tb(x) for x in _bf16(0, 1, 16, 2, 8))
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention(q, k.float(), v)
    out, lse = fa.flash_attention(q, k, v, True)
    delta = fa.backward_delta(g, out)
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention_bwd_dq(q, k, v, None, g.float(), lse, delta, True)
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention_bwd_dkv(q.float(), k, v, None, g, lse, delta,
                                   True)


def test_bf16_operands_count_no_launch_on_cpu():
    q, k, v, g = (_tb(x).requires_grad_(True) for x in _bf16(1, 1, 16, 2, 8))
    names = ("launches", "launches_dq", "launches_dkv", "launches_bf16",
             "launches_dq_bf16", "launches_dkv_bf16")
    before = [getattr(fa, n) for n in names]
    fa.flash_attention_autograd(q, k, v, True).float().sum().backward()
    assert [getattr(fa, n) for n in names] == before
