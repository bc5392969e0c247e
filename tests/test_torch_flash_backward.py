"""The port's flash backward against the JAX package's (f32, CPU).

``flash_attention_bwd_torch`` (the plain version of the dQ and dK/dV
kernels) and the autograd Function built on it are held to the vector-
Jacobian product of the JAX ``flash_attention`` run in Pallas interpret
mode, on the same numpy-seeded inputs and cotangent. The cases mirror
``tests/test_kernels.py``: causal and not, several blocks (T=80 with
32-row blocks), a ragged length, key-padding masks, and a batch row
whose keys are all masked (zero output and zero gradients).

Tolerance: rtol 1e-4, atol 1e-5. Both sides compute in f32 and differ
only in summation order (gradients here are O(1)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import flash_attention as jax_flash
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from _torch_threads import one_torch_thread  # noqa: F401,E402

RTOL, ATOL = 1e-4, 1e-5


def _inputs(seed, B, T, H, D):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, T, H, D).astype(np.float32) * 0.5
               for _ in range(3))
    g = rs.randn(B, T, H, D).astype(np.float32)
    return q, k, v, g


def _jax_vjp(q, k, v, g, causal, km, block):
    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal,
                         key_mask=None if km is None else jnp.asarray(km),
                         block_q=block, block_k=block, interpret=True)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(out),) + tuple(np.asarray(x)
                                      for x in vjp(jnp.asarray(g)))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=ATOL)


def _lengths_mask(T, lengths):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]) \
        .astype(np.float32)


CASES = {
    # name: (B, T, H, D, causal, lengths or None, Pallas block)
    "acausal": (2, 64, 4, 32, False, None, 32),
    "causal": (2, 64, 4, 32, True, None, 32),
    "multiblock_acausal": (1, 80, 2, 16, False, None, 32),
    "multiblock_causal": (1, 80, 2, 16, True, None, 32),
    "ragged": (2, 100, 4, 32, True, None, 64),
    "key_padding_acausal": (2, 48, 2, 16, False, [32, 48], 16),
    "key_padding_causal": (2, 48, 2, 16, True, [32, 48], 16),
    "fully_masked_row": (2, 40, 2, 16, True, [0, 29], 16),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax(name):
    B, T, H, D, causal, lengths, block = CASES[name]
    q, k, v, g = _inputs(len(name), B, T, H, D)
    km = None if lengths is None else _lengths_mask(T, lengths)
    want = _jax_vjp(q, k, v, g, causal, km, block)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tkm = None if km is None else torch.from_numpy(km)
    out, lse = fa.flash_attention_torch(tq, tk, tv, causal, tkm)
    _close(out, want[0])
    dq, dk, dv = fa.flash_attention_bwd_torch(tq, tk, tv, tkm, out, lse,
                                              tg, causal)
    for got, w in zip((dq, dk, dv), want[1:]):
        _close(got, w)


@pytest.mark.parametrize("name", ["causal", "multiblock_acausal",
                                  "key_padding_causal", "fully_masked_row"])
def test_autograd_function_matches_jax(name):
    B, T, H, D, causal, lengths, block = CASES[name]
    q, k, v, g = _inputs(len(name), B, T, H, D)
    km = None if lengths is None else _lengths_mask(T, lengths)
    want = _jax_vjp(q, k, v, g, causal, km, block)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    tkm = None if km is None else torch.from_numpy(km)
    out = fa.flash_attention_autograd(tq, tk, tv, causal=causal,
                                      key_mask=tkm)
    _close(out.detach(), want[0])
    # a strided (transposed) cotangent: the Function makes it contiguous
    gt = torch.from_numpy(np.ascontiguousarray(g.transpose(0, 2, 1, 3)))
    out.backward(gt.transpose(1, 2))
    for t, w in zip((tq, tk, tv), want[1:]):
        _close(t.grad, w)


def test_fully_masked_row_has_zero_output_and_gradients():
    """A batch row whose keys are all masked: its LSE is -1e30, where
    exp(s - lse) would be 1 without the where-guard."""
    B, T, H, D = 2, 24, 2, 8
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(3, B, T, H, D))
    km = torch.from_numpy(_lengths_mask(T, [0, 17]))
    out, lse = fa.flash_attention_torch(q, k, v, True, km)
    assert out[0].abs().max().item() == 0.0
    assert (lse[0] == -1e30).all()
    dq, dk, dv = fa.flash_attention_bwd_torch(q, k, v, km, out, lse, g,
                                              True)
    for grad in (dq, dk, dv):
        assert grad[0].abs().max().item() == 0.0
        assert grad[1].abs().max().item() > 0.0
    # masked keys of the live row get no gradient either
    assert dk[1, 17:].abs().max().item() == 0.0
    assert dv[1, 17:].abs().max().item() == 0.0


def test_function_gives_the_mask_no_gradient_and_counts_nothing_on_cpu():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(4, 1, 16, 2, 8))
    q.requires_grad_(True)
    km = torch.ones((1, 16), requires_grad=True)
    n = (fa.launches, fa.launches_dq, fa.launches_dkv)
    fa.flash_attention_autograd(q, k, v, True, km).sum().backward()
    assert q.grad is not None and km.grad is None
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == n
