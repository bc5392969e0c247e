"""The port's paged decode attention on the CPU (its plain PyTorch
version) against the JAX package's ``paged_attention_xla`` and its
Pallas kernel in interpret mode, on the same numpy-seeded inputs, with
``test_torch_kernels.py``'s decode tolerances. Also: length 0 gives
zeros; NaN in the null block and in stale block tails does not leak;
the result equals the slot math on the gathered panel exactly;
``kv_copy_row`` copies a pool row as JAX does. The Hopper kernel itself
is tested on the card by ``tests/test_torch_kernels_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import kv_quant as jkv
from deeplearning4j_tpu.kernels.paged_attention import (
    gather_blocks as jax_gather_blocks, paged_attention_pallas,
    paged_attention_xla)
from deeplearning4j_tpu_torch.kernels import decode_attention as da
from deeplearning4j_tpu_torch.kernels import kv_quant as tkv
from deeplearning4j_tpu_torch.kernels import paged_attention as pa

# f32: the same math in another summation order
TOL_F32 = 1e-5
# bf16 pools: p is rounded to bf16 before the PV product; a rounding
# that flips at a different place moves an output by ~2^-8 * |v|
TOL_BF16_XLA = 1e-2
# the Pallas kernel rounds the UNnormalised online-softmax p instead
TOL_BF16_PALLAS = 3e-2


def _case(seed, S=3, H=4, D=8, N=10, Bs=4):
    rs = np.random.RandomState(seed)
    q = rs.randn(S, H, D).astype(np.float32)
    kp = rs.randn(N, H, Bs, D).astype(np.float32)
    vp = rs.randn(N, H, Bs, D).astype(np.float32)
    tbl = np.array([[3, 1, 0, 0], [2, 5, 7, 0], [9, 8, 6, 4]], np.int32)[:S]
    lens = np.array([5, 12, 16], np.int32)[:S]
    return q, kp, vp, tbl, lens


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


@pytest.fixture
def no_kernel_launch():
    """CPU tensors take the plain version: no counter may move."""
    n0, d0 = pa.launches, da.launches
    yield
    assert (pa.launches, da.launches) == (n0, d0)


pytestmark = pytest.mark.usefixtures("no_kernel_launch")


@pytest.mark.parametrize("seed", range(3))
def test_f32_matches_jax_xla_and_pallas(seed):
    q, kp, vp, tbl, lens = _case(seed)
    got = pa.paged_attention(_t(q), _t(kp), _t(vp), _t(tbl),
                             _t(lens)).numpy()
    xla = np.asarray(paged_attention_xla(q, kp, vp, tbl, lens))
    pallas = np.asarray(paged_attention_pallas(q, kp, vp, tbl, lens,
                                               interpret=True))
    np.testing.assert_allclose(got, xla, rtol=0, atol=TOL_F32)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL_F32)


@pytest.mark.parametrize("seed", range(3))
def test_bf16_matches_jax_xla_and_pallas(seed):
    q, kp, vp, tbl, lens = _case(10 + seed)
    kb, vb = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
    got = pa.paged_attention(_t(q), _t(kp, torch.bfloat16),
                             _t(vp, torch.bfloat16), _t(tbl),
                             _t(lens)).numpy()
    xla = np.asarray(paged_attention_xla(q, kb, vb, tbl, lens))
    pallas = np.asarray(paged_attention_pallas(q, kb, vb, tbl, lens,
                                               interpret=True))
    np.testing.assert_allclose(got, xla, rtol=0, atol=TOL_BF16_XLA)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL_BF16_PALLAS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_blocks_matches_jax(dtype):
    _, kp, _, tbl, _ = _case(3)
    got = pa.gather_blocks(_t(kp, dtype), _t(tbl)).float().numpy()
    want = np.asarray(jax_gather_blocks(kp, tbl))
    if dtype == torch.bfloat16:
        want = np.asarray(jax_gather_blocks(
            jnp.asarray(kp, jnp.bfloat16), tbl).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_length_zero_gives_exact_zeros(dtype):
    q, kp, vp, tbl, _ = _case(4)
    lens = torch.tensor([0, 12, 16], dtype=torch.int32)
    out = pa.paged_attention(_t(q), _t(kp, dtype), _t(vp, dtype), _t(tbl),
                             lens)
    assert torch.isfinite(out).all()
    assert out[0].abs().max().item() == 0.0


@pytest.mark.parametrize("tail", [99.0, float("nan")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_null_block_and_stale_tails_do_not_leak(tail, dtype):
    """The null block and every sequence's stale tail past its length
    hold ``tail``; the output is finite and equal to the clean one."""
    q, kp, vp, tbl, lens = _case(5)
    k, v = _t(kp, dtype), _t(vp, dtype)
    base = pa.paged_attention(_t(q), k, v, _t(tbl), _t(lens))
    k2, v2 = k.clone(), v.clone()
    k2[0] = tail
    v2[0] = -tail
    for s, n in enumerate(lens):
        last = tbl[s, (n - 1) // 4]
        k2[last, :, n % 4 or 4:] = tail
        v2[last, :, n % 4 or 4:] = -tail
    poisoned = pa.paged_attention(_t(q), k2, v2, _t(tbl), _t(lens))
    assert torch.isfinite(poisoned).all()
    assert torch.equal(base, poisoned)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_equals_slot_math_on_gathered_panel(dtype):
    q, kp, vp, tbl, lens = _case(6)
    k, v = _t(kp, dtype), _t(vp, dtype)
    got = pa.paged_attention_torch(_t(q), k, v, _t(tbl), _t(lens))
    dense = da.decode_attention_torch(_t(q), pa.gather_blocks(k, _t(tbl)),
                                      pa.gather_blocks(v, _t(tbl)),
                                      _t(lens))
    assert torch.equal(got, dense)


def test_unknown_impl_rejected():
    q, kp, vp, tbl, lens = _case(0)
    with pytest.raises(ValueError, match="impl"):
        pa.paged_attention(_t(q), _t(kp), _t(vp), _t(tbl), _t(lens),
                           impl="xla")


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
def test_kv_copy_row_matches_jax(kv_dtype):
    rs = np.random.RandomState(7)
    x = rs.randn(5, 2, 4, 3).astype(np.float32)
    dt = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}[kv_dtype]
    want = np.asarray(jkv.kv_copy_row(jnp.asarray(x, dt[0]), 1, 3)
                      .astype(jnp.float32))
    pool = _t(x, dt[1])
    out = tkv.kv_copy_row(pool, 1, 3)
    assert out is pool                      # written in place
    np.testing.assert_array_equal(pool.float().numpy(), want)


def test_kv_copy_row_int8_is_not_ported():
    """A bare int8 pool (values without their scales) is refused: int8
    pools are QuantArrays, whose copy carries the scale row
    (tests/test_torch_kv_quant.py)."""
    with pytest.raises(TypeError, match="QuantArray"):
        tkv.kv_copy_row(torch.zeros((3, 2), dtype=torch.int8), 0, 1)
