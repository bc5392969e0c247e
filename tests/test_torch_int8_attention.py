"""The int8 legs of the port's attention on the CPU (the plain PyTorch
versions of the int8 kernels and the int8 span math) against the JAX
package's int8 ``xla`` path and its Pallas kernels in interpret mode,
on the same numpy-seeded int8 values and scales: decode and paged
attention, ``gather_blocks``, ``_gather_span``, ``_span_attend``, and
the layers' paged prefill/decode over int8 pools. Also: a stale tail
or null block poisoned through its scale is ignored, an empty lane
gives exactly 0, and mixed quantisation raises. The Hopper kernels
themselves are tested on the card by ``tests/test_torch_kernels_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import kv_quant as jkv
from deeplearning4j_tpu.kernels.decode_attention import (
    decode_attention_pallas, decode_attention_xla)
from deeplearning4j_tpu.kernels.paged_attention import (
    gather_blocks as jax_gather_blocks, paged_attention_pallas,
    paged_attention_xla)
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu_torch.kernels import decode_attention as da
from deeplearning4j_tpu_torch.kernels import kv_quant as tkv
from deeplearning4j_tpu_torch.kernels import paged_attention as pa
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.serving import BlockTable
from _torch_threads import one_torch_thread  # noqa: F401,E402

# int8 against the xla path: the same bf16-operand math with exact
# products, summed in another order (0.0 measured at these shapes); a
# p * vscale on a bf16 rounding boundary could flip one term by 2^-9
TOL_XLA = 1e-5
# the Pallas kernel rounds the UNnormalised online-softmax p * vscale to
# bf16, the plain version the normalised one; each within 2^-8 of its
# term, so an output may move by up to 2^-7 of the largest |v| it
# averages. The JAX package's own Pallas-vs-xla int8 tolerance
# (tests/test_kv_quant.py); 6.4e-3 measured at these shapes
TOL_PALLAS = 2e-2
# the layers: f32 projections around the attention, then the same
TOL_LAYER = 1e-3


def _quant(x):
    """numpy f32 rows -> (JAX QuantArray, port QuantArray) holding the
    same int8 values and scales (quantized once, by JAX)."""
    j = jkv.quantize_rows(jnp.asarray(x))
    t = tkv.QuantArray(torch.from_numpy(np.array(j.q)),
                       torch.from_numpy(np.array(j.scale)))
    return j, t


def _decode_case(seed, S=4, H=2, T=24, D=8):
    rs = np.random.RandomState(seed)
    q = rs.randn(S, H, D).astype(np.float32)
    k = rs.randn(S, H, T, D).astype(np.float32)
    v = rs.randn(S, H, T, D).astype(np.float32)
    lens = np.array([5, T, 13, 1], np.int32)[:S]
    return q, k, v, lens


def _paged_case(seed, S=3, H=4, D=8, N=10, Bs=4):
    rs = np.random.RandomState(seed)
    q = rs.randn(S, H, D).astype(np.float32)
    kp = rs.randn(N, H, Bs, D).astype(np.float32)
    vp = rs.randn(N, H, Bs, D).astype(np.float32)
    tbl = np.array([[3, 1, 0, 0], [2, 5, 7, 0], [9, 8, 6, 4]], np.int32)[:S]
    lens = np.array([5, 12, 16], np.int32)[:S]
    return q, kp, vp, tbl, lens


@pytest.fixture
def no_kernel_launch():
    """CPU tensors take the plain versions: no counter may move."""
    before = (da.launches, da.launches_int8, pa.launches, pa.launches_int8)
    yield
    assert (da.launches, da.launches_int8, pa.launches,
            pa.launches_int8) == before


pytestmark = pytest.mark.usefixtures("no_kernel_launch")


@pytest.mark.parametrize("seed", range(3))
def test_decode_int8_matches_jax_xla_and_pallas(seed):
    q, k, v, lens = _decode_case(seed)
    (jk, tk), (jv, tv) = _quant(k), _quant(v)
    got = da.decode_attention(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(lens)).numpy()
    xla = np.asarray(decode_attention_xla(q, jk, jv, lens))
    pallas = np.asarray(decode_attention_pallas(q, jk, jv, lens,
                                                interpret=True))
    np.testing.assert_allclose(got, xla, rtol=0, atol=TOL_XLA)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL_PALLAS)


@pytest.mark.parametrize("seed", range(3))
def test_paged_int8_matches_jax_xla_and_pallas(seed):
    q, kp, vp, tbl, lens = _paged_case(20 + seed)
    (jk, tk), (jv, tv) = _quant(kp), _quant(vp)
    got = pa.paged_attention(torch.from_numpy(q), tk, tv,
                             torch.from_numpy(tbl),
                             torch.from_numpy(lens)).numpy()
    xla = np.asarray(paged_attention_xla(q, jk, jv, tbl, lens))
    pallas = np.asarray(paged_attention_pallas(q, jk, jv, tbl, lens,
                                               interpret=True))
    np.testing.assert_allclose(got, xla, rtol=0, atol=TOL_XLA)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL_PALLAS)


def test_paged_int8_equals_slot_math_on_the_gathered_panel():
    q, kp, vp, tbl, lens = _paged_case(3)
    _, tk = _quant(kp)
    _, tv = _quant(vp)
    tt, tl, tq = (torch.from_numpy(x) for x in (tbl, lens, q))
    got = pa.paged_attention(tq, tk, tv, tt, tl)
    dense = da.decode_attention(tq, pa.gather_blocks(tk, tt),
                                pa.gather_blocks(tv, tt), tl)
    assert torch.equal(got, dense)


def test_gather_blocks_carries_scales_as_jax():
    _, kp, _, tbl, _ = _paged_case(4)
    jq, tq = _quant(kp)
    got = pa.gather_blocks(tq, torch.from_numpy(tbl))
    want = jax_gather_blocks(jq, tbl)
    assert tkv.is_quantized(got)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_gather_span_carries_scales_as_jax():
    _, kp, _, tbl, _ = _paged_case(5)
    jq, tq = _quant(kp)
    H, Dh = kp.shape[1], kp.shape[3]
    got = tatt._gather_span(tq, torch.from_numpy(tbl[1]), H, Dh)
    want = jatt._gather_span(jq, jnp.asarray(tbl[1]), H, Dh)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("seed", range(2))
def test_span_attend_int8_matches_jax(seed):
    rs = np.random.RandomState(30 + seed)
    C, H, T, Dh, p0 = 4, 2, 16, 8, 6
    q = rs.randn(C, H, Dh).astype(np.float32)
    (jk, tk) = _quant(rs.randn(H, T, Dh).astype(np.float32))
    (jv, tv) = _quant(rs.randn(H, T, Dh).astype(np.float32))
    # a previous occupant's stale tail, poisoned through its scales
    jv = jkv.QuantArray(jv.q, jv.scale.at[:, p0 + C:].set(jnp.nan))
    tv.scale[:, p0 + C:] = float("nan")
    gpos = p0 + np.arange(C)
    want = jatt._span_attend(q, jk, jv, jnp.asarray(gpos), p0 + C,
                             jnp.float32)
    got = tatt._span_attend(torch.from_numpy(q), tk, tv,
                            torch.from_numpy(gpos), p0 + C, torch.float32)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL_XLA)


def test_decode_int8_stale_tail_poisoned_through_scale_is_ignored():
    q, k, v, lens = _decode_case(6)
    _, tk = _quant(k)
    _, tv = _quant(v)
    tq, tl = torch.from_numpy(q), torch.from_numpy(lens)
    base = da.decode_attention(tq, tk, tv, tl)
    for s, n in enumerate(lens):
        tk.scale[s, :, n:] = float("nan")
        tv.scale[s, :, n:] = float("nan")
        tk.q[s, :, n:] = 127
    got = da.decode_attention(tq, tk, tv, tl)
    assert torch.isfinite(got).all()
    assert torch.equal(got, base)


def test_paged_int8_null_block_and_stale_tails_poisoned_are_ignored():
    q, kp, vp, tbl, lens = _paged_case(7)
    _, tk = _quant(kp)
    _, tv = _quant(vp)
    args = [torch.from_numpy(x) for x in (tbl, lens)]
    base = pa.paged_attention(torch.from_numpy(q), tk, tv, *args)
    for pool in (tk, tv):
        pool.scale[0] = float("nan")           # the null block
        for s, n in enumerate(lens):
            last = tbl[s, (n - 1) // 4]
            pool.scale[last, :, n % 4 or 4:] = float("nan")
    got = pa.paged_attention(torch.from_numpy(q), tk, tv, *args)
    assert torch.isfinite(got).all()
    assert torch.equal(got, base)


def test_live_nan_scale_reaches_the_output():
    """NaN transparency: a poisoned LIVE row is not masked away."""
    q, k, v, lens = _decode_case(8)
    _, tk = _quant(k)
    _, tv = _quant(v)
    tv.scale[2, :, 3] = float("nan")
    got = da.decode_attention(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(lens))
    assert torch.isnan(got[2]).all()
    assert torch.isfinite(got[[0, 1, 3]]).all()


def test_empty_lane_gives_exact_zeros():
    q, k, v, _ = _decode_case(9)
    _, tk = _quant(k)
    _, tv = _quant(v)
    tk.scale[0] = float("nan")
    tv.scale[0] = float("nan")
    lens = torch.tensor([0, 3, 0, 24], dtype=torch.int32)
    out = da.decode_attention(torch.from_numpy(q), tk, tv, lens)
    assert out[0].abs().max().item() == 0.0
    assert out[2].abs().max().item() == 0.0
    qp, kp, vp, tbl, _ = _paged_case(9)
    _, pk = _quant(kp)
    _, pv = _quant(vp)
    out = pa.paged_attention(torch.from_numpy(qp), pk, pv,
                             torch.from_numpy(tbl),
                             torch.tensor([0, 12, 16], dtype=torch.int32))
    assert out[0].abs().max().item() == 0.0
    assert torch.isfinite(out).all()


def test_mixed_quantisation_raises():
    q, k, v, lens = _decode_case(10)
    _, tk = _quant(k)
    tq, tl = torch.from_numpy(q), torch.from_numpy(lens)
    with pytest.raises(ValueError, match="quantized together"):
        da.decode_attention(tq, tk, torch.from_numpy(v), tl)
    with pytest.raises(ValueError, match="quantized together"):
        da.decode_attention(tq, torch.from_numpy(k), tk, tl)
    qp, kp, vp, tbl, lp = _paged_case(10)
    _, pk = _quant(kp)
    with pytest.raises(ValueError, match="quantized together"):
        pa.paged_attention(torch.from_numpy(qp), pk, torch.from_numpy(vp),
                           torch.from_numpy(tbl), torch.from_numpy(lp))


@pytest.mark.parametrize("kind", ["attention", "encoder"])
def test_layer_paged_prefill_and_decode_over_int8_pools_match_jax(kind):
    """Chunked prefill then decode on int8 pools, quantize-on-write at
    every write site, through the JAX layer and the port's."""
    T, C, Bs = 8, 16, 4
    if kind == "attention":
        jl = jatt.SelfAttentionLayer(n_heads=4, causal=True,
                                     implementation="plain")
        tl = tatt.SelfAttentionLayer(n_heads=4, causal=True)
    else:
        jl = jatt.TransformerEncoderLayer(n_heads=4, causal=True,
                                          implementation="plain")
        tl = tatt.TransformerEncoderLayer(n_heads=4, causal=True)
    jl.build((T, C))
    tl.build((T, C))
    jp = jl.init_params(jax.random.PRNGKey(0))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.RandomState(1).randn(1, T, C).astype(np.float32)
    shape = (6,) + jl.cache_shape(Bs)
    jk, jv = jkv.kv_zeros(shape, "int8"), jkv.kv_zeros(shape, "int8")
    tk, tv = tkv.kv_zeros(shape, "int8"), tkv.kv_zeros(shape, "int8")
    tbl = BlockTable([2, 4, 1], Bs).padded(4)
    for p0 in (0, 2):
        jo, jk, jv = jl.apply_prefill_paged(
            jp, x[:, p0:p0 + 2], jk, jv, jnp.asarray(tbl), np.int32(p0),
            np.int32(2))
        to, tk2, _ = tl.apply_prefill_paged(
            tp, torch.from_numpy(x[:, p0:p0 + 2]), tk, tv,
            torch.from_numpy(tbl), p0, 2)
        assert tk2 is tk
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=TOL_LAYER)
    for t in range(4, T):
        jo, jk, jv = jl.apply_decode_paged(
            jp, x[:, t], jk, jv, jnp.asarray(tbl)[None],
            jnp.array([t], jnp.int32))
        to, _, _ = tl.apply_decode_paged(
            tp, torch.from_numpy(x[:, t]), tk, tv,
            torch.from_numpy(tbl)[None], torch.tensor([t]))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=TOL_LAYER)
    # compared dequantized: a value on a rounding boundary may land one
    # int8 step apart
    for t_pool, j_pool in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(tkv.dequantize(t_pool).numpy(),
                                   np.asarray(jkv.dequantize(j_pool)),
                                   rtol=0, atol=TOL_LAYER)


def test_layer_slot_decode_over_int8_cache_matches_jax():
    T, C = 6, 16
    jl = jatt.SelfAttentionLayer(n_heads=4, causal=True,
                                 implementation="plain")
    tl = tatt.SelfAttentionLayer(n_heads=4, causal=True)
    jl.build((T, C))
    tl.build((T, C))
    jp = jl.init_params(jax.random.PRNGKey(1))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.RandomState(2).randn(2, T, C).astype(np.float32)
    shape = (2,) + jl.cache_shape(T)
    jk, jv = jkv.kv_zeros(shape, "int8"), jkv.kv_zeros(shape, "int8")
    tk, tv = tkv.kv_zeros(shape, "int8"), tkv.kv_zeros(shape, "int8")
    for t in range(T):
        pos = np.array([t, max(t - 2, 0)], np.int32)
        jo, jk, jv = jl.apply_decode(jp, x[:, t], jk, jv, jnp.asarray(pos))
        to, _, _ = tl.apply_decode(tp, torch.from_numpy(x[:, t]), tk, tv,
                                   torch.from_numpy(pos).long())
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=TOL_LAYER)
