"""The port's int8 KV-cache and weight-only primitives
(``kernels/kv_quant.py``) against the JAX package on the same
numpy-seeded inputs: quantize_rows gives JAX's int8 values and scales
on finite rows, NaN stays NaN through the scale, a zero row gets scale
1, byte accounting equals JAX's, the in-place writes (kv_set,
kv_update_slice, kv_copy_row) store what JAX's functional ones return,
scales included; quantize_weight and mm match JAX; params_from_jax
carries a quantized tree; quantize_mlp_weights is idempotent."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import kv_quant as jkv
from deeplearning4j_tpu.zoo.transformer_lm import CausalTransformerLM as JaxLM
from deeplearning4j_tpu.zoo.transformer_lm import \
    quantize_mlp_weights as jax_quantize_mlp
from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.kernels import kv_quant as tkv
from deeplearning4j_tpu_torch.zoo.transformer_lm import (CausalTransformerLM,
                                                         quantize_mlp_weights)

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=32)


def _rows(seed, *shape, spread=True):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    if spread:  # rows of very different magnitude
        x *= np.exp(rs.randn(*shape[:-1], 1)).astype(np.float32)
    return x


@pytest.mark.parametrize("seed", range(4))
def test_quantize_rows_identical_to_jax_on_finite_rows(seed):
    x = _rows(seed, 3, 4, 16, 8)
    x[0, 0, 0] = 0.0            # a zero row
    x[1, 1, 1, :4] = 127 * 0.5  # .5 boundaries after the division
    x[1, 1, 1, 4:] = 0.0
    want = jkv.quantize_rows(jnp.asarray(x))
    got = tkv.quantize_rows(torch.from_numpy(x))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(tkv.dequantize(got).numpy(),
                                  np.asarray(jkv.dequantize(want)))


def test_nan_row_dequantizes_to_nan_and_zero_row_gets_scale_one():
    x = _rows(5, 4, 8)
    x[1, 3] = np.nan
    x[2] = 0.0
    got = tkv.quantize_rows(torch.from_numpy(x))
    deq = tkv.dequantize(got).numpy()
    assert np.isnan(got.scale[1].item())
    assert np.isnan(deq[1]).all()
    assert got.scale[2].item() == 1.0 and (got.q[2] == 0).all()
    assert np.isfinite(deq[[0, 2, 3]]).all()
    # compared dequantized: NaN -> int8 is undefined in both frameworks
    want = np.asarray(jkv.dequantize(jkv.quantize_rows(jnp.asarray(x))))
    np.testing.assert_array_equal(np.isnan(deq), np.isnan(want))
    np.testing.assert_array_equal(deq[[0, 2, 3]], want[[0, 2, 3]])


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_byte_accounting_matches_jax(kv_dtype):
    for shape in ((5, 4, 16, 8), (2, 3, 7, 12)):
        assert tkv.kv_nbytes(shape, kv_dtype) == jkv.kv_nbytes(shape,
                                                               kv_dtype)
    layers = [(4, 16, 8), (2, 16, 32)]
    assert tkv.kv_bytes_per_token(layers, kv_dtype) == \
        jkv.kv_bytes_per_token(layers, kv_dtype)
    scale = tkv.kv_scale_nbytes((5, 4, 16, 8), kv_dtype)
    assert scale == (5 * 4 * 16 * 4 if kv_dtype == "int8" else 0)


def test_kv_zeros_int8_is_a_quant_array():
    z = tkv.kv_zeros((3, 2, 4, 8), "int8")
    assert tkv.is_quantized(z)
    assert z.q.dtype == torch.int8 and tuple(z.q.shape) == (3, 2, 4, 8)
    assert z.scale.dtype == torch.float32 and tuple(z.scale.shape) == (3, 2, 4)
    assert z.shape == z.q.shape and z.dtype == torch.int8
    assert z.device.type == "cpu"


def test_kv_set_quantizes_on_write_in_place():
    vals = _rows(7, 2, 3, 8)
    slots, pos = np.array([0, 2]), np.array([1, 4])
    jc = jkv.kv_zeros((3, 3, 6, 8), "int8")
    jidx = (jnp.asarray(slots)[:, None], jnp.arange(3)[None, :],
            jnp.asarray(pos)[:, None])
    want = jkv.kv_set(jc, jidx, jnp.asarray(vals))
    tc = tkv.kv_zeros((3, 3, 6, 8), "int8")
    q0, s0 = tc.q, tc.scale
    tidx = (torch.from_numpy(slots)[:, None], torch.arange(3)[None, :],
            torch.from_numpy(pos)[:, None])
    out = tkv.kv_set(tc, tidx, torch.from_numpy(vals))
    assert out is tc and tc.q is q0 and tc.scale is s0   # in place
    np.testing.assert_array_equal(tc.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(want.scale))


def test_kv_update_slice_writes_values_and_scales_in_place():
    slab = _rows(8, 1, 2, 5, 8)
    want = jkv.kv_update_slice(jkv.kv_zeros((3, 2, 7, 8), "int8"),
                               jnp.asarray(slab), (1, 0, 2, 0))
    tc = tkv.kv_zeros((3, 2, 7, 8), "int8")
    out = tkv.kv_update_slice(tc, torch.from_numpy(slab), (1, 0, 2, 0))
    assert out is tc
    np.testing.assert_array_equal(tc.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(want.scale))
    assert (tc.scale[1, :, 2:7] > 0).all() and (tc.scale[0] == 0).all()


def test_kv_copy_row_copies_the_scale_row():
    x = _rows(9, 5, 2, 4, 8)
    jpool = jkv.quantize_rows(jnp.asarray(x))
    want = jkv.kv_copy_row(jpool, 1, 3)
    tpool = tkv.quantize_rows(torch.from_numpy(x))
    out = tkv.kv_copy_row(tpool, 1, 3)
    assert out is tpool
    np.testing.assert_array_equal(tpool.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(tpool.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(tpool.scale[3].numpy(),
                                  tpool.scale[1].numpy())


def test_kv_operands_and_dequant_match_jax():
    x = _rows(10, 2, 3, 4, 8)
    jq = jkv.quantize_rows(jnp.asarray(x))
    tq = tkv.quantize_rows(torch.from_numpy(x))
    vals, scale = tkv.kv_operands(tq)
    jvals, jscale = jkv.kv_operands(jq)
    assert vals.dtype == torch.bfloat16
    np.testing.assert_array_equal(vals.float().numpy(),
                                  np.asarray(jvals.astype(jnp.float32)))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(tkv.kv_dequant_f32(tq).numpy(),
                                  np.asarray(jkv.kv_dequant_f32(jq)))
    b = torch.from_numpy(x).to(torch.bfloat16)
    assert tkv.kv_operands(b)[1] is None


# ---------------------------------------------------------------------------
# weight-only int8
# ---------------------------------------------------------------------------
def test_quantize_weight_identical_to_jax():
    w = _rows(11, 8, 16).T.copy()      # [16, 8], columns of all sizes
    w[:, 3] = 0.0                       # an all-zero output channel
    want = jkv.quantize_weight(jnp.asarray(w))
    got = tkv.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.scale[3].item() == 1.0


def test_mm_matches_jax():
    x = _rows(12, 4, 16)
    w = _rows(13, 16, 8)
    qw_t = tkv.quantize_weight(torch.from_numpy(w))
    got = tkv.mm(torch.from_numpy(x), qw_t).numpy()
    want = np.asarray(jkv.mm(jnp.asarray(x), jkv.quantize_weight(
        jnp.asarray(w))))
    assert got.dtype == np.float32
    # the same exact products summed in another order
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # plain weights fall through to the ordinary product
    np.testing.assert_array_equal(
        tkv.mm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        (torch.from_numpy(x) @ torch.from_numpy(w)).numpy())


def test_params_from_jax_carries_quant_weights():
    jlm = jax_quantize_mlp(JaxLM(**CFG, seed=0).init())
    tree = jax.tree.map(np.asarray, jlm._params)
    params = params_from_jax(tree)
    for bp, jbp in zip(params["blocks"], jlm._params["blocks"]):
        for name in ("W1", "W2"):
            assert isinstance(bp[name], tkv.QuantWeight)
            np.testing.assert_array_equal(bp[name].q.numpy(),
                                          np.asarray(jbp[name].q))
            np.testing.assert_array_equal(bp[name].scale.numpy(),
                                          np.asarray(jbp[name].scale))
        assert isinstance(bp["attn_Wq"], torch.Tensor)
    lm = CausalTransformerLM(**CFG, device="cpu").load_params(tree)
    prompt = np.array([[1, 5, 2, 9, 3, 7, 4, 6]])
    want = np.asarray(jlm.logits(prompt))
    got = lm.logits(prompt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_params_from_jax_rejects_a_malformed_quant_weight():
    jlm = jax_quantize_mlp(JaxLM(**CFG, seed=0).init())
    tree = jax.tree.map(np.asarray, jlm._params)
    bad = tree["blocks"][0]["W1"]
    tree["blocks"][0]["W1"] = type(bad)(bad.q.astype(np.float32), bad.scale)
    with pytest.raises(TypeError, match="int8"):
        params_from_jax(tree)


def test_quantize_mlp_weights_in_place_idempotent_and_matches_jax():
    jlm = JaxLM(**CFG, seed=0).init()
    lm = CausalTransformerLM(**CFG, device="cpu").load_params(
        jax.tree.map(np.asarray, jlm._params))
    prompt = np.array([[1, 5, 2, 9, 3, 7, 4, 6]])
    ref = lm.logits(prompt).numpy()
    assert quantize_mlp_weights(lm) is lm
    first = [(bp["W1"], bp["W2"]) for bp in lm._params["blocks"]]
    quantize_mlp_weights(lm)
    for (w1, w2), bp in zip(first, lm._params["blocks"]):
        assert bp["W1"] is w1 and bp["W2"] is w2   # second call: no-op
        assert isinstance(w1, tkv.QuantWeight)
    got = lm.logits(prompt).numpy()
    jax_quantize_mlp(jlm)
    want = np.asarray(jlm.logits(prompt))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # and the int8 MLP stays close to the f32 one (the JAX test's bound)
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 0.02
