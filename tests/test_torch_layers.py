"""Port layers against the JAX layers on the same weights (f32, CPU):
``layer_norm``, and ``apply_seq``/``apply_prefill``/``apply_decode`` of
``SelfAttentionLayer`` and ``TransformerEncoderLayer``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.functional import layer_norm as jax_layer_norm
from deeplearning4j_tpu.nn.layers.attention import (
    SelfAttentionLayer as JaxSelfAttention,
    TransformerEncoderLayer as JaxEncoder)
from deeplearning4j_tpu_torch import random as R
from deeplearning4j_tpu_torch.nn.functional import layer_norm
from deeplearning4j_tpu_torch.nn.layers.attention import (
    SelfAttentionLayer, TransformerEncoderLayer)

# f32 on both sides: the same math, summed in another order
TOL = 1e-5

B, T, C, H, TMAX = 2, 6, 16, 4, 10


def _to_torch(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def _pair(kind):
    if kind == "attention":
        jl = JaxSelfAttention(n_heads=H, causal=True, implementation="plain")
        tl = SelfAttentionLayer(n_heads=H, causal=True)
    else:
        jl = JaxEncoder(n_heads=H, causal=True, implementation="plain")
        tl = TransformerEncoderLayer(n_heads=H, causal=True)
    jl.build((T, C))
    tl.build((T, C))
    jp = jl.init_params(jax.random.PRNGKey(0))
    return jl, tl, jp, _to_torch(jp)


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _mask():
    km = np.ones((B, T), np.float32)
    km[1, 4:] = 0.0
    return km


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=TOL)


def test_layer_norm_matches():
    x = _x(0, (3, 5, 16)) * 3 + 1
    g, b = _x(1, (16,)), _x(2, (16,))
    _close(layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                      torch.from_numpy(b)).numpy(),
           jax_layer_norm(x, g, b))


@pytest.mark.parametrize("kind", ["attention", "encoder"])
def test_param_shapes_match(kind):
    jl, tl, jp, _ = _pair(kind)
    assert tl.param_shapes() == jl.param_shapes()
    tp = tl.init_params(R.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


@pytest.mark.parametrize("kind", ["attention", "encoder"])
def test_apply_prefill_matches(kind):
    jl, tl, jp, tp = _pair(kind)
    x, km = _x(3, (B, T, C)), _mask()
    jo, jk, jv = jl.apply_prefill(jp, x, km)
    to, tk, tv = tl.apply_prefill(tp, torch.from_numpy(x),
                                  torch.from_numpy(km))
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("kind", ["attention", "encoder"])
def test_apply_decode_matches_and_writes_in_place(kind):
    jl, tl, jp, tp = _pair(kind)
    x = _x(4, (B, T, C))
    Dh = C // H
    _, jk, jv = jl.apply_prefill(jp, x[:, :3])
    jkc = jnp.zeros((B, H, TMAX, Dh)).at[:, :, :3].set(jk)
    jvc = jnp.zeros((B, H, TMAX, Dh)).at[:, :, :3].set(jv)
    tkc = torch.from_numpy(np.array(jkc))
    tvc = torch.from_numpy(np.array(jvc))
    for t in range(3, T):
        jo, jkc, jvc = jl.apply_decode(jp, x[:, t], jkc, jvc,
                                       jnp.full((B,), t, jnp.int32))
        to, k2, v2 = tl.apply_decode(tp, torch.from_numpy(x[:, t]), tkc, tvc,
                                     torch.full((B,), t))
        assert k2 is tkc and v2 is tvc          # written in place
        _close(to, jo)
        _close(tkc, jkc)
        _close(tvc, jvc)


@pytest.mark.parametrize("kind", ["attention", "encoder"])
def test_apply_seq_matches(kind):
    jl, tl, jp, tp = _pair(kind)
    x, km = _x(5, (B, T, C)), _mask()
    jo = jl.apply_seq(jp, x, None, False, None, (), km)[0]
    _close(tl.apply_seq(tp, torch.from_numpy(x), None, False, None, (),
                        torch.from_numpy(km))[0], jo)


def test_flash_matches_plain_attention_on_cpu():
    """The flash kernel's plain version (what a CPU tensor gets from
    ``flash_attention``) agrees with the plain attention the layer uses
    on the CPU, wherever a row has a live key."""
    from deeplearning4j_tpu_torch.kernels.flash_attention import \
        flash_attention
    from deeplearning4j_tpu_torch.parallel.longseq import \
        dot_product_attention
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rng.randn(B, T, H, C // H)
                                .astype(np.float32)) for _ in range(3))
    km = torch.from_numpy(_mask())
    _close(flash_attention(q, k, v, causal=True, key_mask=km)[0],
           dot_product_attention(q, k, v, mask=km[:, None, None, :] > 0,
                                 causal=True))


def test_acausal_prefill_rejected_and_cache_shape():
    lay = SelfAttentionLayer(n_heads=2, causal=False)
    lay.build((4, 8))
    p = lay.init_params(R.PRNGKey(0))
    with pytest.raises(ValueError, match="causal"):
        lay.apply_prefill(p, torch.zeros((1, 4, 8)))
    assert lay.cache_shape(16) == (2, 16, 4)


def test_attend_takes_plain_attention_on_cpu(monkeypatch):
    """Attention is chosen by device alone: CPU tensors never reach the
    flash wrapper."""
    import deeplearning4j_tpu_torch.nn.layers.attention as att

    def no_flash(*a, **kw):
        raise AssertionError("flash_attention called on CPU tensors")

    monkeypatch.setattr(att, "flash_attention_autograd", no_flash)
    jl, tl, jp, tp = _pair("attention")
    x, km = _x(7, (B, T, C)), _mask()
    jo = jl.apply_prefill(jp, x, km)[0]
    _close(tl.apply_prefill(tp, torch.from_numpy(x),
                            torch.from_numpy(km))[0], jo)
