"""The port's CausalTransformerLM against the JAX model on the same
weights (f32, CPU): prefill and cached-decode logits within 1e-5, and
greedy continuations identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.zoo.transformer_lm import (
    CausalTransformerLM as JaxLM, quantize_mlp_weights)
from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.zoo.transformer_lm import CausalTransformerLM
from _torch_threads import one_torch_thread  # noqa: F401,E402

# f32 on both sides: the same math, summed in another order
TOL = 1e-5
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
           max_seq_len=32)


@pytest.fixture(scope="module")
def pair():
    jlm = JaxLM(**CFG, seed=0, implementation="plain").init()
    tlm = CausalTransformerLM(**CFG, seed=0, device="cpu").load_params(
        jax.tree.map(np.asarray, jlm._params))
    return jlm, tlm


def test_init_from_the_seed_is_jax_init():
    """``init`` draws from JAX's keys: the JAX model's weights from the
    same seed (within 8 f32 ulp of each weight, the ones and zeros
    exact)."""
    jlm = JaxLM(**CFG, seed=3, implementation="plain").init()
    tlm = CausalTransformerLM(**CFG, seed=3, device="cpu").init()
    jp = jax.tree.map(np.asarray, jlm._params)
    pairs = [(jp[k], tlm._params[k]) for k in ("tok", "pos", "lnf_g",
                                                "lnf_b", "head")]
    assert len(jp["blocks"]) == len(tlm._params["blocks"]) == 2
    for jb, tb in zip(jp["blocks"], tlm._params["blocks"]):
        assert jb.keys() == tb.keys()
        pairs += [(jb[k], tb[k]) for k in jb]
    for want, got in pairs:
        got = got.numpy()
        assert got.shape == want.shape
        assert np.all(np.abs(got - want) <= 8 * np.spacing(np.abs(want)))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=TOL)


def test_forward_prefill_matches(pair):
    jlm, tlm = pair
    toks = np.random.RandomState(0).randint(0, 64, (2, 12))
    km = np.ones((2, 12), np.float32)
    km[1, 7:] = 0.0
    jl, jks, jvs = jlm.forward_prefill(jlm._params, toks, km)
    with torch.inference_mode():
        tl, tks, tvs = tlm.forward_prefill(tlm._params, torch.from_numpy(toks),
                                           torch.from_numpy(km))
    _close(tl, jl)
    for a, b in zip(tks + tvs, jks + jvs):
        _close(a, b)


def test_forward_decode_matches(pair):
    jlm, tlm = pair
    S, L = 3, 5
    toks = np.random.RandomState(1).randint(0, 64, (S, 12))
    shapes = jlm.cache_shapes(16)
    assert tlm.cache_shapes(16) == shapes
    jk = [jnp.zeros((S,) + s) for s in shapes]
    jv = [jnp.zeros((S,) + s) for s in shapes]
    _, ks, vs = jlm.forward_prefill(jlm._params, toks[:, :L])
    jk = [c.at[:, :, :L].set(k) for c, k in zip(jk, ks)]
    jv = [c.at[:, :, :L].set(v) for c, v in zip(jv, vs)]
    tk = [torch.from_numpy(np.array(c)) for c in jk]
    tv = [torch.from_numpy(np.array(c)) for c in jv]
    with torch.inference_mode():
        for t in range(L, 12):
            pos = np.full(S, t, np.int32)
            jl, jk, jv = jlm.forward_decode(jlm._params, toks[:, t], pos,
                                            jk, jv)
            tl, _, _ = tlm.forward_decode(
                tlm._params, torch.from_numpy(toks[:, t]).long(),
                torch.from_numpy(pos).long(), tk, tv)
            _close(tl, jl)


def _greedy(last_logits_fn, prompt, n):
    """Uncached greedy: the full prefix through the model each step."""
    toks, out = list(prompt), []
    for _ in range(n):
        t = int(np.asarray(last_logits_fn(toks)).argmax())
        out.append(t)
        toks.append(t)
    return out


def _jax_last_logits(jlm):
    """Last-position logits with the prefix padded to the full table:
    causal, so the padding cannot reach position len - 1, and one shape
    keeps JAX from compiling per length."""
    def fn(toks):
        padded = np.zeros((1, CFG["max_seq_len"]), np.int32)
        padded[0, :len(toks)] = toks
        return jlm.logits(padded)[0, len(toks) - 1]
    return fn


def _cached_greedy(tlm, prompt, n, tmax=32):
    """Greedy through the port's cached path: prefill, then decode."""
    kc = [torch.zeros((1,) + s) for s in tlm.cache_shapes(tmax)]
    vc = [torch.zeros((1,) + s) for s in tlm.cache_shapes(tmax)]
    with torch.inference_mode():
        logits, ks, vs = tlm.forward_prefill(
            tlm._params, torch.tensor([prompt]))
        for c, k in zip(kc + vc, ks + vs):
            c[:, :, :len(prompt)] = k
        out = [int(logits[0, -1].argmax())]
        for i in range(n - 1):
            pos = torch.tensor([len(prompt) + i])
            logits, _, _ = tlm.forward_decode(
                tlm._params, torch.tensor([out[-1]]), pos, kc, vc)
            out.append(int(logits[0].argmax()))
    return out


@pytest.mark.parametrize("prompt", [[1, 2, 3], [5], list(range(10, 30))])
def test_greedy_continuations_identical(pair, prompt):
    jlm, tlm = pair
    want = _greedy(_jax_last_logits(jlm), prompt, 8)
    assert _greedy(lambda t: tlm.logits([t])[0, -1].numpy(), prompt, 8) \
        == want
    assert _cached_greedy(tlm, prompt, 8) == want


def test_init_is_seeded_and_keeps_the_jax_layout(pair):
    jlm, _ = pair
    a = CausalTransformerLM(**CFG, seed=3, device="cpu").init()
    b = CausalTransformerLM(**CFG, seed=3, device="cpu").init()
    c = CausalTransformerLM(**CFG, seed=4, device="cpu").init()
    assert torch.equal(a._params["blocks"][1]["W2"],
                       b._params["blocks"][1]["W2"])
    assert not torch.equal(a._params["tok"], c._params["tok"])
    shapes = jax.tree.map(lambda x: tuple(x.shape), jlm._params)
    assert jax.tree.map(lambda x: tuple(x.shape), a._params,
                        is_leaf=lambda x: isinstance(x, torch.Tensor)) \
        == shapes


def test_load_params_checks_shapes(pair):
    jlm, _ = pair
    tree = jax.tree.map(np.asarray, jlm._params)
    tree["blocks"][0]["W1"] = tree["blocks"][0]["W1"][:, :8]
    with pytest.raises(ValueError, match="W1"):
        CausalTransformerLM(**CFG, device="cpu").load_params(tree)


def test_quantized_weights_not_ported_yet():
    """QuantWeight leaves, once refused, now arrive as the port's
    QuantWeight; a leaf of any other kind is still refused."""
    jlm = quantize_mlp_weights(JaxLM(**CFG, seed=0).init())
    tree = jax.tree.map(np.asarray, jlm._params)
    params = params_from_jax(tree)
    w1 = params["blocks"][0]["W1"]
    assert type(w1).__name__ == "QuantWeight" and w1.q.dtype == torch.int8
    tree["blocks"][0]["W1"] = [1.0, 2.0]
    with pytest.raises(TypeError, match="numpy"):
        params_from_jax(tree)
