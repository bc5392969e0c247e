"""The port's mixed-precision policy against the JAX package's
(``nn/precision.py`` on both sides), on the same numpy inputs.

Casts are exact operations (f32 -> bf16 rounds to nearest even on both
sides, bf16 -> f32 is exact), so every comparison is bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import precision as jp
from deeplearning4j_tpu_torch.nn import precision as tp


def _bits(x) -> np.ndarray:
    """A bf16 or f32 array's values as f32 numpy (exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("name", ["bfloat16", "bf16", "half", "float16",
                                  "fp16", "BFloat16", "HALF"])
def test_half_names_map_to_bf16(name):
    assert jp.compute_dtype(name) == jnp.bfloat16
    assert tp.compute_dtype(name) == torch.bfloat16


@pytest.mark.parametrize("name", [None, "float", "float32", "double"])
def test_other_names_are_pure_f32(name):
    assert jp.compute_dtype(name) is None
    assert tp.compute_dtype(name) is None


def _params(rs):
    return {"layer_0": {"W": rs.randn(5, 3).astype(np.float32),
                        "b": rs.randn(3).astype(np.float32)},
            "layer_1": {"W": rs.randn(3, 4).astype(np.float32),
                        "idx": np.arange(4, dtype=np.int32)},
            "layer_2": {"W": rs.randn(4, 2).astype(np.float32)}}


@pytest.mark.parametrize("cdt", [None, "bfloat16"])
def test_cast_params_for_compute_matches_jax(cdt):
    """Every f32 leaf but the exempt layer's is cast; non-float leaves
    and the exempt (output) layer stay as they are."""
    p = _params(np.random.RandomState(0))
    jout = jp.cast_params_for_compute(
        {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in p.items()},
        {"layer_2"}, jp.compute_dtype(cdt))
    tout = tp.cast_params_for_compute(
        {k: {n: torch.from_numpy(a) for n, a in d.items()}
         for k, d in p.items()}, {"layer_2"}, tp.compute_dtype(cdt))
    assert sorted(tout) == sorted(jout)
    for key in jout:
        for name, j in jout[key].items():
            t = tout[key][name]
            assert str(t.dtype).replace("torch.", "") == str(j.dtype)
            np.testing.assert_array_equal(_bits(t), _bits(j))
    if cdt is None:
        assert tout["layer_0"]["W"].dtype == torch.float32
    else:
        assert tout["layer_0"]["W"].dtype == torch.bfloat16
        assert tout["layer_1"]["idx"].dtype == torch.int32
        assert tout["layer_2"]["W"].dtype == torch.float32


def test_cast_params_keeps_the_autograd_path_to_f32_masters():
    """The cast leaves stay in the graph: a loss on them gives f32
    gradients to the f32 masters."""
    w = torch.randn(3, 2, requires_grad=True)
    cast = tp.cast_params_for_compute({"l0": {"W": w}}, set(),
                                      torch.bfloat16)["l0"]["W"]
    assert cast.dtype == torch.bfloat16
    (g,) = torch.autograd.grad(cast.float().sum(), w)
    assert g.dtype == torch.float32


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64])
@pytest.mark.parametrize("cdt", [None, "bfloat16"])
def test_cast_input_for_compute_matches_jax(dtype, cdt):
    """Floating inputs are cast; token ids stay as they are (JAX,
    without x64, holds int64 ids as int32 from the start)."""
    x = (np.random.RandomState(1).randn(4, 6) * 50).astype(dtype)
    j = jp.cast_input_for_compute(jnp.asarray(x), jp.compute_dtype(cdt))
    t = tp.cast_input_for_compute(torch.from_numpy(x), tp.compute_dtype(cdt))
    if np.issubdtype(dtype, np.integer):
        assert t.dtype == torch.from_numpy(x).dtype
        assert jnp.issubdtype(j.dtype, jnp.integer)
    else:
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
    np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_cast_feats_to_f32_matches_jax(dtype):
    x = np.random.RandomState(2).randn(3, 5).astype(np.float32) * 10
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    j = jp.cast_feats_to_f32(jx)
    t = tp.cast_feats_to_f32(tx)
    assert str(t.dtype).replace("torch.", "") == str(j.dtype)
    np.testing.assert_array_equal(_bits(t), _bits(j))
