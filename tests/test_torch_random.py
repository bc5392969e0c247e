"""The port's threefry generator against ``jax.random``: keys and
uniforms must be bit-identical, so sampled tokens depend only on the
logits, and dropout masks are JAX's.

``split``, the shaped ``uniform`` (f32 and bf16, any range) and
``bernoulli`` are held bit for bit. ``normal`` draws JAX's uniform bit
for bit and is within 3 f32 ulp of JAX's normal: XLA's CPU backend
computes ``erf_inv``'s ``log1p`` with its own approximation (the
port reproduces the polynomial and its fused multiply-adds; about 1%
of draws differ in their last bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import random as trandom
from _torch_threads import one_torch_thread  # noqa: F401,E402

SEEDS = [0, 1, 2, 7, 42, 12345, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
STEPS = [0, 1, 2, 3, 31, 64, 1000, 2 ** 20]


def _jax_key_data(key):
    return np.asarray(jax.random.key_data(key), np.uint32)


def _port_key(key):
    return np.array([int(key[0]), int(key[1])], np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_fold_in_bit_identical(seed):
    jk = jax.random.PRNGKey(np.uint32(seed))
    tk = trandom.PRNGKey(seed)
    assert np.array_equal(_jax_key_data(jk), _port_key(tk))
    for step in STEPS:
        assert np.array_equal(_jax_key_data(jax.random.fold_in(jk, step)),
                              _port_key(trandom.fold_in(tk, step)))


def test_uniform_grid_bit_identical():
    seeds = np.repeat(np.array(SEEDS, np.uint32), len(STEPS))
    steps = np.tile(np.array(STEPS, np.int64), len(SEEDS))
    want = np.array([
        np.float32(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(s), int(t)), ()))
        for s, t in zip(seeds, steps)], np.float32)
    got = trandom.uniform(trandom.fold_in(
        trandom.PRNGKey(torch.from_numpy(seeds.astype(np.int64))),
        torch.from_numpy(steps))).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert ((got >= 0) & (got < 1)).all()


def test_threefry_known_answer():
    """Threefry-2x32, 20 rounds, key (0, 0), counter (0, 0): the
    published test vector (Salmon et al., Random123)."""
    x1, x2 = trandom.threefry2x32(0, 0, 0, 0)
    assert (int(x1), int(x2)) == (0x6B200159, 0x99BA4EFE)


def test_threefry_partitionable_layout():
    """The counter layout the port reproduces is the partitionable one
    (JAX's default since 0.5)."""
    assert jax.config.jax_threefry_partitionable


SHAPES = [(1,), (7,), (3, 5, 4), (2, 6, 6, 8)]


@pytest.mark.parametrize("num", [1, 2, 3, 5, 17])
@pytest.mark.parametrize("seed", SEEDS[:5])
def test_split_bit_identical(seed, num):
    jk = jax.random.PRNGKey(np.uint32(seed))
    want = np.asarray(jax.random.split(jk, num), np.uint32)
    got = trandom.split(trandom.PRNGKey(seed), num)
    assert np.array_equal(want[:, 0], np.array(got[0], np.uint32))
    assert np.array_equal(want[:, 1], np.array(got[1], np.uint32))
    # a chain of splits, as the training step walks it
    j, t = jk, trandom.PRNGKey(seed)
    for _ in range(4):
        j = jax.random.split(j)[1]
        t = trandom.key_at(trandom.split(t), 1)
    assert np.array_equal(_jax_key_data(j), _port_key(t))


@pytest.mark.parametrize("num", [1, 2, 5])
def test_split_of_tensor_keys_bit_identical(num):
    """A key held in tensors splits to the same bits as the same key in
    ints (the training chain's form)."""
    for seed in SEEDS:
        k = trandom.fold_in(trandom.PRNGKey(seed), 3)
        got = trandom.split((torch.tensor(k[0]), torch.tensor(k[1])), num)
        want = trandom.split(k, num)
        assert [int(v) for v in got[0]] == list(want[0])
        assert [int(v) for v in got[1]] == list(want[1])
        assert isinstance(k[0], int) and isinstance(want[0][0], int)


def _key_pair(seed):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), 99),
            trandom.fold_in(trandom.PRNGKey(seed), 99))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 3.0), (0.125, 0.25)])
# (3, 65537): four of the hash's chunks on one CPU thread, the last one
# partial (random.py::_CPU_CHUNK)
@pytest.mark.parametrize("shape", SHAPES + [(3, 65537)])
@pytest.mark.parametrize("seed", [0, 42, 2 ** 32 - 1])
def test_shaped_uniform_bit_identical(seed, shape, lo, hi):
    jk, tk = _key_pair(seed)
    want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
    got = trandom.uniform(tk, shape, torch.float32, lo, hi).numpy()
    assert got.shape == shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    wb = np.asarray(jax.random.uniform(jk, shape, jnp.bfloat16))
    gb = trandom.uniform(tk, shape, torch.bfloat16)
    assert np.array_equal(gb.view(torch.int16).numpy().view(np.uint16),
                          wb.view(np.uint16))


@pytest.mark.parametrize("p", [0.05, 0.5, 0.7, 0.95])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [1, 7, 2 ** 31])
def test_bernoulli_bit_identical(seed, shape, p):
    jk, tk = _key_pair(seed)
    want = np.asarray(jax.random.bernoulli(jk, p, shape))
    got = trandom.bernoulli(tk, p, shape).numpy()
    assert got.dtype == np.bool_ and np.array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES + [(64, 6, 6, 64)])
@pytest.mark.parametrize("seed", [0, 123, 2 ** 32 - 1])
def test_normal_within_three_ulp(seed, shape):
    jk, tk = _key_pair(seed)
    want = np.asarray(jax.random.normal(jk, shape))
    got = trandom.normal(tk, shape).numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 3
    assert (ulp > 0).mean() < 0.05
