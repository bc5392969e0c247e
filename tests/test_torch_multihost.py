"""The port's multi-process training against the JAX package's (CPU),
after ``tests/test_multihost_training.py`` and
``tests/test_cluster_init.py``: ``initialize_cluster`` joins two gloo
ranks; ``build_multihost_step`` over ``global_mesh`` fed each rank's
``host_local_array`` shard and ``replicated_array`` state; the
compressed wrapper step over a (2, 1) mesh; and ``ParallelWrapper.fit``
on each process's own rows (``MultiHostIterator``).

The two ranks are spawned ONCE for the file
(``tests/_torch_dp_scenarios.py::multihost_cases``, a 120 s deadline),
from JAX's initial weights. Tolerances: both ranks' losses equal bit for
bit; against JAX, losses within 1e-6 relative and params within 1e-6
of a leaf's max (SGD on f32 sums in another order), the compressed
step's state within tests/test_torch_parallel.py's tolerances."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JIter
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.learning import Sgd as JSgd
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.parallel import (GradientSharingAccumulator as JGSA,
                                         ParallelWrapper as JPW,
                                         make_mesh as jmake_mesh)
from deeplearning4j_tpu.util.serializer import _flatten_tree as jflat

import _torch_dp_scenarios as S
from _torch_dp_util import run_ranks
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nn.global_batch import LocalShard
from deeplearning4j_tpu_torch.parallel import PartitionSpec, make_mesh
from deeplearning4j_tpu_torch.parallel.elastic import initialize_cluster
from deeplearning4j_tpu_torch.parallel.multihost import (
    MultiHostIterator, global_mesh, host_local_array, replicated_array)
from test_torch_parallel import RESIDUAL_TOL, STATE_TOL

JSIDE = S.Side(JConf, JL, JAdam, JSgd)
TOL = 1e-6
WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_multihost"))
    inputs = {}
    for name, adam in (("mlp", False), ("mlp_adam", True)):
        jnet = JNet(S.mlp_conf(JSIDE, adam=adam)).init()
        inputs.update({f"init_{name}/{k}": v
                       for k, v in jflat(jnet.params()).items()})
    np.savez(os.path.join(out, "inputs.npz"), **inputs)
    run_ranks("multihost_cases", WORLD, out)

    def load(case, rank=0):
        with np.load(os.path.join(out, f"rank{rank}_{case}.npz")) as z:
            return {k: z[k] for k in z.files}
    return load


def _meta(d):
    return json.loads(str(d["telemetry"]))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= tol * np.maximum(1.0, abs(want))), \
        (got, want)


def _params_close(got, jnet):
    want = jflat(jax.tree.map(np.asarray, jnet._params))
    for k, w in want.items():
        err = np.abs(got[f"params/{k}"].astype(np.float64) - w).max()
        assert err <= TOL * np.abs(w).max(), (k, err)


def test_initialize_cluster_joins_the_ranks(ranks):
    for r in range(WORLD):
        t = _meta(ranks("cluster", r))
        assert (t["world"], t["rank"]) == (WORLD, r)
        assert t["backend"] == "gloo"
        assert t["noop"] is False


def test_single_process_is_noop_and_needs_every_coordinate():
    from deeplearning4j_tpu.parallel.elastic import \
        initialize_cluster as jinit
    assert initialize_cluster(num_processes=1) is False
    assert jinit(num_processes=1) is False
    with pytest.raises(ValueError, match="together"):
        initialize_cluster("127.0.0.1:1", num_processes=2)


def test_multihost_step_matches_single_process(ranks):
    """Two ranks, each holding its half of the global batch, observe the
    same losses as one process stepping the whole batch."""
    a, b = ranks("step", 0), ranks("step", 1)
    assert np.array_equal(a["loss"], b["loss"])
    for k in a:
        if k.startswith("params/"):
            assert np.array_equal(a[k], b[k]), k
    assert _meta(a) == {"global_shape": [16, 4], "local_rows": 8}
    m = JNet(S.mlp_conf(JSIDE)).init()
    step = jax.jit(m._make_step_fn())
    X, Y = S.global_data()
    params, opt, net = m._params, m._opt_state, m._net_state
    rng = jax.random.PRNGKey(0)
    losses = []
    for i in range(4):
        params, opt, net, loss = step(params, opt, net, jnp.asarray(i), X,
                                      Y, None, rng)
        losses.append(float(loss))
    m._params = params
    _close(a["loss"], losses)
    _params_close(a, m)
    assert a["loss"][-1] < a["loss"][0]


def test_compressed_step_over_the_ranks(ranks):
    """The Strom step over real cross-process collectives, fed local
    shards: both ranks see the same losses and params, and they match
    JAX's wrapper on two devices over the same global batch."""
    a, b = ranks("comp", 0), ranks("comp", 1)
    assert np.array_equal(a["loss"], b["loss"])
    for k in a:
        if k.startswith(("params/", "net/")):
            assert np.array_equal(a[k], b[k]), k
    m = JNet(S.mlp_conf(JSIDE, adam=True)).init()
    pw = JPW(m, mesh=jmake_mesh(jax.devices()[:WORLD]), prefetch_buffer=0,
             accumulator=JGSA(threshold=1e-3))
    pw._build_step()
    X, Y = S.global_data()
    params, opt, net = m._params, m._opt_state, m._net_state
    rng = jax.random.PRNGKey(0)
    losses = []
    for i in range(4):
        params, opt, net, loss = pw._sharded_step(
            params, opt, net, jnp.asarray(i), X, Y, None, rng)
        losses.append(float(loss))
    _close(a["loss"], losses)
    assert a["loss"][-1] < a["loss"][0]
    want = {f"params/{k}": v for k, v in
            jflat(jax.tree.map(np.asarray, params)).items()}
    want.update({f"extra/{k}": np.asarray(v) for k, v in
                 pw.extra_checkpoint_state().items()})
    for k, w in want.items():
        tol = RESIDUAL_TOL if "/residuals/" in k else STATE_TOL
        err = np.abs(a[k].astype(np.float64) - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (k, err)


def test_fit_on_each_process_rows_matches_single_fit(ranks):
    """The user API: ParallelWrapper.fit on a per-process iterator
    (wrapped by MultiHostIterator) trains as one process's fit over the
    global batches."""
    a, b = ranks("fit", 0), ranks("fit", 1)
    assert np.array_equal(a["loss"], b["loss"])
    meta = _meta(a)
    assert meta["batch_size"] == 16
    assert meta["item_global"] == [[16, 4], [16, 2]]
    assert meta["item_local"] == [[8, 4], [8, 2]]
    m = JNet(S.mlp_conf(JSIDE)).init()
    X, Y = S.global_data(32)
    it = JIter(X, Y, batch=16, shuffle=False)
    losses = []
    for _ in range(3):
        m.fit(it, epochs=1)
        losses.append(float(m.score_))
    _close(a["loss"], losses)
    _params_close(a, m)
    assert a["loss"][-1] < a["loss"][0]


class TestGlobalArrays:
    """The helpers on one process (a mesh of one rank)."""

    def test_host_local_array(self):
        mesh = global_mesh()
        assert mesh.shape == {"data": 1}
        x = np.arange(12, dtype=np.float32).reshape(6, 2)
        s = host_local_array(mesh, PartitionSpec("data"), x)
        assert isinstance(s, LocalShard)
        assert s.shape == (6, 2) and len(s) == 6 and s.ndim == 2
        assert np.array_equal(s.local.numpy(), x)
        s2 = host_local_array(mesh, PartitionSpec("data"), x,
                              global_shape=(12, 2))
        assert s2.global_shape == (12, 2)
        with pytest.raises(ValueError):
            host_local_array(mesh, PartitionSpec(None, "data"), x)

    def test_replicated_array_is_each_ranks_copy(self):
        tree = {"a": {"w": np.ones((2, 2), np.float32)}, "b": (np.zeros(3),)}
        out = replicated_array(make_mesh(), tree)
        assert out["a"]["w"].shape == (2, 2) and out["b"][0].shape == (3,)

    def test_multihost_iterator_marks_local_rows(self):
        x = np.arange(16, dtype=np.float32).reshape(8, 2)
        y = np.eye(2, dtype=np.float32)[np.arange(8) % 2]
        it = MultiHostIterator(ArrayDataSetIterator(x, y, batch=4),
                               make_mesh())
        assert it.batch_size() == 4
        items = list(it)
        assert len(items) == 2
        assert all(isinstance(v, LocalShard) for v in items[0])
        assert np.array_equal(items[1][0].local.numpy(), x[4:])
        assert it.state_dict() == {"epoch": 1}
