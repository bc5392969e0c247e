"""The port's data-parallel training against the JAX package's (CPU),
after ``tests/test_parallel.py`` and ``tests/test_gradient_sharing.py``.

The JAX side runs on ``make_mesh(jax.devices()[:2])`` of the conftest's
virtual CPU devices; the port's side is two gloo ranks on the CPU
(``device="cpu"``, one torch thread each), spawned ONCE for the whole
file (``tests/_torch_dp_scenarios.py::parallel_cases``) with a 120 s
deadline. Both start from JAX's initial weights and run the same
batches under the same key chain.

Tolerances (f32 sums in another order: each rank's gradient over its
rows, then the sum over the ranks, against XLA's one reduction; every
one measured before it was set): the losses within 1e-6 relative; every
leaf of the params, the updater state and the layer state within 5e-6
of the leaf's max magnitude (Adam divides the gradients' rounding by
sqrt(v): a batch-norm beta that three steps of lr 1e-2 moved to 0.03
differs by 20 ulp, 2.5e-6 of its max); a gathered residual leaf within
1e-4 of its max (a residual holds the sub-threshold remainder, ~1e-3,
of gradients of ~1e-1 whose last bits differ: 3.1e-5 measured). The
two ranks' params, updater state and layer state agree bit for bit,
and the guard's flags, the threshold and the sparsity are equal."""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.learning import Sgd as JSgd
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.parallel import (GradientSharingAccumulator as JGSA,
                                         ParallelWrapper as JPW,
                                         make_mesh as jmake_mesh,
                                         rebucket_worker_array as jrebucket)
from deeplearning4j_tpu.util.serializer import _flatten_tree as jflat

import _torch_dp_scenarios as S
from _torch_dp_util import run_ranks
from deeplearning4j_tpu_torch.parallel import (GradientSharingAccumulator,
                                               ParallelWrapper, make_mesh,
                                               rebucket_worker_array)

JSIDE = S.Side(JConf, JL, JAdam, JSgd)
TOL = 1e-6           # the losses, relative
STATE_TOL = 5e-6     # params, updater and layer state: of a leaf's max
RESIDUAL_TOL = 1e-4  # a gathered residual leaf: of its max
WORLD = 2


def _inputs():
    out = {}
    jnet = JNet(S.bn_conf(JSIDE)).init()
    out.update({f"init_bn/{k}": v for k, v in jflat(jnet.params()).items()})
    # a trained copy for ParallelInference (batch norm's running stats
    # away from their init)
    jnet.fit([(x, y) for x, y, _ in S.batches()], epochs=2)
    out.update({f"init_bn_trained/{k}": v
                for k, v in jflat(jnet.params()).items()})
    out["bn_trained_mean"] = np.asarray(jnet._net_state["layer_1"]["mean"])
    out["bn_trained_var"] = np.asarray(jnet._net_state["layer_1"]["var"])
    return out, jnet


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_parallel"))
    inputs, trained = _inputs()
    np.savez(os.path.join(out, "inputs.npz"), **inputs)
    run_ranks("parallel_cases", WORLD, out)

    def load(case, rank=0):
        with np.load(os.path.join(out, f"rank{rank}_{case}.npz")) as z:
            return {k: z[k] for k in z.files}
    load.trained = trained
    return load


@functools.lru_cache(maxsize=None)
def _jax_case(mode, guard, masked, nan):
    """JAX's run of a step case (cached: the telemetry tests read the
    same runs as the step tests)."""
    m = JNet(S.bn_conf(JSIDE)).init()
    acc = None if mode is None else JGSA(mode=mode)
    pw = JPW(m, mesh=jmake_mesh(jax.devices()[:WORLD]), prefetch_buffer=0,
             accumulator=acc)
    step = pw.ensure_step(guard=guard)
    key = jax.random.PRNGKey(S.KEY_SEED)
    params, opt, net = m._params, m._opt_state, m._net_state
    losses, oks = [], []
    for i, (x, y, msk) in enumerate(S.batches(mask=masked, nan_batch=nan)):
        key, sub = jax.random.split(key)
        out = step(params, opt, net, jnp.asarray(i), x, y, msk, sub)
        params, opt, net, loss = out[:4]
        losses.append(float(loss))
        oks.append(bool(out[4]) if guard else True)
    m._params, m._opt_state, m._net_state = params, opt, net
    return m, pw, losses, oks


def _jax_state(m, pw):
    out = {}
    for pre, tree in (("params/", m._params), ("opt/", m._opt_state),
                      ("net/", m._net_state)):
        out.update({pre + k: v for k, v in
                    jflat(jax.tree.map(np.asarray, tree)).items()})
    extra = pw.extra_checkpoint_state() or {}
    out.update({f"extra/{k}": np.asarray(v) for k, v in extra.items()})
    return out


def _close(got, want, what):
    assert sorted(k for k in got if "/" in k) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        scale = max(float(np.abs(w).max()) if w.size else 0.0, 1e-30)
        err = float(np.abs(g.astype(np.float64) - w).max()) if w.size \
            else 0.0
        tol = RESIDUAL_TOL if "/residuals/" in k else STATE_TOL
        assert err <= tol * scale, (what, k, err, scale)


def _losses_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= TOL * np.maximum(1.0, abs(want))), \
        (got, want)


def _ranks_same(load, case, mode):
    """The ranks' params and layer state, and their updater state but in
    update mode (each rank's is its own worker's moments there), bit
    for bit."""
    a, b = load(case, 0), load(case, 1)
    same = ("params/", "net/") if mode == "update" else \
        ("params/", "opt/", "net/")
    for k in a:
        if k.startswith(same):
            assert np.array_equal(a[k], b[k], equal_nan=True), (case, k)


class TestMesh:
    def test_mesh_over_the_ranks(self, ranks):
        for r in range(WORLD):
            t = json.loads(str(ranks("mesh", r)["telemetry"]))
            assert t["shape"] == {"data": WORLD, "model": 1}
            assert t["coords"] == [r, 0]
            assert t["refused"] is True      # 3 x 3 != 2 ranks
            assert t["model_shape"] == {"data": 1, "model": WORLD}
            assert t["model_coords"] == [0, r]
        # workers=1 takes the first rank, as JAX takes the first device
        assert json.loads(str(ranks("mesh", 0)["telemetry"]))["solo"] == 1
        assert json.loads(str(ranks("mesh", 1)["telemetry"]))["solo"] == -1

    def test_single_process_mesh(self):
        mesh = make_mesh()
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.coords == (0, 0)
        with pytest.raises(ValueError, match="device count"):
            make_mesh(data=2, model=1)
        with pytest.raises(ValueError):
            jmake_mesh(jax.devices()[:1], data=2, model=1)


class TestRebucket:
    @pytest.mark.parametrize("w,new_w", [(8, 4), (4, 8), (3, 2), (2, 1),
                                         (4, 4)])
    def test_rebucket_matches_jax(self, w, new_w):
        arr = np.random.RandomState(w * 10 + new_w).rand(w, 3, 2) \
            .astype(np.float32)
        got = rebucket_worker_array(arr, new_w)
        want = jrebucket(arr, new_w)
        assert got.dtype == want.dtype and np.array_equal(got, want)

    def test_identity_and_validation(self):
        arr = np.zeros((4, 2), np.float32)
        assert rebucket_worker_array(arr, 4) is arr
        with pytest.raises(ValueError):
            rebucket_worker_array(arr, 0)


class TestSteps:
    @pytest.mark.parametrize("name,mode,guard,masked,nan", S.STEP_CASES,
                             ids=[c[0] for c in S.STEP_CASES])
    def test_step_matches_jax(self, ranks, name, mode, guard, masked, nan):
        got = ranks(name)
        m, pw, losses, oks = _jax_case(mode, guard, masked, nan)
        _close(got, _jax_state(m, pw), name)
        _losses_close(got["loss"][[i for i, o in enumerate(oks) if o]],
                      [l for l, o in zip(losses, oks) if o])
        assert got["ok"].tolist() == oks
        if nan is not None:
            assert oks[nan] is False   # both ranks skipped the batch
        _ranks_same(ranks, name, mode)
        assert ranks(name, 1)["ok"].tolist() == oks
        if mode is not None:
            # the scalar carries: equal, not merely close
            assert np.array_equal(got["extra/gradient_sharing/threshold"],
                                  np.asarray(pw.accumulator.threshold))
            assert np.array_equal(
                got["extra/gradient_sharing/last_sparsity"],
                np.asarray(pw.accumulator.last_sparsity))

    @pytest.mark.parametrize("name,mode", S.FIT_CASES,
                             ids=[c[0] for c in S.FIT_CASES])
    def test_fit_matches_jax(self, ranks, name, mode):
        got = ranks(name)
        m = JNet(S.bn_conf(JSIDE)).init()
        acc = None if mode is None else JGSA(mode=mode)
        pw = JPW(m, mesh=jmake_mesh(jax.devices()[:WORLD]),
                 prefetch_buffer=0, accumulator=acc)
        losses = []
        for x, y, _ in S.batches():
            pw.fit([(x, y)], epochs=1)
            losses.append(float(m.score_))
        _close(got, _jax_state(m, pw), name)
        _losses_close(got["loss"], losses)
        _ranks_same(ranks, name, mode)

    def test_residuals_and_moments_are_per_worker(self, ranks):
        got = ranks("update")
        res = [k for k in got if k.startswith("extra/gradient_sharing/"
                                              "residuals/")]
        opt = [k for k in got if k.startswith("extra/gradient_sharing/"
                                              "opt_state/")]
        assert res and opt
        assert all(got[k].shape[0] == WORLD for k in res + opt)
        # the workers saw different rows: their residuals differ
        assert any(not np.array_equal(got[k][0], got[k][1]) for k in res)
        # the model's updater state is worker 0's live moments
        for k in opt:
            assert np.array_equal(got[k][0], got["opt/" + k.split(
                "opt_state/", 1)[1]])
        assert not any(k.startswith("extra/gradient_sharing/opt_state")
                       for k in ranks("gradient"))

    @pytest.mark.parametrize("case", ["update", "gradient_guard"])
    def test_telemetry_snapshot_matches_jax(self, ranks, case):
        mode, guard, masked, nan = {c[0]: c[1:] for c in S.STEP_CASES}[case]
        _, pw, _, _ = _jax_case(mode, guard, masked, nan)
        want = pw.telemetry_snapshot()
        for r in range(WORLD):
            got = json.loads(str(ranks(case, r)["telemetry"]))
            assert sorted(got) == sorted(want)
            assert sorted(got["compression"]) == sorted(want["compression"])
            for k, v in want["compression"].items():
                assert got["compression"][k] == pytest.approx(
                    v, rel=1e-5, abs=1e-6), (case, k)

    def test_nan_skip_keeps_residual_and_threshold(self, ranks):
        """The guarded compressed step skips the poisoned batch on both
        ranks and leaves the error feedback as it was: the guarded run
        over the poisoned data ends where a run that never saw batch 1
        would (JAX's own run is the witness, compared above); here the
        flags agree across the ranks and no NaN reached any state."""
        for case in ("update_guard", "gradient_guard", "dense_guard"):
            for r in range(WORLD):
                got = ranks(case, r)
                assert got["ok"].tolist() == [True, False, True]
                for k, v in got.items():
                    if k.startswith(("params/", "opt/", "net/", "extra/")):
                        assert np.isfinite(v).all(), (case, r, k)


def test_parallel_inference_matches_output(ranks):
    for r in range(WORLD):
        got = ranks("inference", r)
        assert np.array_equal(got["out"], got["plain"])
    x = S.batches()[0][0]
    want = np.asarray(ranks.trained.output(x))
    got = ranks("inference", 0)["out"]
    assert np.abs(got - want).max() <= STATE_TOL * np.abs(want).max()


def test_accumulator_defaults_and_validation():
    assert GradientSharingAccumulator().mode == "update" == JGSA().mode
    with pytest.raises(ValueError):
        GradientSharingAccumulator(mode="bogus")


def test_one_worker_dense_fit_is_the_models_own_step():
    """At one worker the wrapper's dense step is the network's own
    step: the same params and Adam state bit for bit as a plain fit."""
    import torch
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    torch.manual_seed(0)
    side = S.port_side()
    data = [(x, y) for x, y, _ in S.batches()]
    a = MultiLayerNetwork(S.bn_conf(side), device="cpu").init()
    b = MultiLayerNetwork(S.bn_conf(side), device="cpu").init()
    a.fit(data, epochs=2)
    pw = ParallelWrapper(b, prefetch_buffer=0)
    assert pw.num_workers == 1
    pw.fit(data, epochs=2)
    assert b._jit_step is None          # the seam swapped back
    for tree_a, tree_b in ((a._params, b._params),
                           (a._opt_state, b._opt_state),
                           (a._net_state, b._net_state)):
        fa, fb = S.flat_tree(tree_a), S.flat_tree(tree_b)
        assert sorted(fa) == sorted(fb)
        for k in fa:
            assert np.array_equal(fa[k], fb[k]), k
    assert a._step == b._step == 2 * len(data)
