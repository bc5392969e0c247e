"""The port's resilient-training runtime against the JAX package's
(CPU): ``TrainingSupervisor``, ``AsyncCheckpointWriter`` and the
supervised step loop of ``FaultTolerantTrainer``, mirroring
``tests/test_resilient_training.py`` (its ParallelWrapper class has
its counterpart in ``tests/test_torch_elastic.py::TestWrapperMode``).

Both packages train the same MLP from the same weights (JAX's, carried
with ``convert.py``) on the same numpy-seeded batches under the same
``FaultInjector`` plan. Within the port every contract is bit for bit
(retry, skip, rollback, kill-and-resume); against JAX the counters,
step counters and checkpoint names are equal and the params agree
within 1e-5 (f32 GEMMs summed in another order over at most 18 Adam
steps at lr 1e-2, where Adam moves a param by ~lr * sign(g)).

Timing is never raced: the async-stall case holds the background write
on an Event and asserts the step loop went on past it, and the slow
disk is a ``slow_ms`` sleep, whose lower bound is exact.
"""
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JIter
from deeplearning4j_tpu.faults import FaultInjector as JInjector
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.parallel.elastic import \
    FaultTolerantTrainer as JTrainer
from deeplearning4j_tpu_torch.convert import network_params_from_jax
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.faults import (FaultInjector, PreemptionFault,
                                             TransientFault)
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.parallel.elastic import (FaultTolerantTrainer,
                                                       PreemptionHandler)
from deeplearning4j_tpu_torch.parallel.resilience import (
    AsyncCheckpointWriter, TrainingAnomalyError, TrainingSupervisor)

PARAM_ATOL = 1e-5


def _conf(Conf, L, Opt, seed=0):
    return (Conf.builder().seed(seed).updater(Opt(1e-2))
            .weight_init("xavier").list()
            .layer(L.DenseLayer(n_out=8, activation="tanh"))
            .layer(L.OutputLayer(n_out=2, loss="mcxent",
                                 activation="softmax"))
            .input_type_feed_forward(4).build())


_JAX_INIT = {}


def _jax_params():
    if "p" not in _JAX_INIT:
        _JAX_INIT["p"] = jax.tree.map(
            np.asarray, JNet(_conf(JConf, JL, JAdam)).init().params())
    return _JAX_INIT["p"]


def _mlp():
    """The port's MLP from JAX's initial weights."""
    m = MultiLayerNetwork(_conf(NeuralNetConfiguration, TL, Adam),
                          device="cpu").init()
    m.set_params(network_params_from_jax(_jax_params()))
    return m


def _jmlp():
    return JNet(_conf(JConf, JL, JAdam)).init()


def _arrays(n=48, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.rand(n, 4).astype(np.float32)
    return X, np.eye(2, dtype=np.float32)[rs.randint(0, 2, n)]


def _it(X, Y, batch=8):
    # shuffle on purpose: a resume must replay the dead run's order
    return ArrayDataSetIterator(X, Y, batch=batch, shuffle=True, seed=3)


def _jit(X, Y, batch=8):
    return JIter(X, Y, batch=batch, shuffle=True, seed=3)


def _leaves(m):
    return [t.detach().clone() for p in m.params().values()
            for t in p.values()]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _close_to_jax(jm, m):
    for key, p in jm.params().items():
        for n, v in p.items():
            np.testing.assert_allclose(
                m.params()[key][n].detach().numpy(), np.asarray(v),
                atol=PARAM_ATOL, err_msg=f"{key}.{n}")


def _names(d):
    return [os.path.basename(p) for p in
            FaultTolerantTrainer.list_checkpoints(str(d))]


class _Traj:
    """Listener recording (step, params) after every iteration."""

    def __init__(self):
        self.steps = []

    def iteration_done(self, m, step, epoch):
        self.steps.append((step, _leaves(m)))


class TestTrainingSeams:
    def test_training_seams_exist_and_unknown_rejected(self):
        FaultInjector(rates={"train_step": 0.5, "data_batch": 0.1,
                             "checkpoint_io": 0.2},
                      plan={"preempt": [3]})
        with pytest.raises(ValueError, match="unknown fault seams"):
            FaultInjector(rates={"train_stepp": 0.5})

    def test_preempt_seam_raises_preemption_fault(self):
        inj = FaultInjector(plan={"preempt": [2]})
        assert inj.fire("preempt") is False
        with pytest.raises(PreemptionFault):
            inj.fire("preempt")

    def test_slow_ms_sleeps_instead_of_raising(self):
        inj = FaultInjector(rates={"checkpoint_io": 1.0},
                            slow_ms={"checkpoint_io": 40.0})
        t0 = time.perf_counter()
        assert inj.fire("checkpoint_io") is True
        assert time.perf_counter() - t0 >= 0.04
        assert inj.snapshot()["fired"]["checkpoint_io"] == 1


class TestStepGranularCheckpoints:
    def test_step_cadence_names_listing_and_order(self, tmp_path):
        X, Y = _arrays()
        FaultTolerantTrainer(_mlp(), str(tmp_path / "t"),
                             save_every_n_steps=2, keep_last=10).fit(
            _it(X, Y), epochs=1)
        JTrainer(_jmlp(), str(tmp_path / "j"), save_every_n_steps=2,
                 keep_last=10).fit(_jit(X, Y), epochs=1)
        assert _names(tmp_path / "t") == _names(tmp_path / "j") == [
            "checkpoint_epoch0_step2.zip", "checkpoint_epoch0_step4.zip",
            "checkpoint_epoch0_step6.zip", "checkpoint_epoch1.zip"]
        resumed = FaultTolerantTrainer.resume(str(tmp_path / "t"),
                                              device="cpu")
        assert resumed._step == 6 and resumed._epoch == 1

    def test_bit_exact_resume_plain_fit(self, tmp_path):
        X, Y = _arrays()
        mA, tA = _mlp(), _Traj()
        mA.set_listeners(tA)
        FaultTolerantTrainer(mA, str(tmp_path / "a"),
                             save_every_n_steps=4).fit(_it(X, Y), epochs=3)
        mB = _mlp()
        tr = FaultTolerantTrainer(
            mB, str(tmp_path / "b"), save_every_n_steps=4,
            fault_injector=FaultInjector(plan={"preempt": [8]}))
        with pytest.raises(PreemptionFault):
            tr.fit(_it(X, Y), epochs=3)
        mC = FaultTolerantTrainer.resume(str(tmp_path / "b"), device="cpu")
        assert mC._step == 8
        assert mC._resume_cursor["epoch"] == 1
        tC = _Traj()
        mC.set_listeners(tC)
        FaultTolerantTrainer(mC, str(tmp_path / "b"),
                             save_every_n_steps=4).fit(_it(X, Y), epochs=3)
        assert mC._step == mA._step == 18
        tail = {s: p for s, p in tA.steps if s > 8}
        for s, p in tC.steps:
            assert _same(p, tail[s]), f"trajectory diverged at step {s}"
        assert _same(_leaves(mA), _leaves(mC))
        assert mC._rng == mA._rng
        # the JAX trainer from the same weights: the same trajectory
        jm = _jmlp()
        JTrainer(jm, str(tmp_path / "j"), save_every_n_steps=4).fit(
            _jit(X, Y), epochs=3)
        _close_to_jax(jm, mC)

    def test_bit_exact_resume_after_hard_crash(self, tmp_path):
        """A crash without a flush (retries exhausted mid-step): resume
        falls back to the last cadence checkpoint and still replays the
        uninterrupted trajectory bit for bit."""
        X, Y = _arrays()
        mA, tA = _mlp(), _Traj()
        mA.set_listeners(tA)
        FaultTolerantTrainer(mA, str(tmp_path / "a"),
                             save_every_n_steps=3).fit(_it(X, Y), epochs=2)
        mB = _mlp()
        tr = FaultTolerantTrainer(
            mB, str(tmp_path / "b"), save_every_n_steps=3,
            fault_injector=FaultInjector(plan={"train_step": [8, 9]}),
            max_step_retries=1, retry_backoff_ms=1.0)
        with pytest.raises(TransientFault):
            tr.fit(_it(X, Y), epochs=2)
        mC = FaultTolerantTrainer.resume(str(tmp_path / "b"), device="cpu")
        assert mC._step == 6
        tC = _Traj()
        mC.set_listeners(tC)
        FaultTolerantTrainer(mC, str(tmp_path / "b"),
                             save_every_n_steps=3).fit(_it(X, Y), epochs=2)
        tail = {s: p for s, p in tA.steps if s > 6}
        for s, p in tC.steps:
            assert _same(p, tail[s]), f"diverged at step {s}"
        assert _same(_leaves(mA), _leaves(mC))

    def test_async_checkpoint_does_not_stall_the_loop(self, tmp_path):
        """The async write runs while the step loop goes on: with step
        2's background write held on an Event, step 3 trains while that
        write is still in flight (and the Event is only released then),
        and every write lands. The synchronous writer pays a slow disk
        (``slow_ms`` 300 ms) inside the loop's stall."""
        X, Y = _arrays(n=48)
        gate, seen = threading.Event(), {}
        m = _mlp()
        tr = FaultTolerantTrainer(m, str(tmp_path / "a"),
                                  save_every_n_steps=2, keep_last=5)
        write = tr._write_atomic

        def held_write(snap, path):
            if path.endswith("_step2.zip"):
                gate.wait(timeout=60)
            write(snap, path)
        tr._write_atomic = held_write

        class AtStep3:
            def iteration_done(self, model, step, epoch):
                if step == 3:
                    w = tr._writer.snapshot()
                    # submitted at step 2, held: queued or mid-write
                    seen["writes"] = w["writes"]
                    seen["in_flight"] = w["busy"] + w["pending"]
                    gate.set()
        m.set_listeners(AtStep3())
        tr.fit(_it(X, Y), epochs=1)
        assert seen == {"writes": 0, "in_flight": 1}
        assert tr._writer.writes == 4          # steps 2, 4, 6, epoch 1
        assert tr.supervisor.async_checkpoints.value() == 4
        assert FaultTolerantTrainer.resume(str(tmp_path / "a"),
                                           device="cpu")._step == 6
        slow = FaultInjector(rates={"checkpoint_io": 1.0},
                             slow_ms={"checkpoint_io": 300.0})
        trB = FaultTolerantTrainer(_mlp(), str(tmp_path / "b"),
                                   save_every_n_steps=6, keep_last=2,
                                   fault_injector=slow, async_write=False)
        trB.fit(_it(X, Y), epochs=1)
        assert trB.supervisor.checkpoint_stall_s >= 0.3
        assert trB.supervisor.sync_checkpoints.value() == 2

    def test_checkpoint_io_transient_is_retried(self, tmp_path):
        X, Y = _arrays()
        inj = FaultInjector(plan={"checkpoint_io": [1]})
        tr = FaultTolerantTrainer(_mlp(), str(tmp_path), save_every_n_steps=3,
                                  fault_injector=inj)
        tr.fit(_it(X, Y), epochs=1)
        assert _names(tmp_path)
        assert tr.supervisor.retries.value() >= 1
        assert inj.snapshot()["fired"]["checkpoint_io"] == 1

    def test_zero_seam_traffic_without_injector(self, tmp_path):
        X, Y = _arrays()
        tr = FaultTolerantTrainer(_mlp(), str(tmp_path),
                                  save_every_n_steps=4)
        tr.fit(_it(X, Y), epochs=1)
        snap = tr.faults_snapshot()
        assert snap["retries"] == 0 and snap["anomalies_skipped"] == 0
        assert snap["rollbacks"] == 0 and snap["preemptions"] == 0
        assert "injector" not in snap
        jtr = JTrainer(_jmlp(), str(tmp_path / "j"), save_every_n_steps=4)
        jtr.fit(_jit(X, Y), epochs=1)
        assert set(snap) == set(jtr.faults_snapshot())


class TestSupervisedLoop:
    def test_transient_retry_is_bit_exact(self, tmp_path):
        X, Y = _arrays()
        mA = _mlp()
        FaultTolerantTrainer(mA, str(tmp_path / "a"),
                             save_every_n_steps=100).fit(_it(X, Y), epochs=2)
        mB = _mlp()
        tr = FaultTolerantTrainer(
            mB, str(tmp_path / "b"), save_every_n_steps=100,
            fault_injector=FaultInjector(plan={"train_step": [2, 5, 9]}),
            max_step_retries=8, retry_backoff_ms=1.0)
        tr.fit(_it(X, Y), epochs=2)
        assert tr.supervisor.retries.value() == 3
        assert _same(_leaves(mA), _leaves(mB))
        jm = _jmlp()
        jtr = JTrainer(jm, str(tmp_path / "j"), save_every_n_steps=100,
                       fault_injector=JInjector(
                           plan={"train_step": [2, 5, 9]}),
                       max_step_retries=8, retry_backoff_ms=1.0)
        jtr.fit(_jit(X, Y), epochs=2)
        assert jtr.supervisor.retries.value() == 3
        _close_to_jax(jm, mB)

    def test_retries_exhausted_raises(self, tmp_path):
        X, Y = _arrays()
        tr = FaultTolerantTrainer(
            _mlp(), str(tmp_path),
            fault_injector=FaultInjector(plan={"train_step": [1, 2, 3]}),
            max_step_retries=1, retry_backoff_ms=1.0)
        with pytest.raises(TransientFault):
            tr.fit(_it(X, Y), epochs=1)

    def test_data_batch_transient_is_retried(self, tmp_path):
        X, Y = _arrays()
        mA = _mlp()
        FaultTolerantTrainer(mA, str(tmp_path / "a"),
                             save_every_n_steps=100).fit(_it(X, Y), epochs=1)
        mB = _mlp()
        tr = FaultTolerantTrainer(
            mB, str(tmp_path / "b"), save_every_n_steps=100,
            fault_injector=FaultInjector(plan={"data_batch": [1, 4]}),
            retry_backoff_ms=1.0)
        tr.fit(_it(X, Y), epochs=1)
        assert tr.supervisor.retries.value() == 2
        assert _same(_leaves(mA), _leaves(mB))

    @staticmethod
    def _batches(seed=0, n=5, bad=()):
        rs = np.random.RandomState(seed)
        out = []
        for i in range(n):
            x = rs.rand(8, 4).astype(np.float32)
            y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 8)]
            if i in bad:
                x = x.copy()
                x[0, 0] = np.nan
            out.append((x, y))
        return out

    def test_anomalous_batch_skip_matches_run_without_it(self, tmp_path):
        bad_stream = self._batches(n=4, bad=(1,))
        clean_stream = [b for i, b in enumerate(self._batches(n=4))
                        if i != 1]
        mA = _mlp()
        trA = FaultTolerantTrainer(mA, str(tmp_path / "a"),
                                   anomaly_guard=True)
        trA.fit(bad_stream, epochs=1)
        mB = _mlp()
        FaultTolerantTrainer(mB, str(tmp_path / "b"),
                             anomaly_guard=True).fit(clean_stream, epochs=1)
        assert trA.supervisor.anomalies_skipped.value() == 1
        assert mA._step == mB._step == 3
        assert _same(_leaves(mA), _leaves(mB))
        assert mA._rng == mB._rng
        jm = _jmlp()
        jtr = JTrainer(jm, str(tmp_path / "j"), anomaly_guard=True)
        jtr.fit(bad_stream, epochs=1)
        assert jtr.supervisor.anomalies_skipped.value() == 1
        assert jm._step == 3
        _close_to_jax(jm, mA)
        assert list(mA._rng) == [int(v) for v in np.asarray(jm._rng)]

    def test_rollback_after_k_consecutive_anomalies(self, tmp_path):
        m = _mlp()
        tr = FaultTolerantTrainer(m, str(tmp_path), anomaly_guard=True,
                                  rollback_after=2)
        good_then_bad = self._batches(n=6, bad=(2, 3))
        tr.fit(good_then_bad, epochs=1)
        sup = tr.supervisor
        assert sup.anomalies_skipped.value() == 2
        assert sup.rollbacks.value() == 1
        assert m._step == 4
        assert all(torch.isfinite(a).all() for a in _leaves(m))
        jm = _jmlp()
        jtr = JTrainer(jm, str(tmp_path / "j"), anomaly_guard=True,
                       rollback_after=2)
        jtr.fit(good_then_bad, epochs=1)
        assert jtr.supervisor.snapshot() == {
            **sup.snapshot(), "checkpoint_stall_s":
            jtr.supervisor.snapshot()["checkpoint_stall_s"],
            "checkpoint_write_s":
            jtr.supervisor.snapshot()["checkpoint_write_s"]}
        _close_to_jax(jm, m)

    def test_rollback_restores_snapshot_bits_and_rng(self, tmp_path):
        m = _mlp()
        tr = FaultTolerantTrainer(m, str(tmp_path), anomaly_guard=True,
                                  rollback_after=1)
        tr.fit(self._batches(n=2), epochs=1)
        want_params, want_rng, want_step = _leaves(m), m._rng, m._step
        want_opt = [t.clone() for st in m.get_updater_state().values()
                    for part in st.values() for t in part.values()]
        bad = self._batches(seed=9, n=1, bad=(0,))
        tr.fit(bad, epochs=2)
        assert tr.supervisor.rollbacks.value() >= 1
        assert _same(_leaves(m), want_params)
        assert _same([t for st in m.get_updater_state().values()
                      for part in st.values() for t in part.values()],
                     want_opt)
        assert m._rng == want_rng and m._step == want_step

    def test_anomaly_error_after_max_rollbacks(self, tmp_path):
        tr = FaultTolerantTrainer(_mlp(), str(tmp_path), anomaly_guard=True,
                                  rollback_after=1)
        tr.supervisor.max_rollbacks = 2
        with pytest.raises(TrainingAnomalyError):
            tr.fit(self._batches(n=12, bad=tuple(range(12))), epochs=1)

    def test_guarded_step_is_built_once(self, tmp_path):
        """JAX compiles the guarded step once and never again; the port
        builds its step function once and keeps it."""
        X, Y = _arrays()
        tr = FaultTolerantTrainer(_mlp(), str(tmp_path), anomaly_guard=True)
        tr.fit(_it(X, Y), epochs=1)
        step = tr._step_fns["guard"]
        tr.fit(_it(X, Y), epochs=3)
        assert tr._step_fns == {"guard": step}


class TestStepGranularPreemption:
    def test_sigterm_mid_epoch_flushes_at_step_boundary(self, tmp_path):
        X, Y = _arrays()
        mA = _mlp()
        FaultTolerantTrainer(mA, str(tmp_path / "a"),
                             save_every_n_steps=100).fit(_it(X, Y),
                                                         epochs=2)
        mB = _mlp()
        tr = FaultTolerantTrainer(mB, str(tmp_path / "b"),
                                  save_every_n_steps=100)
        sent = []

        class KillAtStep3:
            def iteration_done(self, m, step, epoch):
                if step == 3 and not sent:
                    sent.append(True)
                    os.kill(os.getpid(), signal.SIGTERM)
        mB.set_listeners(KillAtStep3())
        fired = []
        with PreemptionHandler(tr, signals=(signal.SIGTERM,),
                               on_preempt=fired.append,
                               reraise=False) as h:
            with pytest.raises(PreemptionFault):
                tr.fit(_it(X, Y), epochs=2)
        assert h.preempted and fired == [signal.SIGTERM]
        assert tr.supervisor.preemptions.value() == 1
        assert "checkpoint_epoch0_step3.zip" in _names(tmp_path / "b")
        mC = FaultTolerantTrainer.resume(str(tmp_path / "b"), device="cpu")
        assert mC._step == 3
        assert mC._resume_cursor == {"epoch": 0, "batches_into_epoch": 3,
                                     "iterator": {"epoch": 0}}
        FaultTolerantTrainer(mC, str(tmp_path / "b"),
                             save_every_n_steps=100).fit(_it(X, Y),
                                                         epochs=2)
        assert _same(_leaves(mA), _leaves(mC))

    def test_sigterm_outside_loop_keeps_epoch_semantics(self, tmp_path):
        m = _mlp()
        X, Y = _arrays()
        tr = FaultTolerantTrainer(m, str(tmp_path), save_every_n_epochs=100)
        with PreemptionHandler(tr, signals=(signal.SIGTERM,),
                               reraise=False) as h:
            m.fit([(X[:8], Y[:8])], epochs=2)
            os.kill(os.getpid(), signal.SIGTERM)
            assert h.preempted
        assert len(_names(tmp_path)) == 1
        assert FaultTolerantTrainer.resume(str(tmp_path),
                                           device="cpu")._epoch == 2

    def test_preempt_seam_counts_and_stats(self, tmp_path):
        X, Y = _arrays()
        tr = FaultTolerantTrainer(
            _mlp(), str(tmp_path), save_every_n_steps=2,
            fault_injector=FaultInjector(plan={"preempt": [4]}))
        with pytest.raises(PreemptionFault):
            tr.fit(_it(X, Y), epochs=2)
        snap = tr.faults_snapshot()
        assert snap["preemptions"] == 1
        assert "checkpoint_epoch0_step4.zip" in _names(tmp_path)
        assert snap["async_checkpoints"] >= 1
        assert snap["sync_checkpoints"] == 0
        assert snap["injector"]["fired"]["preempt"] == 1


class TestAsyncCheckpointWriter:
    def test_one_write_in_flight_and_errors_surface(self, tmp_path):
        """``submit`` waits out the write in flight (never this one);
        ``wait`` returns once everything submitted is written; a write
        that raised surfaces on the next ``submit``/``wait``."""
        gate, order = threading.Event(), []

        def write(snap, path):
            if snap == "first":
                gate.wait(timeout=60)
            if snap == "bad":
                raise OSError("disk gone")
            order.append(snap)
        w = AsyncCheckpointWriter(write)
        w.submit("first", "p1")
        t = threading.Thread(target=w.submit, args=("second", "p2"))
        t.start()
        t.join(timeout=0.2)
        assert t.is_alive() and order == []     # held behind "first"
        assert w.snapshot()["busy"] == 1
        gate.set()
        t.join(timeout=60)
        assert w.wait(timeout_s=60)
        assert order == ["first", "second"] and w.writes == 2
        w.submit("bad", "p3")
        with pytest.raises(OSError):
            w.wait(timeout_s=60)
        w.close()
        assert w.closed
        with pytest.raises(RuntimeError):
            w.submit("late", "p4")

    def test_supervisor_snapshot_keys_are_jaxs(self):
        from deeplearning4j_tpu.parallel.resilience import \
            TrainingSupervisor as JSupervisor
        assert set(TrainingSupervisor().snapshot()) == \
            set(JSupervisor().snapshot())
