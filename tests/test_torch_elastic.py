"""The port's elastic-training pieces against the JAX package's (CPU),
mirroring ``tests/test_elastic_training.py`` (the per-worker injector
seams, ``TestPreemptionCoordinator``, ``TestCoordinatedPreemption``,
the plain trainer's sharded v3 layout and ``TestFormatValidation``),
``tests/test_elastic_scope.py::TestPreemptionHandler`` and
``tests/test_cluster_init.py::test_single_process_is_noop``.

Both packages' trainers run the same MLP from the same weights (JAX's,
carried with ``convert.py``) under the same plans; checkpoint names,
manifests and counters must be equal, and the port's resumes bit for
bit. The fleet cases never race the clock: a worker that must still be
running when another's notice lands waits for the coordinator's token
to move (a gate) instead of sleeping. ``TestShardedCheckpointLayout``
is the plain trainer's layout (one shard); ``TestWrapperMode`` holds the
wrapper's W-shard archives, with two gloo ranks on the CPU spawned once
for the class (``tests/_torch_dp_scenarios.py::elastic_cases``): a JAX
W = 2 archive restores in the port at W = 2 bit for bit and at W = 1 by
``rebucket_worker_array``'s rule, the port's W = 2 archive restores in
JAX, and kill-and-resume at W = 2 is bit for bit in every mode.
"""
import json
import os
import signal
import threading
import time
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JIter
from deeplearning4j_tpu.faults import FaultInjector as JInjector
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.learning import Sgd as JSgd
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.parallel import multihost as JMH
from deeplearning4j_tpu.parallel.elastic import \
    FaultTolerantTrainer as JTrainer
from deeplearning4j_tpu_torch.convert import network_params_from_jax
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.faults import (FaultInjector, PreemptionFault,
                                             TransientFault)
from deeplearning4j_tpu_torch.learning import Adam, Sgd
from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.parallel.elastic import (FaultTolerantTrainer,
                                                       PreemptionHandler,
                                                       initialize_cluster)
from deeplearning4j_tpu_torch.parallel.multihost import (
    PreemptionCoordinator, split_data_cursor)
from deeplearning4j_tpu_torch.serving import InferenceServer
from deeplearning4j_tpu_torch.util.serializer import (CheckpointFormatError,
                                                      ModelSerializer)

GATE_S = 60.0


def _conf(Conf, L, Opt, lr=1e-2):
    return (Conf.builder().seed(0).updater(Opt(lr))
            .weight_init("xavier").list()
            .layer(L.DenseLayer(n_out=8, activation="tanh"))
            .layer(L.OutputLayer(n_out=2, loss="mcxent",
                                 activation="softmax"))
            .input_type_feed_forward(4).build())


_INIT = {}


def _mlp(opt="adam"):
    """The port's MLP from JAX's initial weights."""
    J = {"adam": (JAdam, Adam, 1e-2), "sgd": (JSgd, Sgd, 0.1)}[opt]
    if opt not in _INIT:
        _INIT[opt] = jax.tree.map(np.asarray, JNet(
            _conf(JConf, JL, J[0], J[2])).init().params())
    m = MultiLayerNetwork(_conf(NeuralNetConfiguration, TL, J[1], J[2]),
                          device="cpu").init()
    m.set_params(network_params_from_jax(_INIT[opt]))
    return m


def _jmlp():
    return JNet(_conf(JConf, JL, JAdam)).init()


def _arrays(n=64, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.rand(n, 4).astype(np.float32)
    return X, np.eye(2, dtype=np.float32)[rs.randint(0, 2, n)]


def _it(X, Y, batch=16):
    return ArrayDataSetIterator(X, Y, batch=batch, shuffle=True, seed=3)


def _jit(X, Y, batch=16):
    return JIter(X, Y, batch=batch, shuffle=True, seed=3)


def _leaves(m):
    return [t.detach().clone() for p in m.params().values()
            for t in p.values()]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _names(d):
    return [os.path.basename(p) for p in
            FaultTolerantTrainer.list_checkpoints(str(d))]


def _resume(d):
    return FaultTolerantTrainer.resume(str(d), device="cpu")


class TestPerWorkerInjectorSeams:
    def test_worker_plan_targets_one_worker_at_its_own_count(self):
        inj = FaultInjector(plan={"preempt": {1: [3]}})
        for _ in range(6):
            assert inj.fire("preempt", worker=0) is False
        assert inj.fire("preempt", worker=1) is False
        assert inj.fire("preempt", worker=1) is False
        with pytest.raises(PreemptionFault):
            inj.fire("preempt", worker=1)
        snap = inj.snapshot()
        assert snap["fired"]["preempt"] == 1
        assert snap["by_worker"]["preempt"][1]["fired"] == 1
        assert snap["by_worker"]["preempt"][0]["fired"] == 0

    def test_flat_plan_applies_per_worker_independently(self):
        inj = FaultInjector(plan={"checkpoint_io": [2]})
        assert inj.fire("checkpoint_io", worker=0) is False
        assert inj.fire("checkpoint_io", worker=1) is False
        with pytest.raises(TransientFault):
            inj.fire("checkpoint_io", worker=0)
        with pytest.raises(TransientFault):
            inj.fire("checkpoint_io", worker=1)

    def test_worker_streams_deterministic_and_independent(self):
        def pattern(cls, order):
            inj = cls(seed=5, rates={"train_step": 0.5})
            out = {0: [], 1: []}
            for w in order:
                try:
                    inj.fire("train_step", worker=w)
                    out[w].append("ok")
                except Exception:
                    out[w].append("fault")
            return out
        a = pattern(FaultInjector, [0] * 8 + [1] * 8)
        assert a == pattern(FaultInjector, [0, 1] * 8)
        assert "fault" in a[0] + a[1]
        # the same seeded streams as the JAX injector's
        assert a == pattern(JInjector, [0] * 8 + [1] * 8)

    def test_worker_scoped_unknown_seam_still_rejected(self):
        with pytest.raises(ValueError, match="unknown fault seams"):
            FaultInjector(plan={"nope": {0: [1]}})


class TestPreemptionCoordinator:
    def test_generation_monotonic_and_reset(self):
        c = PreemptionCoordinator()
        g0 = c.generation()
        t1 = c.signal(source=3)
        assert c.generation() == t1 > g0
        t2 = c.signal(source=4)
        assert t2 > t1 and c.last_source == 4
        c.reset()
        assert c.generation() == 0.0

    def test_file_channel_crosses_instances_and_packages(self, tmp_path):
        a = PreemptionCoordinator(channel_dir=str(tmp_path))
        b = PreemptionCoordinator(channel_dir=str(tmp_path))
        jb = JMH.PreemptionCoordinator(channel_dir=str(tmp_path))
        gb0, gj0 = b.generation(), jb.generation()
        a.signal(source="worker-a")
        assert b.generation() > gb0
        assert b.last_source == "worker-a"
        # the JAX package's coordinator reads the same sentinel
        assert jb.generation() > gj0 and jb.last_source == "worker-a"
        assert os.path.isfile(tmp_path / PreemptionCoordinator.SENTINEL)
        b.reset()
        assert not os.path.isfile(tmp_path / PreemptionCoordinator.SENTINEL)

    def test_fresh_signaller_never_regresses_the_sentinel(self, tmp_path):
        a = PreemptionCoordinator(channel_dir=str(tmp_path))
        a.signal(source="skewed")
        path = tmp_path / PreemptionCoordinator.SENTINEL
        data = json.loads(path.read_text())
        future = data["token"] + 3600.0
        path.write_text(json.dumps(dict(data, token=future)))
        fresh = PreemptionCoordinator(channel_dir=str(tmp_path))
        tok = fresh.signal(source="operator")
        assert tok > future
        assert PreemptionCoordinator(
            channel_dir=str(tmp_path)).generation() == tok

    def test_stale_notice_ignored_by_new_fit(self, tmp_path):
        coord = PreemptionCoordinator(channel_dir=str(tmp_path / "ch"))
        coord.signal(source="previous-life")
        X, Y = _arrays()
        tr = FaultTolerantTrainer(_mlp(), str(tmp_path / "ck"),
                                  save_every_n_steps=100, coordinator=coord)
        tr.fit(_it(X, Y), epochs=1)
        assert tr.supervisor.preemptions.value() == 0

    def test_split_data_cursor(self):
        cur = {"epoch": 2, "batches_into_epoch": 7,
               "iterator": {"epoch": 2}}
        parts = split_data_cursor(cur, 4)
        assert parts == JMH.split_data_cursor(cur, 4)
        for i, p in enumerate(parts):
            assert p["epoch"] == 2 and p["batches_into_epoch"] == 7
            assert p["worker"] == i and p["num_workers"] == 4
        assert split_data_cursor(None, 3) == [None, None, None]
        with pytest.raises(ValueError):
            split_data_cursor(cur, 0)


class _WaitForNotice:
    """Listener: at ``step`` (after the optional ``barrier``) block
    until the coordinator's token moves past the one it had when the
    listener was made (the gate that replaces a wall-clock race)."""

    def __init__(self, coord, step, barrier=None):
        self.coord, self.step, self.barrier = coord, step, barrier
        self.g0 = coord.generation()

    def iteration_done(self, m, step, epoch):
        if step == self.step:
            if self.barrier is not None:
                self.barrier.wait(timeout=GATE_S)
            deadline = time.monotonic() + GATE_S
            while self.coord.generation() <= self.g0:
                assert time.monotonic() < deadline, "no notice came"
                time.sleep(0.001)


class TestCoordinatedPreemption:
    def _run_fleet(self, base, coord, n_workers=3, epochs=4):
        """N trainers in threads sharing one coordinator and one
        worker-scoped injector that preempts worker 1 at its 4th step.
        Worker 1 reaches its 4th step boundary only once the others
        stand at their 5th (a barrier), and they wait there until its
        notice is out: each of them flushes at its 5th step boundary."""
        X, Y = _arrays(n=96)
        inj = FaultInjector(plan={"preempt": {1: [4]}})
        models = [_mlp() for _ in range(n_workers)]
        barrier = threading.Barrier(n_workers)

        class AtStep4:
            def iteration_done(self, m, step, epoch):
                if step == 4:
                    barrier.wait(timeout=GATE_S)
        for i, m in enumerate(models):
            m.set_listeners(AtStep4() if i == 1 else
                            _WaitForNotice(coord, 5, barrier))
        trainers = [FaultTolerantTrainer(
            models[i], str(base / f"w{i}"), save_every_n_steps=100,
            fault_injector=inj, coordinator=coord, worker_id=i)
            for i in range(n_workers)]
        outcomes = [None] * n_workers

        def run(i):
            try:
                trainers[i].fit(_it(X, Y, batch=8), epochs=epochs)
                outcomes[i] = "done"
            except PreemptionFault:
                outcomes[i] = "preempted"
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        return models, trainers, outcomes

    def test_one_workers_preempt_drains_the_fleet(self, tmp_path):
        coord = PreemptionCoordinator()
        models, trainers, outcomes = self._run_fleet(tmp_path, coord)
        assert outcomes == ["preempted"] * 3, outcomes
        assert trainers[1].supervisor.preempts_broadcast.value() == 1
        for i in (0, 2):
            assert trainers[i].supervisor.preempts_received.value() == 1
            assert trainers[i].supervisor.preempts_broadcast.value() == 0
        for i in range(3):
            names = _names(tmp_path / f"w{i}")
            assert names == [f"checkpoint_epoch0_step{4 if i == 1 else 5}"
                             ".zip"], (i, names)

    def test_fleet_resume_is_bit_exact_per_worker(self, tmp_path):
        X, Y = _arrays(n=96)
        ref = _mlp()
        FaultTolerantTrainer(ref, str(tmp_path / "ref"),
                             save_every_n_steps=100).fit(
            _it(X, Y, batch=8), epochs=4)
        coord = PreemptionCoordinator()
        _, _, outcomes = self._run_fleet(tmp_path, coord)
        assert outcomes == ["preempted"] * 3
        for i in range(3):
            m = _resume(tmp_path / f"w{i}")
            FaultTolerantTrainer(m, str(tmp_path / f"w{i}"),
                                 save_every_n_steps=100).fit(
                _it(X, Y, batch=8), epochs=4)
            assert _same(_leaves(ref), _leaves(m)), \
                f"worker {i} diverged after coordinated resume"

    def test_sigterm_broadcasts_through_handler_channel(self, tmp_path):
        X, Y = _arrays(n=96)
        coord = PreemptionCoordinator(channel_dir=str(tmp_path / "ch"))
        # the background worker stands at its 2nd step (the barrier)
        # before the main worker's SIGTERM, and waits there for the notice
        barrier = threading.Barrier(2)
        m_bg = _mlp()
        m_bg.set_listeners(_WaitForNotice(coord, 2, barrier))
        tr_bg = FaultTolerantTrainer(m_bg, str(tmp_path / "bg"),
                                     save_every_n_steps=100,
                                     coordinator=coord, worker_id=1)
        bg_out = []

        def run_bg():
            try:
                tr_bg.fit(_it(X, Y, batch=8), epochs=4)
                bg_out.append("done")
            except PreemptionFault:
                bg_out.append("preempted")
        bg = threading.Thread(target=run_bg)
        m = _mlp()
        tr = FaultTolerantTrainer(m, str(tmp_path / "main"),
                                  save_every_n_steps=100, worker_id=0)
        sent = []

        class KillAtStep3:
            def iteration_done(self, mm, step, epoch):
                if step == 3 and not sent:
                    sent.append(True)
                    barrier.wait(timeout=GATE_S)
                    os.kill(os.getpid(), signal.SIGTERM)
        m.set_listeners(KillAtStep3())
        bg.start()
        try:
            with PreemptionHandler(tr, signals=(signal.SIGTERM,),
                                   reraise=False, coordinator=coord) as h:
                with pytest.raises(PreemptionFault):
                    tr.fit(_it(X, Y, batch=8), epochs=4)
        finally:
            bg.join(timeout=120)
        assert h.preempted
        assert tr.coordinator is coord
        assert bg_out == ["preempted"]
        assert tr_bg.supervisor.preempts_received.value() == 1
        assert _names(tmp_path / "main") == ["checkpoint_epoch0_step3.zip"]
        assert _names(tmp_path / "bg") == ["checkpoint_epoch0_step2.zip"]


class TestShardedCheckpointLayout:
    """The v3 layout of the plain trainer (one shard), held to the JAX
    trainer's under the same plans."""

    def _fit(self, d, injector=None, steps=3, epochs=2, **kw):
        X, Y = _arrays()
        m = _mlp()
        tr = FaultTolerantTrainer(m, str(d), save_every_n_steps=steps,
                                  sharded_checkpoints=True,
                                  fault_injector=injector, **kw)
        return m, tr, _it(X, Y)

    def _jfit(self, d, injector=None, steps=3, **kw):
        X, Y = _arrays()
        tr = JTrainer(_jmlp(), str(d), save_every_n_steps=steps,
                      sharded_checkpoints=True, fault_injector=injector,
                      **kw)
        return tr, _jit(X, Y)

    def test_directory_layout_and_manifest(self, tmp_path):
        m, tr, it = self._fit(tmp_path / "t")
        tr.fit(it, epochs=2)
        jtr, jit_ = self._jfit(tmp_path / "j")
        jtr.fit(jit_, epochs=2)
        assert _names(tmp_path / "t") == _names(tmp_path / "j")
        last = FaultTolerantTrainer.list_checkpoints(str(tmp_path / "t"))[-1]
        jlast = FaultTolerantTrainer.list_checkpoints(
            str(tmp_path / "j"))[-1]
        assert sorted(os.listdir(last)) == sorted(os.listdir(jlast)) == \
            ["manifest.json", "shard_00000.zip"]
        man = json.load(open(os.path.join(last, "manifest.json")))
        jman = json.load(open(os.path.join(jlast, "manifest.json")))
        assert man["format_version"] == 3 and man["num_workers"] == 1
        assert man["meta"]["step"] == m._step
        assert man["meta"]["cursor"] == jman["meta"]["cursor"]
        assert set(man) == set(jman)
        assert man["sections_present"] == jman["sections_present"]
        assert man["worker_sliced"] == jman["worker_sliced"] == []
        for e, je in zip(man["shards"], jman["shards"]):
            assert os.path.getsize(os.path.join(last, e["file"])) == \
                e["bytes"]
            assert e["entries"] == je["entries"]
        assert _resume(tmp_path / "t")._step == m._step

    def test_mixed_v2_v3_listing_and_migration(self, tmp_path):
        X, Y = _arrays()
        FaultTolerantTrainer(_mlp(), str(tmp_path),
                             save_every_n_steps=100).fit(_it(X, Y), epochs=1)
        m2 = _resume(tmp_path)
        FaultTolerantTrainer(m2, str(tmp_path), save_every_n_steps=100,
                             sharded_checkpoints=True).fit(_it(X, Y),
                                                           epochs=3)
        assert _names(tmp_path) == ["checkpoint_epoch1.zip",
                                    "checkpoint_epoch2.ckpt",
                                    "checkpoint_epoch3.ckpt"]
        assert _resume(tmp_path)._epoch == 3

    def test_kill_and_resume_bit_exact(self, tmp_path):
        mA, trA, it = self._fit(tmp_path / "a")
        trA.fit(it, epochs=3)
        mB, trB, it = self._fit(tmp_path / "b", injector=FaultInjector(
            plan={"preempt": [7]}))
        with pytest.raises(PreemptionFault):
            trB.fit(it, epochs=3)
        mC = _resume(tmp_path / "b")
        assert mC._step == 7
        X, Y = _arrays()
        FaultTolerantTrainer(mC, str(tmp_path / "b"), save_every_n_steps=3,
                             sharded_checkpoints=True).fit(_it(X, Y),
                                                           epochs=3)
        assert mA._step == mC._step == 12
        assert _same(_leaves(mA), _leaves(mC))

    @pytest.mark.parametrize("plan", [{0: [2]}, [4]],
                             ids=["between_shards", "before_manifest"])
    def test_torn_writes_never_listed(self, tmp_path, plan):
        """A checkpoint_io fault on the second checkpoint's shard write
        (the worker-scoped fire) or on its manifest commit (the global
        fire, the 4th call of the seam in all): the torn write is never
        listed and resume takes the first checkpoint, as in JAX."""
        m, tr, it = self._fit(tmp_path / "t",
                              injector=FaultInjector(
                                  plan={"checkpoint_io": plan}),
                              async_write=False, max_step_retries=0)
        with pytest.raises(TransientFault):
            tr.fit(it, epochs=2)
        jtr, jit_ = self._jfit(tmp_path / "j",
                               injector=JInjector(
                                   plan={"checkpoint_io": plan}),
                               async_write=False, max_step_retries=0)
        with pytest.raises(Exception, match="checkpoint_io"):
            jtr.fit(jit_, epochs=2)
        assert _names(tmp_path / "t") == _names(tmp_path / "j") == \
            ["checkpoint_epoch0_step3.ckpt"]
        assert not [n for n in os.listdir(tmp_path / "t") if ".tmp." in n]
        assert _resume(tmp_path / "t")._step == 3

    def test_manifestless_directory_is_invisible_and_diagnosable(
            self, tmp_path):
        m, tr, it = self._fit(tmp_path)
        tr.fit(it, epochs=1)
        good = FaultTolerantTrainer.list_checkpoints(str(tmp_path))[-1]
        torn = os.path.join(str(tmp_path), "checkpoint_epoch9.ckpt")
        os.makedirs(torn)
        with open(os.path.join(torn, "shard_00000.zip"), "wb") as f:
            f.write(b"partial")
        assert FaultTolerantTrainer.list_checkpoints(
            str(tmp_path))[-1] == good
        with pytest.raises(CheckpointFormatError, match="manifest"):
            ModelSerializer.restore(torn, device="cpu")

    def test_temp_sweep_dead_swept_live_spared(self, tmp_path):
        """The sweep by pid liveness, for zip temps, shard directories
        and inner shard temps: a dead writer's go, a live one's stay."""
        m, tr, it = self._fit(tmp_path)
        tr.fit(it, epochs=1)
        dead, live = 999999999, os.getpid()
        dead_dir = str(tmp_path / f"checkpoint_epoch8.ckpt.tmp.{dead}")
        live_dir = str(tmp_path / f"checkpoint_epoch8.ckpt.tmp.{live}")
        for d in (dead_dir, live_dir):
            os.makedirs(d)
            open(os.path.join(d, "shard_00000.zip"), "wb").close()
        committed = FaultTolerantTrainer.list_checkpoints(str(tmp_path))[-1]
        dead_inner = os.path.join(committed, f"shard_00009.zip.tmp.{dead}")
        live_inner = os.path.join(committed, f"shard_00008.zip.tmp.{live}")
        dead_zip = str(tmp_path / f"checkpoint_epoch7.zip.tmp.{dead}")
        live_zip = str(tmp_path / f"checkpoint_epoch7.zip.tmp.{live}")
        for p in (dead_inner, live_inner, dead_zip, live_zip):
            open(p, "wb").close()
        tr._prune_and_sweep()
        assert not os.path.exists(dead_dir) and os.path.isdir(live_dir)
        assert not os.path.exists(dead_inner) and os.path.exists(live_inner)
        assert not os.path.exists(dead_zip) and os.path.exists(live_zip)

    def test_stranded_old_checkpoint_is_renamed_back(self, tmp_path):
        m, tr, it = self._fit(tmp_path)
        tr.fit(it, epochs=1)
        live = FaultTolerantTrainer.list_checkpoints(str(tmp_path))[-1]
        stranded = f"{live}.old.999999999"
        os.rename(live, stranded)
        assert live not in FaultTolerantTrainer.list_checkpoints(
            str(tmp_path))
        tr._prune_and_sweep()
        assert FaultTolerantTrainer.list_checkpoints(
            str(tmp_path))[-1] == live
        assert not os.path.exists(stranded)
        aside = f"{live}.old.{os.getpid()}"
        os.makedirs(aside)
        tr._prune_and_sweep()
        assert os.path.isdir(aside)

    def test_format_rewrite_removes_stale_twin(self, tmp_path):
        X, Y = _arrays()
        FaultTolerantTrainer(_mlp(), str(tmp_path),
                             save_every_n_steps=100).fit(_it(X, Y), epochs=1)
        assert _names(tmp_path) == ["checkpoint_epoch1.zip"]
        FaultTolerantTrainer(_mlp(), str(tmp_path), save_every_n_steps=100,
                             sharded_checkpoints=True).fit(_it(X, Y),
                                                           epochs=1)
        assert _names(tmp_path) == ["checkpoint_epoch1.ckpt"]
        FaultTolerantTrainer(_mlp(), str(tmp_path),
                             save_every_n_steps=100).fit(_it(X, Y), epochs=1)
        assert _names(tmp_path) == ["checkpoint_epoch1.zip"]

    def test_keep_last_prunes_shard_directories(self, tmp_path):
        m, tr, it = self._fit(tmp_path, steps=2, keep_last=2)
        tr.fit(it, epochs=2)
        ckpts = FaultTolerantTrainer.list_checkpoints(str(tmp_path))
        assert len(ckpts) == 2 and all(os.path.isdir(p) for p in ckpts)

    def test_jax_v3_checkpoint_resumes_in_the_port(self, tmp_path):
        """A v3 directory the JAX trainer wrote resumes in the port at
        JAX's step, cursor and params."""
        jtr, jit_ = self._jfit(tmp_path)
        jtr.fit(jit_, epochs=1)
        m = _resume(tmp_path)
        assert m._step == jtr.model._step
        assert m._resume_cursor == jtr.model._resume_cursor or \
            m._resume_cursor["epoch"] == 1
        for key, p in jtr.model.params().items():
            for n, v in p.items():
                assert np.array_equal(m.params()[key][n].detach().numpy(),
                                      np.asarray(v)), (key, n)

    def test_wrapper_mode_waits_for_parallel_wrapper(self, tmp_path):
        """The wrapper mode takes a wrapper of the trainer's own model."""
        from deeplearning4j_tpu_torch.parallel import ParallelWrapper
        with pytest.raises(ValueError, match="trainer's model"):
            FaultTolerantTrainer(_mlp(), str(tmp_path),
                                 wrapper=ParallelWrapper(_mlp()))


class TestFormatValidation:
    def _one(self, tmp_path, **kw):
        X, Y = _arrays(n=16)
        FaultTolerantTrainer(_mlp(), str(tmp_path), save_every_n_steps=100,
                             **kw).fit(_it(X, Y), epochs=1)
        return FaultTolerantTrainer.list_checkpoints(str(tmp_path))[-1]

    @staticmethod
    def _rewrite_meta(path, edit):
        tmp = path + ".rewrite"
        with zipfile.ZipFile(path) as zin, \
                zipfile.ZipFile(tmp, "w") as zout:
            for name in zin.namelist():
                data = zin.read(name)
                if name == "meta.json":
                    meta = json.loads(data.decode())
                    edit(meta)
                    data = json.dumps(meta).encode()
                zout.writestr(name, data)
        os.replace(tmp, path)

    def test_unknown_zip_version_is_actionable(self, tmp_path):
        path = self._one(tmp_path)
        self._rewrite_meta(path, lambda m: m.update(format_version=99))
        with pytest.raises(CheckpointFormatError) as ei:
            _resume(tmp_path)
        msg = str(ei.value)
        assert "99" in msg and str(path) in msg and "supports" in msg

    def test_unknown_manifest_version_is_actionable(self, tmp_path):
        path = self._one(tmp_path, sharded_checkpoints=True)
        mpath = os.path.join(path, "manifest.json")
        man = json.load(open(mpath))
        man["format_version"] = 42
        json.dump(man, open(mpath, "w"))
        with pytest.raises(CheckpointFormatError) as ei:
            _resume(tmp_path)
        assert "42" in str(ei.value) and path in str(ei.value)

    def test_v1_missing_version_still_restores(self, tmp_path):
        path = self._one(tmp_path)
        self._rewrite_meta(path, lambda m: m.pop("format_version", None))
        assert _resume(tmp_path) is not None


class TestPreemptionHandler:
    def test_sigterm_flushes_checkpoint_and_resumes(self, tmp_path):
        m = _mlp("sgd")
        x, y = _arrays(n=32)
        trainer = FaultTolerantTrainer(m, str(tmp_path),
                                       save_every_n_epochs=100)
        fired = []
        with PreemptionHandler(trainer, signals=(signal.SIGTERM,),
                               on_preempt=fired.append,
                               reraise=False) as h:
            assert h.installed
            m.fit([(x, y)], epochs=3)
            assert not _names(tmp_path)
            os.kill(os.getpid(), signal.SIGTERM)
            assert h.preempted
        assert fired == [signal.SIGTERM]
        assert len(_names(tmp_path)) == 1
        restored = _resume(tmp_path)
        assert torch.equal(restored.output(x), m.output(x))

    def test_previous_handler_restored_and_chained(self, tmp_path):
        trainer = FaultTolerantTrainer(_mlp("sgd"), str(tmp_path))
        seen = []
        prev = signal.signal(signal.SIGUSR1,
                             lambda s, f: seen.append("prev"))
        try:
            with PreemptionHandler(trainer, signals=(signal.SIGUSR1,),
                                   reraise=True):
                os.kill(os.getpid(), signal.SIGUSR1)
            assert seen == ["prev"]
            os.kill(os.getpid(), signal.SIGUSR1)
            assert seen == ["prev", "prev"]
        finally:
            signal.signal(signal.SIGUSR1, prev)

    @pytest.mark.parametrize("server_first", [True, False],
                             ids=["server_then_trainer",
                                  "trainer_then_server"])
    def test_beside_the_serving_shells_handler(self, tmp_path,
                                               server_first):
        """The serving shell installs its own SIGTERM handler; in either
        order one SIGTERM both drains the server and flushes the
        trainer's checkpoint, and each restores what it replaced."""
        m = _mlp("sgd")
        x, y = _arrays(n=32)
        m.fit([(x, y)], epochs=2)
        trainer = FaultTolerantTrainer(m, str(tmp_path),
                                       save_every_n_epochs=100)
        srv = InferenceServer(port=0)
        original = signal.getsignal(signal.SIGTERM)
        got = []
        # the outermost previous handler: stands in for the default
        # terminate action, which would end the test process
        signal.signal(signal.SIGTERM, lambda s, f: got.append("outer"))
        try:
            if server_first:
                assert srv.install_signal_handlers(drain_timeout_s=5.0)
                with PreemptionHandler(trainer, signals=(signal.SIGTERM,),
                                       reraise=True) as h:
                    os.kill(os.getpid(), signal.SIGTERM)
                    assert h.preempted
                    srv._signal_drain.join(timeout=GATE_S)
                    deadline = time.monotonic() + GATE_S
                    while not got:   # the drain re-delivers the signal
                        assert time.monotonic() < deadline
                        time.sleep(0.01)
                # the trainer's handler put back the server's
                restored = signal.getsignal(signal.SIGTERM)
                assert getattr(restored, "__name__", "") == "_handle"
            else:
                with PreemptionHandler(trainer, signals=(signal.SIGTERM,),
                                       reraise=True) as h:
                    assert srv.install_signal_handlers(drain_timeout_s=5.0)
                    os.kill(os.getpid(), signal.SIGTERM)
                    srv._signal_drain.join(timeout=GATE_S)
                    deadline = time.monotonic() + GATE_S
                    while not h.preempted or not got:
                        assert time.monotonic() < deadline
                        time.sleep(0.01)
                assert getattr(signal.getsignal(signal.SIGTERM),
                               "__name__", "") == "<lambda>"
            assert got == ["outer"]
            assert not srv.ready()
            assert _names(tmp_path) == ["checkpoint_epoch2.zip"]
        finally:
            signal.signal(signal.SIGTERM, original)
            srv.stop()


def test_single_process_initialize_cluster_is_noop():
    from deeplearning4j_tpu.parallel.elastic import \
        initialize_cluster as jinit
    assert initialize_cluster(num_processes=1) is False
    assert jinit(num_processes=1) is False
    # the multi-process form needs every coordinate (two gloo ranks join
    # in tests/test_torch_multihost.py)
    with pytest.raises(ValueError, match="together"):
        initialize_cluster("localhost:1234", num_processes=2)


# -- the wrapper mode ----------------------------------------------------
import _torch_dp_scenarios as S  # noqa: E402
from _torch_dp_util import run_ranks  # noqa: E402
from deeplearning4j_tpu.faults import \
    PreemptionFault as JPreemptionFault  # noqa: E402
from deeplearning4j_tpu.parallel import (  # noqa: E402
    GradientSharingAccumulator as JGSA, ParallelWrapper as JPW)
from deeplearning4j_tpu.util.serializer import \
    _flatten_tree as jflat  # noqa: E402
from deeplearning4j_tpu_torch.parallel import (  # noqa: E402
    rebucket_worker_array)

WORLD = 2
#: the documented re-mesh tolerance (docs/distributed.md): relative L2
#: parameter distance of a re-meshed resume to the fixed-shape run
REMESH_REL_TOL = 0.05
#: the port's W = 2 run against JAX's from the same archive: f32 sums in
#: another order over 5 Adam steps at lr 1e-2 (tests/test_torch_parallel
#: .py's state tolerance: of a leaf's max)
STATE_TOL = 5e-6
RESIDUAL_TOL = 1e-4


def _jwrapped(m, mode, workers=WORLD):
    acc = None if mode == "plain" else JGSA(mode=mode)
    return JPW(m, workers=workers, accumulator=acc)


def _jax_archive(d):
    """JAX's W = 2 update-mode run, preempted at step 7 (v3 shards)."""
    X, Y = _arrays()
    jm = _jmlp()
    tr = JTrainer(jm, str(d), save_every_n_steps=3,
                  wrapper=_jwrapped(jm, "update"), sharded_checkpoints=True,
                  fault_injector=JInjector(plan={"preempt": [S.PREEMPT_AT]}))
    with pytest.raises(JPreemptionFault):
        tr.fit(_jit(X, Y), epochs=3)


def _port_extra(path):
    """The archive's params and gradient_sharing members, read by the
    port's serializer."""
    m = ModelSerializer.restore(path, device="cpu")
    flat = {f"params/{k}": v for k, v in S.flat_tree(m.params()).items()}
    flat.update({f"extra/{k}": np.asarray(v)
                 for k, v in (m._resume_extra or {}).items()})
    return flat


def _jax_state(jm, pw):
    out = {f"params/{k}": v for k, v in
           jflat(jax.tree.map(np.asarray, jm._params)).items()}
    out.update({f"extra/{k}": np.asarray(v) for k, v in
                (pw.extra_checkpoint_state() or {}).items()})
    return out


def _flat_params(arrays, pre):
    keys = sorted(k for k in arrays if k.startswith(pre + "params/"))
    return np.concatenate([arrays[k].ravel() for k in keys])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.fixture(scope="module")
def wrapper_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_elastic_wrapper"))
    init = jflat(_jmlp().params())
    np.savez(os.path.join(out, "inputs.npz"),
             **{f"init_elastic/{k}": v for k, v in init.items()})
    _jax_archive(os.path.join(out, "jax_update"))
    run_ranks("elastic_cases", WORLD, out)

    def load(case, rank=0):
        with np.load(os.path.join(out, f"rank{rank}_{case}.npz")) as z:
            return {k: z[k] for k in z.files}
    load.dir = out
    return load


class TestWrapperMode:
    @pytest.mark.parametrize("mode", S.ELASTIC_MODES)
    def test_same_shape_resume_is_bit_exact(self, wrapper_ranks, mode):
        for r in range(WORLD):
            got = wrapper_ranks(f"elastic_{mode}", r)
            meta = json.loads(str(got["telemetry"]))
            assert meta["resumed_step"] == S.PREEMPT_AT
            assert meta["steps"] == [12, 12]
            assert meta["remesh"] is None      # same shape: no re-mesh
            assert meta["writes"] is (r == 0)
            assert meta["telemetry"]["workers"] == WORLD
            assert ("compression" in meta["telemetry"]) is (mode != "plain")
            for k in got:
                if k.startswith("a/"):
                    assert np.array_equal(got[k], got["c/" + k[2:]]), \
                        (mode, r, k)
        a0, a1 = (wrapper_ranks(f"elastic_{mode}", r) for r in (0, 1))
        for k in a0:
            if k.startswith(("a/params/", "a/net/")):
                assert np.array_equal(a0[k], a1[k]), (mode, k)

    def test_wrapper_archive_holds_one_shard_a_worker(self, wrapper_ranks):
        d = os.path.join(wrapper_ranks.dir, "port_update_b")
        last = FaultTolerantTrainer.list_checkpoints(d)[-1]
        assert sorted(os.listdir(last)) == ["manifest.json"] + [
            f"shard_{i:05d}.zip" for i in range(WORLD)]
        man = json.load(open(os.path.join(last, "manifest.json")))
        assert man["num_workers"] == WORLD
        assert man["meta"]["step"] == S.PREEMPT_AT
        assert any(k.startswith("gradient_sharing/residuals/")
                   for k in man["worker_sliced"])
        assert any(k.startswith("gradient_sharing/opt_state/")
                   for k in man["worker_sliced"])

    def test_jax_archive_restores_at_the_same_worker_count(
            self, wrapper_ranks):
        jdir = os.path.join(wrapper_ranks.dir, "jax_update")
        want = _port_extra(FaultTolerantTrainer.list_checkpoints(jdir)[-1])
        assert any(k.startswith("extra/gradient_sharing/residuals/")
                   for k in want)
        for r in range(WORLD):
            got = wrapper_ranks("jax_resumed", r)
            meta = json.loads(str(got["telemetry"]))
            assert meta["remesh"] is None and meta["step"] == 12
            for k, w in want.items():
                assert np.array_equal(got["restored/" + k], w), (r, k)
        # the rest of the schedule against JAX's from the same archive
        m = JTrainer.resume(jdir)
        pw = _jwrapped(m, "update")
        X, Y = _arrays()
        JTrainer(m, jdir + "_jax", save_every_n_steps=3, wrapper=pw,
                 sharded_checkpoints=True).fit(_jit(X, Y), epochs=3)
        got = wrapper_ranks("jax_resumed", 0)
        for k, w in _jax_state(m, pw).items():
            tol = RESIDUAL_TOL if "/residuals/" in k else STATE_TOL
            err = np.abs(got["final/" + k].astype(np.float64) - w).max()
            assert err <= tol * max(np.abs(w).max(), 1e-30), (k, err)

    def test_jax_archive_restores_at_one_worker(self, wrapper_ranks):
        from deeplearning4j_tpu_torch.parallel import (
            GradientSharingAccumulator, ParallelWrapper)
        jdir = os.path.join(wrapper_ranks.dir, "jax_update")
        archive = _port_extra(FaultTolerantTrainer.list_checkpoints(jdir)[-1])
        m = _resume(jdir)
        pw = ParallelWrapper(m, accumulator=GradientSharingAccumulator())
        pw.ensure_step()
        assert pw.last_remesh == (WORLD, 1)
        got = pw.extra_checkpoint_state()
        for k, v in got.items():
            w = archive["extra/" + k]
            if k.startswith(("gradient_sharing/residuals/",
                             "gradient_sharing/opt_state/")):
                w = rebucket_worker_array(w, 1)
            assert np.array_equal(v, w), k

    def test_port_archive_restores_in_jax(self, wrapper_ranks):
        pdir = os.path.join(wrapper_ranks.dir, "port_update_b")
        want = _port_extra(FaultTolerantTrainer.list_checkpoints(pdir)[-1])
        m = JTrainer.resume(pdir)
        assert m._step == S.PREEMPT_AT
        pw = _jwrapped(m, "update")
        pw.ensure_step()
        assert pw.last_remesh is None
        got = _jax_state(m, pw)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert np.array_equal(got[k], w), k
        # and JAX finishes the schedule where the port's resumed run did
        X, Y = _arrays()
        JTrainer(m, pdir + "_jax", save_every_n_steps=3, wrapper=pw,
                 sharded_checkpoints=True).fit(_jit(X, Y), epochs=3)
        ported = wrapper_ranks("elastic_update", 0)
        for k, w in _jax_state(m, pw).items():
            tol = RESIDUAL_TOL if "/residuals/" in k else STATE_TOL
            err = np.abs(ported["c/" + k].astype(np.float64) - w).max()
            assert err <= tol * max(np.abs(w).max(), 1e-30), (k, err)

    @pytest.mark.parametrize("mode", S.ELASTIC_MODES)
    def test_remeshed_resume_within_tolerance(self, wrapper_ranks, mode):
        """The W = 2 archive resumed on one worker finishes the schedule
        within the documented tolerance of the fixed-shape (W = 2) run
        (the dense wrapper within 1e-2, as JAX's own test holds it)."""
        from deeplearning4j_tpu_torch.parallel import (
            GradientSharingAccumulator, ParallelWrapper)
        d = os.path.join(wrapper_ranks.dir, f"port_{mode}_b")
        m = _resume(d)
        assert m._step == S.PREEMPT_AT
        acc = None if mode == "plain" else GradientSharingAccumulator(
            mode=mode)
        pw = ParallelWrapper(m, accumulator=acc)
        X, Y = _arrays()
        FaultTolerantTrainer(m, d + "_w1", save_every_n_steps=3,
                             wrapper=pw, sharded_checkpoints=True).fit(
            _it(X, Y), epochs=3)
        assert m._step == 12
        assert pw.last_remesh == (None if mode == "plain" else (WORLD, 1))
        ref = _flat_params(wrapper_ranks(f"elastic_{mode}", 0), "a/")
        got = np.concatenate([v.ravel() for _, v in
                              sorted(S.flat_tree(m.params()).items())])
        assert np.isfinite(got).all()
        assert _rel(ref, got) <= (1e-2 if mode == "plain"
                                  else REMESH_REL_TOL), mode
