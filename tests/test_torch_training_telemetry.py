"""Training observability of the port against the JAX package's (CPU),
mirroring ``tests/test_training_observability.py``'s
``TestEventTimeline``, ``TestFleetTelemetry`` and its traced-fit cases
(the UIServer metrics plane waits for ROADMAP.md queue A, item 16):

- ``EventTimeline`` and ``FleetTelemetry`` give JAX's dumps, counts and
  snapshots for the same calls;
- the step loop carries no tracing code (source-scanned) and an
  attached but disabled tracer allocates nothing in ``tracing.py``
  (tracemalloc);
- a traced fit rebuilds its per-phase spans from the ring at fit exit,
  with the span kinds and counts of the JAX trainer's trace for the
  same run, and a resumed fit records the ``resume`` event and span.
"""
import inspect
import os
import tracemalloc

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JIter
from deeplearning4j_tpu.faults import FaultInjector as JInjector
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.parallel import telemetry as JT
from deeplearning4j_tpu.parallel.elastic import \
    FaultTolerantTrainer as JTrainer
from deeplearning4j_tpu.tracing import Tracer as JTracer
from deeplearning4j_tpu_torch.convert import network_params_from_jax
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.faults import FaultInjector, PreemptionFault
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.parallel import telemetry as TT
from deeplearning4j_tpu_torch.parallel.elastic import FaultTolerantTrainer
from deeplearning4j_tpu_torch.parallel.resilience import TrainingSupervisor
from deeplearning4j_tpu_torch.parallel.telemetry import (EventTimeline,
                                                         FleetTelemetry)
from deeplearning4j_tpu_torch.tracing import Tracer


def _conf(Conf, L, Opt):
    return (Conf.builder().seed(0).updater(Opt(1e-2))
            .weight_init("xavier").list()
            .layer(L.DenseLayer(n_out=8, activation="tanh"))
            .layer(L.OutputLayer(n_out=2, loss="mcxent",
                                 activation="softmax"))
            .input_type_feed_forward(4).build())


def _pair():
    jm = JNet(_conf(JConf, JL, JAdam)).init()
    m = MultiLayerNetwork(_conf(NeuralNetConfiguration, TL, Adam),
                          device="cpu").init()
    m.set_params(network_params_from_jax(jax.tree.map(np.asarray,
                                                      jm.params())))
    return jm, m


def _arrays(n=64, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.rand(n, 4).astype(np.float32)
    return X, np.eye(2, dtype=np.float32)[rs.randint(0, 2, n)]


def _its(X, Y, batch=16):
    return (JIter(X, Y, batch=batch, shuffle=True, seed=3),
            ArrayDataSetIterator(X, Y, batch=batch, shuffle=True, seed=3))


def _kinds(trace):
    kinds = {}
    for s in trace["spans"]:
        kinds[s["kind"]] = kinds.get(s["kind"], 0) + 1
    return kinds


def _strip_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


class TestEventTimeline:
    def test_ring_is_bounded_but_counts_survive_eviction(self):
        evs = [EventTimeline(capacity=4), JT.EventTimeline(capacity=4)]
        for ev in evs:
            for i in range(10):
                ev.record("anomaly_skip", worker=0, step=i)
        ev, jev = evs
        assert len(ev) == len(jev) == 4
        assert ev.counts() == jev.counts() == {"anomaly_skip": 10}
        assert [e["step"] for e in ev.dump()] == [6, 7, 8, 9]
        assert _strip_ts(ev.dump()) == _strip_ts(jev.dump())

    def test_dump_filters_by_kind_and_limits(self):
        evs = [EventTimeline(), JT.EventTimeline()]
        for ev in evs:
            ev.record("preempt_broadcast", worker=1, step=4)
            ev.record("preempt_received", worker=0, step=4)
            ev.record("preempt_received", worker=2, step=4)
            ev.record("checkpoint_commit", worker=1, duration_ms=2.0)
        ev, jev = evs
        got = ev.dump(kind="preempt_received")
        assert [e["worker"] for e in got] == [0, 2]
        assert _strip_ts(got) == _strip_ts(jev.dump(kind="preempt_received"))
        assert len(ev.dump(limit=2)) == 2
        assert all("ts" in e for e in got)
        ev.clear()
        assert len(ev) == 0 and ev.counts() == {}


class TestFleetTelemetry:
    def test_ewma_seeds_on_first_observation(self):
        for cls in (FleetTelemetry, JT.FleetTelemetry):
            ft = cls(alpha=0.5)
            ft.observe_step(0, 0.100)
            assert ft.snapshot()["workers"]["0"]["ewma_ms"] == 100.0
            ft.observe_step(0, 0.200)
            assert ft.snapshot()["workers"]["0"]["ewma_ms"] == 150.0

    def test_straggler_spread_is_slowest_over_median(self):
        fts = [FleetTelemetry(), JT.FleetTelemetry()]
        for ft in fts:
            for w, s in ((0, 0.010), (1, 0.010), (2, 0.030)):
                ft.observe_step(w, s)
        st = fts[0].straggler()
        assert st == fts[1].straggler()
        assert st["slowest_worker"] == 2
        assert st["median_ms"] == 10.0 and st["spread"] == 3.0
        assert fts[0].snapshot() == fts[1].snapshot()

    def test_counters_and_unknown_key_raises(self):
        ft = FleetTelemetry()
        ft.inc(1, "preempts")
        ft.inc(1, "rollbacks", 2)
        w = ft.snapshot()["workers"]["1"]
        assert (w["preempts"], w["rollbacks"], w["anomaly_skips"]) \
            == (1, 2, 0)
        with pytest.raises(KeyError):
            ft.inc(1, "nonsense")

    def test_compression_stats_waits_for_parallel_wrapper(self):
        """None until a wrapper's compressed step is built; then JAX's
        keys and, for the same one-worker run, JAX's rounded values."""
        from deeplearning4j_tpu.parallel import (
            GradientSharingAccumulator as JGSA, ParallelWrapper as JPW,
            make_mesh as jmake_mesh)
        from deeplearning4j_tpu_torch.parallel import (
            GradientSharingAccumulator, ParallelWrapper)
        assert TT.compression_stats(object()) is None
        assert JT.compression_stats(object()) is None
        jm, m = _pair()
        jpw = JPW(jm, mesh=jmake_mesh(jax.devices()[:1]), prefetch_buffer=0,
                  accumulator=JGSA(threshold=1e-2))
        pw = ParallelWrapper(m, prefetch_buffer=0,
                             accumulator=GradientSharingAccumulator(
                                 threshold=1e-2))
        assert TT.compression_stats(pw) is None
        assert JT.compression_stats(jpw) is None
        X, Y = _arrays()
        data = [(X[i:i + 16], Y[i:i + 16]) for i in range(0, 64, 16)]
        jpw.fit(data, epochs=1)
        pw.fit(data, epochs=1)
        got, want = TT.compression_stats(pw), JT.compression_stats(jpw)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k


class TestTracedFit:
    def test_hot_path_sources_carry_no_tracing_code(self):
        for fn in (FaultTolerantTrainer._run_one_step,
                   FaultTolerantTrainer._after_step,
                   TrainingSupervisor.step):
            src = inspect.getsource(fn).lower()
            assert "trace" not in src, \
                f"{fn.__qualname__} mentions tracing in the hot path"

    def test_disabled_instrumented_fit_allocates_nothing_in_tracing(
            self, tmp_path):
        X, Y = _arrays()
        _, m = _pair()
        tr = FaultTolerantTrainer(m, str(tmp_path / "ck"),
                                  save_every_n_steps=3,
                                  tracer=Tracer(enabled=False))
        tr.fit(_its(X, Y)[1], epochs=1)
        trace_py = os.path.join("deeplearning4j_tpu_torch", "tracing.py")
        tracemalloc.start()
        try:
            tr.fit(_its(X, Y)[1], epochs=2)
            snap = tracemalloc.take_snapshot()
        finally:
            tracemalloc.stop()
        hits = [st for st in snap.statistics("filename")
                if st.traceback[0].filename.endswith(trace_py)]
        assert not hits, [(h.traceback[0].filename, h.size) for h in hits]
        assert tr._obs is None and tr.supervisor.obs is None

    def test_traced_fit_builds_phase_spans_retroactively(self, tmp_path):
        X, Y = _arrays()
        jm, m = _pair()
        jit_, it = _its(X, Y)
        traces = []
        for cls, T, model, itr in ((JTrainer, JTracer, jm, jit_),
                                   (FaultTolerantTrainer, Tracer, m, it)):
            tracer = T(enabled=True)
            tr = cls(model, str(tmp_path / cls.__module__), worker_id=5,
                     save_every_n_steps=2, tracer=tracer)
            tr.fit(itr, epochs=1)           # 4 steps, ckpt every 2
            (t,) = tracer.dump()
            traces.append(t)
        jt, t = traces
        assert t["request_id"].startswith("train-w5-")
        kinds = _kinds(t)
        assert kinds == _kinds(jt)
        assert kinds["fit"] == 1 and kinds["data_wait"] == 4
        assert kinds["device_step"] == 4 and kinds["host_snapshot"] == 2
        assert kinds["checkpoint_submit"] == 2
        assert kinds["checkpoint_write"] >= 1
        root = next(s for s in t["spans"] if s["kind"] == "fit")
        assert all(s["parent_id"] == root["span_id"]
                   for s in t["spans"] if s is not root)
        assert set(root["attrs"]) == set(next(
            s for s in jt["spans"] if s["kind"] == "fit")["attrs"])
        ds = next(s for s in t["spans"] if s["kind"] == "device_step")
        assert ds["attrs"]["worker"] == 5
        ph = tr.telemetry_snapshot()["phases"]
        assert ph["device_step_s"] > 0
        assert 0.0 <= ph["data_wait_frac"] <= 1.0

    def test_events_and_fleet_telemetry_of_a_faulted_fit(self, tmp_path):
        """A fit with an anomaly skip, a rollback and a preemption
        records JAX's events and fleet counters, and its
        ``telemetry_snapshot`` has JAX's keys."""
        rs = np.random.RandomState(0)
        batches = []
        for i in range(6):
            x = rs.rand(8, 4).astype(np.float32)
            if i in (2, 3):
                x[0, 0] = np.nan
            batches.append((x, np.eye(2, dtype=np.float32)[
                rs.randint(0, 2, 8)]))
        jm, m = _pair()
        out = []
        for cls, Inj, ET, FT, model in (
                (JTrainer, JInjector, JT.EventTimeline,
                 JT.FleetTelemetry, jm),
                (FaultTolerantTrainer, FaultInjector, EventTimeline,
                 FleetTelemetry, m)):
            events, fleet = ET(), FT()
            tr = cls(model, str(tmp_path / cls.__module__),
                     anomaly_guard=True, rollback_after=2, worker_id=0,
                     fault_injector=Inj(plan={"preempt": [5]}),
                     events=events, fleet_telemetry=fleet)
            with pytest.raises(Exception, match="preempt"):
                tr.fit(batches, epochs=1)
            out.append((events, fleet, tr))
        (je, jf, jtr), (e, f, tr) = out
        assert e.counts() == je.counts()
        assert [ev["kind"] for ev in e.dump()] == \
            [ev["kind"] for ev in je.dump()]
        for a, b in zip(e.dump(), je.dump()):
            assert set(a) == set(b)
            if a["kind"] != "checkpoint_commit":
                assert {k: v for k, v in a.items() if k != "ts"} == \
                    {k: v for k, v in b.items() if k != "ts"}
        w, jw = f.snapshot()["workers"]["0"], jf.snapshot()["workers"]["0"]
        assert {k: v for k, v in w.items() if k != "ewma_ms"} == \
            {k: v for k, v in jw.items() if k != "ewma_ms"}
        assert set(tr.telemetry_snapshot()) == set(jtr.telemetry_snapshot())
        assert isinstance(tr.faults_snapshot()["injector"], dict)

    def test_resume_records_resume_event_and_span(self, tmp_path):
        X, Y = _arrays()
        _, m = _pair()
        tr = FaultTolerantTrainer(m, str(tmp_path / "ck"),
                                  save_every_n_steps=100,
                                  fault_injector=FaultInjector(
                                      plan={"preempt": [3]}))
        with pytest.raises(PreemptionFault):
            tr.fit(_its(X, Y)[1], epochs=2)
        tracer, events = Tracer(enabled=True), EventTimeline()
        m2 = FaultTolerantTrainer.resume(str(tmp_path / "ck"), device="cpu")
        tr2 = FaultTolerantTrainer(m2, str(tmp_path / "ck"),
                                   save_every_n_steps=100, tracer=tracer,
                                   events=events, worker_id=0)
        tr2.fit(_its(X, Y)[1], epochs=2)
        evs = events.dump(kind="resume")
        assert len(evs) == 1 and evs[0]["step"] == 3
        spans = [s for t in tracer.dump() for s in t["spans"]
                 if s["kind"] == "resume"]
        assert len(spans) == 1 and spans[0]["attrs"]["epoch"] >= 0
