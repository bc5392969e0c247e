"""Request tracing on the port (CPU): ``tracing.py`` (lifted from the JAX
package) and the generation engine's spans, held to
``tests/test_observability.py`` case for case and to the JAX engine on
the same numpy-seeded weights (d32 x L2, 2 slots):

- the tracer: ``TestTracer``'s nine cases (rings, forced traces, span
  trees, retroactive and open spans, concurrent span ids);
- ``TestEngineSpans`` on the paged engine: the admission, queue,
  prefill and decode spans, and the ``shed`` verdict at submit;
- parity: one request at a time through a traced JAX engine and a
  traced port engine gives the same span kinds, in order, and the same
  non-timing attributes, on the slot backend, on the paged backend with
  a prefix hit and a session turn, and through a recompute-recovery
  (an injected corrupting fault, or a failing decode call from
  ``tests/_torch_fault_rig.py``);
- ``TestTraceOverhead``: no tracing code in the decode loop's source,
  and disabled tracing allocates nothing in the port's ``tracing.py``;
- the stream hook: ``stream_notify`` is called once per token and once
  at the end, and one that raises reaches neither the stream nor the
  scheduler.

The speculation spans (``draft``/``verify``) are in
``tests/test_torch_speculative.py``, the ``offload_restore`` span in
``tests/test_torch_kv_offload.py``."""
import inspect
import os
import re
import threading
import time
import tracemalloc

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import faults as jfaults
from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.tracing import Tracer as JaxTracer
from deeplearning4j_tpu.zoo.transformer_lm import CausalTransformerLM as JaxLM
from deeplearning4j_tpu_torch import faults as tfaults
from deeplearning4j_tpu_torch.serving import (ClientError,
                                              DeadlineExceededError,
                                              GenerationEngine)
from deeplearning4j_tpu_torch.tracing import Tracer, new_request_id
from deeplearning4j_tpu_torch.zoo.transformer_lm import CausalTransformerLM

from _torch_fault_rig import Gate, Rig, RigLM, jax_engine
from _torch_threads import one_torch_thread  # noqa: F401,E402

VOCAB = 64
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2,
           max_seq_len=32)
SLOTS = dict(num_slots=2, max_queue=16, min_prompt_bucket=4)
PAGED = dict(SLOTS, cache="paged", block_size=8, prefill_chunk_tokens=8)
#: the attributes a span's timing does not decide
KEYS = ("verdict", "steps", "finish_reason", "recoveries", "bucket",
        "chunk", "chunks", "resumed", "source", "matched_tokens",
        "matched_blocks", "cow", "why", "tokens_kept", "quarantined")


@pytest.fixture(scope="module")
def jlm():
    return JaxLM(**CFG, seed=0, implementation="plain").init()


def _port(jlm, cls=CausalTransformerLM):
    return cls(**CFG, seed=0, device="cpu").load_params(
        jax.tree.map(np.asarray, jlm._params))


@pytest.fixture(scope="module")
def lm(jlm):
    return _port(jlm)


def _spans(tr):
    """(kind, non-timing attributes) of every span, in order."""
    return [(s.kind, {k: s.attrs[k] for k in KEYS if k in s.attrs})
            for s in tr.spans]


def _traced(eng, tracer, **req):
    tr = tracer.begin()
    out = eng.generate(timeout_ms=120_000, trace=tr, **req)
    tracer.finish(tr)
    return out["tokens"], tr


# ---------------------------------------------------------------------------
# the tracer (tests/test_observability.py::TestTracer)
# ---------------------------------------------------------------------------
class TestTracer:
    def test_disabled_begin_returns_none_and_finish_tolerates_it(self):
        tr = Tracer(enabled=False)
        assert tr.begin() is None
        tr.finish(None)
        assert tr.snapshot()["started"] == 0

    def test_force_traces_single_request_while_disabled(self):
        tr = Tracer(enabled=False)
        t = tr.begin("rid-1", force=True)
        assert t is not None and t.trace_id == "rid-1"
        t.span("http").end(status=200)
        tr.finish(t)
        dumped = tr.dump(request_id="rid-1")
        assert len(dumped) == 1
        assert dumped[0]["spans"][0]["kind"] == "http"
        assert dumped[0]["spans"][0]["attrs"]["status"] == 200

    def test_minted_request_ids_are_unique_hex(self):
        ids = {new_request_id() for _ in range(64)}
        assert len(ids) == 64
        assert all(re.fullmatch(r"[0-9a-f]{16}", i) for i in ids)

    def test_recent_ring_is_bounded(self):
        tr = Tracer(enabled=True, ring=8)
        for i in range(25):
            t = tr.begin(f"r{i}")
            t.span("http").end()
            tr.finish(t)
        snap = tr.snapshot()
        assert snap["started"] == snap["finished"] == 25
        assert snap["recent"] == 8
        got = [d["request_id"] for d in tr.dump(limit=100)]
        assert got[0] == "r24" and "r0" not in got

    def test_slow_and_errored_rings_retain_past_recent_eviction(self):
        tr = Tracer(enabled=True, ring=2, slow_ms=5.0)
        slow = tr.begin("slow-one")
        slow.t_start -= 1.0
        tr.finish(slow)
        tr.finish(tr.begin("err-one"), error=True)
        for i in range(10):
            tr.finish(tr.begin(f"f{i}"))
        snap = tr.snapshot()
        assert snap["slow"] >= 1 and snap["errored"] >= 1
        assert len(tr.dump(request_id="slow-one")) == 1
        errd = tr.dump(request_id="err-one")
        assert len(errd) == 1 and errd[0]["error"] is True

    def test_dump_limit_and_dedup(self):
        tr = Tracer(enabled=True, ring=16, slow_ms=0.0)  # all slow too
        for i in range(6):
            tr.finish(tr.begin(f"r{i}"))
        assert len(tr.dump(limit=100)) == 6
        assert len(tr.dump(limit=3)) == 3

    def test_span_tree_defaults_to_component_root(self):
        t = Tracer(enabled=True).begin("tree")
        root = t.span("http")
        a = t.span("admission")
        q = t.span("queue")
        explicit = t.span("device", parent=q)
        assert a.parent_id == root.span_id
        assert q.parent_id == root.span_id
        assert explicit.parent_id == q.span_id
        assert len({root.span_id, a.span_id, q.span_id,
                    explicit.span_id}) == 4

    def test_retroactive_span_and_open_span_serialization(self):
        tr = Tracer(enabled=True)
        t = tr.begin("retro")
        t.span("decode", t_start=t.t_start, t_end=t.t_start + 0.250,
               steps=5)
        open_span = t.span("hedge")
        tr.finish(t)
        d = t.to_dict()
        decode = next(s for s in d["spans"] if s["kind"] == "decode")
        assert decode["duration_ms"] == pytest.approx(250.0, abs=1.0)
        assert decode["attrs"]["steps"] == 5
        hedge = next(s for s in d["spans"] if s["kind"] == "hedge")
        assert hedge["duration_ms"] is None
        assert open_span.span_id == hedge["span_id"]

    def test_concurrent_span_ids_unique(self):
        t = Tracer(enabled=True).begin("conc")
        spans = []

        def rec():
            for _ in range(50):
                spans.append(t.span("dispatch").end())

        th = [threading.Thread(target=rec) for _ in range(4)]
        for x in th:
            x.start()
        for x in th:
            x.join()
        ids = [s.span_id for s in spans]
        assert len(ids) == len(set(ids)) == 200


# ---------------------------------------------------------------------------
# the engine's spans (tests/test_observability.py::TestEngineSpans)
# ---------------------------------------------------------------------------
def test_generation_spans_and_shed_verdict(lm):
    eng = GenerationEngine(lm, num_slots=2, max_seq_len=32,
                           prompt_buckets=[8], cache="paged", block_size=4,
                           num_blocks=16)
    eng.warmup()
    tracer = Tracer(enabled=True)
    try:
        tokens, tr = _traced(eng, tracer, prompt=[1, 2, 3], max_tokens=8)
        d = tr.to_dict()
        kinds = [s["kind"] for s in d["spans"]]
        assert {"admission", "queue", "prefill", "decode",
                "step_pipeline"} <= set(kinds)
        adm = next(s for s in d["spans"] if s["kind"] == "admission")
        assert adm["attrs"]["verdict"] == "admitted"
        assert {"est_cost_ms", "prefill_ms_per_tok",
                "decode_ewma_ms"} <= set(adm["attrs"])
        dec = next(s for s in d["spans"] if s["kind"] == "decode")
        assert dec["attrs"]["steps"] == len(tokens) == 8
        assert dec["attrs"]["finish_reason"] == "length"
        # every span closed, the queue wait among them
        assert all(s["duration_ms"] is not None for s in d["spans"])

        # a prompt longer than max_seq_len is a ClientError at submit,
        # recorded as admission with verdict "shed"
        tr2 = tracer.begin("gen-shed")
        with pytest.raises(ClientError):
            eng.generate(list(range(1, 60)), max_tokens=8, trace=tr2)
        tracer.finish(tr2, error=True)
        spans2 = tr2.to_dict()["spans"]
        assert [s["kind"] for s in spans2] == ["admission"]
        assert spans2[0]["attrs"]["verdict"] == "shed"
        assert "error" in spans2[0]["attrs"]
        assert tracer.snapshot()["errored"] == 1
    finally:
        eng.stop()


def test_expired_verdict_at_dequeue(lm):
    """A request whose deadline budget goes while it waits in the queue is
    shed at dequeue: an ``admission`` span with verdict ``expired``, the
    queue span closed, an ``error`` span, as in the JAX engine."""
    eng = GenerationEngine(lm, **SLOTS)
    tracer = Tracer(enabled=True)
    gate = Gate()
    try:
        eng.set_fault_injector(gate)
        assert gate.held.wait(10.0)
        tr = tracer.begin()
        stream = eng.stream([1, 2, 3], max_tokens=4, timeout_ms=1.0,
                            trace=tr)
        time.sleep(0.05)  # the 1 ms budget is gone
        gate.open.set()
        with pytest.raises(DeadlineExceededError, match="deadline"):
            list(stream)
        eng.set_fault_injector(None)
        kinds = [(s.kind, s.attrs.get("verdict")) for s in tr.spans]
        assert kinds == [("admission", "admitted"), ("queue", None),
                         ("admission", "expired"), ("error", None)]
        assert all(s.t_end is not None for s in tr.spans)
    finally:
        gate.open.set()
        eng.stop()


# ---------------------------------------------------------------------------
# parity with the JAX engine
# ---------------------------------------------------------------------------
def _both(jlm, lm, kw, run, jax_cls=JaxEngine, port_lm=None):
    """``run(engine, tracer)`` on the JAX engine and on the port's, each
    traced by its own package's tracer; returns both results."""
    out = []
    for cls, model, tcls in ((jax_cls, jlm, JaxTracer),
                             (GenerationEngine, port_lm or lm, Tracer)):
        eng = cls(model, **kw)
        try:
            out.append(run(eng, tcls(enabled=True)))
        finally:
            eng.stop()
    return out


def _prompt(i, n=17):
    return [(5 * i + j) % (VOCAB - 8) + 1 for j in range(n)]


def test_slot_spans_equal_jax(jlm, lm):
    def run(eng, tracer):
        got = []
        for i, temp in enumerate((0.0, 0.9, 0.0)):
            toks, tr = _traced(eng, tracer, prompt=_prompt(i, 5 + 4 * i),
                               max_tokens=6, temperature=temp, top_k=8,
                               seed=i)
            got.append((toks, _spans(tr)))
        return got
    jax_got, port_got = _both(jlm, lm, SLOTS, run)
    assert port_got == jax_got
    kinds = [k for k, _ in port_got[0][1]]
    assert kinds == ["admission", "queue", "prefill", "decode",
                     "step_pipeline"]


def test_paged_prefix_and_session_spans_equal_jax(jlm, lm):
    """A prompt behind another's full blocks (an index hit), then a
    session's two turns (a session hit ending mid-block: copy on write),
    on the chunked paged backend."""
    def run(eng, tracer):
        got = []
        base = _prompt(0)
        # the session pins 12 + 6 - 1 = 17 tokens: its match ends
        # mid-block
        reqs = [dict(prompt=base, max_tokens=5),
                dict(prompt=base[:16] + [3, 9, 4], max_tokens=5),
                dict(prompt=_prompt(1, 12), max_tokens=6, session_id="s1")]
        for r in reqs:
            toks, tr = _traced(eng, tracer, **r)
            got.append((toks, _spans(tr)))
        turn2 = _prompt(1, 12) + got[-1][0] + [7, 11]
        toks, tr = _traced(eng, tracer, prompt=turn2, max_tokens=4,
                           session_id="s1")
        got.append((toks, _spans(tr)))
        return got
    jax_got, port_got = _both(jlm, lm, PAGED, run)
    assert port_got == jax_got
    matches = [a for _, spans in port_got for k, a in spans
               if k == "prefix_match"]
    assert [m["source"] for m in matches] == ["index", "session"]
    assert matches[1]["cow"] is True
    chunks = [a for k, a in port_got[0][1] if k == "prefill"]
    assert [c["chunk"] for c in chunks] == [0, 1, 2]


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_recovery_spans_equal_jax_under_injected_fault(jlm, lm, backend):
    """One corrupting fault at the 3rd decode step sends the request
    through recompute-recovery: a ``recovery`` span (its ``why`` and
    ``tokens_kept``), the re-prefill (``resumed``), then the decode span
    with ``recoveries`` 1, on both engines alike."""
    kw = SLOTS if backend == "slots" else PAGED

    def run(eng, tracer):
        mod = tfaults if isinstance(eng, GenerationEngine) else jfaults
        eng.set_fault_injector(mod.FaultInjector(
            plan={"device_step": [3]}, corrupting=("device_step",)))
        toks, tr = _traced(eng, tracer, prompt=_prompt(2, 10), max_tokens=8)
        assert eng.stats()["faults"]["recoveries"] == 1
        return toks, _spans(tr)
    jax_got, port_got = _both(jlm, lm, kw, run)
    assert port_got == jax_got
    kinds = [k for k, _ in port_got[1]]
    rec = kinds.index("recovery")
    assert max(i for i, k in enumerate(kinds) if k == "prefill") > rec
    assert dict(port_got[1])["recovery"]["tokens_kept"] > 0
    dec = dict(port_got[1])["decode"]
    assert dec["recoveries"] == 1 and dec["steps"] == 8


def test_recovery_spans_equal_jax_under_failing_decode_call(jlm):
    """The fault rig's failing decode call (as a CUDA launch error would
    fail it) on the slot backend: the same spans on both engines, the
    recovery's ``why`` the call's own error."""
    rig = Rig()
    port_lm = _port(jlm, RigLM)
    port_lm.rig = rig

    def run(eng, tracer):
        rig.arm(decode=[3])
        toks, tr = _traced(eng, tracer, prompt=_prompt(3, 9), max_tokens=7)
        rig.arm()
        return toks, _spans(tr)
    jax_got, port_got = _both(
        jlm, None, SLOTS, run, port_lm=port_lm,
        jax_cls=lambda m, **kw: jax_engine(m, rig, **kw))
    assert port_got == jax_got
    why = [a["why"] for k, a in port_got[1] if k == "recovery"]
    assert len(why) == 1 and "CUDA error 700" in why[0]


# ---------------------------------------------------------------------------
# zero cost (tests/test_observability.py::TestTraceOverhead)
# ---------------------------------------------------------------------------
def test_decode_hot_loop_carries_no_tracing_code():
    for fn in (GenerationEngine._decode_step_fn, GenerationEngine._loop,
               GenerationEngine._dispatch_decode,
               GenerationEngine._collect_decode, GenerationEngine._retire):
        assert "trace" not in inspect.getsource(fn).lower(), (
            f"{fn.__name__} must stay free of tracing code; the decode "
            "span is rebuilt in _trace_terminal")


def test_disabled_tracing_allocates_nothing(lm):
    eng = GenerationEngine(lm, num_slots=2, max_seq_len=32,
                           prompt_buckets=[8], cache="paged", block_size=4,
                           num_blocks=16)
    eng.warmup()
    tracer = Tracer(enabled=False)
    try:
        eng.generate([1, 2, 3], max_tokens=4)   # warm paths
        trace_py = os.path.join("deeplearning4j_tpu_torch", "tracing.py")
        tracemalloc.start()
        try:
            tr = tracer.begin()
            eng.generate([4, 5, 6], max_tokens=8, trace=tr)
            tracer.finish(tr)
            snap = tracemalloc.take_snapshot()
        finally:
            tracemalloc.stop()
        hits = [st for st in snap.statistics("filename")
                if st.traceback[0].filename.endswith(trace_py)]
        assert tr is None and not hits, (
            "disabled tracing must allocate nothing: "
            f"{[(h.traceback[0].filename, h.size) for h in hits]}")
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# the stream hook
# ---------------------------------------------------------------------------
def _stream_with_notify(eng, notify, **req):
    """Stream ``req`` with ``notify`` set on the request before the
    scheduler can take it (held at its ``latency`` seam)."""
    gate = Gate()
    eng.set_fault_injector(gate)
    try:
        assert gate.held.wait(10.0)
        stream = eng.stream(timeout_ms=120_000, **req)
        stream._req.stream_notify = notify
    finally:
        gate.open.set()
    chunks = list(stream)
    eng.set_fault_injector(None)
    return chunks


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_stream_notify_once_per_token_and_once_at_the_end(lm, backend):
    eng = GenerationEngine(lm, **(SLOTS if backend == "slots" else PAGED))
    calls = []
    try:
        chunks = _stream_with_notify(eng, lambda: calls.append(1),
                                     prompt=_prompt(4, 11), max_tokens=6)
        want = eng.generate(_prompt(4, 11), max_tokens=6)["tokens"]
    finally:
        eng.stop()
    assert [c["token"] for c in chunks[:-1]] == want
    assert chunks[-1]["done"] is True
    assert len(calls) == len(want) + 1


def test_raising_stream_notify_reaches_neither_stream_nor_scheduler(lm):
    eng = GenerationEngine(lm, **SLOTS)
    calls = []

    def bad():
        calls.append(1)
        raise RuntimeError("consumer bug")
    try:
        chunks = _stream_with_notify(eng, bad, prompt=_prompt(5, 7),
                                     max_tokens=5)
        again = eng.generate(_prompt(5, 7), max_tokens=5)
        assert eng.alive()
        st = eng.stats()
    finally:
        eng.stop()
    assert [c["token"] for c in chunks[:-1]] == again["tokens"]
    assert chunks[-1]["finish_reason"] == "length"
    assert len(calls) == 6
    assert st["faults"]["recoveries"] == 0 and st["server_errors"] == 0
