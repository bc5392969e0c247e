"""The port's speculative decoding (``serving/speculative.py`` and the
engine's speculative round) against the JAX package on the same weights
(CPU), at the tiny scale of ``tests/test_speculative.py`` (vocab 64,
d32, L2, H2, max_seq_len 96, the same workload):

- bit identity: at every temperature, on slots, paged and paged with
  sharing, f32 and int8 target caches, with a same-weights draft
  (accept-heavy) and ``make_draft_lm``'s draft carried across from JAX
  (reject-heavy), the port's speculating tokens equal its
  ``speculation_k=0`` tokens and the JAX speculating engine's, with the
  same ``spec`` counters;
- ``forward_verify`` logits and cache writes against JAX's within 1e-5,
  on f32 and int8 slot caches, a span past the cache's end included;
- ``_verify_tail``'s (tgt, n_accepted, ok) against JAX's on seeded
  logits;
- the copy-on-write guard, ``SlotTable.commit`` and the config surface,
  mirrored from the JAX tests.

- ``TestTracingSpans``: a traced speculating request's retroactive
  ``draft`` and ``verify`` spans carry the round and accept sums, which
  ``tools/trace_report.py`` folds from the port's dump as from JAX's,
  and its spans (kinds, in order, and non-timing attributes) are the
  JAX speculating engine's on slots and paged.

The engine's argument validation is held to JAX's messages in
``tests/test_torch_generation.py``, and the card's side
(two CUDA graphs, the draft's launches) is in
``tests/test_torch_kernels_gpu.py``."""
import importlib.util
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import kv_quant as jkv
from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.serving import speculative as jspec
from deeplearning4j_tpu.serving.kvcache import KVCache as JaxKVCache
from deeplearning4j_tpu.tracing import Tracer as JaxTracer
from deeplearning4j_tpu.zoo.transformer_lm import CausalTransformerLM as JaxLM
from deeplearning4j_tpu.zoo.transformer_lm import make_draft_lm as jax_draft
from deeplearning4j_tpu_torch.kernels import kv_quant as tkv
from deeplearning4j_tpu_torch.serving import GenerationEngine, SlotTable
from deeplearning4j_tpu_torch.serving import speculative as tspec
from deeplearning4j_tpu_torch.serving.paging import BlockTable
from deeplearning4j_tpu_torch.tracing import Tracer
from deeplearning4j_tpu_torch.zoo.transformer_lm import (CausalTransformerLM,
                                                         make_draft_lm)
from _torch_threads import one_torch_thread  # noqa: F401,E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 64
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2,
           max_seq_len=96)
# f32 on both sides: the same math, summed in another order
TOL = 1e-5

#: the JAX tests' workload: short and long prompts, a near-empty one,
#: and a budget (max_tokens=3 < k+1) that plain-decodes end to end
_REQS = [(list(range(1, 6)), 24), (list(range(2, 20)), 24),
         (list(range(3, 40)), 17), (list(range(1, 4)), 3)]


def _port(jmodel, **kw):
    """The port's model carrying ``jmodel``'s weights."""
    cfg = dict(CFG, seed=jmodel.seed, **kw)
    return CausalTransformerLM(**cfg, device="cpu").load_params(
        jax.tree.map(np.asarray, jmodel._params))


@pytest.fixture(scope="module")
def jlm():
    return JaxLM(**CFG, seed=7, implementation="plain").init()


@pytest.fixture(scope="module")
def lm(jlm):
    return _port(jlm)


@pytest.fixture(scope="module")
def drafts(jlm, lm):
    """(JAX draft, port draft) pairs: ``same`` is a same-config,
    same-seed copy of the target (with random weights the only draft
    whose argmax follows the target's: the accept path), ``tiny`` is
    JAX's ``make_draft_lm`` draft carried into the port's
    ``make_draft_lm`` (near-chance proposals: the reject path)."""
    same = JaxLM(**CFG, seed=7, implementation="plain").init()
    tiny = jax_draft(jlm)
    return {"same": (same, _port(same)),
            "tiny": (tiny, make_draft_lm(lm).load_params(
                jax.tree.map(np.asarray, tiny._params)))}


def _mk(cls, model, k=0, draft=None, cache=None, sharing=False,
        kv_dtype="f32"):
    kw = dict(num_slots=4, max_queue=32, min_prompt_bucket=4,
              kv_dtype=kv_dtype)
    if cache == "paged":
        kw.update(cache="paged", block_size=8, prefill_chunk_tokens=16,
                  enable_prefix_sharing=sharing)
    if k:
        kw.update(speculation_k=k, draft_model=draft)
    eng = cls(model, **kw)
    if cls is GenerationEngine:
        # the JAX engine compiles what the traffic needs on its own; its
        # warmup would compile every bucket pair
        eng.warmup()
    return eng


def _run_all(eng, temperature=0.0, reqs=_REQS):
    with ThreadPoolExecutor(len(reqs)) as ex:
        futs = [ex.submit(eng.generate, p, max_tokens=n,
                          temperature=temperature, top_k=8, seed=11 + i,
                          timeout_ms=120_000)
                for i, (p, n) in enumerate(reqs)]
        return [f.result()["tokens"] for f in futs]


@pytest.fixture(scope="module")
def baseline(lm):
    """The port's speculation_k=0 tokens for the workload."""
    eng = _mk(GenerationEngine, lm)
    try:
        return {t: _run_all(eng, t) for t in (0.0, 0.9)}
    finally:
        eng.stop()


class TestBitIdentity:
    @pytest.mark.parametrize("draft", ["same", "tiny"])
    @pytest.mark.parametrize("cache,sharing", [
        (None, False), ("paged", False), ("paged", True)])
    def test_identical_to_k0_and_to_jax(self, jlm, lm, drafts, baseline,
                                        cache, sharing, draft):
        jd, td = drafts[draft]
        k = 3 if draft == "same" else 2
        te = _mk(GenerationEngine, lm, k, td, cache, sharing)
        je = _mk(JaxEngine, jlm, k, jd, cache, sharing)
        try:
            for t in (0.0, 0.9):
                got = _run_all(te, t)
                assert got == baseline[t]
                assert got == _run_all(je, t)
            spec = te.stats()["spec"]
            assert spec == je.stats()["spec"]
            assert spec["enabled"] and spec["speculation_k"] == k
            assert spec["verify_batches"] > 0
            if draft == "same":
                assert spec["draft_tokens_accepted"] > 0
            else:
                assert spec["rollbacks"] > 0 and spec["accept_rate"] < 0.3
            assert te.metrics.compiles == 0   # no CUDA graph on a CPU
        finally:
            te.stop()
            je.stop()

    @pytest.mark.parametrize("cache", [None, "paged"])
    def test_int8_target_cache_identical(self, jlm, lm, drafts, cache):
        """An int8 target cache (the draft's stays f32): the same tokens
        as the port's int8 k=0 engine and the JAX int8 speculating
        engine, with the same counters."""
        jd, td = drafts["same"]
        base = _mk(GenerationEngine, lm, cache=cache, kv_dtype="int8")
        te = _mk(GenerationEngine, lm, 3, td, cache, kv_dtype="int8")
        je = _mk(JaxEngine, jlm, 3, jd, cache, kv_dtype="int8")
        try:
            assert tkv.is_quantized(te._kcs[0])
            assert not tkv.is_quantized(te._draft_cache.ks[0])
            for t in (0.0, 0.9):
                want = _run_all(base, t)
                assert _run_all(te, t) == want == _run_all(je, t)
            assert te.stats()["spec"] == je.stats()["spec"]
            assert te.stats()["spec"]["draft_tokens_accepted"] > 0
        finally:
            for e in (base, te, je):
                e.stop()


def _slot_caches(jlm, kv_dtype, S=3, T=16, L=10, seed=0):
    """JAX and port slot caches holding a prefilled prefix of ``L``
    positions in every slot (K/V of random tokens)."""
    jc = JaxKVCache(jlm.cache_shapes(T), S, kv_dtype=kv_dtype)
    toks = np.random.RandomState(seed).randint(0, VOCAB, (S, L))
    _, ks, vs = jlm.forward_prefill(jlm._params, toks)
    jk = [jkv.kv_update_slice(c, k, (0, 0, 0, 0)) for c, k in zip(jc.ks, ks)]
    jv = [jkv.kv_update_slice(c, v, (0, 0, 0, 0)) for c, v in zip(jc.vs, vs)]

    def port(c):
        if jkv.is_quantized(c):
            return tkv.QuantArray(torch.from_numpy(np.array(c.q)),
                                  torch.from_numpy(np.array(c.scale)))
        return torch.from_numpy(np.array(c))
    return jk, jv, [port(c) for c in jk], [port(c) for c in jv]


def _deq(c):
    if jkv.is_quantized(c):
        return np.asarray(jkv.dequantize(c))
    if tkv.is_quantized(c):
        return tkv.dequantize(c).numpy()
    return np.asarray(c)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("p0,clen", [(10, 4), (5, 3), (12, 4)])
def test_forward_verify_matches_jax(jlm, lm, kv_dtype, p0, clen):
    """A verify span of the bucket C=8 at ``p0`` with ``clen`` valid
    rows: logits and every cache row within 1e-5 of JAX's. At p0=12 the
    span runs past the 16-position panel: rows 16..19 are not written
    (JAX drops them) and nothing raises."""
    jk, jv, tk, tv = _slot_caches(jlm, kv_dtype)
    toks = np.random.RandomState(p0).randint(0, VOCAB, (1, 8))
    slot = 1
    jl, jk, jv = jlm.forward_verify(jlm._params, toks, p0, clen, jk, jv,
                                    slot)
    with torch.inference_mode():
        tl, _, _ = lm.forward_verify(lm._params, torch.from_numpy(toks), p0,
                                     clen, tk, tv, slot)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    for a, b in zip(tk + tv, jk + jv):
        np.testing.assert_allclose(_deq(a), _deq(b), rtol=0, atol=TOL)


@pytest.mark.parametrize("temp,top_k", [(0.0, 0), (0.9, 0), (0.9, 8)])
def test_verify_tail_matches_jax(temp, top_k):
    """``(tgt, n_accepted, ok)`` on seeded logits: drafts that match the
    target's first two samples and then miss, drafts past ``vlen - 1``
    that match (not counted), and a non-finite value in a padded row
    (ignored) or in a valid one (ok False)."""
    rs = np.random.RandomState(3)
    C, vlen = 8, 5
    logits = rs.randn(C, VOCAB).astype(np.float32) * 3
    step0, seed = 4, 1234
    want, _, _ = jspec._verify_tail(jnp.asarray(logits),
                                    jnp.zeros((1, C), jnp.int32), vlen,
                                    seed, step0, temp, top_k)
    want = np.asarray(want)
    tokens = np.zeros((1, C), np.int64)
    tokens[0, 1:3] = want[:2]                  # two accepted
    tokens[0, 3] = (want[2] + 1) % VOCAB       # then a miss
    tokens[0, 5:] = want[4:7]                  # past vlen - 1: not counted
    for bad_row in (None, 6, 2):
        lg = logits.copy()
        if bad_row is not None:
            lg[bad_row, 0] = np.nan
        j = jspec._verify_tail(jnp.asarray(lg),
                               jnp.asarray(tokens, jnp.int32), vlen, seed,
                               step0, temp, top_k)
        t = tspec._verify_tail(torch.from_numpy(lg), torch.from_numpy(tokens),
                               vlen, seed, step0, temp, top_k)
        rows = [i for i in range(C) if i != bad_row]  # NaN rows aside
        assert t[0][rows].tolist() == np.asarray(j[0])[rows].tolist()
        assert int(t[1]) == int(j[1]) == 2
        assert bool(t[2]) == bool(j[2]) == (bad_row != 2)


class TestCowGuard:
    @pytest.fixture()
    def quiesced(self, lm, drafts):
        """A warmed paged speculating engine, stopped, with a hand-built
        slot: sharing only ever shares prompt-prefix blocks (below the
        decode cursor), so the hazard the guard defends against is
        staged directly."""
        eng = _mk(GenerationEngine, lm, 3, drafts["same"][1], "paged")
        eng.stop()
        slot = eng._slots.alloc(object())
        blocks = eng._allocator.alloc(3)
        table = BlockTable(blocks, eng.block_size)
        eng._slot_blocks[slot] = table
        eng._tables[slot] = table.padded(eng._blocks_per_seq)
        return eng, slot, table

    def test_shared_block_cowed_before_speculative_write(self, quiesced):
        eng, slot, table = quiesced
        b0, b1 = table.blocks[0], table.blocks[1]
        eng._allocator.share([b1])   # the staged second owner
        for pool in eng._kcs + eng._vcs:
            pool[b1].normal_()
        before = [pool[b1].clone() for pool in eng._kcs + eng._vcs]
        cow0 = eng.metrics.cow_copies
        assert eng._spec_cow_guard(slot, 10) is True   # block 1 of bs=8
        nb = table.blocks[1]
        assert nb != b1
        assert eng._allocator.ref(nb) == 1
        assert eng._allocator.ref(b1) == 1
        assert table.blocks[0] == b0
        assert eng.metrics.cow_copies == cow0 + 1
        assert eng._tables[slot][1] == nb
        # the private copy holds the shared block's K/V
        for pool, want in zip(eng._kcs + eng._vcs, before):
            assert torch.equal(pool[nb], want)

    def test_guard_noop_when_nothing_shared(self, quiesced):
        eng, slot, table = quiesced
        before = list(table.blocks)
        cow0 = eng.metrics.cow_copies
        assert eng._spec_cow_guard(slot, 10) is True
        assert table.blocks == before
        assert eng.metrics.cow_copies == cow0

    def test_guard_reports_pool_exhaustion(self, quiesced):
        eng, slot, table = quiesced
        eng._allocator.share([table.blocks[1]])
        hold = eng._allocator.alloc(eng._allocator.free_count)
        assert eng._allocator.free_count == 0
        assert eng._spec_cow_guard(slot, 10) is False
        eng._allocator.free(hold)

    def test_sharing_composes_with_speculation(self, lm, drafts):
        """A shared-prefix burst through a speculating engine: prefix
        hits happen, speculation happens, and the temp-0 tokens equal
        the same burst on a k=0 slot engine."""
        shared = list(range(1, 17))            # two full blocks
        reqs = [(shared + [20 + i], 12) for i in range(3)]
        ref = _mk(GenerationEngine, lm)
        try:
            want = _run_all(ref, 0.0, reqs)
        finally:
            ref.stop()
        eng = _mk(GenerationEngine, lm, 3, drafts["same"][1], "paged",
                  sharing=True)
        try:
            eng.generate(shared + [19], max_tokens=4, seed=999,
                         timeout_ms=120_000)
            assert _run_all(eng, 0.0, reqs) == want
            assert eng.metrics.prefix_hits >= 1
            assert eng.stats()["spec"]["verify_batches"] > 0
        finally:
            eng.stop()


def _traced_spec(eng, tcls, prompt, max_tokens=16):
    tracer = tcls(enabled=True, ring=8)
    tr = tracer.begin()
    out = eng.generate(prompt, max_tokens=max_tokens, temperature=0.0,
                       seed=5, timeout_ms=120_000, trace=tr)
    tracer.finish(tr)
    return out["tokens"], tr


#: the non-timing attributes of the engine's spans (the speculation
#: spans' sums among them)
SPAN_KEYS = ("verdict", "steps", "finish_reason", "recoveries", "bucket",
             "chunk", "chunks", "resumed", "rounds", "proposed", "accepted",
             "accept_rate", "spec_tokens")


class TestTracingSpans:
    def test_draft_and_verify_spans_aggregate(self, lm, drafts):
        """``tests/test_speculative.py::TestTracingSpans`` on the port: the
        verify span's round and accept sums, the draft span's rounds, and
        ``tools/trace_report.py``'s speculation fold of the port's dump
        (the tool loaded by path, as the JAX test loads it)."""
        import tempfile
        eng = _mk(GenerationEngine, lm, 3, drafts["same"][1])
        try:
            _, tr = _traced_spec(eng, Tracer, list(range(1, 10)))
        finally:
            eng.stop()
        spans = {s.kind: s for s in tr.spans}
        assert "draft" in spans and "verify" in spans
        v = spans["verify"].attrs
        assert v["rounds"] >= 1
        assert v["proposed"] == 3 * v["rounds"]
        assert 0 <= v["accepted"] <= v["proposed"]
        assert v["accept_rate"] == round(v["accepted"] / v["proposed"], 4)
        assert v["spec_tokens"] >= v["rounds"]
        assert v["saved_est_ms"] >= 0
        assert spans["draft"].attrs["rounds"] == v["rounds"]
        spec = importlib.util.spec_from_file_location(
            "trp", os.path.join(ROOT, "tools", "trace_report.py"))
        trp = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(trp)
        with tempfile.NamedTemporaryFile("w", suffix=".json",
                                         delete=False) as f:
            json.dump({"traces": [tr.to_dict()]}, f)
            path = f.name
        try:
            rep = trp.report([path])
        finally:
            os.unlink(path)
        sp = rep["speculation"]
        assert sp["requests"] == 1
        assert sp["rounds"] == v["rounds"]
        assert sp["accepted"] == v["accepted"]

    @pytest.mark.parametrize("cache", [None, "paged"])
    def test_spans_equal_jax(self, jlm, lm, drafts, cache):
        """One traced greedy request through the JAX speculating engine
        and the port's (same-weights draft, k=3): the same tokens, the
        same span kinds in order, the same non-timing attributes."""
        jd, td = drafts["same"]
        got = []
        for cls, model, draft, tcls in ((JaxEngine, jlm, jd, JaxTracer),
                                        (GenerationEngine, lm, td, Tracer)):
            eng = _mk(cls, model, 3, draft, cache)
            try:
                toks, tr = _traced_spec(eng, tcls, list(range(2, 20)))
            finally:
                eng.stop()
            got.append((toks, [(s.kind, {k: s.attrs[k] for k in SPAN_KEYS
                                         if k in s.attrs})
                               for s in tr.spans]))
        assert got[1] == got[0]
        kinds = [k for k, _ in got[1][1]]
        assert kinds[-2:] == ["draft", "verify"]
        assert dict(got[1][1])["verify"]["accepted"] > 0


class TestSlotTableCommit:
    def test_commit_advances_cursors_only(self):
        st = SlotTable(2)
        slot = st.alloc(object())
        st.token[slot], st.pos[slot], st.step[slot] = 5, 10, 3
        st.seed[slot], st.temp[slot] = 77, 0.5
        st.commit(slot, token=9, n_accepted=4)
        assert (st.token[slot], st.pos[slot], st.step[slot]) == (9, 14, 7)
        assert (st.seed[slot], st.temp[slot]) == (77, 0.5)

    def test_commit_validates(self):
        st = SlotTable(2)
        with pytest.raises(ValueError, match="slot 0 is free"):
            st.commit(0, token=1, n_accepted=1)
        slot = st.alloc(object())
        with pytest.raises(ValueError, match="must commit >= 1 token"):
            st.commit(slot, token=1, n_accepted=0)

    def test_free_clears_spec_ok(self):
        st = SlotTable(1)
        slot = st.alloc(object())
        st.spec_ok[slot] = True
        st.free(slot)
        assert not st.spec_ok[slot]


class TestConfigSurface:
    def test_verify_bucket_is_pow2_of_k_plus_1(self):
        for k in (1, 2, 3, 4, 7, 8):
            assert tspec.verify_bucket(k) == jspec.verify_bucket(k)
        assert [tspec.verify_bucket(k) for k in (1, 3, 4)] == [2, 4, 8]

    def test_make_draft_lm_shares_vocab_and_horizon(self, jlm, lm):
        d, jd = make_draft_lm(lm), jax_draft(jlm)
        assert (d.vocab_size, d.max_seq_len, d.eos_id, d.seed) == \
            (jd.vocab_size, jd.max_seq_len, jd.eos_id, jd.seed)
        assert (d.d_model, d.n_layers, d.n_heads) == (32, 1, 2)
        assert d.device == lm.device and d._params is not None
        assert d.cache_shapes() == jd.cache_shapes()

    def test_off_by_default_and_counters_zero(self, jlm, lm):
        eng = GenerationEngine(lm, num_slots=2)
        je = JaxEngine(jlm, num_slots=2)
        try:
            spec = eng.stats()["spec"]
            assert spec == je.stats()["spec"] == {
                "enabled": False, "speculation_k": 0,
                "draft_tokens_proposed": 0, "draft_tokens_accepted": 0,
                "accept_rate": 0.0, "verify_batches": 0, "rollbacks": 0,
                "draft_fallbacks": 0}
            assert eng._draft is None and eng.decode_pipeline
        finally:
            eng.stop()
            je.stop()

    def test_speculation_forces_the_pipeline_off(self, lm, drafts):
        eng = GenerationEngine(lm, num_slots=2, speculation_k=2,
                               draft_model=drafts["same"][1])
        try:
            assert not eng.decode_pipeline
            # the draft's dense f32 cache counts in the cache bytes
            assert eng.metrics.cache_bytes == \
                eng._cache.nbytes() + eng._draft_cache.nbytes()
        finally:
            eng.stop()
