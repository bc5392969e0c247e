"""The port's fault ladder (``serving/generation.py``) against the JAX
package's, on the CPU at the JAX fault-tolerance tests' sizes (d32 x
L2, vocab 64, weights carried across by ``load_params``): the JAX
``TestChaosSlots`` and ``TestChaosPaged`` cases with their
``retries``/``recoveries`` counts (no accepted request lost, tokens
identical to the fault-free run, no capture after warmup, every block
back), its ``TestChaosSpeculative`` cases on a speculating engine (the
draft cache kept on its storage), corrupting recovery on an int8 cache
that keeps every tensor's storage, the same injector plan through the
JAX engine and the port's with the same tokens and counts, the stall
watchdog, a drain that waits for re-admissions, the poison fallback,
``decode_impl`` at the JAX engine's position, and the near-tie measure
of ``chip_smoke.py``'s phase 11."""
import importlib.util
import inspect
import pathlib
import threading
import time

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import FaultInjector as JaxInjector
from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.zoo.transformer_lm import CausalTransformerLM as JaxLM
from deeplearning4j_tpu_torch.kernels.kv_quant import is_quantized
from deeplearning4j_tpu_torch.serving import (FaultInjector,
                                              GenerationEngine,
                                              ServingError)
from deeplearning4j_tpu_torch.zoo.transformer_lm import CausalTransformerLM
from _torch_threads import one_torch_thread  # noqa: F401,E402

VOCAB = 64
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4,
           max_seq_len=32)
SLOT_KW = dict(num_slots=3, max_queue=64, min_prompt_bucket=4)
PAGED_KW = dict(num_slots=3, max_queue=64, cache="paged", block_size=4,
                prompt_buckets=[8], prefill_chunk_tokens=8)
BACKENDS = {"slots": SLOT_KW, "paged": PAGED_KW}
FAST_RETRY = dict(retry_backoff_ms=0.2, retry_backoff_max_ms=2.0)

#: the JAX chaos workload: mixed prompt and generation lengths, sampled
_REQS = [(np.random.RandomState(i).randint(0, 32, 3 + 2 * i).tolist(),
          5 + i) for i in range(6)]


@pytest.fixture(scope="module")
def jlm():
    return JaxLM(**CFG, seed=0, implementation="plain").init()


@pytest.fixture(scope="module")
def lm(jlm):
    return CausalTransformerLM(**CFG, seed=0, device="cpu").load_params(
        jax.tree.map(np.asarray, jlm._params))


def _run_all(eng, reqs=_REQS):
    """Submit every request at once; returns token lists (None for a
    failed request) and the errors."""
    results = [None] * len(reqs)
    errors = [None] * len(reqs)

    def go(i):
        p, n = reqs[i]
        try:
            results[i] = eng.generate(
                p, max_tokens=n, temperature=0.8, top_k=8, seed=i,
                timeout_ms=120_000)["tokens"]
        except Exception as e:  # noqa: BLE001 — recorded for asserts
            errors[i] = e

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return results, errors


def _chaos_run(eng, inj):
    """The workload under an injector on a shared warmed engine; returns
    (outputs, errors, retries, recoveries, captures) of this run."""
    m = eng.metrics
    r0, v0, c0 = m.retries, m.recoveries, m.compiles
    eng.set_fault_injector(inj)
    try:
        out, errs = _run_all(eng)
    finally:
        eng.set_fault_injector(None)
    return out, errs, m.retries - r0, m.recoveries - v0, m.compiles - c0


def _engine(lm, backend, **kw):
    eng = GenerationEngine(lm, **FAST_RETRY, **BACKENDS[backend], **kw)
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def slot_eng(lm):
    """One warmed slot engine shared by every chaos case (through
    set_fault_injector)."""
    eng = _engine(lm, "slots")
    yield eng
    eng.stop()


@pytest.fixture(scope="module")
def slot_baseline(slot_eng):
    """Fault-free outputs: what every chaos run must reproduce."""
    out, errs = _run_all(slot_eng)
    assert errs == [None] * len(_REQS)
    return out


@pytest.fixture(scope="module")
def paged_eng(lm):
    eng = _engine(lm, "paged")
    yield eng
    eng.stop()


@pytest.fixture(scope="module")
def paged_baseline(paged_eng, slot_baseline):
    out, errs = _run_all(paged_eng)
    assert errs == [None] * len(_REQS)
    assert out == slot_baseline  # the backends agree fault-free
    return out


class TestChaosSlots:
    def test_transient_faults_retried_token_identical(self, slot_eng,
                                                      slot_baseline):
        inj = FaultInjector(plan={"device_step": [2, 5, 9],
                                  "prefill": [3]})
        out, errs, retries, recoveries, captures = _chaos_run(slot_eng,
                                                              inj)
        assert errs == [None] * len(_REQS)   # zero requests lost
        assert out == slot_baseline          # token-identical
        assert (retries, recoveries, captures) == (4, 0, 0)

    def test_corrupting_fault_recovers_token_identical(self, slot_eng,
                                                       slot_baseline):
        inj = FaultInjector(plan={"device_step": [6], "prefill": [2]},
                            corrupting=("device_step", "prefill"))
        out, errs, retries, recoveries, captures = _chaos_run(slot_eng,
                                                              inj)
        assert errs == [None] * len(_REQS)
        assert out == slot_baseline
        assert (retries, recoveries, captures) == (0, 2, 0)

    def test_retries_exhausted_falls_back_to_recovery(self, slot_eng,
                                                      slot_baseline):
        # 5 consecutive transient faults against max_step_retries=2:
        # strikes 1 and 2 retry, the 3rd recovers, then 2 more retries
        inj = FaultInjector(plan={"device_step": [1, 2, 3, 4, 5]})
        slot_eng._max_step_retries = 2
        try:
            out, errs, retries, recoveries, captures = _chaos_run(
                slot_eng, inj)
        finally:
            slot_eng._max_step_retries = 3
        assert errs == [None] * len(_REQS)
        assert out == slot_baseline
        assert (retries, recoveries, captures) == (4, 1, 0)

    def test_random_rate_chaos_is_lossless(self, slot_eng, slot_baseline):
        inj = FaultInjector(seed=11, rates={"device_step": 0.05,
                                            "prefill": 0.05})
        out, errs, _, _, captures = _chaos_run(slot_eng, inj)
        assert errs == [None] * len(_REQS)
        assert out == slot_baseline
        assert captures == 0

    def test_faults_surface_in_stats(self, slot_eng):
        before = slot_eng.stats()["faults"]["retries"]
        _chaos_run(slot_eng, FaultInjector(plan={"device_step": [1]}))
        f = slot_eng.stats()["faults"]
        assert f["retries"] == before + 1
        assert set(f) == {"retries", "recoveries", "quarantined", "drains"}


class TestChaosPaged:
    def test_transient_chunk_and_alloc_faults(self, paged_eng,
                                              paged_baseline):
        inj = FaultInjector(plan={"prefill": [2, 6], "alloc": [2],
                                  "device_step": [4]})
        out, errs, retries, recoveries, captures = _chaos_run(paged_eng,
                                                              inj)
        assert errs == [None] * len(_REQS)
        assert out == paged_baseline
        assert (retries, recoveries, captures) == (4, 0, 0)

    def test_corrupting_faults_recover_and_reclaim_blocks(
            self, paged_eng, paged_baseline):
        inj = FaultInjector(plan={"device_step": [4], "prefill": [2, 9]},
                            corrupting=("device_step", "prefill"))
        out, errs, retries, recoveries, captures = _chaos_run(paged_eng,
                                                              inj)
        assert errs == [None] * len(_REQS)   # zero requests lost
        assert out == paged_baseline         # token-identical
        assert (retries, recoveries, captures) == (0, 3, 0)
        # the only live blocks left are prefix-index pins registered
        # after the last recovery; releasing them reclaims the pool
        paged_eng.clear_prefix_cache()
        assert paged_eng._allocator.free_count == \
            paged_eng._allocator.capacity

    def test_mid_prefill_requests_survive_recovery(self, paged_eng,
                                                   paged_baseline):
        # prefill seam call #3 lands in the chunk ladder while other
        # lanes decode; whoever holds a slot restarts cleanly
        inj = FaultInjector(plan={"prefill": [3]}, corrupting=("prefill",))
        out, errs, retries, recoveries, captures = _chaos_run(paged_eng,
                                                              inj)
        assert errs == [None] * len(_REQS)
        assert out == paged_baseline
        assert (retries, recoveries, captures) == (0, 1, 0)


class _NaNDraftLM(CausalTransformerLM):
    """Draft-side NaN rig: the prime (a prefill) is clean, so lanes
    become eligible, but every draft decode step's logits are NaN, so
    each round's per-lane guard trips. The target is untouched: the
    engine plain-decodes the tripped lanes and fails no request."""

    def forward_decode(self, *args, **kw):
        logits, kcs, vcs = super().forward_decode(*args, **kw)
        return torch.full_like(logits, float("nan")), kcs, vcs


def _draft_storage(eng):
    return [c.data_ptr() for c in eng._draft_cache.ks + eng._draft_cache.vs]


@pytest.fixture(scope="module")
def spec_eng(jlm, lm):
    """A warmed speculating slot engine (k=2) whose draft is a copy of
    the target, so rounds accept, shared by the speculative chaos
    cases."""
    draft = CausalTransformerLM(**CFG, seed=0, device="cpu").load_params(
        jax.tree.map(np.asarray, jlm._params))
    eng = _engine(lm, "slots", speculation_k=2, draft_model=draft)
    yield eng
    eng.stop()


@pytest.fixture(scope="module")
def spec_baseline(spec_eng, slot_baseline):
    """Fault-free speculating outputs: the k=0 outputs (the identity
    contract)."""
    out, errs = _run_all(spec_eng)
    assert errs == [None] * len(_REQS)
    assert out == slot_baseline
    assert spec_eng.stats()["spec"]["draft_tokens_accepted"] > 0
    return out


def _spec_chaos_run(eng, inj):
    """:func:`_chaos_run` that also holds the draft cache to its
    storage: recovery and draft faults zero it in place."""
    where = _draft_storage(eng)
    res = _chaos_run(eng, inj)
    assert _draft_storage(eng) == where
    return res


class TestChaosSpeculative:
    """The JAX ``TestChaosSpeculative`` cases: draft-side trouble (NaN
    logits, a failed or corrupting draft call) costs speculation only,
    a transient verify fault is retried, a corrupting one recovers, and
    every request replays token-identical with no capture and the draft
    cache on its storage."""

    def test_draft_nan_falls_back_lane_only(self, lm, slot_baseline):
        eng = _engine(lm, "slots", speculation_k=2, draft_model=_NaNDraftLM(
            **CFG, seed=1, device="cpu").init())
        try:
            where, c0 = _draft_storage(eng), eng.metrics.compiles
            out, errs = _run_all(eng)
            assert errs == [None] * len(_REQS)   # never the request
            assert out == slot_baseline          # the plain-decode result
            sp = eng.stats()["spec"]
            assert sp["draft_fallbacks"] >= 1
            assert sp["draft_tokens_accepted"] == 0
            assert eng.metrics.compiles == c0
            assert _draft_storage(eng) == where
        finally:
            eng.stop()

    def test_transient_verify_fault_retried_token_identical(
            self, spec_eng, spec_baseline):
        out, errs, retries, recoveries, captures = _spec_chaos_run(
            spec_eng, FaultInjector(plan={"verify": [2]}))
        assert errs == [None] * len(_REQS)
        assert out == spec_baseline
        assert (retries, recoveries, captures) == (1, 0, 0)

    def test_corrupting_verify_fault_recovers_token_identical(
            self, spec_eng, spec_baseline):
        # the verify call writes the target's cache: a corrupting fire
        # there recovers every in-flight request
        out, errs, retries, recoveries, captures = _spec_chaos_run(
            spec_eng, FaultInjector(plan={"verify": [3]},
                                    corrupting=("verify",)))
        assert errs == [None] * len(_REQS)
        assert out == spec_baseline
        assert (retries, recoveries, captures) == (0, 1, 0)

    def test_corrupting_draft_fault_costs_speculation_only(
            self, spec_eng, spec_baseline):
        # the draft call writes only the draft's own cache: even a
        # corrupting fire there degrades to plain decode, with no retry
        # and no recovery
        f0 = spec_eng.stats()["spec"]["draft_fallbacks"]
        out, errs, retries, recoveries, captures = _spec_chaos_run(
            spec_eng, FaultInjector(plan={"draft": [1, 2]},
                                    corrupting=("draft",)))
        assert errs == [None] * len(_REQS)
        assert out == spec_baseline
        assert (retries, recoveries, captures) == (0, 0, 0)
        assert spec_eng.stats()["spec"]["draft_fallbacks"] > f0


def _storage(eng):
    """The address of every cache tensor, int8 scale rows included."""
    out = []
    for pool in eng._kcs + eng._vcs:
        if is_quantized(pool):
            out += [pool.q.data_ptr(), pool.scale.data_ptr()]
        else:
            out.append(pool.data_ptr())
    return out


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_int8_corrupting_recovery_keeps_the_cache_storage(lm, backend):
    """Corrupting faults on an int8 cache (values and scale rows) recover
    token-identical, on the same tensors: recovery zeroes them in place,
    never reallocates."""
    eng = _engine(lm, backend, kv_dtype="int8")
    try:
        assert is_quantized(eng._kcs[0])
        base, errs = _run_all(eng)
        assert errs == [None] * len(_REQS)
        where = _storage(eng)
        inj = FaultInjector(plan={"device_step": [4], "prefill": [2]},
                            corrupting=("device_step", "prefill"))
        out, errs, retries, recoveries, captures = _chaos_run(eng, inj)
        assert errs == [None] * len(_REQS)
        assert out == base
        assert (retries, recoveries, captures) == (0, 2, 0)
        assert _storage(eng) == where
        assert eng._kcs is eng._cache.ks and eng._vcs is eng._cache.vs
    finally:
        eng.stop()


#: one plan for both packages: transient prefill (and alloc) faults and
#: two corrupting decode steps
SAME_PLAN = dict(plan={"device_step": [3, 8], "prefill": [2, 5],
                       "alloc": [3]},
                 corrupting=("device_step",))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_same_plan_as_the_jax_engine(jlm, lm, backend):
    """The same injector plan through the JAX engine and the port's:
    the same tokens (those of the fault-free run) and the same
    retries/recoveries."""
    kw = dict(FAST_RETRY, **BACKENDS[backend])
    je = JaxEngine(jlm, **kw)
    te = GenerationEngine(lm, **kw)
    try:
        je.warmup()
        te.warmup()
        want, errs = _run_all(je)
        assert errs == [None] * len(_REQS)
        jout, jerrs, jr, jv, _ = _chaos_run(je, JaxInjector(**SAME_PLAN))
        tout, terrs, tr, tv, captures = _chaos_run(
            te, FaultInjector(**SAME_PLAN))
        assert jerrs == [None] * len(_REQS) and terrs == jerrs
        assert jout == want and tout == want
        assert (tr, tv) == (jr, jv) == ((3 if backend == "paged" else 2), 2)
        assert captures == 0
    finally:
        je.stop()
        te.stop()


class _Jam:
    """Injector stand-in that wedges the scheduler at the ``latency``
    seam until released: what a hung device call looks like to the
    watchdog."""

    def __init__(self):
        self.release = threading.Event()

    def fire(self, seam, worker=None):
        if seam == "latency":
            self.release.wait(10.0)
        return False


def test_alive_flags_a_wedged_loop(lm):
    eng = GenerationEngine(lm, num_slots=2, min_prompt_bucket=4,
                           stall_timeout_s=0.5)
    jam = _Jam()
    try:
        # an idle engine parks for at most stall_timeout_s / 4 at a time,
        # so it never looks wedged
        t_end = time.monotonic() + 1.2
        while time.monotonic() < t_end:
            assert eng.alive()
            time.sleep(0.05)
        eng.set_fault_injector(jam)
        time.sleep(1.2)   # one park (0.125 s), then past the 0.5 s watchdog
        assert not eng.alive()
        jam.release.set()  # unwedged: the heartbeat resumes
        time.sleep(0.3)
        assert eng.alive()
        eng.set_fault_injector(None)
        assert len(eng.generate([1, 2], max_tokens=3)["tokens"]) == 3
    finally:
        jam.release.set()
        eng.stop()
    assert eng.alive()   # a stopped engine is not wedged


def test_drain_waits_for_requeued_requests(lm):
    """A request re-stashed by a transient prefill fault waits out the
    retry backoff in the re-admission deque: drain() must count it, not
    stop the engine under it."""
    eng = GenerationEngine(lm, num_slots=2, min_prompt_bucket=4,
                           retry_backoff_ms=400.0,
                           retry_backoff_max_ms=400.0)
    try:
        want = eng.generate([3, 1, 4], max_tokens=5)["tokens"]
        eng.set_fault_injector(FaultInjector(plan={"prefill": [1]}))
        got = {}
        t = threading.Thread(target=lambda: got.update(
            eng.generate([3, 1, 4], max_tokens=5)))
        t.start()
        t_end = time.monotonic() + 5.0
        while not eng._requeue and time.monotonic() < t_end:
            time.sleep(0.002)
        assert eng._requeue and not eng.draining
        assert eng.drain(timeout_s=10.0)
        assert eng.draining
        t.join(timeout=10)
        assert not t.is_alive()
        assert got["tokens"] == want
        assert eng.metrics.retries == 1 and eng.metrics.drains == 1
    finally:
        eng.stop()


def test_poison_when_recovery_raises(lm):
    """A recovery that raises poisons: every in-flight request fails
    with ServingError, the cache is reset in place, and the engine
    serves on with unchanged tokens."""
    eng = _engine(lm, "paged")
    try:
        base, _ = _run_all(eng)
        where = _storage(eng)
        cache = eng._cache
        real_reset, calls = cache.reset, []

        def reset_once():
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("reset failed")
            real_reset()

        cache.reset = reset_once
        inj = FaultInjector(plan={"device_step": [3]},
                            corrupting=("device_step",))
        out, errs, _, recoveries, _ = _chaos_run(eng, inj)
        del cache.reset
        failed = [e for e in errs if e is not None]
        assert failed and all(isinstance(e, ServingError)
                              and "reset failed" in str(e) for e in failed)
        assert all(o == b for o, b in zip(out, base) if o is not None)
        assert recoveries == 1 and len(calls) == 2
        assert _storage(eng) == where
        assert eng._slots.active_count == 0 and not eng._prefilling
        eng.clear_prefix_cache()
        assert eng._allocator.free_count == eng._allocator.capacity
        again, errs = _run_all(eng)
        assert errs == [None] * len(_REQS) and again == base
    finally:
        eng.stop()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_reset_that_keeps_failing_ends_the_scheduler(lm):
    """A sticky device error makes recovery and poison both raise; the
    second raise is left unguarded, as in the JAX engine: the scheduler
    thread ends, and alive() says so."""
    eng = _engine(lm, "slots")
    try:
        def broken():
            raise RuntimeError("CUDA error: an illegal memory access")

        eng._cache.reset = broken
        eng.set_fault_injector(FaultInjector(plan={"device_step": [1]},
                                             corrupting=("device_step",)))
        with pytest.raises(ServingError, match="illegal memory access"):
            eng.generate([1, 2, 3], max_tokens=4, timeout_ms=10_000)
        eng._thread.join(timeout=10)
        assert not eng._thread.is_alive()
        assert not eng.alive()
    finally:
        eng.stop()


def test_decode_impl_at_the_jax_position(jlm, lm):
    """``decode_impl`` is the 7th parameter after the model in both
    engines: the same positional arguments up to ``kv_dtype`` build
    engines that agree attribute by attribute; a name other than
    "auto" raises."""
    jp = list(inspect.signature(JaxEngine.__init__).parameters.items())
    tp = list(inspect.signature(GenerationEngine.__init__).parameters.items())
    assert [(n, p.default) for n, p in tp] == \
        [(n, p.default) for n, p in jp]
    names = [n for n, _ in tp]
    assert names.index("decode_impl") == 8   # self, model, then 7th
    args = (2, 32, [8, 16], 4, 10, 5000.0, "auto", "paged", 8, 9, 8, True,
            7, 5, None, None, 2, 0.5, 4.0, 1, 9.0, 0.25, 0, None, False,
            "int8")
    assert names[2:2 + len(args)][-1] == "kv_dtype"
    je = JaxEngine(jlm, *args)
    te = GenerationEngine(lm, *args)
    try:
        for attr in ("num_slots", "max_seq_len", "prompt_buckets",
                     "min_prompt_bucket", "default_timeout_ms",
                     "decode_impl", "cache_backend", "block_size",
                     "num_blocks", "prefill_chunk_tokens", "chunk_buckets",
                     "enable_prefix_sharing", "_faults", "_max_step_retries",
                     "_retry_backoff_s", "_retry_backoff_max_s",
                     "_max_recoveries", "_stall_timeout_s",
                     "batch_queue_fraction", "_batch_queue_limit",
                     "decode_pipeline", "kv_dtype"):
            assert getattr(te, attr) == getattr(je, attr), attr
        assert te._prefix_index.capacity == je._prefix_index.capacity == 7
        assert te._sessions.capacity == je._sessions.capacity == 5
        assert te.metrics.queue_max == je.metrics.queue_max == 10
    finally:
        je.stop()
        te.stop()
    for bad in ("pallas", "xla", "nope"):
        with pytest.raises(ValueError, match="decode_impl"):
            GenerationEngine(lm, decode_impl=bad)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("d", [1e-3, 5e-3, 2e-2])
def test_sampled_near_tie_gap_bounds_the_change(d):
    """chip_smoke.py's phase 11 accepts a sampled lane that differs from
    its fault-free run only as a near-tie: ``sample_gap`` must be 0 for
    the sampler's own pick and at most 2 d whenever a change of the
    logits by at most d (random, top-k members swapped included) flips
    the pick, as a greedy gap is."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(0)
    flips = 0
    for _ in range(60):
        r = torch.randn(2000, generator=g, dtype=torch.float64) * 0.3
        u = float(torch.rand(1, generator=g))
        e = (torch.rand(2000, generator=g, dtype=torch.float64) * 2 - 1) * d
        a, b = cs._pick(r, 0.8, 40, u), cs._pick(r + e, 0.8, 40, u)
        assert cs.sample_gap(r, 0.8, 40, u, a, a) == 0.0
        if a != b:
            flips += 1
            assert cs.sample_gap(r, 0.8, 40, u, a, b) <= 2 * d
    assert flips
