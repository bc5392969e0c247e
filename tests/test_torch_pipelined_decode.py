"""The port's pipelined decode loop (``decode_pipeline``, on by default
as in the JAX engine) on the CPU, where torch runs the same dispatch and
collect bookkeeping synchronously: pipelined and synchronous tokens are
identical on both backends at f32 and int8, greedy and sampled, with
requests one at a time (the JAX ``TestPipelinedDecodeIdentity`` cases)
and all at once, more requests than slots, so lanes retire while a step
is in flight; the port's pipelined tokens equal the JAX engine's
pipelined tokens on the same weights; a failed device call drops the
in-flight steps, so nothing of them is emitted, and recovers as the JAX
engine does; and ``stats()`` carries the JAX engine's
``decode_sync_wait_ms`` and ``compile_cache`` keys."""
import threading
import time

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.zoo.transformer_lm import CausalTransformerLM as JaxLM
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.serving import GenerationEngine
from deeplearning4j_tpu_torch.zoo.transformer_lm import CausalTransformerLM

from _torch_fault_rig import Rig, RigLM, gated_streams, jax_engine

VOCAB = 64
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4,
           max_seq_len=32)
BACKENDS = {"slots": dict(num_slots=4, max_queue=64, min_prompt_bucket=4),
            "paged": dict(num_slots=4, max_queue=64, min_prompt_bucket=4,
                          cache="paged", block_size=4, num_blocks=40,
                          prefill_chunk_tokens=8)}
KV_DTYPES = ("f32", "int8")

#: the JAX TestPipelinedDecodeIdentity cases: (prompt, max_tokens,
#: temperature, top_k, seed), greedy and sampled
CASES = [([1, 2, 3], 6, 0.0, 0, 11), ([4, 5], 8, 0.8, 8, 12),
         ([6], 5, 0.5, 4, 13), ([7, 8, 9, 10], 7, 0.9, 16, 14)]

#: more requests than slots, mixed prompt and generation lengths,
#: greedy and sampled lanes side by side
BURST = [dict(prompt=np.random.RandomState(i).randint(
                  1, VOCAB, 1 + (5 * i) % 19).tolist(),
              max_tokens=3 + (7 * i) % 11,
              temperature=0.0 if i % 3 else 0.9,
              top_k=(0, 8, 0, 5)[i % 4], seed=100 + i)
         for i in range(10)]


@pytest.fixture(scope="module")
def jlm():
    return JaxLM(**CFG, seed=0, implementation="plain").init()


def _port_lm(jlm, cls=CausalTransformerLM):
    return cls(**CFG, seed=0, device="cpu").load_params(
        jax.tree.map(np.asarray, jlm._params))


def _engine(lm, backend, kv_dtype, **kw):
    eng = GenerationEngine(lm, **BACKENDS[backend], kv_dtype=kv_dtype, **kw)
    eng.warmup()
    return eng


def _run_all(eng, reqs):
    """Submit every request at once; returns (results, errors)."""
    results = [None] * len(reqs)
    errors = [None] * len(reqs)

    def go(i):
        try:
            results[i] = eng.generate(timeout_ms=120_000, **reqs[i])
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


def _lane_steps(eng) -> int:
    """Lane-steps the decode steps computed (occupancy summed)."""
    return sum(int(k) * v for k, v in
               eng.metrics.occupancy_hist.snapshot().items())


def test_pipeline_is_the_default(jlm):
    eng = GenerationEngine(_port_lm(jlm), num_slots=2, min_prompt_bucket=4)
    try:
        assert eng.decode_pipeline is True
    finally:
        eng.stop()
    eng = GenerationEngine(_port_lm(jlm), num_slots=2, min_prompt_bucket=4,
                           decode_pipeline=False)
    try:
        assert eng.decode_pipeline is False
    finally:
        eng.stop()


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_one_at_a_time_identical_and_no_capture(jlm, backend, kv_dtype):
    """The JAX A/B identity cases: pipelined and synchronous tokens are
    bit-identical, and nothing is captured after warmup."""
    lm = _port_lm(jlm)
    outs = {}
    for pipeline in (False, True):
        eng = _engine(lm, backend, kv_dtype, decode_pipeline=pipeline)
        before = eng.metrics.compiles
        try:
            outs[pipeline] = [eng.generate(
                p, max_tokens=n, temperature=t, top_k=k, seed=s,
                timeout_ms=60_000)["tokens"] for p, n, t, k, s in CASES]
            assert eng.metrics.compiles == before
        finally:
            eng.stop()
    assert outs[True] == outs[False]
    assert [len(t) for t in outs[True]] == [n for _, n, *_ in CASES]


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_concurrent_load_identical(jlm, backend, kv_dtype):
    """Every request at once, more than the slots: lanes retire while
    the next step is already in flight (the pipelined engine computes
    lane-steps it never emits), slots and blocks are reused behind
    them, and the tokens are the synchronous engine's."""
    lm = _port_lm(jlm)
    runs = {}
    for pipeline in (False, True):
        eng = _engine(lm, backend, kv_dtype, decode_pipeline=pipeline)
        try:
            got, errs = _run_all(eng, BURST)
            assert errs == [None] * len(BURST)
            emitted = sum(len(r["tokens"]) - 1 for r in got)  # decode's
            runs[pipeline] = ([r["tokens"] for r in got], _lane_steps(eng),
                              emitted)
            assert eng._slots.free_count == eng.num_slots
            if backend == "paged":
                eng.clear_prefix_cache()
                assert eng._allocator.free_count == eng._allocator.capacity
        finally:
            eng.stop()
    assert runs[True][0] == runs[False][0]
    _, sync_steps, sync_emitted = runs[False]
    _, piped_steps, piped_emitted = runs[True]
    assert sync_steps == sync_emitted      # every computed token emitted
    assert piped_steps > piped_emitted     # steps ran past retirements


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_pipelined_identical_to_jax_pipelined(jlm, backend, kv_dtype):
    """The pipeline on in both engines, every request at once."""
    je = JaxEngine(jlm, **BACKENDS[backend], kv_dtype=kv_dtype,
                   decode_pipeline=True)
    je.warmup()
    te = _engine(_port_lm(jlm), backend, kv_dtype, decode_pipeline=True)
    try:
        want, jerr = _run_all(je, BURST)
        got, terr = _run_all(te, BURST)
    finally:
        je.stop()
        te.stop()
    assert jerr == [None] * len(BURST) and terr == jerr
    assert [r["tokens"] for r in got] == [r["tokens"] for r in want]
    assert [r["finish_reason"] for r in got] == \
        [r["finish_reason"] for r in want]


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_failed_decode_call_drops_the_pending_step(jlm, backend, pipeline):
    """The 4th decode call raises, as a failed kernel launch would.
    Synchronous: steps 1-3 were each collected. Pipelined: step 3 was in
    flight when step 4's dispatch raised; it is dropped, never emitted,
    and recovery regenerates it at the same PRNG fold. Either way the
    stream sees the tokens of an engine that never failed. A persistent
    failure fails the request with ServingError after
    max_recoveries_per_request recoveries. The JAX engine on the same rig
    gives the same outcomes; then the engine serves on."""
    rig = Rig()
    lm = _port_lm(jlm, RigLM)
    lm.rig = rig
    kw = dict(prompt=[3, 1, 4], max_tokens=12, temperature=0.7, top_k=8,
              seed=5)
    outcomes = []
    for port in (False, True):
        eng = (_engine(lm, backend, "f32", decode_pipeline=pipeline) if port
               else jax_engine(jlm, rig, **BACKENDS[backend],
                               decode_pipeline=pipeline))
        try:
            if not port:
                eng.warmup()
            rig.arm()
            want = eng.generate(**kw)["tokens"]
            if port:
                _wait_collected(eng)
                steps0 = eng.metrics.decode_steps
                synced0 = eng.metrics.decode_sync_wait_ms.snapshot()["count"]
            r0 = eng.metrics.recoveries
            rig.arm(decode={4})
            seen = [c["token"] for c in eng.stream(**kw) if "token" in c]
            r1 = eng.metrics.recoveries
            if port:
                _wait_collected(eng)
                assert not eng._tok_on_dev.any()
                # every dispatched step was collected (synced), except
                # the one in flight at the failure, which was dropped
                steps = eng.metrics.decode_steps - steps0
                synced = (eng.metrics.decode_sync_wait_ms.snapshot()["count"]
                          - synced0)
                assert synced == steps - (1 if pipeline else 0)
            rig.arm(decode="always")
            always = gated_streams(eng, [kw])
            r2 = eng.metrics.recoveries
            rig.arm()
            after = eng.generate(**kw)["tokens"]
            outcomes.append((want, seen, r1 - r0, always, r2 - r1, after))
            assert eng._slots.free_count == eng.num_slots
        finally:
            eng.stop()
    jax_out, port_out = outcomes
    assert port_out == jax_out
    want, seen, once, always, n_always, after = port_out
    assert seen == want == after and once == 1
    assert always[0][1] == "ServingError" and n_always == 4


def _wait_collected(eng, timeout_s=10.0):
    """Until the scheduler has collected its last in-flight step."""
    t_end = time.monotonic() + timeout_s
    while eng._pending and time.monotonic() < t_end:
        time.sleep(0.005)
    assert not eng._pending


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_failed_prefill_with_a_step_in_flight(jlm, backend):
    """A prefill (or chunk) call that raises while another request's step
    is in flight fails only its own request, with its error, as the JAX
    engine attributes it; the request in flight is recovered and
    finishes with its fault-free tokens; nothing leaks."""
    rig = Rig()
    lm = _port_lm(jlm, RigLM)
    lm.rig = rig
    eng = _engine(lm, backend, "f32")
    try:
        want = eng.generate([2, 7], max_tokens=25)["tokens"]
        rig.decode_sleep_s = 0.02   # 25 steps outlast the next submit
        r0 = eng.metrics.recoveries
        stream = eng.stream([2, 7], max_tokens=25)
        first = next(stream)["token"]       # decoding, steps in flight
        rig.arm(**{"chunk" if backend == "paged" else "prefill": {1}})
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            eng.generate([5, 6, 7], max_tokens=4)
        rest = [c["token"] for c in stream if "token" in c]
        assert [first] + rest == want
        assert eng.metrics.recoveries == r0 + 1
        rig.decode_sleep_s = 0.0
        _wait_collected(eng)
        assert not eng._tok_on_dev.any()
        assert eng._slots.free_count == eng.num_slots
        if backend == "paged":
            eng.clear_prefix_cache()
            assert eng._allocator.free_count == eng._allocator.capacity
        assert eng.generate([2, 7], max_tokens=25)["tokens"] == want
    finally:
        eng.stop()


def test_stats_carry_the_jax_pipeline_and_compile_keys(jlm):
    je = JaxEngine(jlm, **BACKENDS["slots"])
    je.warmup()
    te = _engine(_port_lm(jlm), "slots", "f32")
    try:
        kw = dict(prompt=[1, 2, 3], max_tokens=5)
        je.generate(**kw)
        te.generate(**kw)
        _wait_collected(te)
        jst, tst = je.stats(), te.stats()
    finally:
        je.stop()
        te.stop()
    assert set(tst["decode_sync_wait_ms"]) == set(jst["decode_sync_wait_ms"])
    assert tst["decode_sync_wait_ms"]["count"] == tst["decode_steps"] > 0
    assert set(tst["compile_cache"]) == set(jst["compile_cache"])
    assert tst["compile_cache"]["compiles"] == 0   # no CUDA graph on a CPU
    assert tst["compile_cache"]["warmed_buckets"] == \
        jst["compile_cache"]["warmed_buckets"]


def test_replay_launch_accounting():
    """A replayed CUDA graph calls no wrapper: the engine adds the
    launches its capture counted once per replay."""
    before = kernels.launch_counts()
    assert set(before) >= {"decode_attention.launches_int8",
                           "paged_attention.launches",
                           "flash_attention.launches"}
    try:
        kernels.add_launches({"paged_attention.launches_int8": 8,
                              "decode_attention.launches": 2})
        after = kernels.launch_counts()
        assert after["paged_attention.launches_int8"] == \
            before["paged_attention.launches_int8"] + 8
        assert after["decode_attention.launches"] == \
            before["decode_attention.launches"] + 2
        assert {k: v for k, v in after.items()
                if k not in ("paged_attention.launches_int8",
                             "decode_attention.launches")} == \
            {k: v for k, v in before.items()
             if k not in ("paged_attention.launches_int8",
                          "decode_attention.launches")}
    finally:
        kernels.add_launches({"paged_attention.launches_int8": -8,
                              "decode_attention.launches": -2})
    assert kernels.launch_counts() == before
