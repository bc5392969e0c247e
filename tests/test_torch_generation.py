"""The port's GenerationEngine (slot backend) against the JAX
GenerationEngine on the same weights (CPU): a mixed concurrent
workload with slot reuse and EOS/max_tokens retirement gives identical
tokens, greedy and sampled; 503/504 shedding; per-lane NaN quarantine;
a failing device call goes through the JAX engine's fault ladder;
unported options raise."""
import threading

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.zoo.transformer_lm import CausalTransformerLM as JaxLM
from deeplearning4j_tpu_torch.faults import PoisonRequestError
from deeplearning4j_tpu_torch.serving import (ClientError,
                                              DeadlineExceededError,
                                              DrainingError,
                                              GenerationEngine,
                                              QueueFullError)
from deeplearning4j_tpu_torch.zoo.transformer_lm import CausalTransformerLM

from _torch_fault_rig import Rig, RigLM, gated_streams, jax_engine

VOCAB = 64
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4,
           max_seq_len=32)
ENGINE = dict(num_slots=4, max_queue=64, min_prompt_bucket=4)

# more requests than slots; mixed prompt and generation lengths; greedy
# and temperature/top-k lanes side by side
WORKLOAD = [dict(prompt=np.random.RandomState(i).randint(
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


@pytest.fixture(scope="module")
def engines(jlm):
    je = JaxEngine(jlm, **ENGINE)
    je.warmup()
    te = GenerationEngine(_port_lm(jlm), **ENGINE)
    te.warmup()
    yield je, te
    je.stop()
    te.stop()


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


def test_mixed_workload_identical_to_jax(engines):
    je, te = engines
    want, jerr = _run_all(je, WORKLOAD)
    got, terr = _run_all(te, WORKLOAD)
    assert jerr == [None] * len(WORKLOAD) and terr == jerr
    assert got == want
    assert te._slots.free_count == te.num_slots
    occ = te.metrics.occupancy_hist.snapshot()
    assert any(int(k) > 1 for k in occ), occ   # steps batched lanes


def test_eos_retirement_identical_to_jax(engines):
    je, te = engines
    probe = je.generate(**WORKLOAD[0])["tokens"]
    reqs = [dict(WORKLOAD[i], eos_id=probe[1]) for i in (0, 3, 6)]
    want, _ = _run_all(je, reqs)
    got, terr = _run_all(te, reqs)
    assert terr == [None] * 3
    assert got == want
    assert got[0]["finish_reason"] == "eos"
    assert got[0]["tokens"] == probe[:2]


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.7, 0),
                                               (1.3, 4), (0.9, 128)])
def test_single_requests_identical(engines, temperature, top_k):
    je, te = engines
    kw = dict(prompt=[3, 1, 4, 1, 5], max_tokens=12,
              temperature=temperature, top_k=top_k, seed=7)
    assert te.generate(**kw) == je.generate(**kw)


def test_stream_matches_blocking(engines):
    _, te = engines
    kw = dict(max_tokens=6, temperature=0.7, top_k=4, seed=11)
    blocking = te.generate([3, 4], **kw)
    chunks = list(te.stream([3, 4], **kw))
    assert [c["token"] for c in chunks if "token" in c] == \
        blocking["tokens"]
    assert chunks[-1]["done"] is True
    assert chunks[-1]["finish_reason"] == blocking["finish_reason"]


def test_client_errors(engines):
    _, te = engines
    for bad in (dict(prompt=[]), dict(prompt=[1, 999]),
                dict(prompt=[[1, 2]]), dict(prompt=list(range(1, 33))),
                dict(prompt=[1], max_tokens=0),
                dict(prompt=[1.5, 2.0]),
                dict(prompt=[1], session_id="s")):
        with pytest.raises(ClientError):
            te.generate(**bad)


def test_queue_full_is_503_and_counted(jlm):
    eng = GenerationEngine(_port_lm(jlm), num_slots=1, max_queue=1,
                           min_prompt_bucket=4)
    eng.warmup([4])
    shed = []

    def client(i):
        try:
            eng.generate([1 + i % 8], max_tokens=24)
        except QueueFullError:
            shed.append(i)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    eng.stop()
    assert shed and eng.metrics.shed >= len(shed)


def test_deadline_is_504_and_counted(engines):
    _, te = engines
    before = te.metrics.timeouts
    with pytest.raises(DeadlineExceededError):
        te.generate([1, 2], max_tokens=4, timeout_ms=0)
    assert te.metrics.timeouts > before


def test_drain_rejects_new_work(jlm):
    eng = GenerationEngine(_port_lm(jlm), num_slots=2, min_prompt_bucket=4)
    assert eng.drain(timeout_s=5.0)
    with pytest.raises(DrainingError):
        eng.generate([1, 2], max_tokens=2)


TRIGGER = VOCAB - 2      # prompt token: first sample forced to POISON
POISON = VOCAB - 1       # decoding it gives NaN logits
NAN_TRIGGER = VOCAB - 3  # prompt token: NaN prefill logits and K/V


class _PoisonLM(CausalTransformerLM):
    """NaN rig, as the JAX fault-tolerance tests build it: TRIGGER in a
    prompt makes the request go non-finite mid-decode (with healthy
    batchmates in the same step); NAN_TRIGGER poisons its prefill,
    leaving NaN K/V in the slot it vacates. POISON is suppressed
    everywhere else so no clean request samples it."""

    def forward_prefill(self, params, tokens, key_mask=None):
        logits, ks, vs = super().forward_prefill(params, tokens, key_mask)
        logits = logits.clone()
        logits[..., POISON] = -50.0
        trig = (tokens == TRIGGER).any(dim=-1)
        logits[trig] = -50.0
        logits[trig, :, POISON] = 50.0
        bad = (tokens == NAN_TRIGGER).any(dim=-1)
        logits[bad] = float("nan")
        ks = [torch.where(bad[:, None, None, None], float("nan"), k)
              for k in ks]
        vs = [torch.where(bad[:, None, None, None], float("nan"), v)
              for v in vs]
        return logits, ks, vs

    def forward_decode(self, params, tokens, pos, k_caches, v_caches):
        logits, kcs, vcs = super().forward_decode(params, tokens, pos,
                                                  k_caches, v_caches)
        logits = logits.clone()
        logits[:, POISON] = -50.0
        logits[tokens == POISON] = float("nan")
        return logits, kcs, vcs


@pytest.fixture(scope="module")
def poison_engine(jlm):
    eng = GenerationEngine(_port_lm(jlm, _PoisonLM), num_slots=3,
                           max_queue=64, min_prompt_bucket=4)
    eng.warmup()
    yield eng
    eng.stop()


CLEAN = WORKLOAD[:3]


def test_decode_poison_quarantines_one_lane(poison_engine):
    eng = poison_engine
    base, errs = _run_all(eng, CLEAN)
    assert errs == [None] * 3
    q0 = eng.metrics.quarantined
    out, errs = _run_all(eng, CLEAN + [dict(prompt=[1, TRIGGER],
                                            max_tokens=8)])
    assert isinstance(errs[3], PoisonRequestError)
    assert "quarantined" in str(errs[3])
    assert errs[:3] == [None] * 3
    assert out[:3] == base                 # batchmates unchanged
    assert eng.metrics.quarantined == q0 + 1
    assert eng._slots.free_count == eng.num_slots


def test_prefill_poison_and_clean_slot_reuse(poison_engine):
    """NaN K/V left across a whole prefill slab: the freed slots are
    reused without zeroing, so successors stay clean only because
    attention masks V (not just p) past the live length."""
    eng = poison_engine
    base, _ = _run_all(eng, CLEAN)
    nan_prompt = [NAN_TRIGGER] + list(range(1, 17))
    _, errs = _run_all(eng, [dict(prompt=nan_prompt, max_tokens=4)] * 3)
    assert all(isinstance(e, PoisonRequestError) for e in errs)
    out, errs = _run_all(eng, CLEAN)
    assert errs == [None] * 3 and out == base


def test_device_error_fails_in_flight_requests_with_it(jlm):
    """Held to the JAX engine's fault ladder on the same rig (its decode
    device call raising as a failed kernel launch would): a one-shot
    failure recovers every in-flight request token-identical; a
    persistent one fails each with ServingError after
    max_recoveries_per_request recoveries; then the engine serves on."""
    rig = Rig()
    lm = _port_lm(jlm, RigLM)
    lm.rig = rig
    reqs = [dict(prompt=[1, 2], max_tokens=5, temperature=0.8, top_k=8,
                 seed=1),
            dict(prompt=[3], max_tokens=5)]
    outcomes = []
    for eng in (jax_engine(jlm, rig, num_slots=2, min_prompt_bucket=4),
                GenerationEngine(lm, num_slots=2, min_prompt_bucket=4)):
        try:
            eng.warmup()
            rig.arm()
            want = gated_streams(eng, reqs)
            rig.arm(decode={3})
            once = gated_streams(eng, reqs)
            r1 = eng.metrics.recoveries
            rig.arm(decode="always")
            always = gated_streams(eng, reqs)
            r2 = eng.metrics.recoveries
            rig.arm()
            after = eng.generate([1, 2], max_tokens=3)["tokens"]
            outcomes.append((want, once, r1, always, r2, after,
                             eng.stats()["faults"]))
            assert eng._slots.free_count == eng.num_slots
        finally:
            eng.stop()
    jax_out, port_out = outcomes
    assert port_out == jax_out
    want, once, r1, always, r2, _, faults = port_out
    assert once == want and r1 == 1
    assert all(o[1] == "ServingError" and "3 recovery attempts" in o[2]
               and "CUDA error 700" in o[2] for o in always), always
    assert r2 == 1 + 4   # three re-admissions, then the fourth fails both
    assert set(faults) == {"retries", "recoveries", "quarantined", "drains"}


@pytest.mark.parametrize("kw", [dict(speculation_k=2, cache="paged"),
                                dict(speculation_k=2),
                                dict(offload_host_bytes=1 << 20),
                                dict(offload_disk_bytes=1 << 20),
                                dict(offload_dir="/tmp/x"),
                                dict(offload_prefetch=False)])
def test_unported_options_raise(jlm, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GenerationEngine(_port_lm(jlm), **kw)


#: the JAX engine's defaults for the fault ladder's knobs and for the
#: offload knobs the port accepts but does not implement (ROADMAP.md
#: queue A, item 8)
JAX_DEFAULT_KNOBS = dict(max_step_retries=3, retry_backoff_ms=1.0,
                         retry_backoff_max_ms=50.0,
                         max_recoveries_per_request=3,
                         stall_timeout_s=30.0, offload_disk_bytes=0,
                         offload_dir=None, offload_prefetch=True)


@pytest.mark.parametrize("kw,item", [
    (dict(offload_disk_bytes=1 << 20), "8"),
    (dict(offload_prefetch=False), "8")])
def test_unported_knobs_name_their_item(jlm, kw, item):
    with pytest.raises(NotImplementedError, match=f"item {item}\\)"):
        GenerationEngine(_port_lm(jlm), **kw)


def test_unported_knobs_accepted_at_jax_defaults(engines, jlm):
    _, te = engines
    eng = GenerationEngine(_port_lm(jlm), **ENGINE, **JAX_DEFAULT_KNOBS)
    try:
        eng.warmup()
        kw = dict(prompt=[3, 1, 4, 1, 5], max_tokens=8)
        assert eng.generate(**kw)["tokens"] == te.generate(**kw)["tokens"]
    finally:
        eng.stop()


def test_stats_surface(engines):
    _, te = engines
    st = te.stats()
    assert st["cache_backend"] == "slots"
    assert st["slots"]["num_slots"] == 4
    assert st["kv_cache_bytes"] == 2 * 2 * 4 * 4 * 32 * 8 * 4
    assert st["tokens_generated"] > 0 and st["decode_steps"] > 0
    assert set(st["ttft_ms"]) == {"count", "mean", "p50", "p90", "p99",
                                  "max"}
