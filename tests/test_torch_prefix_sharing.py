"""Prefix sharing and sessions on the port's paged engine (CPU), the
engine tests of ``tests/test_prefix_sharing.py`` held to the uncached
greedy oracle and, for sessions and duplicate prompts, to the JAX paged
engine on the same weights: identical prompts share and copy on write,
a shared prefix costs fewer blocks (with the overlap of the two
requests made deterministic), a divergent suffix matches only the
common chain, turn 2 of a session prefills only its tail, eviction
reclaims every block, session misuse is rejected, and a quarantined
request leaves the shared blocks bit-unchanged."""
import contextlib
import threading

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.zoo.transformer_lm import CausalTransformerLM as JaxLM
from deeplearning4j_tpu_torch.faults import PoisonRequestError
from deeplearning4j_tpu_torch.serving import ClientError, GenerationEngine
from deeplearning4j_tpu_torch.zoo.transformer_lm import CausalTransformerLM

from test_torch_paged_generation import NAN_TRIGGER, PoisonLM

VOCAB = 64
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4,
           max_seq_len=32)
OPTS = dict(num_slots=3, max_queue=64, min_prompt_bucket=4, cache="paged",
            block_size=8, prefill_chunk_tokens=8)

# a 16-token prompt = exactly two full 8-token blocks, so both blocks
# land in the prefix index when it completes
P16 = [1, 5, 2, 9, 3, 7, 4, 6, 8, 10, 1, 5, 2, 9, 3, 7]


@pytest.fixture(scope="module")
def jlm():
    return JaxLM(**CFG, seed=0, implementation="plain").init()


def port_lm(jlm, cls=CausalTransformerLM):
    return cls(**CFG, seed=0, device="cpu").load_params(
        jax.tree.map(np.asarray, jlm._params))


@pytest.fixture(scope="module")
def lm(jlm):
    return port_lm(jlm)


@pytest.fixture(scope="module")
def jeng(jlm):
    eng = JaxEngine(jlm, **OPTS)
    eng.warmup()
    yield eng
    eng.stop()


def mkeng(lm, sharing=True, **kw):
    eng = GenerationEngine(lm, **dict(OPTS, enable_prefix_sharing=sharing,
                                      **kw))
    eng.warmup()
    return eng


def ref_greedy(lm, prompt, n):
    """Uncached full-prefix greedy decode: the oracle every shared,
    copied or session-resumed path reproduces."""
    toks = list(prompt)
    for _ in range(n):
        toks.append(int(lm.logits(np.asarray(toks)[None])[0, -1].argmax()))
    return toks[len(prompt):]


@contextlib.contextmanager
def paused(eng):
    """Hold the scheduler inside a job: requests submitted meanwhile are
    all admitted in its next iteration, so they hold blocks together."""
    started, release = threading.Event(), threading.Event()

    def job():
        started.set()
        release.wait(30)
    eng._jobs.append(job)
    eng._wake.set()
    assert started.wait(30)
    try:
        yield
    finally:
        release.set()


def test_identical_prompts_share_and_match_oracle_and_jax(lm, jeng):
    eng = mkeng(lm)
    try:
        want = ref_greedy(lm, P16, 6)
        r1 = eng.generate(P16, max_tokens=6)
        hits0 = eng.metrics.prefix_hits
        r2 = eng.generate(P16, max_tokens=6)
        assert r1["tokens"] == r2["tokens"] == want
        assert jeng.generate(P16, max_tokens=6)["tokens"] == want
        assert eng.metrics.prefix_hits == hits0 + 1
        assert eng.metrics.prefix_tokens_matched == 15
        # an exact-duplicate prompt copies its final matched block (the
        # L-1 cap) rather than writing into a shared one
        assert eng.metrics.cow_copies == 1
        assert eng.metrics.prefill_tokens == 16 + 1
    finally:
        eng.stop()


def test_shared_prefix_uses_fewer_blocks(lm):
    """A 20-token request registers its two full blocks; two more with
    the same 16-token prefix are admitted together (the scheduler is
    held while both are submitted). Sharing keeps the prefix resident
    once: 2 + 1 + 1 blocks at the peak against 3 + 3 without."""
    p_a = P16 + [11, 12, 13, 14]
    p_b = P16 + [21, 22, 23, 24]
    p_c = P16 + [31, 32, 33, 34]
    peaks, outs = {}, {}
    for sharing in (True, False):
        eng = mkeng(lm, sharing=sharing)
        try:
            eng.generate(p_a, max_tokens=4)
            with paused(eng):
                s_b = eng.stream(p_b, max_tokens=4)
                s_c = eng.stream(p_c, max_tokens=4)
            outs[sharing] = [c["token"] for c in s_b if "token" in c]
            list(s_c)
            peaks[sharing] = eng.metrics.blocks_peak_used
        finally:
            eng.stop()
    assert outs[True] == outs[False] == ref_greedy(lm, p_b, 4)
    assert peaks == {True: 4, False: 6}


def test_cow_on_divergent_suffix_matches_oracle(lm):
    """B shares A's first block and diverges inside the second: only
    the common chain is matched, and B's tokens are the oracle's."""
    p_b = P16[:12] + [30, 31, 32, 33]
    eng = mkeng(lm)
    try:
        eng.generate(P16, max_tokens=4)
        r = eng.generate(p_b, max_tokens=4)
        assert r["tokens"] == ref_greedy(lm, p_b, 4)
        # only block 0's chain matched (block 1's digest diverged)
        assert eng.metrics.prefix_tokens_matched == 8
        assert eng.metrics.prefix_hits == 1
    finally:
        eng.stop()


def test_stats_and_gauges_surface(lm):
    eng = mkeng(lm)
    try:
        eng.generate(P16, max_tokens=4)
        eng.generate(P16, max_tokens=4)
        p = eng.stats()["paged"]
        pc = p["prefix_cache"]
        assert pc["enabled"] is True
        assert pc["prefix_hits"] >= 1
        assert pc["prefix_blocks"] == 2          # P16 = 2 blocks
        assert pc["cow_copies"] >= 1
        assert 0.0 <= p["fragmentation"] <= 1.0
        assert eng.clear_prefix_cache() == 2
        assert eng.stats()["paged"]["prefix_cache"]["prefix_blocks"] == 0
        assert eng._allocator.free_count == eng._allocator.capacity
    finally:
        eng.stop()


def test_quarantined_nan_leaves_shared_blocks_bit_unchanged(jlm):
    """A poisoned request that shares a healthy prefix writes its NaN
    K/V only into its own (fresh or copied) blocks: the shared blocks'
    pool rows are bitwise the same before and after, and a healthy
    re-reader's tokens do not move."""
    eng = mkeng(port_lm(jlm, PoisonLM))
    try:
        base = eng.generate(P16, max_tokens=4)["tokens"]
        shared = sorted(eng._prefix_index.blocks())
        assert shared
        before = [p[shared].clone() for p in eng._kcs + eng._vcs]
        with pytest.raises(PoisonRequestError):
            eng.generate(P16 + [NAN_TRIGGER], max_tokens=4)
        assert eng.metrics.quarantined == 1
        assert eng.metrics.prefix_hits == 1
        for b, pool in zip(before, eng._kcs + eng._vcs):
            assert torch.equal(b, pool[shared])
        assert eng.generate(P16, max_tokens=4)["tokens"] == base
    finally:
        eng.stop()


def test_session_turn2_prefills_only_the_tail_and_matches_jax(lm, jeng):
    eng = mkeng(lm)
    try:
        r1 = eng.generate(P16, max_tokens=5, session_id="alice")
        j1 = jeng.generate(P16, max_tokens=5, session_id="alice")
        assert r1["tokens"] == j1["tokens"] == ref_greedy(lm, P16, 5)
        assert eng.metrics.sessions_live == 1
        turn2 = P16 + r1["tokens"] + [12, 13, 14]
        hits0 = eng.metrics.session_hits
        pf0 = eng.metrics.prefill_tokens
        cow0 = eng.metrics.cow_copies
        r2 = eng.generate(turn2, max_tokens=4, session_id="alice")
        j2 = jeng.generate(turn2, max_tokens=4, session_id="alice")
        assert r2["tokens"] == j2["tokens"] == ref_greedy(lm, turn2, 4)
        assert eng.metrics.session_hits == hits0 + 1
        # the session pinned prompt + tokens[:-1] = 20 of the 24 turn-2
        # tokens: only the 4-token tail is prefilled, and the match ends
        # mid-block (20 % 8), so that block is copied on write
        assert eng.metrics.prefill_tokens - pf0 == 4
        assert eng.metrics.cow_copies == cow0 + 1
    finally:
        eng.stop()


def test_session_eviction_reclaims_every_block(lm):
    eng = mkeng(lm, session_capacity=2)
    try:
        for i, sid in enumerate(("a", "b", "c")):
            eng.generate([1 + i] * 9, max_tokens=4, session_id=sid)
        # capacity 2: "a" was displaced at "c"'s pin
        assert eng.metrics.sessions_live == 2
        assert eng.metrics.session_evictions == 1
        assert eng.evict_sessions() == 2
        assert eng.metrics.sessions_live == 0
        eng.clear_prefix_cache()
        assert eng._allocator.free_count == eng._allocator.capacity
    finally:
        eng.stop()


def test_session_requires_paged_sharing(lm):
    slots = GenerationEngine(lm, num_slots=2, max_queue=8,
                             min_prompt_bucket=4)
    try:
        with pytest.raises(ClientError, match="paged"):
            slots.generate([1, 2], max_tokens=2, session_id="x")
    finally:
        slots.stop()
    off = mkeng(lm, sharing=False)
    try:
        with pytest.raises(ClientError, match="prefix sharing"):
            off.generate([1, 2], max_tokens=2, session_id="x")
    finally:
        off.stop()


@pytest.mark.parametrize("sid", ["", "s" * 300, 7])
def test_session_id_validation(lm, sid):
    eng = mkeng(lm)
    try:
        with pytest.raises(ClientError, match="session_id"):
            eng.generate([1, 2], max_tokens=2, session_id=sid)
        assert eng.metrics.requests == 0
    finally:
        eng.stop()
