"""The port's paged backend against the JAX package on the same weights
(CPU): the layer and model paged surfaces within 1e-5, chunked prefill
against full prefill, and the GenerationEngine with ``cache="paged"``:
a 32-request mixed workload (greedy and sampled, with block reuse and
chunked prefill) token-identical to the JAX paged engine and to the
port's slot engine, the same chunk plans, admission that waits for
blocks, up-front rejection, stream drops and failed device calls that
go through the JAX engine's fault ladder and give every block back,
and block reuse over poisoned stale K/V."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.zoo.transformer_lm import CausalTransformerLM as JaxLM
from deeplearning4j_tpu_torch.faults import PoisonRequestError
from deeplearning4j_tpu_torch.kernels import paged_attention as pa
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.serving import (BlockTable, ClientError,
                                              GenerationEngine,
                                              PagedKVCache)
from deeplearning4j_tpu_torch.serving.paging import blocks_for, pow2_bucket
from deeplearning4j_tpu_torch.zoo.transformer_lm import CausalTransformerLM

from _torch_fault_rig import Rig, RigLM, gated_streams, jax_engine
from _torch_threads import one_torch_thread  # noqa: F401,E402

# f32 on both sides: the same math, summed in another order
TOL = 1e-5

VOCAB = 64
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4,
           max_seq_len=32)
PAGED = dict(num_slots=4, max_queue=64, min_prompt_bucket=4, cache="paged",
             block_size=8, prefill_chunk_tokens=8)


@pytest.fixture(scope="module")
def jlm():
    return JaxLM(**CFG, seed=0, implementation="plain").init()


def port_lm(jlm, cls=CausalTransformerLM):
    return cls(**CFG, seed=0, device="cpu").load_params(
        jax.tree.map(np.asarray, jlm._params))


@pytest.fixture(scope="module")
def lm(jlm):
    return port_lm(jlm)


def ref_greedy(lm, prompt, n):
    """Uncached full-prefix greedy decode on the port's model: the
    oracle every paged, shared or session-resumed path reproduces."""
    toks = list(prompt)
    for _ in range(n):
        toks.append(int(lm.logits(np.asarray(toks)[None])[0, -1].argmax()))
    return toks[len(prompt):]


def run_all(eng, reqs, timeout_ms=120_000):
    """Submit every request at once; returns (results, errors)."""
    results = [None] * len(reqs)
    errors = [None] * len(reqs)

    def go(i):
        try:
            results[i] = eng.generate(timeout_ms=timeout_ms, **reqs[i])
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


def wait_until(cond, timeout_s=5.0):
    deadline = time.time() + timeout_s
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


# ---------------------------------------------------------------------------
# layers and model
# ---------------------------------------------------------------------------
def _to_torch(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


@pytest.mark.parametrize("kind", ["attention", "encoder"])
def test_layer_chunked_prefill_and_paged_decode_match_jax(kind):
    T, C, Bs = 8, 16, 4
    if kind == "attention":
        jl = jatt.SelfAttentionLayer(n_heads=4, causal=True,
                                     implementation="plain")
        tl = tatt.SelfAttentionLayer(n_heads=4, causal=True)
    else:
        jl = jatt.TransformerEncoderLayer(n_heads=4, causal=True,
                                          implementation="plain")
        tl = tatt.TransformerEncoderLayer(n_heads=4, causal=True)
    jl.build((T, C))
    tl.build((T, C))
    jp = jl.init_params(jax.random.PRNGKey(0))
    tp = _to_torch(jp)
    x = np.random.RandomState(1).randn(1, T, C).astype(np.float32)
    shape = (6,) + jl.cache_shape(Bs)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    tbl = BlockTable([2, 4, 1], Bs).padded(4)
    for p0 in (0, 2):   # positions 0..3 in two chunks of 2
        jo, jk, jv = jl.apply_prefill_paged(
            jp, x[:, p0:p0 + 2], jk, jv, jnp.asarray(tbl), np.int32(p0),
            np.int32(2))
        to, tk2, tv2 = tl.apply_prefill_paged(
            tp, torch.from_numpy(x[:, p0:p0 + 2]), tk, tv,
            torch.from_numpy(tbl), p0, 2)
        assert tk2 is tk and tv2 is tv      # written in place
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL)
    for t in range(4, T):  # decode positions 4..7 one at a time
        jo, jk, jv = jl.apply_decode_paged(
            jp, x[:, t], jk, jv, jnp.asarray(tbl)[None],
            jnp.array([t], jnp.int32))
        to, _, _ = tl.apply_decode_paged(
            tp, torch.from_numpy(x[:, t]), tk, tv,
            torch.from_numpy(tbl)[None], torch.tensor([t]))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_span_attend_matches_jax(dtype):
    rs = np.random.RandomState(2)
    C, H, T, Dh, p0 = 4, 2, 16, 8, 6
    q = rs.randn(C, H, Dh).astype(np.float32)
    kk = rs.randn(H, T, Dh).astype(np.float32)
    vv = rs.randn(H, T, Dh).astype(np.float32)
    vv[:, p0 + C:] = np.nan         # a previous occupant's stale tail
    gpos = p0 + np.arange(C)
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jatt._span_attend(q, jnp.asarray(kk, jd), jnp.asarray(vv, jd),
                             jnp.asarray(gpos), p0 + C, jnp.float32)
    got = tatt._span_attend(torch.from_numpy(q),
                            torch.from_numpy(kk).to(td),
                            torch.from_numpy(vv).to(td),
                            torch.from_numpy(gpos), p0 + C, torch.float32)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL if dtype == "f32" else 1e-2)


def test_span_attend_int8_pool_is_not_ported():
    """A bare int8 panel (values without their scales) is refused: int8
    pools are QuantArrays (tests/test_torch_int8_attention.py)."""
    kk = torch.zeros((2, 8, 4), dtype=torch.int8)
    with pytest.raises(TypeError, match="QuantArray"):
        tatt._span_attend(torch.zeros((1, 2, 4)), kk, kk,
                          torch.zeros(1, dtype=torch.long), 1,
                          torch.float32)


def test_model_paged_surfaces_match_jax(jlm, lm):
    """forward_prefill_chunk over three chunks (the last one padded past
    the position table, which the clamped lookup covers) and
    forward_decode_paged, against JAX on the same pools and tables."""
    Bs = 8
    rs = np.random.RandomState(0)
    prompt = rs.randint(0, VOCAB, 29).astype(np.int32)
    shapes = lm.cache_shapes(Bs)
    jk = [jnp.zeros((9,) + s) for s in shapes]
    jv = [jnp.zeros((9,) + s) for s in shapes]
    pool = PagedKVCache(shapes, num_blocks=9, device="cpu")
    tbl = BlockTable([3, 1, 5, 7], Bs).padded(8)
    for p0, C in ((0, 16), (16, 8), (24, 16)):
        clen = min(C, 29 - p0)
        ct = np.zeros((1, C), np.int32)
        ct[0, :clen] = prompt[p0:p0 + clen]
        jl_, jk, jv = jlm.forward_prefill_chunk(
            jlm._params, ct, np.int32(p0), np.int32(clen), jk, jv,
            jnp.asarray(tbl))
        tl_, _, _ = lm.forward_prefill_chunk(
            lm._params, torch.from_numpy(ct).long(), p0, clen, pool.ks,
            pool.vs, torch.from_numpy(tbl))
        np.testing.assert_allclose(tl_[:clen].numpy(),
                                   np.asarray(jl_)[:clen], atol=TOL)
    for a, b in zip(pool.ks + pool.vs, jk + jv):
        np.testing.assert_allclose(a.numpy()[[3, 1, 5, 7]],
                                   np.asarray(b)[[3, 1, 5, 7]], atol=TOL)
    tables = np.stack([tbl[:4], np.zeros(4, np.int32)])  # lane 1 inactive
    tok = np.array([5, 0], np.int32)
    pos = np.array([29, 0], np.int32)
    jl_, jk, jv = jlm.forward_decode_paged(jlm._params, tok, pos, jk, jv,
                                           jnp.asarray(tables))
    tl_, _, _ = lm.forward_decode_paged(
        lm._params, torch.from_numpy(tok).long(),
        torch.from_numpy(pos).long(), pool.ks, pool.vs,
        torch.from_numpy(tables))
    np.testing.assert_allclose(tl_[0].numpy(), np.asarray(jl_)[0],
                               atol=TOL)


def test_chunked_prefill_matches_full_prefill(lm):
    rs = np.random.RandomState(3)
    L, Bs, C = 13, 8, 8
    prompt = rs.randint(0, VOCAB, L)
    full = lm.logits(prompt[None])[0, L - 1]
    pool = PagedKVCache(lm.cache_shapes(Bs), num_blocks=8, device="cpu")
    tbl = torch.from_numpy(BlockTable([3, 1, 5], Bs).padded(4))
    with torch.inference_mode():
        for p0 in range(0, L, C):
            clen = min(C, L - p0)
            ct = torch.zeros((1, C), dtype=torch.long)
            ct[0, :clen] = torch.from_numpy(prompt[p0:p0 + clen])
            logits, _, _ = lm.forward_prefill_chunk(
                lm._params, ct, p0, clen, pool.ks, pool.vs, tbl)
    last = logits[clen - 1]
    np.testing.assert_allclose(last.numpy(), full.numpy(), atol=TOL)
    assert int(last.argmax()) == int(full.argmax())


def test_undersized_table_fails_loudly(lm):
    """JAX clamps an out-of-range table index to the last entry (a real
    block); the port raises instead of aliasing live data."""
    pool = PagedKVCache(lm.cache_shapes(8), num_blocks=4, device="cpu")
    with pytest.raises(IndexError):
        lm.forward_prefill_chunk(lm._params,
                                 torch.zeros((1, 16), dtype=torch.long), 0,
                                 16, pool.ks, pool.vs,
                                 torch.tensor([1], dtype=torch.int32))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def _mixed_cases():
    rs = np.random.RandomState(7)
    cases = []
    for i in range(32):
        plen = int(rs.choice([1, 3, 6, 12, 20]))
        n = int(rs.choice([2, 5, 9]))
        cases.append(dict(prompt=rs.randint(0, VOCAB, plen).tolist(),
                          max_tokens=n,
                          temperature=float(rs.choice([0.0, 0.8])),
                          top_k=8, seed=i))
    return cases


@pytest.fixture(scope="module")
def mixed_runs(jlm, lm):
    """The 32-request workload through the JAX paged engine, the port's
    paged engine (a pool that holds ~6 sequences, so blocks recycle)
    and the port's slot engine."""
    cases = _mixed_cases()
    je = JaxEngine(jlm, **dict(PAGED, num_blocks=25))
    je.warmup()
    te = GenerationEngine(lm, **dict(PAGED, num_blocks=25))
    warmed = te.warmup()
    se = GenerationEngine(lm, num_slots=4, max_queue=64, min_prompt_bucket=4)
    se.warmup()
    try:
        out = {name: run_all(eng, cases)
               for name, eng in (("jax", je), ("paged", te), ("slots", se))}
        yield cases, out, te, warmed
    finally:
        for eng in (je, te, se):
            eng.stop()


def test_mixed_workload_identical_to_jax_and_slots(mixed_runs):
    cases, out, te, warmed = mixed_runs
    for name in out:
        assert out[name][1] == [None] * len(cases), name
    assert warmed == te.chunk_buckets == [4, 8]
    for i in range(len(cases)):
        assert out["paged"][0][i] == out["jax"][0][i], i
        assert out["paged"][0][i] == out["slots"][0][i], i
    assert any(c["temperature"] > 0 for c in cases)
    # 32 requests through a pool that holds ~6: blocks were reused
    assert te.metrics.blocks_peak_used <= 24
    assert te.metrics.chunked_prefills >= 1
    occ = te.metrics.occupancy_hist.snapshot()
    assert any(int(k) > 1 for k in occ), occ


def test_pool_reclaimed_after_mixed_workload(mixed_runs):
    _, _, te, _ = mixed_runs
    te.clear_prefix_cache()
    assert te.stats()["paged"]["blocks_free"] == 24
    assert te._allocator.free_count == te._allocator.capacity


def test_chunk_plans_and_ladders_match_jax(jlm, lm):
    for kw in (dict(block_size=8, prefill_chunk_tokens=8),
               dict(block_size=4, prefill_chunk_tokens=4),
               dict(block_size=8, prefill_chunk_tokens=None),
               dict(block_size=16, prefill_chunk_tokens=12)):
        opts = dict(num_slots=2, max_queue=4, min_prompt_bucket=4,
                    cache="paged", **kw)
        je, te = JaxEngine(jlm, **opts), GenerationEngine(lm, **opts)
        try:
            assert te.chunk_buckets == je.chunk_buckets
            assert te._tbl_top == je._tbl_top
            assert te._blocks_per_seq == je._blocks_per_seq
            assert te.num_blocks == je.num_blocks
            assert te.prefill_chunk_tokens == je.prefill_chunk_tokens
            for n in range(1, 32):
                for start in (0, 3, 8):
                    assert te._chunk_plan(n, start) == \
                        je._chunk_plan(n, start), (kw, n, start)
                assert te._padded_prefill_len(n) == \
                    je._padded_prefill_len(n)
        finally:
            je.stop()
            te.stop()
    eng = GenerationEngine(lm, num_slots=1, max_queue=4, min_prompt_bucket=4,
                           cache="paged", block_size=8,
                           prefill_chunk_tokens=8)
    plan = eng._chunk_plan(31)
    span = max(31 + 1, plan[-1][0] + plan[-1][1])
    assert pow2_bucket(blocks_for(span, 8)) <= eng._tbl_top
    eng.stop()


def test_admission_waits_for_blocks_not_failure(lm):
    """4 usable blocks, 6 requests of 2 blocks each: two run at a time,
    the rest wait at the queue head; none fails."""
    eng = GenerationEngine(lm, num_slots=4, max_queue=32,
                           min_prompt_bucket=4, cache="paged",
                           block_size=8, num_blocks=5)
    eng.warmup()
    reqs = [dict(prompt=list(range(1, 10)), max_tokens=7, seed=i)
            for i in range(6)]
    results, errors = run_all(eng, reqs)
    assert errors == [None] * 6
    assert all(len(r["tokens"]) == 7 for r in results)
    assert eng.metrics.server_errors == 0
    assert eng.metrics.blocks_peak_used <= 4
    eng.clear_prefix_cache()
    assert eng.metrics.blocks_free == 4
    eng.stop()


def test_oversized_request_rejected_up_front(lm):
    eng = GenerationEngine(lm, num_slots=2, max_queue=8, min_prompt_bucket=4,
                           cache="paged", block_size=8, num_blocks=3)
    with pytest.raises(ClientError, match="blocks"):
        eng.generate(list(range(1, 20)), max_tokens=8)
    assert eng.metrics.requests == 0
    eng.stop()


def test_misconfiguration_rejected(lm):
    with pytest.raises(ValueError, match="cache"):
        GenerationEngine(lm, num_slots=1, cache="virtual")
    with pytest.raises(ValueError, match="block_size"):
        GenerationEngine(lm, num_slots=1, cache="paged", block_size=0)
    with pytest.raises(ValueError, match="num_blocks"):
        GenerationEngine(lm, num_slots=1, cache="paged", num_blocks=1)
    with pytest.raises(ValueError, match="prefill_chunk_tokens"):
        GenerationEngine(lm, num_slots=1, cache="paged",
                         prefill_chunk_tokens=0)
    eng = GenerationEngine(lm, num_slots=1, cache="paged", block_size=8,
                           prefill_chunk_tokens=8, min_prompt_bucket=4)
    with pytest.raises(ValueError, match="chunk_buckets"):
        eng.warmup([16])
    eng.stop()


@pytest.fixture(scope="module")
def paged_engine(lm):
    eng = GenerationEngine(lm, **PAGED)
    eng.warmup()
    yield eng
    eng.stop()


def test_streaming_and_eos_on_paged(paged_engine):
    kw = dict(max_tokens=5, temperature=0.7, top_k=4, seed=11)
    blocking = paged_engine.generate([3, 4], **kw)
    chunks = list(paged_engine.stream([3, 4], **kw))
    assert [c["token"] for c in chunks if "token" in c] == \
        blocking["tokens"]
    assert chunks[-1]["done"] is True
    probe = paged_engine.generate([5, 6], max_tokens=8, temperature=0.9,
                                  top_k=8, seed=42)
    r = paged_engine.generate([5, 6], max_tokens=8, temperature=0.9,
                              top_k=8, seed=42, eos_id=probe["tokens"][2])
    assert r["finish_reason"] == "eos"
    assert r["tokens"] == probe["tokens"][:3]


@pytest.mark.parametrize("started", [True, False])
def test_dropped_stream_frees_blocks(lm, paged_engine, started):
    eng = paged_engine
    eng.clear_prefix_cache()
    cap = eng._allocator.capacity
    it = eng.stream([1, 2, 3], max_tokens=25, temperature=0.5)
    if started:
        next(it)                          # live, blocks claimed
        assert eng._allocator.free_count < cap
    it.close()                            # the client hangs up
    assert wait_until(lambda: eng._allocator.free_count == cap
                      and eng._slots.active_count == 0)
    assert eng.generate([1, 2, 3], max_tokens=3)["tokens"] == \
        ref_greedy(lm, [1, 2, 3], 3)


def test_paged_stats_surface(paged_engine):
    paged_engine.clear_prefix_cache()
    paged_engine.generate(list(range(1, 15)), max_tokens=4)
    s = paged_engine.stats()
    assert s["cache_backend"] == "paged"
    p = s["paged"]
    assert p["block_size"] == 8
    # idle: what is still held belongs to the prefix index (the
    # 14-token prompt spans one full 8-token block)
    assert p["prefix_cache"]["prefix_blocks"] == 1
    assert p["blocks_free"] + 1 == p["blocks_total"]
    assert p["blocks_peak_used"] >= 3
    assert p["prefill_chunks"] >= 2 and p["chunked_prefills"] >= 1
    assert 0.0 <= p["fragmentation"] <= 1.0
    # 2 layers x K+V x (4 slots x 4 blocks + null) x 4 heads x 8 x 8 x f32
    assert s["kv_cache_bytes"] == 2 * 2 * 17 * 4 * 8 * 8 * 4
    assert s["kv_bytes_per_token"] == 2 * 2 * 4 * 8 * 4


TRIGGER = VOCAB - 2      # prompt token: first sample forced to POISON
POISON = VOCAB - 1       # decoding it gives NaN logits
NAN_TRIGGER = VOCAB - 3  # prompt token: NaN chunk logits and K/V


class PoisonLM(CausalTransformerLM):
    """NaN rig of the paged surfaces, as the JAX fault-tolerance tests
    build it: NAN_TRIGGER in a chunk makes its logits NaN and writes NaN
    into every pool position the chunk wrote (the request's own blocks,
    freed later without zeroing); TRIGGER forces the first sample to
    POISON, whose decode step gives NaN logits and NaN K/V at ``pos``.
    POISON is suppressed everywhere else."""

    def forward_prefill_chunk(self, params, tokens, p0, chunk_len,
                              k_pools, v_pools, block_table):
        logits, kcs, vcs = super().forward_prefill_chunk(
            params, tokens, p0, chunk_len, k_pools, v_pools, block_table)
        logits = logits.clone()
        logits[:, POISON] = -50.0
        if (tokens == TRIGGER).any():
            logits[:] = -50.0
            logits[:, POISON] = 50.0
        if (tokens == NAN_TRIGGER).any():
            logits[:] = float("nan")
            Bs = kcs[0].shape[2]
            gpos = p0 + torch.arange(tokens.shape[1])
            blk = block_table.long()[gpos // Bs]
            for pool in kcs + vcs:
                pool[blk, :, gpos % Bs] = float("nan")
        return logits, kcs, vcs

    def forward_decode_paged(self, params, tokens, pos, k_pools, v_pools,
                             block_tables):
        logits, kcs, vcs = super().forward_decode_paged(
            params, tokens, pos, k_pools, v_pools, block_tables)
        logits = logits.clone()
        logits[:, POISON] = -50.0
        bad = tokens == POISON
        logits[bad] = float("nan")
        if bad.any():
            Bs = kcs[0].shape[2]
            blk = block_tables.long().gather(1, (pos // Bs)[:, None])[:, 0]
            for pool in kcs + vcs:
                pool[blk[bad], :, (pos % Bs)[bad]] = float("nan")
        return logits, kcs, vcs


CLEAN = [dict(prompt=[1, 2, 3], max_tokens=5),
         dict(prompt=list(range(4, 15)), max_tokens=6, temperature=0.8,
              seed=3),
         dict(prompt=[9, 8], max_tokens=4)]


def test_decode_poison_quarantines_one_lane(jlm):
    eng = GenerationEngine(port_lm(jlm, PoisonLM), **PAGED)
    eng.warmup()
    base, errs = run_all(eng, CLEAN)
    assert errs == [None] * 3
    out, errs = run_all(eng, CLEAN + [dict(prompt=[1, TRIGGER],
                                           max_tokens=8)])
    assert isinstance(errs[3], PoisonRequestError)
    assert errs[:3] == [None] * 3 and out[:3] == base
    assert eng.metrics.quarantined == 1
    eng.clear_prefix_cache()
    assert eng._allocator.free_count == eng._allocator.capacity
    eng.stop()


def test_block_reuse_over_poisoned_stale_kv(jlm, lm):
    """A quarantined prefill leaves NaN K/V in its blocks; they return
    to the pool without zeroing, and the short requests that reuse them
    still reproduce the oracle (the kernel and the chunk attention mask
    V, not just p, past the live length)."""
    eng = GenerationEngine(port_lm(jlm, PoisonLM), num_slots=2,
                           max_queue=8, min_prompt_bucket=4, cache="paged",
                           block_size=8, num_blocks=5,
                           prefill_chunk_tokens=8)
    eng.warmup()
    with pytest.raises(PoisonRequestError):
        eng.generate([NAN_TRIGGER] + list(range(1, 20)), max_tokens=4)
    # a long occupant writes deep into the recycled blocks, then short
    # ones cycle through them
    eng.generate(list(range(1, 12)), max_tokens=18, seed=0)
    assert eng.metrics.blocks_peak_used >= 4
    for start in (3, 9, 15):
        prompt = [start, start + 1]
        assert eng.generate(prompt, max_tokens=5)["tokens"] == \
            ref_greedy(lm, prompt, 5)
    eng.stop()


@pytest.mark.parametrize("where", ["decode", "chunk"])
def test_failed_device_call_releases_every_block(jlm, where):
    """In flight: decoding lanes, a mid-prefill request and one held for
    blocks, over a cached prefix and a session pinned before. Held to the
    JAX engine's fault ladder on the same rig (the paged decode step or
    a prefill chunk raising as a failed kernel launch would): a one-shot
    decode failure recovers every request token-identical, a one-shot
    chunk failure fails its own request with its error and recovers the
    rest; a persistent decode failure fails each request with
    ServingError after max_recoveries_per_request recoveries, a
    persistent chunk failure each with its own error. Every block comes
    back and the engine keeps serving."""
    rig = Rig()
    lm = port_lm(jlm, RigLM)
    lm.rig = rig
    kw = dict(num_slots=3, max_queue=16, min_prompt_bucket=4, cache="paged",
              block_size=8, num_blocks=5, prefill_chunk_tokens=8)
    reqs = [dict(prompt=list(range(1, 10)), max_tokens=7),
            dict(prompt=list(range(2, 14)), max_tokens=3),
            dict(prompt=[5, 6, 7], max_tokens=12)]
    outcomes = []
    for eng in (jax_engine(jlm, rig, **kw), GenerationEngine(lm, **kw)):
        try:
            eng.warmup()
            rig.arm()
            first = eng.generate(list(range(1, 10)), max_tokens=2,
                                 session_id="s")
            assert first["finish_reason"] == "length"
            want = gated_streams(eng, reqs)
            runs = []
            for fail in ({2}, "always"):
                r0 = eng.metrics.recoveries
                rig.arm(**{where: fail})
                runs.append((gated_streams(eng, reqs),
                             eng.metrics.recoveries - r0))
            rig.arm()
            assert eng._slots.active_count == 0
            assert not eng._prefilling and eng._held is None
            eng.evict_sessions()
            eng.clear_prefix_cache()
            assert eng._allocator.free_count == eng._allocator.capacity
            after = eng.generate([1, 2], max_tokens=3)["tokens"]
            outcomes.append((want, runs, after))
        finally:
            eng.stop()
    jax_out, port_out = outcomes
    assert port_out == jax_out
    want, ((once, n_once), (always, _)), after = port_out
    assert all(isinstance(w, list) for w in want) and len(after) == 3
    failed = [o for o in once if not isinstance(o, list)]
    assert [o for o in once if isinstance(o, list)] == \
        [w for w, o in zip(want, once) if isinstance(o, list)]
    if where == "decode":
        assert not failed and n_once == 1
        assert all(o[1] == "ServingError" and "3 recovery attempts" in o[2]
                   for o in always), always
    else:
        assert len(failed) == 1 and n_once == 1
        assert all(o[1] == "RuntimeError" and "CUDA error 700" in o[2]
                   for o in failed + always), always


def test_paged_kernel_never_launched_on_cpu(paged_engine):
    n0 = pa.launches
    paged_engine.generate([1, 2, 3, 4, 5], max_tokens=4)
    assert pa.launches == n0
