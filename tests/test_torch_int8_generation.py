"""The int8 KV cache on the port's GenerationEngine, both backends,
against the JAX package's int8 engine on the same weights (CPU):
greedy and sampled tokens identical to ``GenerationEngine(kv_dtype=
"int8")``, with and without ``quantize_mlp_weights`` on both sides;
the stats surface (kv_bits, kv_bytes_per_token, quant) equal to JAX's;
pool bytes that shrink against f32 and bf16; copy-on-write that carries
the scale rows (a shared divergent suffix equals the unshared run);
session turn 2 equal to the JAX int8 engine's turn 2; a NaN that
crosses the int8 pool through its scale and quarantines only its own
lane, with the slots and blocks it leaves reused cleanly; and no block
leaked once sessions and the prefix cache are cleared.

The reference's own int8 session test holds turn 2 to an f32 greedy
run and fails in the reference (ROADMAP.md queue C); this file holds
the port to the JAX int8 engine instead."""
import threading

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.zoo.transformer_lm import CausalTransformerLM as JaxLM
from deeplearning4j_tpu.zoo.transformer_lm import \
    quantize_mlp_weights as jax_quantize_mlp
from deeplearning4j_tpu_torch.faults import PoisonRequestError
from deeplearning4j_tpu_torch.kernels import decode_attention as da
from deeplearning4j_tpu_torch.kernels import kv_quant as tkv
from deeplearning4j_tpu_torch.kernels import paged_attention as pa
from deeplearning4j_tpu_torch.serving import GenerationEngine
from deeplearning4j_tpu_torch.zoo.transformer_lm import (CausalTransformerLM,
                                                         quantize_mlp_weights)
from _torch_threads import one_torch_thread  # noqa: F401,E402

VOCAB = 64
NAN_TRIGGER = VOCAB - 3  # prompt token: NaN K/V written into the cache
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4,
           max_seq_len=32)
SLOTS = dict(num_slots=4, max_queue=64, min_prompt_bucket=4,
             kv_dtype="int8")
PAGED = dict(SLOTS, cache="paged", block_size=8, prefill_chunk_tokens=8,
             num_blocks=25)
BACKENDS = {"slots": SLOTS, "paged": PAGED}


def _jax_lm(quant_mlp=False):
    lm = JaxLM(**CFG, seed=0, implementation="plain").init()
    return jax_quantize_mlp(lm) if quant_mlp else lm


def _port_lm(jlm, cls=CausalTransformerLM):
    return cls(**CFG, seed=0, device="cpu").load_params(
        jax.tree.map(np.asarray, jlm._params))


def run_all(eng, reqs, timeout_ms=120_000):
    """Submit every request at once; returns (tokens or None, errors)."""
    results = [None] * len(reqs)
    errors = [None] * len(reqs)

    def go(i):
        try:
            results[i] = eng.generate(timeout_ms=timeout_ms,
                                      **reqs[i])["tokens"]
        except Exception as e:  # noqa: BLE001 — recorded for asserts
            errors[i] = e

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return results, errors


def _workload():
    rs = np.random.RandomState(11)
    reqs = []
    for i in range(16):
        plen = int(rs.choice([1, 3, 7, 12, 19]))
        reqs.append(dict(prompt=rs.randint(0, VOCAB - 3, plen).tolist(),
                         max_tokens=int(rs.choice([3, 6, 10])),
                         temperature=float(rs.choice([0.0, 0.0, 0.8])),
                         top_k=8, seed=i))
    return reqs


@pytest.fixture(scope="module", params=[False, True],
                ids=["f32_mlp", "int8_mlp"])
def runs(request):
    """The workload through the JAX int8 engine and the port's, on both
    backends, on the same weights (int8 MLP on both sides or neither)."""
    jlm = _jax_lm(request.param)
    lm = _port_lm(jlm)
    reqs = _workload()
    out = {}
    engines = {}
    try:
        for backend, kw in BACKENDS.items():
            je = JaxEngine(jlm, **kw)
            te = GenerationEngine(lm, **kw)
            engines[backend] = (je, te)
            je.warmup()
            te.warmup()
            out[backend] = (run_all(je, reqs), run_all(te, reqs))
        yield reqs, out, engines
    finally:
        for je, te in engines.values():
            je.stop()
            te.stop()


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_tokens_identical_to_the_jax_int8_engine(runs, backend):
    reqs, out, _ = runs
    (jtok, jerr), (ttok, terr) = out[backend]
    assert jerr == [None] * len(reqs) and terr == [None] * len(reqs)
    assert any(r["temperature"] > 0 for r in reqs)
    for i in range(len(reqs)):
        assert ttok[i] == jtok[i], (backend, i)


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_stats_match_the_jax_int8_engine(runs, backend):
    _, _, engines = runs
    je, te = engines[backend]
    js, ts = je.stats(), te.stats()
    assert ts["kv_dtype"] == "int8" and ts["kv_bits"] == 8
    assert ts["kv_bytes_per_token"] == js["kv_bytes_per_token"]
    assert ts["kv_cache_bytes"] == js["kv_cache_bytes"]
    assert ts["quant"]["scale_bytes"] == js["quant"]["scale_bytes"] > 0
    assert tkv.is_quantized(te._cache.ks[0])
    if backend == "paged":
        assert ts["quant"]["blocks_quantized"] == \
            te._allocator.used_count > 0


def test_no_block_leaks_after_the_caches_are_cleared(runs):
    _, _, engines = runs
    te = engines["paged"][1]
    te.evict_sessions()
    te.clear_prefix_cache()
    assert te._allocator.free_count == te._allocator.capacity
    assert te.stats()["quant"]["blocks_quantized"] == 0


def test_int8_kernels_never_launched_on_cpu(runs):
    assert da.launches_int8 == 0 and pa.launches_int8 == 0


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_pool_bytes_shrink_against_f32_and_bf16(backend):
    lm = CausalTransformerLM(**CFG, device="cpu").init()
    sizes = {}
    for dt in ("f32", "bf16", "int8"):
        eng = GenerationEngine(lm, **dict(BACKENDS[backend], kv_dtype=dt))
        try:
            sizes[dt] = eng._cache.nbytes()
            assert eng.stats()["kv_cache_bytes"] == sizes[dt]
        finally:
            eng.stop()
    assert sizes["bf16"] == sizes["f32"] // 2
    assert sizes["f32"] // 4 < sizes["int8"] < sizes["f32"] // 2


# ---------------------------------------------------------------------------
# copy-on-write and sessions over int8 pools
# ---------------------------------------------------------------------------
P16 = [1, 5, 2, 9, 3, 7, 4, 6, 8, 10, 1, 5, 2, 9, 3, 7]
COW = dict(num_slots=3, max_queue=64, min_prompt_bucket=4, cache="paged",
           block_size=8, prefill_chunk_tokens=8, kv_dtype="int8")


def test_cow_divergent_suffix_int8_matches_unshared():
    """Two requests share a 16-token int8 prefix then diverge, and an
    exact block-aligned duplicate copies its last matched block on
    write: the copy must carry the scale rows with the values, or the
    shared run drifts from the unshared one."""
    lm = _port_lm(_jax_lm())
    outs = {}
    for sharing in (True, False):
        eng = GenerationEngine(lm, **COW, enable_prefix_sharing=sharing)
        eng.warmup()
        try:
            ra = eng.generate(P16 + [11, 12, 13, 14], max_tokens=5)
            rb = eng.generate(P16 + [21, 22, 23, 24], max_tokens=5)
            rc1 = eng.generate(P16, max_tokens=5)
            rc2 = eng.generate(P16, max_tokens=5)
            assert rc2["tokens"] == rc1["tokens"]
            outs[sharing] = (ra["tokens"], rb["tokens"], rc1["tokens"])
            if sharing:
                assert eng.metrics.prefix_hits >= 1
                assert eng.metrics.cow_copies >= 1
        finally:
            eng.stop()
    assert outs[True] == outs[False]


def test_session_turn_two_equals_the_jax_int8_engine():
    jlm = _jax_lm()
    lm = _port_lm(jlm)
    je = JaxEngine(jlm, **COW)
    te = GenerationEngine(lm, **COW)
    try:
        je.warmup()
        te.warmup()
        r1 = {n: e.generate(P16, max_tokens=4, session_id="alice",
                            timeout_ms=120_000)["tokens"]
              for n, e in (("jax", je), ("port", te))}
        assert r1["port"] == r1["jax"]
        turn2 = P16 + r1["jax"] + [12, 13]
        r2 = {n: e.generate(turn2, max_tokens=4, session_id="alice",
                            timeout_ms=120_000)["tokens"]
              for n, e in (("jax", je), ("port", te))}
        assert r2["port"] == r2["jax"]
        assert te.metrics.session_hits == 1
        assert te.metrics.cow_copies >= 1   # the match ends mid-block
        te.evict_sessions()
        te.clear_prefix_cache()
        assert te._allocator.free_count == te._allocator.capacity
    finally:
        je.stop()
        te.stop()


# ---------------------------------------------------------------------------
# NaN through the int8 pool
# ---------------------------------------------------------------------------
class CachePoisonLM(CausalTransformerLM):
    """NaN rig that poisons only what a prompt holding NAN_TRIGGER
    writes into the cache, never its prefill logits: the slot prefill's
    K/V slabs (quantized on write, so the NaN must survive in the
    scale) and, on the paged backend, the scale rows of the positions
    a chunk wrote. The request goes non-finite only if the int8 cache
    carries the NaN back out to attention."""

    def forward_prefill(self, params, tokens, key_mask=None):
        logits, ks, vs = super().forward_prefill(params, tokens, key_mask)
        bad = (tokens == NAN_TRIGGER).any(dim=-1)[:, None, None, None]
        return (logits, [torch.where(bad, float("nan"), k) for k in ks],
                [torch.where(bad, float("nan"), v) for v in vs])

    def forward_prefill_chunk(self, params, tokens, p0, chunk_len,
                              k_pools, v_pools, block_table):
        logits, kcs, vcs = super().forward_prefill_chunk(
            params, tokens, p0, chunk_len, k_pools, v_pools, block_table)
        if (tokens == NAN_TRIGGER).any():
            Bs = kcs[0].shape[2]
            gpos = p0 + torch.arange(tokens.shape[1])
            blk = block_table.long()[gpos // Bs]
            for pool in kcs + vcs:
                pool.scale[blk, :, gpos % Bs] = float("nan")
        return logits, kcs, vcs


CLEAN = [dict(prompt=[1, 2, 3], max_tokens=5),
         dict(prompt=list(range(4, 15)), max_tokens=6, temperature=0.8,
              seed=3),
         dict(prompt=[9, 8], max_tokens=4)]


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_nan_crosses_the_int8_pool_and_quarantines_one_lane(backend):
    lm = _port_lm(_jax_lm(), CachePoisonLM)
    eng = GenerationEngine(lm, **dict(BACKENDS[backend], num_slots=3,
                                      **({"num_blocks": 12}
                                         if backend == "paged" else {})))
    eng.warmup()
    try:
        base, errs = run_all(eng, CLEAN)
        assert errs == [None] * 3
        out, errs = run_all(eng, CLEAN + [dict(prompt=[1, NAN_TRIGGER, 2],
                                               max_tokens=6)])
        assert isinstance(errs[3], PoisonRequestError)
        assert errs[:3] == [None] * 3 and out[:3] == base
        assert eng.metrics.quarantined == 1
        # fill every slot (and, paged, most blocks) with int8 leavings
        # whose scales are NaN, free them without zeroing, rerun clean
        nan_prompt = [NAN_TRIGGER] + list(range(1, 17))
        _, errs = run_all(eng, [dict(prompt=nan_prompt, max_tokens=4)] * 3)
        assert all(isinstance(e, PoisonRequestError) for e in errs)
        out, errs = run_all(eng, CLEAN)
        assert errs == [None] * 3 and out == base
        if backend == "paged":
            eng.clear_prefix_cache()
            assert eng._allocator.free_count == eng._allocator.capacity
    finally:
        eng.stop()
