"""The hierarchical KV tier on the port (CPU): ``serving/offload.py``
(lifted from the JAX package), the block-run helpers of
``kernels/kv_quant.py`` and ``serving/paging.py``, and the paged
engine's demote-on-evict and restore-on-resume, held to
``tests/test_kv_offload.py`` case for case and to the JAX package on the
same numpy-seeded weights:

- the tier's classes: ``HostRun`` pack/unpack (``pack()`` byte for byte
  and meta for meta JAX's), ``DiskRing`` wrap-eviction, ``HostBlockStore``
  LRU, byte budget and spill, ``OffloadPrefetcher`` staging;
- the helpers at f32, bf16 and int8 with NULL-padded indices: the
  gather, the packed host rows, the padded operands and the scatter
  equal JAX's bit for bit, and the scatter keeps each pool's storage;
- the engine at the JAX file's size (d32 x L2, 9 blocks of 8, a pool
  that pins ~2 sessions): 4 two-turn sessions give the uncached greedy
  oracle's tokens, JAX's tokens and JAX's offload counters and gauges
  (all but the ms reservoirs and ``prefetch_hits``, a race), with no
  capture after warmup under recorded captures; prefetch, the disk
  spill, suffix-only re-prefill, the prefix tier; torn demotions and
  failed restores at f32 and int8, transient and corrupting, degrade to
  discard and re-prefill; a failed scatter goes through
  recompute-recovery with no request lost and no block leaked; the host
  tier survives a recovery; ``clear_offload``, the config guards, int8's
  >= 3x sessions per host byte and the ``stats()`` block;
- traced turn 2s of the same workload: each restore's
  ``offload_restore`` span (``tokens``, ``blocks``, ``prefetched``) and
  each session hit's ``prefix_match`` are the JAX engine's, with the
  prefetch off and with every restore staged by it."""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import kv_quant as jkv
from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.serving import offload as joff
from deeplearning4j_tpu.serving.metrics import \
    GenerationMetrics as JaxMetrics
from deeplearning4j_tpu.tracing import Tracer as JaxTracer
from deeplearning4j_tpu.zoo.transformer_lm import CausalTransformerLM as JaxLM
from deeplearning4j_tpu_torch.faults import FaultInjector
from deeplearning4j_tpu_torch.kernels import kv_quant as tkv
from deeplearning4j_tpu_torch.serving import GenerationEngine
from deeplearning4j_tpu_torch.serving.offload import (DiskRing,
                                                      HostBlockStore,
                                                      HostRun,
                                                      OffloadPrefetcher)
from deeplearning4j_tpu_torch.serving.paging import (NULL_BLOCK,
                                                     export_block_run,
                                                     import_block_run)
from deeplearning4j_tpu_torch.tracing import Tracer
from deeplearning4j_tpu_torch.zoo.transformer_lm import CausalTransformerLM

from _torch_fault_rig import Gate
from _torch_threads import one_torch_thread  # noqa: F401,E402

VOCAB = 64
# n_heads=2 -> head_dim 16, where int8 (1 byte a value + a 4-byte scale
# over 16) is 3.2x smaller than f32 a token: the capacity test's >= 3x
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2,
           max_seq_len=32)
#: 8 usable blocks pin ~2.5 sessions: a 4-session workload must evict
#: (and so demote)
OPTS = dict(num_slots=2, max_queue=64, min_prompt_bucket=4, cache="paged",
            block_size=8, prefill_chunk_tokens=8, num_blocks=9,
            offload_host_bytes=1 << 20)
#: the offload counters and gauges the engine parity holds to JAX's
#: (prefetch_hits depends on the prefetch thread's timing)
PARITY_KEYS = ("enabled", "demotions", "restores", "demote_failures",
               "restore_failures", "spills", "drops", "host_runs",
               "host_blocks", "host_bytes", "disk_blocks", "disk_bytes")


@pytest.fixture(scope="module")
def jlm():
    return JaxLM(**CFG, seed=0, implementation="plain").init()


@pytest.fixture(scope="module")
def lm(jlm):
    return CausalTransformerLM(**CFG, seed=0, device="cpu").load_params(
        jax.tree.map(np.asarray, jlm._params))


def _ref_greedy(lm, prompt, n):
    """Uncached full-prefix greedy decode: the oracle every restored or
    re-prefilled path reproduces."""
    toks = list(prompt)
    for _ in range(n):
        toks.append(int(lm.logits(np.asarray(toks)[None])[0, -1].argmax()))
    return toks[len(prompt):]


def _mkeng(lm, **kw):
    eng = GenerationEngine(lm, **dict(OPTS, **kw))
    eng.warmup()
    return eng


def _prompt(i):
    # 16 tokens = two full 8-token blocks, distinct per session
    return [(3 * i + j) % (VOCAB - 8) + 1 for j in range(16)]


def _turn(eng, lm, sid, prompt, n=5):
    out = eng.generate(prompt, max_tokens=n, session_id=sid,
                       timeout_ms=120_000)["tokens"]
    assert out == _ref_greedy(lm, prompt, n), sid
    return out


def _two_turns(eng, lm):
    """4 sessions' first turns, then their second turns (prompt + the
    first turn's tokens + a 2-token tail); returns every turn's
    tokens."""
    outs = [_turn(eng, lm, f"s{i}", _prompt(i)) for i in range(4)]
    return outs + [_turn(eng, lm, f"s{i}", _prompt(i) + outs[i] + [7, 11],
                         n=4) for i in range(4)]


def _offsnap(eng):
    return eng.stats()["paged"]["offload"]


def _all_blocks_free(eng):
    return eng._allocator.free_count == eng._allocator.capacity


# ---------------------------------------------------------------------------
# HostRun pack/unpack
# ---------------------------------------------------------------------------
def _parts_f32(rng, nblk):
    return (rng.randn(nblk, 2, 8, 16).astype(np.float32),)


def _parts_int8(rng, nblk):
    return (rng.randint(-128, 128, (nblk, 2, 8, 16), dtype=np.int8),
            rng.rand(nblk, 2, 8).astype(np.float32))


def _parts_bf16(rng, nblk):
    return (rng.randint(0, 1 << 16, (nblk, 2, 8, 16)).astype(np.uint16),)


_MAKE = {"f32": _parts_f32, "int8": _parts_int8, "bf16": _parts_bf16}


def _run(kv="f32", ntok=12, nblk=3, seed=0, cls=HostRun):
    rng = np.random.RandomState(seed)
    mk = _MAKE[kv]
    ks = [mk(rng, nblk), mk(rng, nblk)]
    vs = [mk(rng, nblk), mk(rng, nblk)]
    return cls(np.arange(ntok, dtype=np.int32), ks, vs, kv)


class TestHostRun:
    @pytest.mark.parametrize("kv", ["f32", "int8", "bf16"])
    def test_pack_unpack_roundtrip(self, kv):
        run = _run(kv)
        payload, meta = run.pack()
        back = HostRun.unpack(memoryview(payload), meta)
        np.testing.assert_array_equal(back.tokens, run.tokens)
        assert back.kv_dtype == run.kv_dtype
        assert back.n_blocks == run.n_blocks
        for a, b in zip(run.ks + run.vs, back.ks + back.vs):
            assert len(a) == len(b)
            for pa, pb in zip(a, b):
                assert pa.dtype == pb.dtype
                np.testing.assert_array_equal(pa, pb)

    def test_nbytes_counts_every_part(self):
        run = _run("int8")
        want = run.tokens.nbytes + sum(
            p.nbytes for layer in run.ks + run.vs for p in layer)
        assert run.nbytes == want
        payload, _ = run.pack()
        assert len(payload) == want

    @pytest.mark.parametrize("kv", ["f32", "int8"])
    def test_pack_is_jax_pack(self, kv):
        """The same run packs to JAX's payload, byte for byte, and meta."""
        payload, meta = _run(kv).pack()
        jpayload, jmeta = _run(kv, cls=joff.HostRun).pack()
        assert payload == jpayload
        assert meta == jmeta

    def test_bf16_nbytes_is_jax_nbytes(self):
        """A bf16 run's bit patterns cost JAX's 2 bytes a value."""
        run = _run("bf16")
        jrun = joff.HostRun(
            run.tokens,
            [tuple(p.view(jnp.bfloat16) for p in layer) for layer in run.ks],
            [tuple(p.view(jnp.bfloat16) for p in layer) for layer in run.vs],
            "bf16")
        assert run.nbytes == jrun.nbytes


# ---------------------------------------------------------------------------
# DiskRing
# ---------------------------------------------------------------------------
class TestDiskRing:
    def test_put_get_roundtrip(self):
        ring = DiskRing(1 << 20)
        try:
            run = _run()
            assert ring.put("a", *run.pack())
            back = ring.get("a")
            np.testing.assert_array_equal(back.ks[0][0], run.ks[0][0])
            assert ring.get("nope") is None
        finally:
            ring.close()

    def test_wrap_evicts_oldest(self):
        payload, meta = _run(nblk=1).pack()
        # room for exactly 2 entries: the 3rd wraps and kills "a"
        ring = DiskRing(len(payload) * 2 + len(payload) // 2)
        try:
            for k in ("a", "b", "c"):
                assert ring.put(k, payload, meta)
            assert "a" not in ring and "c" in ring
            assert ring.get("c") is not None
        finally:
            ring.close()

    def test_oversized_payload_rejected(self):
        ring = DiskRing(64)
        try:
            payload, meta = _run().pack()
            assert not ring.put("big", payload, meta)
            assert len(ring) == 0
        finally:
            ring.close()

    def test_close_unlinks_own_tempfile(self):
        ring = DiskRing(1 << 12)
        ring.put("a", b"\x01" * 16, {"n_blocks": 1})
        path = ring._path
        assert path is not None and os.path.exists(path)
        ring.close()
        assert not os.path.exists(path)


# ---------------------------------------------------------------------------
# HostBlockStore
# ---------------------------------------------------------------------------
class TestHostBlockStore:
    def test_budget_drops_lru_without_disk(self):
        store = HostBlockStore(byte_budget=_run(nblk=1).nbytes * 2 + 1)
        for k in ("a", "b", "c"):
            store.put(k, _run(nblk=1))
        assert "a" not in store and "c" in store
        assert store.drops == 1 and store.spills == 0

    def test_get_touches_lru_order(self):
        store = HostBlockStore(byte_budget=_run(nblk=1).nbytes * 2 + 1)
        store.put("a", _run(nblk=1))
        store.put("b", _run(nblk=1))
        assert store.get("a") is not None      # "b" is now LRU
        store.put("c", _run(nblk=1))
        assert "b" not in store and "a" in store

    def test_peek_does_not_touch_lru(self):
        store = HostBlockStore(byte_budget=_run(nblk=1).nbytes * 2 + 1)
        store.put("a", _run(nblk=1))
        store.put("b", _run(nblk=1))
        assert store.peek("a") is not None     # "a" stays LRU
        store.put("c", _run(nblk=1))
        assert "a" not in store and "b" in store

    def test_over_budget_spills_to_disk_and_reads_back(self):
        runs = {k: _run(nblk=1, seed=i)
                for i, k in enumerate(("a", "b", "c"))}
        store = HostBlockStore(byte_budget=runs["a"].nbytes + 1,
                               disk=DiskRing(1 << 20))
        try:
            for k, r in runs.items():
                store.put(k, r)
            assert store.spills == 2 and store.drops == 0
            st = store.stats()
            assert st["host_runs"] == 1 and st["disk_blocks"] == 2
            assert st["disk_bytes"] > 0
            # a disk hit rebuilds the run bit-exactly, without promotion
            back = store.get("a")
            np.testing.assert_array_equal(back.ks[0][0],
                                          runs["a"].ks[0][0])
            assert store.peek("a") is None     # still on disk only
            assert sorted(store.keys()) == ["a", "b", "c"]
        finally:
            store.close()

    def test_pop_removes_from_both_tiers(self):
        store = HostBlockStore(byte_budget=_run(nblk=1).nbytes + 1,
                               disk=DiskRing(1 << 20))
        try:
            store.put("a", _run(nblk=1))
            store.put("b", _run(nblk=1))   # "a" spills to disk
            store.pop("a")
            store.pop("b")
            assert "a" not in store and "b" not in store
            assert store.stats()["host_bytes"] == 0
        finally:
            store.close()

    def test_oversized_insert_is_never_self_evicted(self):
        run = _run()
        store = HostBlockStore(byte_budget=1)  # everything is over
        store.put("big", run)
        assert store.get("big") is run         # the len > 1 guard held
        assert store.drops == 0

    def test_stamp_names_the_current_put_in_either_tier(self):
        store = HostBlockStore(byte_budget=_run(nblk=1).nbytes + 1,
                               disk=DiskRing(1 << 20))
        try:
            store.put("a", _run(nblk=1))
            first = store.stamp("a")
            store.put("b", _run(nblk=1))           # "a" spills
            assert store.peek("a") is None and store.stamp("a") == first
            store.put("a", _run(nblk=1))           # a new put
            assert store.stamp("a") not in (None, first)
            store.pop("a")
            assert store.stamp("a") is None and store.stamp("zz") is None
        finally:
            store.close()

    def test_same_key_replace_keeps_bytes_exact(self):
        store = HostBlockStore(byte_budget=1 << 30)
        store.put("a", _run(nblk=2))
        store.put("a", _run(nblk=1))
        st = store.stats()
        assert st["host_runs"] == 1
        assert st["host_bytes"] == store.get("a").nbytes


class TestOffloadPrefetcher:
    def test_stage_take_and_failed_stage(self):
        def stage(key):
            if key == "boom":
                raise RuntimeError("disk died")
            return key.upper()

        pf = OffloadPrefetcher(stage, max_staged=4)
        try:
            pf.request("a")
            pf.request("boom")
            got = None
            for _ in range(200):
                got = pf.take("a")
                if got is not None:
                    break
                time.sleep(0.01)
            assert got == "A"
            assert pf.take("a") is None        # take pops
            assert pf.take("boom") is None     # a failed stage -> inline
        finally:
            pf.stop()
        assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# the block-run helpers against JAX's
# ---------------------------------------------------------------------------
def _pools(kv, rs, n=6):
    """One seeded pool [n, 2, 8, 16] for the port and its JAX copy."""
    x = rs.randn(n, 2, 8, 16).astype(np.float32)
    if kv == "int8":
        qv = tkv.quantize_rows(torch.from_numpy(x))
        return qv, jkv.QuantArray(jnp.asarray(qv.q.numpy()),
                                  jnp.asarray(qv.scale.numpy()))
    if kv == "bf16":
        return (torch.from_numpy(x).to(torch.bfloat16),
                jnp.asarray(x).astype(jnp.bfloat16))
    return torch.from_numpy(x), jnp.asarray(x)


def _np_parts(x):
    """A port pool or rows as numpy (bf16 as uint16 bits)."""
    return [p.view(torch.int16).numpy().view(np.uint16)
            if p.dtype == torch.bfloat16 else p.numpy()
            for p in ((x.q, x.scale) if tkv.is_quantized(x) else (x,))]


def _jnp_parts(x):
    parts = (x.q, x.scale) if jkv.is_quantized(x) else (x,)
    return [np.asarray(p).view(np.uint16) if p.dtype == jnp.bfloat16
            else np.asarray(p) for p in parts]


def _bits_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_block_run_helpers_are_jax_helpers(kv):
    rs = np.random.RandomState(7)
    pool, jpool = _pools(kv, rs)
    dst, jdst = _pools(kv, rs)
    n, bucket = 3, 8
    idx = np.full(bucket, NULL_BLOCK, np.int32)
    idx[:n] = [4, 1, 5]
    tidx = torch.from_numpy(idx.astype(np.int64))
    rows = tkv.kv_gather_rows(pool, tidx)
    jrows = jkv.kv_gather_rows(jpool, jnp.asarray(idx))
    _bits_equal(_np_parts(rows), _jnp_parts(jrows))
    # into a static row buffer of a larger bucket: its leading rows
    buf = tkv.kv_zeros((16, 2, 8, 16), kv)
    _bits_equal(_np_parts(tkv.kv_gather_rows(pool, tidx, out=buf)),
                _jnp_parts(jrows))
    packed = tkv.kv_pack_host(rows, n)
    jpacked = jkv.kv_pack_host(jrows, n)
    _bits_equal(list(packed), [np.asarray(p).view(np.uint16)
                               if p.dtype == jnp.bfloat16 else p
                               for p in jpacked])
    for p in packed:   # owned copies: nothing shares the rows' memory
        assert p.flags.owndata and p.flags.c_contiguous
    assert tkv.kv_host_nbytes(packed) == jkv.kv_host_nbytes(jpacked)
    ops = tkv.kv_unpack_host(packed, bucket)
    jops = jkv.kv_unpack_host(jpacked, bucket)
    _bits_equal(_np_parts(ops), _jnp_parts(jops))
    ptrs = [p.data_ptr() for p in ((dst.q, dst.scale)
                                   if kv == "int8" else (dst,))]
    out = tkv.kv_scatter_rows(dst, ops, tidx)
    assert out is dst
    assert [p.data_ptr() for p in ((dst.q, dst.scale)
                                   if kv == "int8" else (dst,))] == ptrs
    jout = jkv.kv_scatter_rows(jdst, jops, jnp.asarray(idx))
    _bits_equal(_np_parts(dst), _jnp_parts(jout))
    # the run landed where idx says, and the padding only on the null
    # block (zeros)
    for got, want in zip(_np_parts(dst), _np_parts(pool)):
        np.testing.assert_array_equal(got[[4, 1, 5]], want[[4, 1, 5]])
        assert not got[NULL_BLOCK].any()


def test_export_import_block_run_in_place():
    rs = np.random.RandomState(8)
    kcs = [_pools("int8", rs)[0] for _ in range(2)]
    vcs = [_pools("int8", rs)[0] for _ in range(2)]
    idx = torch.tensor([2, 3, NULL_BLOCK, NULL_BLOCK])
    k_rows, v_rows = export_block_run(kcs, vcs, idx)
    before = [(p.q.clone(), p.scale.clone()) for p in kcs + vcs]
    dk = [tkv.kv_zeros(p.shape, "int8") for p in kcs]
    dv = [tkv.kv_zeros(p.shape, "int8") for p in vcs]
    ptrs = [(p.q.data_ptr(), p.scale.data_ptr()) for p in dk + dv]
    got_k, got_v = import_block_run(dk, dv, k_rows, v_rows, idx)
    assert got_k is dk and got_v is dv
    assert [(p.q.data_ptr(), p.scale.data_ptr()) for p in dk + dv] == ptrs
    for p, (q, sc) in zip(dk + dv, before):
        assert torch.equal(p.q[2:4], q[2:4])
        assert torch.equal(p.scale[2:4], sc[2:4])
        assert not p.q[4:].any() and not p.q[1].any()


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------
_JAX_RUNS = {}


def _jax_run(jlm, kv_dtype):
    """The 4-session workload on the JAX engine (its compiles lazy):
    every turn's tokens and its offload block."""
    if kv_dtype not in _JAX_RUNS:
        je = JaxEngine(jlm, **OPTS, kv_dtype=kv_dtype)
        try:
            outs = [je.generate(_prompt(i), max_tokens=5, session_id=f"s{i}",
                                timeout_ms=120_000)["tokens"]
                    for i in range(4)]
            outs += [je.generate(_prompt(i) + outs[i] + [7, 11],
                                 max_tokens=4, session_id=f"s{i}",
                                 timeout_ms=120_000)["tokens"]
                     for i in range(4)]
            _JAX_RUNS[kv_dtype] = outs, je.stats()["paged"]["offload"]
        finally:
            je.stop()
    return _JAX_RUNS[kv_dtype]


class _Recorded:
    def __init__(self, run):
        self.replay = run


def _recording(eng):
    """Card behaviour with recorded captures (a "replay" runs the
    captured function); returns the captured names."""
    names = []

    def capture(run, what, shared=False):
        names.append(what)
        eng.metrics.inc("compiles")
        return _Recorded(run), {}
    eng._cuda_graph = True
    eng._capture = capture
    return names


class TestEngineRoundtrip:
    @pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
    def test_two_turns_token_identical_zero_recompiles(self, lm, jlm,
                                                       kv_dtype):
        """4 sessions on a pool that pins ~2: turn-1 completions evict
        (= demote) earlier sessions, turn-2 resumes restore them. Every
        output is the oracle's and the JAX engine's, the offload
        counters and gauges are JAX's, and the warmed gather/scatter
        graphs (recorded captures) served all of it: no capture after
        warmup, and as many at warmup as the JAX engine compiles."""
        eng = GenerationEngine(lm, **OPTS, kv_dtype=kv_dtype)
        names = _recording(eng)
        try:
            eng.warmup()
            c0 = eng.metrics.compiles
            plan = eng.graph_plan()
            assert c0 == len(names) == len(plan)
            assert {("offload_save", b) for b in (1, 2, 4)} <= set(plan)
            outs = _two_turns(eng, lm)
            want, joff_snap = _jax_run(jlm, kv_dtype)
            assert outs == want
            snap = _offsnap(eng)
            assert {k: snap[k] for k in PARITY_KEYS} == \
                {k: joff_snap[k] for k in PARITY_KEYS}
            assert snap["demotions"] > 0 and snap["restores"] > 0
            assert snap["demote_failures"] == snap["restore_failures"] == 0
            assert eng.metrics.compiles == c0 == len(names), \
                "capture after warmup"
            # full reclamation: demote everything, then drain the tiers
            eng.offload_sessions()
            eng.clear_prefix_cache()
            assert _all_blocks_free(eng)
        finally:
            eng.stop()

    def test_bf16_round_trip_restores_bit_patterns(self, lm):
        """A bf16 pool's runs travel as uint16 bit patterns and restore
        to the same bf16 values: turn 2 of an offloaded session gives
        the tokens of an engine that never offloads."""
        eng = _mkeng(lm, kv_dtype="bf16")
        hot = GenerationEngine(lm, **dict(OPTS, num_blocks=64,
                                          offload_host_bytes=0),
                               kv_dtype="bf16")
        try:
            hot.warmup()
            for e in (eng, hot):
                e.outs = [e.generate(_prompt(i), max_tokens=5,
                                     session_id=f"s{i}")["tokens"]
                          for i in range(4)]
                e.outs += [e.generate(_prompt(i) + e.outs[i] + [7, 11],
                                      max_tokens=4,
                                      session_id=f"s{i}")["tokens"]
                           for i in range(4)]
            assert eng.outs == hot.outs
            snap = _offsnap(eng)
            assert snap["restores"] > 0
            assert all(p.dtype == np.uint16 for k in eng._offload.keys()
                       for layer in eng._offload.get(k).ks for p in layer)
            assert _offsnap(hot)["enabled"] is False
        finally:
            eng.stop()
            hot.stop()

    def test_prefetch_overlaps_restore(self, lm):
        """A resume submitted while its session sits in the host tier
        kicks the prefetcher at submit time; admission then takes the
        staged operands, counted as a prefetch hit."""
        eng = _mkeng(lm)
        try:
            _two_turns(eng, lm)
            snap = _offsnap(eng)
            assert snap["restores"] > 0
            assert 0 <= snap["prefetch_hits"] <= snap["restores"]
        finally:
            eng.stop()

    @pytest.mark.parametrize("where", ["ram", "disk", "re-demoted"])
    def test_staged_prefetch_is_a_hit(self, lm, where):
        """Deterministically: a run staged before admission is taken
        there (a prefetch hit) and restores the same tokens, also when it
        was spilled to the disk ring after staging; a run demoted again
        after staging is stale, restored inline (no hit)."""
        eng = _mkeng(lm, offload_host_bytes=20_000,
                     offload_disk_bytes=1 << 20)
        try:
            out = _turn(eng, lm, "a", _prompt(0))
            assert eng.offload_sessions() == 1
            pf, store = eng._offload_prefetcher, eng._offload
            pf.request("a")
            for _ in range(500):
                if pf._staged:
                    break
                time.sleep(0.01)
            assert "a" in pf._staged
            if where == "disk":
                store.put("filler", store.peek("a"))   # "a" spills
                assert store.peek("a") is None and "a" in store
            elif where == "re-demoted":
                store.put("a", store.peek("a"))
            _turn(eng, lm, "a", _prompt(0) + out + [7, 11], n=4)
            snap = _offsnap(eng)
            assert snap["restores"] == 1
            assert snap["prefetch_hits"] == (where != "re-demoted")
        finally:
            eng.stop()

    def test_disk_tier_spill_and_restore(self, lm):
        """A host budget too small for the working set spills LRU runs
        to the disk ring; a resume whose run lives ONLY on disk still
        restores token-identically."""
        eng = _mkeng(lm, offload_host_bytes=6_000,
                     offload_disk_bytes=1 << 20)
        try:
            outs = [_turn(eng, lm, f"s{i}", _prompt(i)) for i in range(4)]
            snap1 = _offsnap(eng)
            assert snap1["spills"] > 0, "budget never forced a spill"
            assert snap1["disk_blocks"] > 0 and snap1["disk_bytes"] > 0
            for i in range(4):
                _turn(eng, lm, f"s{i}", _prompt(i) + outs[i] + [7, 11], n=4)
            snap2 = _offsnap(eng)
            assert snap2["restores"] > 0
            assert snap2["drops"] == 0, "a run fell off the hierarchy"
            path = eng._offload.disk._path
            assert os.path.exists(path)
        finally:
            eng.stop()
        assert not os.path.exists(path), "stop() left the ring file"

    # (4, 11): a resume finds a free slot while in-flight turns hold the
    # blocks its run needs; (3, 9): a restored resume is held for its
    # suffix's blocks
    @pytest.mark.parametrize("slots,blocks", [(4, 11), (3, 9)])
    def test_burst_resumes_wait_for_blocks_instead_of_reprefilling(
            self, lm, slots, blocks):
        """All four resumes submitted at once on a pool that in-flight
        turns fill: a resume whose run cannot get blocks yet waits at
        the head of the line and restores later, so no session the host
        tier holds is re-prefilled (no session miss); a resume held for
        its suffix's blocks keeps its restored pin (each session
        restores once: no demote/restore churn); every turn gives the
        oracle's tokens."""
        import threading
        eng = _mkeng(lm, num_slots=slots, num_blocks=blocks,
                     offload_prefetch=False)
        reads = []
        get = eng._offload.get

        def counted_get(key):
            reads.append(key)
            return get(key)
        eng._offload.get = counted_get
        try:
            outs = [_turn(eng, lm, f"s{i}", _prompt(i)) for i in range(4)]
            misses0 = eng.metrics.session_misses
            del reads[:]
            got = [None] * 4

            def go(i):
                got[i] = eng.generate(_prompt(i) + outs[i] + [7, 11],
                                      max_tokens=4, session_id=f"s{i}",
                                      timeout_ms=120_000)["tokens"]
            threads = [threading.Thread(target=go, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
            assert got == [_ref_greedy(lm, _prompt(i) + outs[i] + [7, 11], 4)
                           for i in range(4)]
            assert eng.metrics.session_misses == misses0
            snap = _offsnap(eng)
            assert snap["restores"] == 4 and snap["restore_failures"] == 0
            # a held attempt's read is kept for the next one: one read a
            # session
            assert sorted(k for k in reads if not k.startswith("px:")) == \
                [f"s{i}" for i in range(4)]
        finally:
            eng.stop()

    def test_restored_resume_skips_the_prefix_prefill(self, lm):
        """A restored turn 2 re-prefills only its unseen suffix, exactly
        like a hot session hit."""
        eng = _mkeng(lm)
        try:
            out = _turn(eng, lm, "a", _prompt(0))
            assert eng.offload_sessions() == 1   # force the cold path
            assert _offsnap(eng)["host_runs"] >= 1
            p2 = _prompt(0) + out + [7, 11]
            pf0 = eng.metrics.prefill_tokens
            hits0 = eng.metrics.session_hits
            _turn(eng, lm, "a", p2, n=4)
            assert _offsnap(eng)["restores"] >= 1
            assert eng.metrics.session_hits == hits0 + 1
            # the pinned prompt + gen[:-1] = 20 of 23 prompt tokens came
            # from the restored run
            assert eng.metrics.prefill_tokens - pf0 < len(p2) // 2
        finally:
            eng.stop()


def test_eviction_keeps_pins_it_cannot_use(lm):
    """The pool's eviction rule (the engine's own bookkeeping, no device
    call): an allocation that even evicting every pin cannot cover
    evicts nothing, and a prefix chain's own entries are never evicted
    for its restores (a session goes instead)."""
    eng = GenerationEngine(lm, **dict(OPTS, offload_host_bytes=0))
    eng.stop()
    a, idx, sessions = eng._allocator, eng._prefix_index, eng._sessions
    held = a.alloc(3)                       # in-flight work
    b0, b1 = a.alloc(2)
    idx.register(b"h0", b0)
    idx.register(b"h1", b1)
    sess = a.alloc(3)
    sessions.put("s", np.arange(20), sess)
    assert a.free_count == 0 and eng._reclaimable() == 5
    assert eng._alloc_with_eviction(6) is None
    assert len(idx) == 2 and "s" in sessions    # nothing evicted
    chain = frozenset([b"h0", b"h1"])
    assert eng._reclaimable(frozenset([b"h0"])) == 4
    assert eng._reclaimable(chain) == 3
    assert eng._alloc_with_eviction(4, protect=chain) is None
    assert "s" in sessions
    got = eng._alloc_with_eviction(3, protect=chain)
    assert sorted(got) == sorted(sess) and "s" not in sessions
    assert idx.match([b"h0", b"h1"]) == [b0, b1]
    # unprotected, the LRU prefix entry goes first
    assert eng._alloc_with_eviction(1) == [b0] and len(idx) == 1


class TestPrefixTier:
    def test_evicted_prefix_blocks_restore_on_rematch(self, lm):
        eng = _mkeng(lm)
        try:
            pA = _prompt(0)
            base = eng.generate(pA, max_tokens=4,
                                timeout_ms=120_000)["tokens"]
            # pressure the pool until A's prefix entries are LRU-evicted
            # (demoted, not discarded)
            for i in range(1, 5):
                eng.generate(_prompt(i), max_tokens=4, timeout_ms=120_000)
            assert any(k.startswith("px:") for k in eng._offload.keys()), \
                "no prefix block was demoted under pool pressure"
            r0 = _offsnap(eng)["restores"]
            again = eng.generate(pA, max_tokens=4,
                                 timeout_ms=120_000)["tokens"]
            assert again == base
            assert _offsnap(eng)["restores"] > r0
        finally:
            eng.stop()


class TestOffloadFaults:
    # each (dtype, corrupting) pair appears once across the two tests,
    # so both fault flavours hit both pool dtypes
    @pytest.mark.parametrize("kv_dtype,corrupting",
                             [("f32", False), ("int8", True)])
    def test_torn_demotion_degrades_to_discard(self, lm, kv_dtype,
                                               corrupting):
        """Every demotion tears: the host tier stays empty, evicted
        sessions re-prefill from scratch, and every output is still
        token-identical."""
        eng = _mkeng(lm, kv_dtype=kv_dtype)
        try:
            eng.set_fault_injector(FaultInjector(
                rates={"offload_io": 1.0},
                corrupting=("offload_io",) if corrupting else ()))
            _two_turns(eng, lm)
            snap = _offsnap(eng)
            assert snap["demote_failures"] > 0
            assert snap["demotions"] == 0 and snap["restores"] == 0
            assert snap["host_runs"] == 0 and snap["host_bytes"] == 0
            assert eng.metrics.recoveries == 0
            eng.set_fault_injector(None)
            eng.evict_sessions()
            eng.clear_prefix_cache()
            assert _all_blocks_free(eng)
            assert eng._allocator.shared_count == 0
        finally:
            eng.stop()

    @pytest.mark.parametrize("kv_dtype,corrupting",
                             [("f32", True), ("int8", False)])
    def test_failed_restore_falls_back_to_reprefill(self, lm, kv_dtype,
                                                    corrupting):
        """Demotions land cleanly, then the seam tears every restore:
        the engine drops the host copy and re-prefills, token-identical,
        no corrupted lane, no leaked block."""
        eng = _mkeng(lm, kv_dtype=kv_dtype)
        try:
            out = _turn(eng, lm, "a", _prompt(0))
            assert eng.offload_sessions() == 1
            assert "a" in eng._offload
            eng.set_fault_injector(FaultInjector(
                rates={"offload_io": 1.0},
                corrupting=("offload_io",) if corrupting else ()))
            _turn(eng, lm, "a", _prompt(0) + out + [7, 11], n=4)
            snap = _offsnap(eng)
            assert snap["restore_failures"] >= 1
            assert snap["restores"] == 0
            assert "a" not in eng._offload, "torn copy not invalidated"
            assert eng.metrics.recoveries == 0
            eng.set_fault_injector(None)
            eng.evict_sessions()
            eng.clear_prefix_cache()
            assert _all_blocks_free(eng)
        finally:
            eng.stop()

    @pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
    def test_failed_scatter_goes_through_recovery(self, lm, kv_dtype):
        """A REAL scatter failure (the device call raises after it may
        have written the pools) is a CorruptedStateFault: one
        recompute-recovery, the resume re-admitted in order and restored
        from the surviving host copy, its tokens the oracle's, while a
        batchmate decoding at the time loses nothing; no block leaks."""
        eng = _mkeng(lm, kv_dtype=kv_dtype)
        load = eng._offload_load_fn
        fired = []

        def failing(*a, **k):
            if not fired:
                fired.append(1)
                raise RuntimeError("offload scatter: CUDA error 700")
            return load(*a, **k)
        try:
            out = _turn(eng, lm, "a", _prompt(0))
            assert eng.offload_sessions() == 1
            eng._offload_load_fn = failing
            other = eng.stream(_prompt(5), max_tokens=12,
                               timeout_ms=120_000)
            first = next(other)
            _turn(eng, lm, "a", _prompt(0) + out + [7, 11], n=4)
            rest = [first["token"]] + [e["token"] for e in other
                                       if "token" in e]
            assert rest == _ref_greedy(lm, _prompt(5), 12)
            assert fired and eng.metrics.recoveries == 1
            snap = _offsnap(eng)
            assert snap["restores"] == 1 and snap["restore_failures"] == 0
            eng.evict_sessions()
            eng.clear_prefix_cache()
            assert _all_blocks_free(eng)
        finally:
            eng.stop()

    def test_host_tier_survives_recompute_recovery(self, lm):
        """Recovery zeroes the DEVICE pools in place; the host tier is
        plain numpy and rides through untouched: a post-recovery resume
        still restores instead of re-prefilling."""
        eng = _mkeng(lm)
        try:
            out = _turn(eng, lm, "a", _prompt(0))
            assert eng.offload_sessions() == 1
            eng.set_fault_injector(FaultInjector(
                plan={"prefill": [1]}, corrupting=("prefill",)))
            eng.generate(_prompt(3), max_tokens=3, timeout_ms=120_000)
            assert eng.metrics.recoveries >= 1
            eng.set_fault_injector(None)
            assert "a" in eng._offload, "recovery dropped the host tier"
            _turn(eng, lm, "a", _prompt(0) + out + [7, 11], n=4)
            assert _offsnap(eng)["restores"] >= 1
        finally:
            eng.stop()


class TestAdminAndGuards:
    def test_clear_offload_resets_to_reprefill(self, lm):
        eng = _mkeng(lm)
        try:
            out = _turn(eng, lm, "a", _prompt(0))
            assert eng.offload_sessions() == 1
            assert eng.clear_offload() == 1
            assert eng.clear_offload() == 0
            misses0 = eng.metrics.session_misses
            _turn(eng, lm, "a", _prompt(0) + out + [7, 11], n=4)
            assert eng.metrics.session_misses == misses0 + 1
            assert _offsnap(eng)["restores"] == 0
        finally:
            eng.stop()

    def test_offload_requires_paged_sharing(self, lm):
        with pytest.raises(ValueError, match="offload"):
            GenerationEngine(lm, num_slots=2, cache="slots",
                             offload_host_bytes=1 << 20)
        with pytest.raises(ValueError, match="offload"):
            GenerationEngine(lm, num_slots=2, cache="paged",
                             block_size=8, prefill_chunk_tokens=8,
                             enable_prefix_sharing=False,
                             offload_host_bytes=1 << 20)

    def test_int8_holds_3x_the_sessions_per_host_byte(self, lm):
        """int8's byte saving carries into the host tier: the same
        demoted working set costs >= 3x fewer host bytes a block at int8
        than f32 (head_dim 16 -> 3.2x, scale rows included)."""
        per_block = {}
        for dt in ("f32", "int8"):
            eng = _mkeng(lm, kv_dtype=dt)
            try:
                for i in range(3):
                    _turn(eng, lm, f"s{i}", _prompt(i))
                eng.offload_sessions()
                snap = _offsnap(eng)
                # prefix blocks demoted under pool pressure ride along:
                # normalise per BLOCK, the unit capacity is sized in
                assert snap["host_blocks"] >= 3
                per_block[dt] = snap["host_bytes"] / snap["host_blocks"]
            finally:
                eng.stop()
        assert per_block["f32"] >= 3 * per_block["int8"]


def test_offload_stats_block_has_jax_keys(lm):
    """The ``stats()`` half of the JAX observability test (its
    ``/metrics`` half waits for the serving shell): the offload block
    sits under ``paged`` with the JAX engine's keys, enabled, and moves
    under a two-turn workload."""
    eng = _mkeng(lm)
    try:
        _two_turns(eng, lm)
        off = eng.stats()["paged"]["offload"]
    finally:
        eng.stop()
    jm = JaxMetrics()
    jm.cache_backend = "paged"
    want = jm.snapshot()["paged"]["offload"]
    assert set(off) == set(want)
    assert set(off["restore_ms"]) == set(want["restore_ms"])
    assert off["enabled"] is True
    assert off["demotions"] > 0 and off["restores"] > 0
    assert off["restore_ms"]["count"] == off["restores"]
    assert off["demote_ms"]["count"] > 0


# ---------------------------------------------------------------------------
# the offload_restore span against the JAX engine's
# ---------------------------------------------------------------------------
def _staged_turn(eng, tracer, sid, prompt):
    """One traced turn 2 whose demoted run the prefetch thread staged
    before the scheduler admits it: the scheduler is held at its
    ``latency`` seam from before the submit until the stage is in."""
    gate = Gate()
    eng.set_fault_injector(gate)
    tr = tracer.begin()
    try:
        assert gate.held.wait(10.0)
        demoted = sid not in eng._sessions and sid in eng._offload
        stream = eng.stream(prompt, max_tokens=4, session_id=sid,
                            timeout_ms=120_000, trace=tr)
        staged = eng._offload_prefetcher._staged
        t_end = time.monotonic() + 10.0
        while demoted and sid not in staged and time.monotonic() < t_end:
            time.sleep(0.005)
        assert not demoted or sid in staged
    finally:
        gate.open.set()
    toks = [c["token"] for c in stream if "token" in c]
    eng.set_fault_injector(None)
    tracer.finish(tr)
    return toks, tr


@pytest.mark.parametrize("prefetch", [False, True])
def test_traced_restore_spans_are_jax_spans(lm, jlm, prefetch):
    """JAX's 4-session workload with every turn 2 traced: the same tokens,
    and per turn 2 the same ``offload_restore`` attributes (the restored
    run's tokens and blocks; ``prefetched``, made deterministic by
    holding the scheduler until the prefetch thread staged the run) and
    ``prefix_match`` attributes as the JAX engine's."""
    keep = ("tokens", "blocks", "prefetched", "source", "matched_tokens",
            "matched_blocks", "cow")
    got = []
    for cls, model, tcls in ((JaxEngine, jlm, JaxTracer),
                             (GenerationEngine, lm, Tracer)):
        eng = cls(model, **dict(OPTS, offload_prefetch=prefetch))
        try:
            outs = [eng.generate(_prompt(i), max_tokens=5, session_id=f"s{i}",
                                 timeout_ms=120_000)["tokens"]
                    for i in range(4)]
            tracer = tcls(enabled=True)
            turns = []
            for i in range(4):
                prompt = _prompt(i) + outs[i] + [7, 11]
                if prefetch:
                    toks, tr = _staged_turn(eng, tracer, f"s{i}", prompt)
                else:
                    tr = tracer.begin()
                    toks = eng.generate(prompt, max_tokens=4,
                                        session_id=f"s{i}",
                                        timeout_ms=120_000,
                                        trace=tr)["tokens"]
                    tracer.finish(tr)
                turns.append((toks, [
                    (sp.kind, {k: sp.attrs[k] for k in keep
                               if k in sp.attrs})
                    for sp in tr.spans
                    if sp.kind in ("offload_restore", "prefix_match")]))
            got.append((outs, turns, eng.stats()["paged"]["offload"]))
        finally:
            eng.stop()
    (jouts, jturns, joff_snap), (outs, turns, off) = got
    assert (outs, turns) == (jouts, jturns)
    restores = [a for _, spans in turns for k, a in spans
                if k == "offload_restore"]
    assert restores and len(restores) == off["restores"] \
        == joff_snap["restores"]
    assert all(a["prefetched"] is prefetch for a in restores)
    assert all(a == {"tokens": 20, "blocks": 3, "prefetched": prefetch}
               for a in restores)
    # every turn 2 is a session hit, restored or pinned
    assert all([k for k, _ in spans].count("prefix_match") == 1
               and dict(spans)["prefix_match"]["source"] == "session"
               for _, spans in turns)
